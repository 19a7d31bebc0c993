"""Every hand-written CUDA kernel of the port against its plain version, on
the card.

These tests carry the ``gpu`` marker and skip without a card. They import
only torch, numpy, pytest and the port, with fixtures of their own, so the
card's machine (no JAX there) runs them without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu -rs tests/test_torch_gpu.py

(``chip_smoke.py``'s phase ``gpu_tests`` runs exactly that.) The CPU
tests of each module hold its plain version against the JAX package.
"""
import numpy as np
import pytest
import torch

from adaqp_tpu_torch.assigner.assignment import buckets_from_assignment, random_assignment
from adaqp_tpu_torch.comm.exchange import padded_wire
from adaqp_tpu_torch.comm.wire import wire_cols
from adaqp_tpu_torch.ops import quant_cuda as qc
from adaqp_tpu_torch.ops import spmm_block as tblock
from adaqp_tpu_torch.ops import spmm_compact as tc
from adaqp_tpu_torch.ops import spmm_strip as tstrip
from adaqp_tpu_torch.ops.spmm_compact import BD, BS, WORDS
from adaqp_tpu_torch.scripts import microbench_dma_gather as dg
from adaqp_tpu_torch.scripts import microbench_expand as me
from adaqp_tpu_torch.scripts import microbench_gather as gb
from adaqp_tpu_torch.scripts import probe_r5 as pr
from torch_helpers import (abs_sums, hub_layout, merged_targets, random_edges, random_plan,
                           random_wire, rank_buckets, received, received_frames, strip_cases)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rows(rng, n, f, ft):
    x = rng.normal(size=(n, f)) * rng.uniform(0.1, 10.0, size=(n, 1))
    x[:, ft:] = 0.0  # layout padding
    x[3] = 1.25  # a constant row
    return x.astype(np.float32)


def _tiered_edges(rng, n, n_src, e):
    """Dense diagonal regions in the first half of the rows (full tiles), a
    hot set of 1,500 source columns there too (subtile groups, several
    subtiles to a region), a sprinkle over the second half (the ELL tail)."""
    d1 = rng.integers(0, n // 2, e)
    s1 = np.minimum((d1 // 2048) * 2048 + rng.integers(0, 2048, e), n_src - 1)
    d2 = rng.integers(0, n // 2, e // 2)
    hot = rng.integers(0, n_src, 1500)
    s2 = hot[rng.integers(0, 1500, e // 2)]
    d3 = rng.integers(n // 2, n, e // 40)
    s3 = rng.integers(0, n_src, e // 40)
    return (np.concatenate([s1, s2, s3]).astype(np.int32),
            np.concatenate([d1, d2, d3]).astype(np.int32))


def _item_inputs(rng, fc):
    mask = rng.integers(0, 1 << 16, (BD, WORDS)).astype(np.uint16).view(np.int16)
    col = rng.integers(0, BS, BS).astype(np.int32).reshape(16, 128)
    win = rng.normal(size=(BS, fc)).astype(np.float32)
    return mask, col, win


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_kernels_match_plain(rng, cuda_device, bits, dtype):
    n, f, ft = 1000, 640, 602
    x = torch.tensor(_rows(rng, n, f, ft), device=cuda_device).to(dtype)
    fw = wire_cols(ft, bits)
    w, s, r = qc.quant_pack(x, bits, ft, fw, 123)
    w0, s0, r0 = qc._quant_pack_torch(x, bits, ft, fw, 123)
    assert torch.equal(w, w0) and torch.equal(s, s0) and torch.equal(r, r0)
    y = qc.unpack_dequant(w, s, r, bits, ft, fw, f)
    assert torch.equal(y, qc.dequantize_words(w0, s0, r0, bits, ft, fw, f))


# (bits_set, has_params, skipped channels): a quantized wire with raw f32
# lanes, the fp wire, a wire with no lanes at all (N=0)
LANE_WIRES = {
    "2/4/8/32": ((2, 4, 8, 32), True, ((0, 2),)),
    "fp": ((32,), False, ((0, 2),)),
    "no lanes": ((2, 4, 8), True, tuple((a, b) for a in range(4) for b in range(4))),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f,ft", [(640, 602), (256, 256), (333, 301)])
@pytest.mark.parametrize("kind", list(LANE_WIRES))
def test_cuda_lane_kernels_match_plain(rng, cuda_device, kind, f, ft, dtype):
    """pack_lanes and unpack_lanes (one launch a direction) against their
    plain versions on K=4 wires of the port's wire lowering, bit for bit: every
    rank's send buffer and ranges, its received rows placed through the
    inverse map and one row a lane; the rows added into their destinations
    within 1e-6 * sum |terms| (the order of the atomics)."""
    bits_set, params, skip = LANE_WIRES[kind]
    out_len, n_src = 3000, 2000
    wd = random_wire(rng, 4, ft, bits_set, params, out_len, n_src, skip=skip, lanes=(100, 400))
    wires = [wd.local(r, out_len, cuda_device) for r in range(4)]
    bufs = []
    for r, w in enumerate(wires):
        x = torch.tensor(_rows(rng, n_src, f, ft), device=cuda_device).to(dtype)
        keys = [qc.stream_key(9, r, bi) for bi in range(len(w.bits))]
        n_words = sum(w.send_splits)
        before = qc.quant_pack.launches
        got, rng_k = qc.pack_lanes(x, w.send_lanes, w.bits, w.wpr, keys, ft, n_words, True)
        assert qc.quant_pack.launches == before + (w.send_lanes.n > 0)
        want, rng_p = qc._pack_lanes_torch(x, w.send_lanes, w.bits, w.wpr, keys, ft, n_words,
                                           True)
        assert torch.equal(got, want) and torch.equal(rng_k, rng_p), f"rank {r}"
        bufs.append(got)
    for r, w in enumerate(wires):
        recv = received(bufs, wires, r)
        for inv in (w.d_inv, None):
            want = qc._unpack_lanes_torch(recv, w.recv_lanes, w.bits, w.wpr, ft, f, inv)
            before = qc.unpack_dequant.launches
            got = qc.unpack_lanes(recv, w.recv_lanes, w.bits, w.wpr, ft, f, inv)
            assert qc.unpack_dequant.launches == before + (w.recv_lanes.n > 0)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
                f"rank {r}, inv {inv is not None}")
        # the backward's sums: atomics in another order than index_add_'s
        zeros = torch.zeros(out_len, f, device=cuda_device)
        got = qc.unpack_lanes(recv, w.recv_lanes, w.bits, w.wpr, ft, f, add_into=zeros.clone())
        want = qc._unpack_lanes_torch(recv, w.recv_lanes, w.bits, w.wpr, ft, f,
                                      add_into=zeros.clone())
        terms = qc._unpack_lanes_torch(recv, w.recv_lanes, w.bits, w.wpr, ft, f).abs()
        scale = zeros.clone().index_add_(0, w.recv_lanes.row, terms)
        assert bool(((got - want).abs() <= 1e-6 * scale).all()), f"rank {r}: sums"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_padded_kernels_match_plain(rng, cuda_device, bits, dtype):
    n, f, ft = 1000, 640, 602
    x = torch.tensor(_rows(rng, n, f, ft), device=cuda_device).to(dtype)
    before = (qc.quant_rows.launches, qc.dequant_rows.launches)
    q, s, r = qc.quant_rows(x, bits, ft, 123)
    q0, s0, r0 = qc._quant_rows_torch(x, bits, ft, 123)
    assert torch.equal(q, q0) and torch.equal(s, s0) and torch.equal(r, r0)
    assert torch.equal(qc.dequant_rows(q, s, r), qc._dequant_rows_torch(q0, s0, r0))
    assert (qc.quant_rows.launches, qc.dequant_rows.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f,ft", [(640, 602), (256, 256), (18, 17)])
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "bwd"])
def test_cuda_frame_kernels_match_plain(rng, cuda_device, forward, f, ft, dtype):
    """quant_frames and dequant_frames (one launch a direction) against
    their plain versions on the lane tables of a random K=4 plan with 2-,
    4- and 8-bit buckets: every rank's send buffer and ranges bit for bit;
    the received rows stored at their halo slots bit for bit (forward), or
    added into their owners' rows within 1e-6 * sum |terms| (backward: the
    atomics add in another order than index_add_, and row 0 comes back from
    every peer); the sentinel lanes of both directions dropped."""
    n_rows = 3000
    plan = random_plan(rng, 4, n_rows, lanes=(200, 800))
    lowered = buckets_from_assignment(plan, random_assignment(plan, 1, 3), n_rows)[0]
    assert len(lowered[0]) == 3
    ft = ft if forward else f  # the backward's rows are every column live
    n_src, out_len = (n_rows, plan.r_pad) if forward else (plan.r_pad, n_rows)
    frames = [getattr(padded_wire(rank_buckets(lowered, r, cuda_device), ft, f),
                      "fwd" if forward else "bwd") for r in range(4)]
    bufs = []
    for r, fr in enumerate(frames):
        x = torch.tensor(_rows(rng, n_src, f, ft), device=cuda_device).to(dtype)
        keys = [qc.stream_key(9, r, i) for i in range(len(fr.bits))]
        before = qc.quant_rows.launches
        got, rng_k = qc.quant_frames(x, fr, keys, with_range=True)
        assert qc.quant_rows.launches == before + (fr.n > 0)
        want, rng_p = qc._quant_frames_torch(x, fr, keys, with_range=True)
        assert torch.equal(got, want) and torch.equal(rng_k, rng_p), f"rank {r}"
        bufs.append(got)
    for r, fr in enumerate(frames):
        recv = received_frames(bufs, frames, r)
        zeros = torch.zeros(out_len, f, device=cuda_device)
        before = qc.dequant_rows.launches
        got = qc.dequant_frames(recv, fr, zeros.clone(), add=not forward)
        assert qc.dequant_rows.launches == before + (fr.n > 0)
        want = qc._dequant_frames_torch(recv, fr, zeros.clone(), add=not forward)
        if forward:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), f"rank {r}"
            continue
        assert bool(((got - want).abs() <= 1e-6 * abs_sums(recv, fr, out_len, f)).all()), \
            f"rank {r}: sums"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_strip_kernel_matches_plain(rng, cuda_device, dtype):
    src, dst = random_edges(rng, 5000, 60000)
    lay = tstrip.strip_layout(src, dst, 5000, min_edges=4).to_device(cuda_device)
    h = torch.from_numpy(rng.normal(size=(lay.n_src_pad, 640)).astype(np.float32))
    h = h.to(cuda_device, dtype)
    before = tstrip.strip_spmm.launches
    got = tstrip.strip_spmm(lay, h)
    torch.cuda.synchronize()
    assert tstrip.strip_spmm.launches == before + 1
    want = tstrip._run_strip_torch(lay, h)
    # f32 sums in another order, then (bf16) one rounding step
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f", [8, 128, 256, 264, 640])
def test_cuda_strip_kernel_walks_every_layout(rng, cuda_device, f, dtype):
    # against the plain version; a rerun is the same bit for bit
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for name, (src, dst, n, n_src, me) in strip_cases(rng).items():
        lay = tstrip.strip_layout(src, dst, n, min_edges=me, n_src=n_src).to_device(cuda_device)
        h = torch.from_numpy(rng.normal(size=(lay.n_src_pad, f)).astype(np.float32))
        h = h.to(cuda_device, dtype)
        want = tstrip._run_strip_torch(lay, h)
        got = tstrip._run_strip_cuda(lay, h)
        again = tstrip._run_strip_cuda(lay, h)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")
        assert torch.equal(got, again), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_block_kernel_matches_plain(rng, cuda_device, dtype):
    # a square layout, and a halo-shaped one whose rows are padded to 256
    # only (2,304: its last strip holds one block)
    src, dst = random_edges(rng, 5000, 60000)
    hs, hd = random_edges(rng, 2100, 30000, 5000)
    layouts = {"square": tblock.block_layout(src, dst, 5000, min_edges=4),
               "non-square": tblock.block_layout(hs, hd, 2100, min_edges=8, n_src=5000)}
    assert layouts["non-square"].n_pad % 2048
    # f32 sums in another order, then (bf16) one rounding step
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for name, host in layouts.items():
        lay = host.to_device(cuda_device)
        h = torch.from_numpy(rng.normal(size=(lay.n_src_pad, 640)).astype(np.float32))
        h = h.to(cuda_device, dtype)
        before = tblock.block_spmm.launches
        got = tblock.block_spmm(lay, h)
        torch.cuda.synchronize()
        assert tblock.block_spmm.launches == before + 1
        want = tblock._run_block_torch(lay, h)
        assert got.shape == want.shape and got.dtype == dtype, name
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_compact_kernel_matches_plain(rng, cuda_device, dtype):
    # three tiers, and groups only, where a region's subtiles spill into a
    # second item of its (strip, window): one walk tile takes both
    src, dst = _tiered_edges(rng, 8192, 8192, 60000)
    layouts = {"three tiers": tc.compact_layout(src, dst, 8192),
               "merged subtiles": tc.compact_layout(src, dst, 8192, full_cols=2048)}
    # f32 sums in another order, then (bf16) one rounding step
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for name, host in layouts.items():
        lay = host.to_device(cuda_device)
        h = torch.from_numpy(rng.normal(size=(lay.n_src_pad, 384)).astype(np.float32))
        h = h.to(cuda_device, dtype)
        before = tc.compact_spmm.launches
        got = tc.compact_spmm(lay, h)
        torch.cuda.synchronize()
        assert tc.compact_spmm.launches == before + 1
        want = tc._run_compact_torch(lay, h)
        assert got.shape == want.shape and got.dtype == dtype, name
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")
    # the groups-only layout has a target whose subtiles come from two items
    assert merged_targets(layouts["merged subtiles"]) > 0


@pytest.mark.gpu
def test_cuda_gather_rows_is_bit_exact(rng, cuda_device):
    tc.dynamic_gather_supported.cache_clear()
    assert tc.dynamic_gather_supported() is True
    x = torch.from_numpy(rng.normal(size=(1000, 37)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 1000, (1000, 37)).astype(np.int32)).to(cuda_device)
    assert torch.equal(tc.gather_rows(x, idx), torch.take_along_dim(x, idx.long(), dim=0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,skew", [((2048, 128), 0), ((1000, 37), 0), ((1000, 1), 0),
                                        ((2048, 128), 1), ((1000, 37), 1), ((7, 4), 3)],
                         ids=["2048x128", "1000x37", "C=1", "2048x128-at+4", "1000x37-at+4",
                              "7x4-at+12"])
@pytest.mark.parametrize("zero", [False, True], ids=["random", "zero-idx"])
def test_cuda_gather_rows_shapes_and_alignments(cuda_device, shape, skew, zero):
    """Bit for bit with torch.take_along_dim on the 4-wide and the scalar
    paths: idx (and x) as contiguous views ``skew`` elements into their
    storage, random or all-zero (the JAX probe's own input)."""
    rng = np.random.default_rng(sum(shape) + skew)
    r, c = shape

    def view(a, dtype):
        out = torch.empty(r * c + skew, dtype=dtype, device=cuda_device)[skew:].view(r, c)
        return out.copy_(torch.from_numpy(a))

    x = view(rng.normal(size=shape).astype(np.float32), torch.float32)
    idx = view(np.zeros(shape, np.int32) if zero else
               rng.integers(0, r, shape).astype(np.int32), torch.int32)
    assert x.is_contiguous() and idx.is_contiguous() and idx.data_ptr() % 16 == 4 * skew % 16
    before = tc.gather_rows.launches
    got = tc.gather_rows(x, idx)
    assert tc.gather_rows.launches == before + 1
    assert torch.equal(got, torch.take_along_dim(x, idx.long(), dim=0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_ring_gather_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(dg.N, 256)).astype(np.float32)).to(cuda_device, dtype)
    for vname, vi in dg.idx_variants(rng).items():
        i = torch.from_numpy(vi).to(cuda_device)
        for depth in (1, 4, 64):
            before = dg.ring_gather.launches
            got = dg.ring_gather(h, i, 3, depth, many_blocks=True)
            assert dg.ring_gather.launches == before + 1
            assert torch.equal(got, dg._ring_gather_torch(h, i)), (vname, depth)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [8, 131, dg.CHUNK])
@pytest.mark.parametrize("blocks", [None, 1])
def test_cuda_ring_gather_persistent_form(cuda_device, blocks, chunk):
    # the reference's form (blocks None): one block an SM with `depth`
    # copies in flight over its share of the stream (8 and 131 rows: fewer
    # than SMs, a block a row; 4,096: a remainder over 132 SMs); and a grid
    # of one block, the ring on one SM
    rng = np.random.default_rng(chunk)
    h = torch.from_numpy(rng.normal(size=(dg.N, 256)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    sms = dg.sm_count(h.device)
    grid = dg.ring_plan(chunk, 2, 64, sms=sms, blocks=blocks)[0]
    assert grid == (1 if blocks else min(sms, chunk))
    for vname, vi in dg.idx_variants(rng, dg.N, chunk).items():
        i = torch.from_numpy(vi).to(cuda_device)
        want = dg._ring_gather_torch(h, i)
        for depth in (1, 4, 64):
            for iters in (1, 3):
                before = dg.ring_gather.launches
                got = dg.ring_gather(h, i, iters, depth, blocks=blocks)
                assert dg.ring_gather.launches == before + 1
                assert torch.equal(got, want), (vname, depth, iters)


@pytest.mark.gpu
@pytest.mark.parametrize("issuers", [1, 2, 3, 8, 16])
def test_cuda_ring_gather_any_issuers(cuda_device, issuers):
    # the ring's slots split over 1 to 16 issuing warps (ring_issuers: at
    # most ISSUERS, the depth and a block's rows times passes), a slot each
    # (depth = issuers: one block an SM, or one block) or shares that may
    # be uneven (3 warps of 64 slots: blocks of 3 rows, one pass), at f32
    # rows of 640 columns
    rng = np.random.default_rng(issuers)
    h = torch.from_numpy(rng.normal(size=(dg.N, 640)).astype(np.float32)).to(cuda_device)
    for chunk in (issuers * 8, issuers * 1365):
        i = torch.from_numpy(dg.idx_variants(rng, dg.N, chunk)["uniform"]).to(cuda_device)
        for depth, blocks, iters in ((issuers, None, 2), (issuers, 1, 2),
                                     (64, chunk // issuers, 1)):
            rows = dg.ring_plan(chunk, iters, depth, sms=dg.sm_count(h.device), blocks=blocks)[1]
            # fewer rows than SMs leave a block a row: as many issuers as items
            assert dg.ring_issuers(depth, rows * iters) == min(issuers, rows * iters)
            assert blocks is None or rows * iters >= issuers
            got = dg.ring_gather(h, i, iters, depth, blocks=blocks)
            assert torch.equal(got, dg._ring_gather_torch(h, i)), (chunk, depth, blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [0, 1])
def test_cuda_window_gather_matches_plain(cuda_device, axis, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(axis)
    shape = (2048, 256) if axis == 0 else (256, 2048)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    full = torch.randint(0, 2048, shape, generator=g, device=cuda_device, dtype=torch.int32)
    col = torch.randint(0, 2048, (1, 2048), generator=g, device=cuda_device, dtype=torch.int32)
    for idx in (full, col):
        for iters in (1, 3, 200):
            before = gb.window_gather.launches
            got = gb.window_gather(x, idx, iters, axis)
            assert gb.window_gather.launches == before + 1
            assert torch.equal(got, gb._window_gather_torch(x, idx, iters, axis))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", [((1000, 257), 0), ((257, 1000), 1), ((300, 641), 0),
                                        ((641, 300), 1)])
def test_cuda_window_gather_uneven_shapes(cuda_device, shape, axis, dtype):
    # a gather axis of 300 or 1,000 positions (no multiple of 256 threads)
    # and 257 or 641 lines, which the plan's lines a block do not divide;
    # then lines of 1, 3 and 7 a block (narrower loads, other remainders)
    length, lines = shape[axis], shape[1 - axis]
    plan = gb.window_plan(*shape, axis, 2 if dtype == torch.bfloat16 else 4)
    assert lines % plan.lines and length % 256
    g = torch.Generator(device=cuda_device).manual_seed(lines + axis)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    full = torch.randint(0, length, shape, generator=g, device=cuda_device, dtype=torch.int32)
    col = torch.randint(0, length, (1, length), generator=g, device=cuda_device,
                        dtype=torch.int32)
    for idx in (full, col):
        for per_block in (None, 1, 3, 7):
            for iters in (1, 3):
                before = gb.window_gather.launches
                got = gb.window_gather(x, idx, iters, axis, per_block)
                assert gb.window_gather.launches == before + 1
                assert torch.equal(got, gb._window_gather_torch(x, idx, iters, axis)), (
                    idx.shape, per_block, iters)


@pytest.mark.gpu
@pytest.mark.parametrize("fc", [64, 100, 136, 256, 384, 640])
@pytest.mark.parametrize("kind", [0, 1])
def test_cuda_compact_item_matches_plain(cuda_device, kind, fc):
    """fc 100: a row stride that is not a multiple of 16 bytes (the wrapper
    pads a copy); 136 and 640: a last chunk of 8 and of 128 columns."""
    mask, col, win = (torch.from_numpy(a).to(cuda_device)
                      for a in _item_inputs(np.random.default_rng(fc), fc))
    win = win.to(torch.bfloat16)
    for iters in (1, 200):
        before = gb.compact_item.launches
        got = gb.compact_item(mask, col, win, kind, iters)
        assert gb.compact_item.launches == before + 1
        assert gb.item_within(got, gb._compact_item_torch(mask, col, win, kind, iters))
        if kind == 0:
            assert torch.equal(got[BD:], torch.zeros_like(got[BD:]))


@pytest.mark.gpu
@pytest.mark.parametrize("masks", ["ones", "zeros"])
@pytest.mark.parametrize("cols", ["equal", "arange"])
@pytest.mark.parametrize("kind", [0, 1])
def test_cuda_compact_item_edge_inputs(cuda_device, kind, cols, masks):
    """A mask of all ones (every product a full sum) and of all zeros
    (zeros out), ``col`` all one row and ``col = arange`` (kind 1 then
    multiplies the same rows as kind 0), at 1 and 200 iterations."""
    rng = np.random.default_rng(7)
    fc = 136
    mask = torch.full((BD, WORDS), -1 if masks == "ones" else 0, dtype=torch.int16,
                      device=cuda_device)
    col = (torch.full((BS,), 1234, dtype=torch.int32) if cols == "equal" else
           torch.arange(BS, dtype=torch.int32)).to(cuda_device)
    win = torch.from_numpy(rng.normal(size=(BS, fc)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    for iters in (1, 200):
        got = gb.compact_item(mask, col, win, kind, iters)
        want = gb._compact_item_torch(mask, col, win, kind, iters)
        assert gb.item_within(got, want)
        if masks == "zeros":
            assert not got.any()
        if kind == 0:
            assert not got[BD:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("layout,f", [("random", 128), ("random", 384), ("random", 640),
                                      ("hub", 384)])
@pytest.mark.parametrize("variant", me.VARIANTS)
def test_cuda_expand_spmm_matches_plain(rng, cuda_device, variant, layout, f):
    """A random layout with more tiles than destination blocks, and a hub
    (``tests/torch_helpers.py::hub_layout``): one block of 26 tiles, whose
    832 K-steps cycle the window ring many times, and blocks with no tile,
    which must come out zero."""
    if layout == "hub":
        lay = hub_layout(rng, cuda_device)
        tiles = torch.diff(lay.blk_ptr)
        assert int(tiles[0]) == 26 and int((tiles == 0).sum()) > 100
    else:
        src, dst = random_edges(rng, 5000, 200_000)
        lay = tblock.block_layout(src, dst, 5000, min_edges=64).to_device(cuda_device)
        assert int(lay.blk_ptr[-1]) > lay.n_pad // BD  # more tiles than destination blocks
    h = torch.from_numpy(rng.normal(size=(lay.n_pad, f)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    before = me.expand_spmm.launches
    got = me.expand_spmm(lay, h, variant)
    torch.cuda.synchronize()
    assert me.expand_spmm.launches == before + 1
    assert got.dtype == torch.bfloat16
    want = me._run_expand_torch(lay, h, variant).float()
    # exact products summed in f32 in another order (the tensor cores'),
    # then rounded to bf16: the sum's error scales with the sum of the
    # terms' magnitudes, which v3's products (up to 3e4 |h|, of both signs)
    # far exceed the result by; each rounding adds 2^-8 of the result
    tol = 1e-4 + 2.0 ** -7 * want.abs() + 1e-5 * me.term_magnitudes(lay, h, variant)
    assert ((got.float() - want).abs() <= tol).all()
    if layout == "hub":
        none = ((tiles == 0).nonzero().flatten()[:, None] * BD
                + torch.arange(BD, device=cuda_device)).flatten()
        assert not got[none].any()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 25), (1, 1), (33, 31), (1000, 7), (7, 1000),
                                   (4097, 65), (100_003, 25)])
def test_cuda_transpose_u32_is_bit_exact(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(shape[0])
    x = torch.randint(-2**31, 2**31 - 1, shape, generator=g, device=cuda_device,
                      dtype=torch.int32)
    before = pr.transpose_u32.launches
    got = pr.transpose_u32(x)
    assert pr.transpose_u32.launches == before + 1
    assert torch.equal(got, pr._transpose_torch(x))
