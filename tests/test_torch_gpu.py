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
from torch_helpers import random_edges, random_wire, received, strip_cases


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
    src, dst = random_edges(rng, 5000, 60000)
    lay = tblock.block_layout(src, dst, 5000, min_edges=4).to_device(cuda_device)
    h = torch.from_numpy(rng.normal(size=(lay.n_src_pad, 640)).astype(np.float32))
    h = h.to(cuda_device, dtype)
    before = tblock.block_spmm.launches
    got = tblock.block_spmm(lay, h)
    torch.cuda.synchronize()
    assert tblock.block_spmm.launches == before + 1
    want = tblock._run_block_torch(lay, h)
    # f32 sums in another order, then (bf16) one rounding step
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_compact_kernel_matches_plain(rng, cuda_device, dtype):
    src, dst = _tiered_edges(rng, 8192, 8192, 60000)
    lay = tc.compact_layout(src, dst, 8192).to_device(cuda_device)
    h = torch.from_numpy(rng.normal(size=(lay.n_src_pad, 384)).astype(np.float32))
    h = h.to(cuda_device, dtype)
    before = tc.compact_spmm.launches
    got = tc.compact_spmm(lay, h)
    torch.cuda.synchronize()
    assert tc.compact_spmm.launches == before + 1
    want = tc._run_compact_torch(lay, h)
    # f32 sums in another order, then (bf16) one rounding step
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol)


@pytest.mark.gpu
def test_cuda_gather_rows_is_bit_exact(rng, cuda_device):
    tc.dynamic_gather_supported.cache_clear()
    assert tc.dynamic_gather_supported() is True
    x = torch.from_numpy(rng.normal(size=(1000, 37)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 1000, (1000, 37)).astype(np.int32)).to(cuda_device)
    assert torch.equal(tc.gather_rows(x, idx), torch.take_along_dim(x, idx.long(), dim=0))


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
@pytest.mark.parametrize("chunk", [8, dg.CHUNK])
def test_cuda_ring_gather_one_block_at_depth_64(cuda_device, chunk):
    # the reference's form: one block keeps 64 copies in flight over the stream
    rng = np.random.default_rng(chunk)
    h = torch.from_numpy(rng.normal(size=(dg.N, 256)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    assert dg.ring_plan(chunk, 2, 64)[::2] == (1, min(64, 2 * chunk))
    for vname, vi in dg.idx_variants(rng, dg.N, chunk).items():
        i = torch.from_numpy(vi).to(cuda_device)
        before = dg.ring_gather.launches
        got = dg.ring_gather(h, i, 2, 64)
        assert dg.ring_gather.launches == before + 1
        assert torch.equal(got, dg._ring_gather_torch(h, i)), vname


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
@pytest.mark.parametrize("fc", [256, 136])
@pytest.mark.parametrize("kind", [0, 1])
def test_cuda_compact_item_matches_plain(cuda_device, kind, fc):
    mask, col, win = (torch.from_numpy(a).to(cuda_device)
                      for a in _item_inputs(np.random.default_rng(fc), fc))
    win = win.to(torch.bfloat16)
    for iters in (1, 200):
        before = gb.compact_item.launches
        got = gb.compact_item(mask, col, win, kind, iters)
        assert gb.compact_item.launches == before + 1
        assert gb.item_within(got, gb._compact_item_torch(mask, col, win, kind, iters))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [128, 640])
@pytest.mark.parametrize("variant", me.VARIANTS)
def test_cuda_expand_spmm_matches_plain(rng, cuda_device, variant, f):
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
