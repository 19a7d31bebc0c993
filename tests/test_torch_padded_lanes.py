"""The padded wire's lane tables and its one-launch send and receive sides.

``comm/exchange.py::padded_wire`` lays out each direction's lanes (source
and destination rows, bucket, index in the bucket's batch, frame offset)
from ``buckets_from_assignment``'s arrays, and the exchange runs the
``quant_rows``/``dequant_rows`` kernels once a direction over them
(``ops/quant_cuda.py::quant_frames``/``dequant_frames``); on the CPU they
run the plain versions ``_quant_frames_torch`` and
``_dequant_frames_torch``. Held here, bit for bit, against the composition
the exchange used before (per bucket the lane gather, ``quant_rows``,
``to_width``, ``pack_rows`` and the frame; on the receive side the frame's
split, ``unpack_rows``, ``dequant_rows``, ``true_columns`` and the
placement or ``index_add_``, kept in ``tests/torch_helpers.py``), on random
plans of K=2 and K=4 ranks: mixed 2/4/8-bit buckets, an empty bucket, f32
and bf16 rows, the sentinel slots of both directions, wire widths below
and above the stored width. The frames also decode, bit for bit, through
the JAX package's ``unpack_rows`` and ``message_dequantize``. One process,
no ranks: every rank's side runs here and the receive buffers are cut from
the send buffers. The card's kernels against the same plain versions:
``tests/test_torch_gpu.py``.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaqp_tpu.ops import quant as jquant
from adaqp_tpu_torch.assigner.assignment import buckets_from_assignment, random_assignment
from adaqp_tpu_torch.comm.exchange import padded_wire, range_proxy, variance_proxy
from adaqp_tpu_torch.ops import quant_cuda as qc
from torch_helpers import (frames_by_buckets, rank_buckets, random_plan, received_frames,
                           unframe_by_buckets)

N_ROWS = 60
# (F, f_true): the wire's columns within the row, past it, Reddit's layer 0
SHAPES = {"48/37": (48, 37), "18/17": (18, 17), "640/602": (640, 602)}


def _layer(k, shape, empty):
    """Per rank (bits, quads) of one layer on a random plan: K=4 with 2- and
    8-bit buckets and an empty 4-bit one between them, K=2 all three."""
    rng = np.random.default_rng(zlib.crc32(f"{k} {shape} {empty}".encode()))
    lanes = (2, 5) if shape == "640/602" else (3, 12)
    plan = random_plan(rng, k, N_ROWS, lanes)
    asg = random_assignment(plan, 1, k, bits_set=(2, 8) if empty else (2, 4, 8))
    ranks = [rank_buckets(buckets_from_assignment(plan, asg, N_ROWS)[0], r) for r in range(k)]
    if empty:
        hole = torch.zeros((k, 0), dtype=torch.int64)
        ranks = [((bits[0], 4, *bits[1:]), (quads[0], (hole,) * 4, *quads[1:]))
                 for bits, quads in ranks]
    return plan, ranks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("k", [2, 4])
def test_frames_reproduce_the_bucket_composition(k, shape, forward, dtype):
    f, ft = SHAPES[shape]
    if not forward:
        ft = f  # the backward's rows are every column live
    plan, ranks = _layer(k, shape, empty=k == 4)
    rng = np.random.default_rng(k * 7 + f)
    n_src, out_len = (N_ROWS, plan.r_pad) if forward else (plan.r_pad, N_ROWS)
    xs = [torch.from_numpy(rng.standard_normal((n_src, f)).astype(np.float32)).to(dtype)
          for _ in range(k)]
    frames = [getattr(padded_wire(b, ft, f), "fwd" if forward else "bwd") for b in ranks]
    bufs, old = [], []
    for r, (b, fr, x) in enumerate(zip(ranks, frames, xs)):
        key = 1000 + r
        keys = [qc.stream_key(key, i) for i in range(len(fr.bits))]
        buf, rng_rows = qc.quant_frames(x, fr, keys, with_range=True)
        want = frames_by_buckets(x, b, keys, ft, backward=not forward)
        assert buf.dtype == torch.uint8 and buf.shape == (fr.nbytes,)
        for i, (view, w) in enumerate(zip(fr.views(buf), want)):
            assert torch.equal(view, w.reshape(-1)), f"rank {r} bucket {i}: frames differ"
        # the ranges give the variance trace of the rows the lanes read
        src = fr.src[fr.src < n_src].unique()
        assert torch.equal(range_proxy(rng_rows[src], ft), variance_proxy(x[src].float(), ft))
        assert not rng_rows[np.setdiff1d(np.arange(n_src), src.numpy())].any()
        bufs.append(buf)
        old.append(want)
    # the sentinels of this direction, dropped on receipt (a rank that no
    # peer sends to receives only those)
    dst = torch.cat([fr.dst for fr in frames])
    assert (dst >= out_len).any() and (dst < out_len).any()
    for r, (b, fr) in enumerate(zip(ranks, frames)):
        recv = received_frames(bufs, frames, r)
        got = qc.dequant_frames(recv, fr, torch.zeros((out_len, f)), add=not forward)
        want = unframe_by_buckets([torch.stack([o[i][r] for o in old]) for i in range(len(b[0]))],
                                  b, f, ft, out_len, backward=not forward)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), f"rank {r}"
        assert not got[:, ft:].any() and (got.any() or not (fr.dst < out_len).any())


@pytest.mark.parametrize("k", [2, 4])
def test_frames_decode_with_the_jax_package(k):
    """Each bucket's received frames through the JAX package's unpack_rows
    and message_dequantize give the rows the port places, bit for bit."""
    f, ft = SHAPES["48/37"]
    plan, ranks = _layer(k, "48/37", empty=False)
    rng = np.random.default_rng(k)
    xs = [torch.from_numpy(rng.standard_normal((N_ROWS, f)).astype(np.float32))
          for _ in range(k)]
    frames = [padded_wire(b, ft, f).fwd for b in ranks]
    bufs = [qc.quant_frames(x, fr, [qc.stream_key(r, i) for i in range(len(fr.bits))])[0]
            for r, (x, fr) in enumerate(zip(xs, frames))]
    for r, fr in enumerate(frames):
        recv = received_frames(bufs, frames, r)
        got = qc.dequant_frames(recv, fr, torch.zeros((plan.r_pad, f)))
        want = np.zeros((plan.r_pad + 1, f), np.float32)
        for i, view in enumerate(fr.views(recv)):
            frame = view.reshape(fr.counts[i], -1)
            codes = jnp.asarray(frame[:, :-4].numpy())
            pair = jnp.asarray(frame[:, -4:].contiguous().view(torch.bfloat16).float().numpy())
            q = np.asarray(jquant.unpack_rows(codes, fr.bits[i], fr.f_wire))
            np.testing.assert_array_equal(
                q, qc.unpack_rows(frame[:, :-4], fr.bits[i], fr.f_wire).numpy())
            rows = jquant.message_dequantize(codes, pair.astype(jnp.bfloat16), fr.bits[i], f,
                                             f_true=ft)
            dst = fr.dst[sum(fr.counts[:i]):sum(fr.counts[:i + 1])].numpy()
            want[dst] = np.asarray(rows)
        np.testing.assert_array_equal(got.numpy(), want[:plan.r_pad])


def test_lane_tables_tile_the_buffers():
    """Every byte of a direction's buffer belongs to exactly one lane's
    frame; each bucket is one contiguous [K, cap, frame] slice; each lane's
    rows and index are its bucket's arrays in order."""
    plan, ranks = _layer(4, "18/17", empty=True)
    for bits, quads in ranks:
        w = padded_wire((bits, quads), 17, 18)
        for fr, (si, di) in ((w.fwd, (0, 1)), (w.bwd, (2, 3))):
            sizes = torch.tensor([fr.frame_bytes(i) for i in range(len(bits))])[fr.bucket]
            cover = torch.cat([o + torch.arange(n) for o, n in
                               zip(fr.frame_off.tolist(), sizes.tolist())])
            assert torch.equal(cover.sort().values, torch.arange(fr.nbytes))
            assert fr.counts == tuple(q[0].numel() for q in quads) and 0 in fr.counts
            assert torch.equal(fr.src, torch.cat([q[si].reshape(-1) for q in quads]))
            assert torch.equal(fr.dst, torch.cat([q[di].reshape(-1) for q in quads]))
            assert torch.equal(fr.index, torch.cat([torch.arange(n) for n in fr.counts]))
            for i, view in enumerate(fr.views(torch.empty(fr.nbytes, dtype=torch.uint8))):
                assert view.numel() == quads[i][0].numel() * fr.frame_bytes(i)
                assert fr.frame_bytes(i) == 20 * bits[i] // 8 + 4  # pad_features(17) = 20
        assert w.bwd.f_true == 18 and w.fwd.f_true == 17


def test_cpu_wrappers_launch_nothing_and_other_devices_raise():
    plan, ranks = _layer(2, "48/37", empty=False)
    fr = padded_wire(ranks[0], 37, 48).fwd
    x = torch.randn(N_ROWS, 48)
    before = (qc.quant_rows.launches, qc.dequant_rows.launches)
    buf, rng = qc.quant_frames(x, fr, [1] * len(fr.bits))
    assert rng is None
    qc.dequant_frames(buf, fr, torch.zeros(plan.r_pad, 48))
    assert (qc.quant_rows.launches, qc.dequant_rows.launches) == before
    with pytest.raises(ValueError, match="no quant_frames"):
        qc.quant_frames(x.to("meta"), fr, [1] * len(fr.bits))
    with pytest.raises(ValueError, match="no dequant_frames"):
        qc.dequant_frames(buf.to("meta"), fr, torch.zeros(plan.r_pad, 48))
    with pytest.raises(ValueError, match="2, 4 and 8"):
        padded_wire(((32,), ranks[0][1][:1]), 37, 48)
