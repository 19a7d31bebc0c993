"""The ragged wire's lane tables and the one-launch send and receive sides.

``comm/wire.py`` lays out each direction's lanes (row, bucket, index
inside the bucket, word and parameter-word offsets), and
``comm/exchange_ragged.py``'s ``pack_dir``/``unpack_dir`` run the
``quant_pack``/``unpack_dequant`` kernels once a direction over them; on
the CPU they run the plain versions ``_pack_lanes_torch`` and
``_unpack_lanes_torch``. Held here, bit for bit, against the composition
the exchange used before (per bucket a row gather, quantize-and-pack,
``param_words``, per-peer ``torch.cat``; on the receive side the same
undone, then ``rows[d_inv]`` or ``index_add_``, kept in
``tests/torch_helpers.py``), on random wires from the port's wire lowering:
buckets of 2, 4, 8 and 32 bits, with and without parameter words, a peer
with no lanes, an empty bucket, a source row sent to every peer, f32 and
bf16 rows, ``f_true`` < F. One process, no ranks: every rank's side runs
here and the receive buffers are cut from the send buffers. The card's
kernels against the same plain versions: ``tests/test_torch_gpu.py``.
"""
import zlib

import numpy as np
import pytest
import torch

from adaqp_tpu_torch.comm.exchange import variance_proxy
from adaqp_tpu_torch.comm.exchange_ragged import pack_dir, unpack_dir
from torch_helpers import pack_by_buckets, random_wire, received, unpack_by_buckets

K = 4
OUT_LEN, N_SRC = 300, 200

# (bits_set, has_params, widths no lane draws): the quantized wire, the
# quantized wire with raw f32 lanes (fp32_lanes), the fp wire
WIRES = {
    "2/4/8": ((2, 4, 8), True, ()),
    "2/4/8/32, 4 empty": ((2, 4, 8, 32), True, (4,)),
    "fp": ((32,), False, ()),
}
SHAPES = {"F=64": (64, 64), "F=70, f_true=45": (70, 45)}


def _sides(rng, kind, f, ft, forward, dtype):
    bits_set, params, unused = WIRES[kind]
    wd = random_wire(rng, K, ft, bits_set, params, OUT_LEN, N_SRC, forward=forward,
                     unused=unused)
    wires = [wd.local(r, OUT_LEN) for r in range(K)]
    srcs = [torch.from_numpy(rng.standard_normal((N_SRC, f)).astype(np.float32)).to(dtype)
            for _ in range(K)]
    return wd, wires, srcs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", list(WIRES))
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "bwd"])
def test_lanes_reproduce_the_bucket_composition(forward, kind, shape, dtype):
    rng = np.random.default_rng(zlib.crc32(f"{forward} {kind} {shape} {dtype}".encode()))
    f, ft = SHAPES[shape]
    wd, wires, srcs = _sides(rng, kind, f, ft, forward, dtype)
    assert wd.cnt[0, 2].sum() == 0 and wd.cnt.sum() > 0  # a peer with no lanes
    if WIRES[kind][2]:
        assert wd.cnt[..., wd.bits.index(4)].sum() == 0  # an empty bucket
    bufs = []
    for r, (w, x) in enumerate(zip(wires, srcs)):
        key = 1000 + r
        got, tr = pack_dir(w, x, key, ft, trace=True)
        want, tr0 = pack_by_buckets(w, x, key, ft, trace=True)
        assert got.dtype == torch.int32 and got.shape == (sum(w.send_splits),)
        assert torch.equal(got, want), f"rank {r}: send buffers differ"
        # the range output gives the variance proxy bit for bit
        assert torch.equal(tr, tr0) and torch.equal(tr, variance_proxy(
            x[w.send_lanes.row].float(), ft))
        bufs.append(got)
    for r, w in enumerate(wires):
        recv = received(bufs, wires, r)
        assert recv.shape == (sum(w.recv_splits),)
        got = unpack_dir(w, recv, not forward, ft, f)
        want = unpack_by_buckets(w, recv, not forward, ft, f)
        assert got.shape == (OUT_LEN, f)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), f"rank {r}"


def test_lane_offsets_tile_the_buffers():
    """Every word of a send or receive buffer belongs to exactly one lane's
    words or parameter word, and each lane's row, bucket and index are the
    wire's own."""
    rng = np.random.default_rng(3)
    wd = random_wire(rng, K, 45, (2, 4, 8, 32), True, OUT_LEN, N_SRC, unused=(4,))
    for r in range(K):
        w = wd.local(r, OUT_LEN)
        for lanes, splits, rows in ((w.send_lanes, w.send_splits, w.q_rows),
                                    (w.recv_lanes, w.recv_splits, w.d_rows)):
            wpr = torch.tensor(w.wpr)[lanes.bucket]
            cover = [o + torch.arange(n) for o, n in zip(lanes.word_off.tolist(), wpr.tolist())]
            cover.append(lanes.param_off)
            cover = torch.cat(cover).sort().values
            assert torch.equal(cover, torch.arange(sum(splits)))
            assert lanes.counts == tuple(len(x) for x in rows)
            assert torch.equal(lanes.row, torch.cat(rows))
            assert torch.equal(lanes.bucket, torch.repeat_interleave(
                torch.arange(len(w.bits)), torch.tensor(lanes.counts)))
            assert torch.equal(lanes.index, torch.cat([torch.arange(n) for n in lanes.counts]))
        assert w.quant_launches() == (int(w.send_lanes.n > 0), int(w.recv_lanes.n > 0))


def test_a_rank_without_lanes_packs_and_unpacks_nothing():
    rng = np.random.default_rng(4)
    skip = tuple((ws, 1) for ws in range(K)) + tuple((1, wr) for wr in range(K))
    wd = random_wire(rng, K, 45, (2, 4, 8), True, OUT_LEN, N_SRC, skip=skip)
    w = wd.local(1, OUT_LEN)
    assert w.send_lanes.n == w.recv_lanes.n == 0 and w.quant_launches() == (0, 0)
    x = torch.randn(N_SRC, 64)
    buf, tr = pack_dir(w, x, 7, 45, trace=True)
    assert buf.shape == (0,) and tr is None
    empty = torch.empty(0, dtype=torch.int32)
    assert torch.equal(unpack_dir(w, empty, False, 45, 64), torch.zeros(OUT_LEN, 64))
    assert torch.equal(unpack_dir(w, empty, True, 45, 64), torch.zeros(OUT_LEN, 64))
