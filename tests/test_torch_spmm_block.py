"""The port's block bitmask SpMM (``spmm_impl=block``) against the JAX
package's, on the CPU.

The same edges and features, drawn with numpy, go through both packages:
the layouts must be the same arrays, the port's plain version must match
the JAX portable twin (both sum exactly in f32, so only the order differs:
1e-4 absolute on sums of a few dozen N(0, 1) values) and the JAX kernel in
interpret mode (which rounds f32 windows to bf16 before its product: bf16
tolerance, 0.05 + 1% of the value), and the port's autograd must give the
JAX custom VJP's gradient. The block shards must hold each rank's JAX
shard without the JAX package's inert padding tiles. The window-stationary
walk that the CUDA kernel reads, built from each layout and interpreted in
torch, must give the plain version's result (f32, rtol 1e-5). The CUDA
kernel itself is held against the plain version by ``chip_smoke.py`` on
the card, and by the ``gpu`` tests of ``tests/test_torch_gpu.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaqp_tpu_torch.ops import spmm_block as tblock
from torch_helpers import interpret_walk, walk_row_lists, walk_schedule

jblock = importlib.import_module("adaqp_tpu.ops.spmm_block")
jfast = importlib.import_module("adaqp_tpu.ops.spmm_fast")


def _edges(rng, n, e, n_src=None):
    ns = n if n_src is None else n_src
    src = rng.integers(0, ns, e).astype(np.int32)
    dst = np.where(
        rng.random(e) < 0.5,
        (src + rng.integers(-300, 300, e)) % n,
        rng.integers(0, n, e),
    ).astype(np.int32)
    return src, dst


def _ell_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.n == b.n and a.row_chunk == b.row_chunk and len(a.buckets) == len(b.buckets)
    for (wa, *xa), (wb, *xb) in zip(a.buckets, b.buckets):
        assert wa == wb
        for u, v in zip(xa, xb):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _layouts_equal(jl, tl):
    assert (jl.n, jl.n_pad, jl.n_src_pad) == (tl.n, tl.n_pad, tl.n_src_pad)
    np.testing.assert_array_equal(jl.masks.view(np.uint16), tl.masks.view(np.uint16))
    for name in ("src_start", "dst_blk", "is_first"):
        np.testing.assert_array_equal(getattr(jl, name), getattr(tl, name))
    _ell_equal(jl.straggler, tl.straggler)


# (n, e, min_edges, n_src): square with an ELL tail, dense-only with a
# non-default threshold, a rectangular halo-shaped layout, and no edges
CASES = [(3000, 20000, 64, None), (3000, 50000, 1, None), (2100, 30000, 8, 5000),
         (2048, 0, 192, 4096)]


@pytest.mark.parametrize("n,e,min_edges,n_src", CASES)
def test_layout_arrays_match_jax(rng, n, e, min_edges, n_src):
    src, dst = _edges(rng, n, e, n_src)
    jl = jblock.block_layout(src, dst, n, min_edges=min_edges, n_src=n_src)
    tl = tblock.block_layout(src, dst, n, min_edges=min_edges, n_src=n_src)
    _layouts_equal(jl, tl)
    # the kernel's per-block tile ranges cover the tiles in order
    ptr = tblock.block_pointers(tl.dst_blk, tl.n_pad)
    assert ptr[0] == 0 and ptr[-1] == len(tl.dst_blk)
    assert (np.diff(ptr) >= 1).all()  # every block has a (maybe all-zero) tile
    for b in range(len(ptr) - 1):
        assert (tl.dst_blk[ptr[b]:ptr[b + 1]] == b).all()


@pytest.mark.parametrize("n,e,min_edges,n_src", CASES)
def test_plain_matches_jax_twin_f32(rng, n, e, min_edges, n_src):
    src, dst = _edges(rng, n, e, n_src)
    jl = jblock.block_layout(src, dst, n, min_edges=min_edges, n_src=n_src)
    tl = tblock.block_layout(src, dst, n, min_edges=min_edges, n_src=n_src)
    h = rng.normal(size=(tl.n_src_pad, 24)).astype(np.float32)
    want = np.asarray(jblock.run_block(jl.to_device(), jnp.asarray(h), use_pallas=False))
    got = tblock.run_block(tl.to_device("cpu"), torch.from_numpy(h))
    assert got.dtype == torch.float32 and got.shape == (tl.n_pad, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if e == 0:
        assert not got.any()


def test_plain_matches_jax_interpret_kernel(rng):
    # the JAX accelerator kernel itself (interpret mode) plus its ELL tail
    src, dst = _edges(rng, 2048, 12000)
    jl = jblock.block_layout(src, dst, 2048, min_edges=16)
    tl = tblock.block_layout(src, dst, 2048, min_edges=16)
    h = rng.normal(size=(tl.n_src_pad, 128)).astype(np.float32)
    hj = jnp.asarray(h)
    want = jblock._run_block_pallas(jl.to_device(), hj, interpret=True)
    if jl.straggler is not None:
        want = want + jfast._run_ell(jl.straggler.to_device(), hj, acc_dtype=jnp.float32)
    got = tblock.run_block(tl.to_device("cpu"), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.05, rtol=0.01)


def test_bf16_plain_sums_in_f32(rng):
    # bf16 h: both packages sum in f32 and round once; only the order differs
    src, dst = _edges(rng, 3000, 20000)
    jl = jblock.block_layout(src, dst, 3000, min_edges=64)
    tl = tblock.block_layout(src, dst, 3000, min_edges=64)
    h = rng.normal(size=(tl.n_src_pad, 32)).astype(np.float32)
    want = jblock.run_block(jl.to_device(), jnp.asarray(h, jnp.bfloat16), use_pallas=False)
    got = tblock.run_block(tl.to_device("cpu"), torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=0.05, rtol=0.01)


def test_grad_matches_jax_custom_vjp(rng):
    n, f = 2100, 16
    src, dst = _edges(rng, n, 15000)
    jf = jblock.block_layout(src, dst, n, min_edges=8)
    jb = jblock.block_layout(dst, src, n, min_edges=8)
    tf = tblock.block_layout(src, dst, n, min_edges=8).to_device("cpu")
    tb = tblock.block_layout(dst, src, n, min_edges=8).to_device("cpu")
    h = rng.normal(size=(jf.n_src_pad, f)).astype(np.float32)
    g = rng.normal(size=(jf.n_pad, f)).astype(np.float32)

    def loss(hj):
        return (jblock.spmm_block(jf.to_device(), hj, jb.to_device(), False)
                * jnp.asarray(g)).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(h)))
    ht = torch.from_numpy(h).requires_grad_()
    (tblock.spmm_block(tf, ht, tb) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), want, atol=1e-4)


def test_layout_cache_roundtrips_and_goes_stale_like_jax(rng, tmp_path):
    src, dst = _edges(rng, 3000, 20000)
    key = str(tmp_path / "blk")
    a = tblock.block_layout(src, dst, 3000, min_edges=16, cache_key=key)
    # the JAX package reads the port's cache, and the port reads it back
    _layouts_equal(jblock.block_layout(src[:1], dst[:1], 3000, min_edges=16, cache_key=key), a)
    _layouts_equal(a, tblock.block_layout(src[:1], dst[:1], 3000, min_edges=16, cache_key=key))
    # another threshold or size rebuilds (and rewrites the cache), in both
    for n, me in ((3000, 32), (3001, 32)):
        want = jblock.block_layout(src, dst, n, min_edges=me)
        got = tblock.block_layout(src, dst, n, min_edges=me, cache_key=key)
        _layouts_equal(want, got)
        _layouts_equal(want, jblock.block_layout(src[:1], dst[:1], n, min_edges=me,
                                                 cache_key=key))


def _partitioned(k):
    from adaqp_tpu.common.types import GNNType as JGNNType
    from adaqp_tpu.graph import build_layout as jbuild
    from adaqp_tpu.graph import partition_graph as jpart
    from adaqp_tpu.helper import sbm_graph as jsbm
    from adaqp_tpu_torch.common.types import GNNType
    from adaqp_tpu_torch.graph import build_layout, partition_graph
    from adaqp_tpu_torch.helper.dataset import sbm_graph

    jg = jsbm(n=900, blocks=3, num_feats=8, seed=2)
    jlay = jbuild(jg, jpart(jg, k, "ldg"), JGNNType.GCN, pad_multiple=2048)
    g = sbm_graph(n=900, blocks=3, num_feats=8, seed=2)
    lay = build_layout(g, partition_graph(g, k, "ldg"), GNNType.GCN, pad_multiple=2048)
    return jlay, lay


def test_shards_match_jax_without_inert_tiles():
    from adaqp_tpu.graph.block_shards import build_block_shards as jbuild
    from adaqp_tpu_torch.graph.block_shards import build_block_shards

    jlay, lay = _partitioned(3)
    jsh = jbuild(jlay, min_edges=400)  # some tiles go to the ELL tail
    shards = build_block_shards(lay, min_edges=400)
    assert shards.ell_widths == jsh.ell_widths and shards.ell_widths[0]
    jquads = (jsh.fwd_local, jsh.fwd_local if jsh.bwd_local is None else jsh.bwd_local,
              jsh.fwd_halo, jsh.bwd_halo)
    for rank in range(3):
        sel = shards.select(rank)
        assert sel.selected == rank and sel.fwd_local[0].shape[0] == 1
        jdevs = jax.tree.map(lambda a: a[rank:rank + 1], jsh).local().devices()
        for dev, jdev, quad in zip(sel.devices(), jdevs, jquads):
            masks, src_start, dst_blk, _ = (np.asarray(x[rank]) for x in quad)
            t = int(dev.blk_ptr[-1])
            # JAX appends inert tiles (zero mask, dst block 0) after the real ones
            assert not masks[t:].any() and not dst_blk[t:].any()
            np.testing.assert_array_equal(dev.masks[:t].numpy(), masks[:t])
            np.testing.assert_array_equal(dev.src_start[:t].numpy(), src_start[:t])
            np.testing.assert_array_equal(dev.dst_blk[:t].numpy(), dst_blk[:t])
            np.testing.assert_array_equal(
                dev.blk_ptr.numpy(), tblock.block_pointers(dst_blk[:t], dev.n_pad))
            assert (dev.n_pad, dev.n_src_pad) == (jdev.n_pad, jdev.n_src_pad)
            assert (dev.straggler is None) == (jdev.straggler is None)
            if dev.straggler is not None:
                for x, y in zip(dev.straggler.buckets, jdev.straggler.buckets):
                    assert x[0] == y[0]
                    for u, v in zip(x[1:], y[1:]):
                        np.testing.assert_array_equal(u.numpy(), np.asarray(v))
        with pytest.raises(ValueError):
            sel.devices((rank + 1) % 3)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    e = np.zeros(0, np.int32)
    lay = tblock.block_layout(e, e, 2048).to_device("cpu")
    before = tblock.block_spmm.launches
    out = tblock.block_spmm(lay, torch.ones(lay.n_src_pad, 8))
    assert not out.any() and tblock.block_spmm.launches == before


def _device_layout(rng, n, e, min_edges, n_src):
    src, dst = _edges(rng, n, e, n_src)
    lay = tblock.block_layout(src, dst, n, min_edges=min_edges, n_src=n_src).to_device("cpu")
    assert lay.walk is None  # a layout carries its walk only on a CUDA device
    return lay


@pytest.mark.parametrize("n,e,min_edges,n_src", CASES)
def test_schedule_lists_each_tile_once_in_window_order(rng, n, e, min_edges, n_src):
    # the block layout's tiles are the walk's tiles as they are, all-zero
    # ones (of blocks with no dense tile) included, at no columns
    lay = _device_layout(rng, n, e, min_edges, n_src)
    walk = lay.build_walk()
    t = int(lay.blk_ptr[-1])
    assert walk_schedule(walk, lay.n_pad) == {
        i: (int(lay.dst_blk[i]), int(lay.src_start[i])) for i in range(t)}
    lists, tail_padded = walk_row_lists(walk, t)
    assert tail_padded
    empty = [i for i in range(t) if not lay.masks[i].any()]
    assert all(len(lists[i * tblock.BD + r]) == 0 for i in empty for r in range(tblock.BD))
    if e == 0:
        assert len(empty) == t == lay.n_pad // tblock.BD


@pytest.mark.parametrize("n,e,min_edges,n_src", CASES)
def test_walk_gives_the_plain_result(rng, n, e, min_edges, n_src):
    # the CUDA kernel's order of work in torch (torch_helpers.interpret_walk)
    lay = _device_layout(rng, n, e, min_edges, n_src)
    h = torch.from_numpy(rng.normal(size=(lay.n_src_pad, 24)).astype(np.float32))
    out = interpret_walk(lay.build_walk(), h, lay.n_pad)
    torch.testing.assert_close(out, tblock._run_block_torch(lay, h), atol=1e-5, rtol=1e-5)


def test_non_square_layout_fills_its_last_strip(rng):
    # a halo-shaped layout pads its rows to 256 only: 2,304 rows are nine
    # blocks, a whole strip and one block of the next, whose other seven
    # blocks the schedule leaves without a tile
    lay = _device_layout(rng, 2100, 30000, 8, 5000)
    assert lay.n_pad == 9 * tblock.BD and lay.n_src_pad == 6144
    walk = lay.build_walk()
    assert walk.strip_ptr.numel() == 3
    last = walk.step_tile[int(walk.strip_ptr[1]):int(walk.strip_ptr[2])]
    assert last.shape[0] > 0 and (last[:, 0] >= 0).any() and (last[:, 1:] == -1).all()
    h = torch.from_numpy(rng.normal(size=(lay.n_src_pad, 8)).astype(np.float32))
    out = interpret_walk(walk, h, lay.n_pad)
    assert out.shape == (lay.n_pad, 8)
    torch.testing.assert_close(out, tblock._run_block_torch(lay, h), atol=1e-5, rtol=1e-5)


def test_shards_carry_each_shards_walk():
    from adaqp_tpu_torch.graph.block_shards import build_block_shards

    _, lay = _partitioned(3)
    shards = build_block_shards(lay, min_edges=4)
    assert all(d.walk is None for d in shards.to("cpu").devices(1))  # built on a card only
    # stacked, one kept after or before the build
    for built in (shards.with_walks(), shards.with_walks().select(1),
                  shards.select(1).with_walks()):
        for d in built.devices(1):
            want = tblock.strip_walk(d.masks, d.src_start, d.blk_ptr)
            assert d.walk.cols.data_ptr() % 16 == 0
            for got, ref in zip(d.walk.tensors(), want.tensors()):
                # stacked over shards: zero padding past this shard's entries
                assert torch.equal(got[:ref.shape[0]], ref)
