"""The port's compact-column SpMM (``spmm_impl=compact``) against the JAX
package's, on the CPU.

The same edges and features, drawn with numpy, go through both packages.
The layouts must be the same 14 arrays on graphs that give full tiles,
subtile groups (several subtiles to one target) and an ELL tail, on a
groups-only, a rectangular halo-shaped and an empty layout. The port's
plain version and its autograd must match the JAX portable twin and custom
VJP: both sum exactly in f32, so only the order differs (1e-4 absolute on
sums of a few dozen N(0, 1) values). The compact shards must hold each
rank's JAX shard without the JAX package's inert padding items. The
window-stationary walk that the CUDA kernel reads, decoded from each
layout's items and interpreted in torch, must give the plain version's
result (f32, rtol 1e-5), with the subtiles of one target merged. The CUDA
kernels are held against their plain versions by ``chip_smoke.py`` on the
card, and by the ``gpu`` tests of ``tests/test_torch_gpu.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaqp_tpu_torch.ops import spmm_compact as tc
from torch_helpers import interpret_walk, merged_targets, walk_row_lists, walk_schedule

jc = importlib.import_module("adaqp_tpu.ops.spmm_compact")

FIELDS = ("kind", "masks", "col_idx", "src_start", "strip_id", "new_window", "wslot",
          "strip_first", "strip_last", "dst_off", "nsub")


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
    for name in FIELDS:
        a, b = getattr(jl, name), getattr(tl, name)
        if name == "masks":  # bit patterns
            a, b = a.view(np.uint16), b.view(np.uint16)
        np.testing.assert_array_equal(a, b, err_msg=name)
    _ell_equal(jl.straggler, tl.straggler)


# (tag, n, n_src, e, full_cols)
CASES = [("three tiers", 4096, 4096, 24000, 1024), ("groups only", 4096, 4096, 24000, 2048),
         ("rectangular halo", 2048, 6144, 12000, 1024), ("empty", 2048, 4096, 0, 1024)]


def _case(rng, n, n_src, e, full_cols):
    src, dst = _tiered_edges(rng, n, n_src, e) if e else (np.zeros(0, np.int32),) * 2
    kw = dict(n_src=n_src, full_cols=full_cols)
    return src, dst, jc.compact_layout(src, dst, n, **kw), tc.compact_layout(src, dst, n, **kw)


@pytest.mark.parametrize("tag,n,n_src,e,full_cols", CASES)
def test_layout_arrays_match_jax(rng, tag, n, n_src, e, full_cols):
    _, _, jl, tl = _case(rng, n, n_src, e, full_cols)
    _layouts_equal(jl, tl)
    real = tl.masks.reshape(len(tl.kind), -1).any(1)
    kinds = set(tl.kind[real].tolist())
    if tag == "three tiers":
        assert kinds == {0, 1} and tl.straggler is not None
        grp = tl.kind == 1
        # a region of more than 256 occupied columns: two subtiles, one target
        assert any(len(set(d[:k])) < k for d, k in zip(tl.dst_off[grp], tl.nsub[grp]))
    elif tag == "groups only":
        assert kinds == {1}
    elif tag == "rectangular halo":
        assert 1 in kinds
    # the kernel's per-strip item ranges cover the items in order
    ptr = tc.item_pointers(tl.strip_id, tl.n_pad)
    assert ptr[0] == 0 and ptr[-1] == len(tl.kind) and (np.diff(ptr) >= 1).all()


@pytest.mark.parametrize("tag,n,n_src,e,full_cols", CASES)
def test_plain_matches_jax_twin_f32(rng, tag, n, n_src, e, full_cols):
    _, _, jl, tl = _case(rng, n, n_src, e, full_cols)
    h = rng.normal(size=(tl.n_src_pad, 16)).astype(np.float32)
    want = np.asarray(jc.run_compact(jl.to_device(), jnp.asarray(h), use_pallas=False))
    got = tc.run_compact(tl.to_device("cpu"), torch.from_numpy(h))
    assert got.dtype == torch.float32 and got.shape == (tl.n_pad, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if not e:
        assert not got.any()


def test_grad_matches_jax_custom_vjp(rng):
    n, f = 4096, 8
    src, dst = _tiered_edges(rng, n, n, 20000)
    jf, jb = jc.compact_layout(src, dst, n), jc.compact_layout(dst, src, n)
    tf = tc.compact_layout(src, dst, n).to_device("cpu")
    tb = tc.compact_layout(dst, src, n).to_device("cpu")
    h = rng.normal(size=(jf.n_src_pad, f)).astype(np.float32)
    g = rng.normal(size=(jf.n_pad, f)).astype(np.float32)

    def loss(hj):
        return (jc.spmm_compact(jf.to_device(), hj, jb.to_device(), False)
                * jnp.asarray(g)).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(h)))
    ht = torch.from_numpy(h).requires_grad_()
    (tc.spmm_compact(tf, ht, tb) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), want, atol=1e-4)


def test_layout_cache_roundtrips_and_goes_stale_like_jax(rng, tmp_path):
    src, dst = _tiered_edges(rng, 4096, 4096, 20000)
    key = str(tmp_path / "cmp")
    a = tc.compact_layout(src, dst, 4096, cache_key=key)
    # the JAX package reads the port's cache, and the port reads it back
    _layouts_equal(jc.compact_layout(src[:1], dst[:1], 4096, cache_key=key), a)
    _layouts_equal(a, tc.compact_layout(src[:1], dst[:1], 4096, cache_key=key))
    # other tiering knobs or sizes rebuild (and rewrite the cache), in both
    for kw in ({"me_ell": 32}, {"full_cols": 512}, {"n_src": 5000}):
        want = jc.compact_layout(src, dst, 4096, **kw)
        _layouts_equal(want, tc.compact_layout(src, dst, 4096, cache_key=key, **kw))
        _layouts_equal(want, jc.compact_layout(src[:1], dst[:1], 4096, cache_key=key, **kw))


def test_shards_match_jax_without_inert_items():
    from adaqp_tpu.common.types import GNNType as JGNNType
    from adaqp_tpu.graph import build_layout as jbuild
    from adaqp_tpu.graph import partition_graph as jpart
    from adaqp_tpu.graph.compact_shards import build_compact_shards as jshards
    from adaqp_tpu.helper import sbm_graph as jsbm
    from adaqp_tpu_torch.common.types import GNNType
    from adaqp_tpu_torch.graph import build_layout, partition_graph
    from adaqp_tpu_torch.graph.compact_shards import build_compact_shards
    from adaqp_tpu_torch.helper.dataset import sbm_graph

    jg = jsbm(n=900, blocks=3, num_feats=8, seed=2)
    jlay = jbuild(jg, jpart(jg, 3, "ldg"), JGNNType.GCN, pad_multiple=2048)
    g = sbm_graph(n=900, blocks=3, num_feats=8, seed=2)
    lay = build_layout(g, partition_graph(g, 3, "ldg"), GNNType.GCN, pad_multiple=2048)
    kw = dict(me_ell=200, full_cols=100)  # all three tiers on this small graph
    jsh, shards = jshards(jlay, **kw), build_compact_shards(lay, **kw)
    assert shards.ell_widths == jsh.ell_widths and shards.ell_widths[0]
    jitems = (jsh.fwd_local, jsh.fwd_local if jsh.bwd_local is None else jsh.bwd_local,
              jsh.fwd_halo, jsh.bwd_halo)
    seen = set()
    for rank in range(3):
        sel = shards.select(rank)
        assert sel.selected == rank and sel.fwd_local[0].shape[0] == 1
        jdevs = jax.tree.map(lambda a: a[rank:rank + 1], jsh).local().devices()
        for dev, jdev, items in zip(sel.devices(), jdevs, jitems):
            arrays = dict(zip(FIELDS, (np.asarray(x[rank]) for x in items)))
            t = int(dev.item_ptr[-1])
            # JAX pads with inert items: zero masks, no window, no flush
            assert not arrays["masks"][t:].any() and not arrays["strip_last"][t:].any()
            for name in ("kind", "masks", "col_idx", "src_start", "dst_off", "nsub"):
                np.testing.assert_array_equal(getattr(dev, name)[:t].numpy(), arrays[name][:t])
            np.testing.assert_array_equal(
                dev.item_ptr.numpy(), tc.item_pointers(arrays["strip_id"][:t], dev.n_pad))
            seen |= set(dev.kind[:t][dev.masks[:t].reshape(t, -1).any(1)].tolist())
            assert (dev.n_pad, dev.n_src_pad) == (jdev.n_pad, jdev.n_src_pad)
            assert (dev.straggler is None) == (jdev.straggler is None)
            if dev.straggler is not None:
                for x, y in zip(dev.straggler.buckets, jdev.straggler.buckets):
                    assert x[0] == y[0]
                    for u, v in zip(x[1:], y[1:]):
                        np.testing.assert_array_equal(u.numpy(), np.asarray(v))
    assert seen == {0, 1}


def test_gather_probe_needs_a_card_and_builds_nothing_without_one(monkeypatch):
    from adaqp_tpu_torch.utils import cuda_build

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card answer cannot show")

    def no_build(*a, **k):
        raise AssertionError("the probe built a kernel")

    monkeypatch.setattr(cuda_build, "build", no_build)
    monkeypatch.setattr(cuda_build, "load_library", no_build)
    tc.dynamic_gather_supported.cache_clear()
    assert tc.dynamic_gather_supported() is False
    assert tc.gather_rows.launches == 0


def test_plain_gather_rows_equals_jax_take_along_axis(rng):
    x = rng.normal(size=(2048, 128)).astype(np.float32)
    idx = rng.integers(0, 2048, (2048, 128)).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx), axis=0))
    got = tc.gather_rows(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="one \\[R, C\\] shape"):
        tc.gather_rows(torch.from_numpy(x), torch.from_numpy(idx[:5]))


def _gather_cover(plan, rows, cols):
    """How many times the kernel's walk (csrc/spmm_compact.cu) on ``plan``
    reaches each element: thread (x, y) of block (i, j) takes column group
    ``bx i + x`` (if below ``cols // width``) and rows ``r0 + k by`` (k <
    unroll, below ``rows``) for ``r0 = by unroll j + y`` stepping by ``gy
    by unroll``."""
    (bx, by), (gx, gy), w, u = plan.block, plan.grid, plan.width, plan.unroll
    groups = np.arange(gx * bx)
    groups = groups[groups < cols // w]
    step = gy * by * u
    starts = (np.arange(gy)[:, None] * by * u + np.arange(by)[None, :]).ravel()
    r = (starts[:, None, None] + step * np.arange(-(-rows // step))[None, :, None]
         + by * np.arange(u)[None, None, :]).ravel()
    r = r[r < rows]
    c = (groups[:, None] * w + np.arange(w)[None, :]).ravel()
    seen = np.zeros((rows, cols), np.int32)
    np.add.at(seen, (r[:, None], c[None, :]), 1)
    return seen


@pytest.mark.parametrize("rows,cols,aligned,sms", [
    (2048, 128, True, 132), (2048, 128, False, 132), (1000, 37, True, 132),
    (1000, 1, True, 132), (7, 4, True, 132), (3000, 64, True, 2), (3000, 33, True, 2),
    (5, 3000, False, 1)])
def test_gather_plan_reaches_every_element_once(rows, cols, aligned, sms):
    """The 4-wide path exactly where C and the alignment allow it, 128
    threads a block, 4 gathers a thread, at most a wave of 16 blocks an SM
    along the rows (a small ``sms`` makes the blocks stride), and every
    element reached once."""
    plan = tc.gather_plan(rows, cols, aligned, sms)
    (bx, by), (gx, gy) = plan.block, plan.grid
    assert plan.width == (4 if aligned and cols % 4 == 0 else 1)
    assert bx * by == tc.GATHER_THREADS and plan.width * plan.unroll == tc.GATHER_LOADS
    assert gy == 1 or gx * gy <= sms * 16
    assert (_gather_cover(plan, rows, cols) == 1).all()
    assert tc.gather_plan(2048, 128, True) == tc.GatherPlan(4, 1, (32, 4), (1, 512))


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    e = np.zeros(0, np.int32)
    lay = tc.compact_layout(e, e, 2048).to_device("cpu")
    before = tc.compact_spmm.launches
    out = tc.compact_spmm(lay, torch.ones(lay.n_src_pad, 8))
    assert not out.any() and tc.compact_spmm.launches == before
    x = torch.ones(4, 4, device="meta")
    with pytest.raises(ValueError, match="no row gather"):
        tc.gather_rows(x, torch.zeros(4, 4, dtype=torch.int32, device="meta"))


def _targets(tl):
    """(destination block, window start) -> {row: sorted window columns} of
    every set bit of a host compact layout, decoded item by item: kind 0
    reads window row v, kind 1 ``col_idx[v]`` at subtile ``v // 256``'s
    block; and how many items land on each target."""
    rows, owners = {}, {}
    for i in range(len(tl.kind)):
        bits = np.unpackbits(tl.masks[i].view(np.uint16)[..., None].view(np.uint8), axis=-1,
                             bitorder="little").transpose(0, 2, 1).reshape(tc.BD, tc.BS)
        for r, v in zip(*np.nonzero(bits)):
            s = v // tc.CSUB if tl.kind[i] == 1 else 0
            key = (int(tl.strip_id[i]) * tc.SB + int(tl.dst_off[i, s]) // tc.BD,
                   int(tl.src_start[i]))
            col = int(tl.col_idx[i, v]) if tl.kind[i] == 1 else int(v)
            rows.setdefault(key, {}).setdefault(int(r), []).append(col)
            owners.setdefault(key, set()).add(i)
    return ({k: {r: sorted(c) for r, c in v.items()} for k, v in rows.items()},
            {k: len(v) for k, v in owners.items()})


@pytest.mark.parametrize("tag,n,n_src,e,full_cols", CASES)
def test_schedule_lists_each_subtile_once_in_window_order(rng, tag, n, n_src, e, full_cols):
    # one walk tile for each (block, window) that a subtile or full tile
    # lands on, each once, windows ascending within a strip
    _, _, _, tl = _case(rng, n, n_src, e, full_cols)
    dev = tl.to_device("cpu")
    assert dev.walk is None  # a layout carries its walk only on a CUDA device
    walk = dev.build_walk()
    where = walk_schedule(walk, dev.n_pad)
    targets, _ = _targets(tl)
    assert sorted(where.values()) == sorted(targets)
    if not e:
        assert not where


@pytest.mark.parametrize("tag,n,n_src,e,full_cols", CASES)
def test_walk_gives_the_plain_result(rng, tag, n, n_src, e, full_cols):
    # the CUDA kernel's order of work in torch (torch_helpers.interpret_walk)
    _, _, _, tl = _case(rng, n, n_src, e, full_cols)
    dev = tl.to_device("cpu")
    h = torch.from_numpy(rng.normal(size=(dev.n_src_pad, 16)).astype(np.float32))
    out = interpret_walk(dev.build_walk(), h, dev.n_pad)
    torch.testing.assert_close(out, tc._run_compact_torch(dev, h), atol=1e-5, rtol=1e-5)


def test_walk_merges_subtiles_of_one_target(rng):
    # groups only: a region's subtiles that spill into the next item of its
    # (strip, window) land on the same block; the walk holds one tile for
    # them, whose rows are the union of the items' columns, ascending
    _, _, _, tl = _case(rng, 4096, 4096, 24000, 2048)
    targets, owners = _targets(tl)
    assert max(owners.values()) > 1
    assert merged_targets(tl) == sum(k - 1 for k in owners.values())
    walk = tl.to_device("cpu").build_walk()
    where = walk_schedule(walk, tl.n_pad)
    lists, tail_padded = walk_row_lists(walk, len(where))
    assert tail_padded and len(where) < sum(owners.values())
    for tile, key in where.items():
        for r in range(tc.BD):
            np.testing.assert_array_equal(lists[tile * tc.BD + r], targets[key].get(r, []))


def test_shards_carry_each_shards_walk():
    from adaqp_tpu_torch.common.types import GNNType
    from adaqp_tpu_torch.graph import build_layout, partition_graph
    from adaqp_tpu_torch.graph.compact_shards import build_compact_shards
    from adaqp_tpu_torch.helper.dataset import sbm_graph

    g = sbm_graph(n=900, blocks=3, num_feats=8, seed=2)
    lay = build_layout(g, partition_graph(g, 3, "ldg"), GNNType.GCN, pad_multiple=2048)
    shards = build_compact_shards(lay, me_ell=200, full_cols=100)
    assert all(d.walk is None for d in shards.to("cpu").devices(1))  # built on a card only
    # stacked, one kept after or before the build
    for built in (shards.with_walks(), shards.with_walks().select(1),
                  shards.select(1).with_walks()):
        for d in built.devices(1):
            want = tc.compact_walk(d.kind, d.masks, d.col_idx, d.src_start, d.dst_off,
                                   d.item_ptr)
            assert d.walk.cols.data_ptr() % 16 == 0
            for got, ref in zip(d.walk.tensors(), want.tensors()):
                # stacked over shards: zero padding past this shard's entries
                assert torch.equal(got[:ref.shape[0]], ref)
