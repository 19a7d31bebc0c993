"""The port's compact-column SpMM (``spmm_impl=compact``) against the JAX
package's, on the CPU.

The same edges and features, drawn with numpy, go through both packages.
The layouts must be the same 14 arrays on graphs that give full tiles,
subtile groups (several subtiles to one target) and an ELL tail, on a
groups-only, a rectangular halo-shaped and an empty layout. The port's
plain version and its autograd must match the JAX portable twin and custom
VJP: both sum exactly in f32, so only the order differs (1e-4 absolute on
sums of a few dozen N(0, 1) values). The compact shards must hold each
rank's JAX shard without the JAX package's inert padding items. The CUDA
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


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    e = np.zeros(0, np.int32)
    lay = tc.compact_layout(e, e, 2048).to_device("cpu")
    before = tc.compact_spmm.launches
    out = tc.compact_spmm(lay, torch.ones(lay.n_src_pad, 8))
    assert not out.any() and tc.compact_spmm.launches == before
    x = torch.ones(4, 4, device="meta")
    with pytest.raises(ValueError, match="no row gather"):
        tc.gather_rows(x, torch.zeros(4, 4, dtype=torch.int32, device="meta"))
