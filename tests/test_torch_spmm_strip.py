"""The port's strip bitmask SpMM against the JAX package's, on the CPU.

The same edges and features, drawn with numpy, go through both packages:
the layouts must be the same arrays, the port's plain version must match
the JAX portable twin (exact f32 sums) and the JAX kernel in interpret mode
(which rounds f32 windows to bf16), and the port's autograd must give the
JAX custom VJP's gradient. The CUDA kernel itself is held against the plain
version by ``chip_smoke.py`` on the card, and by the ``gpu`` tests of
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaqp_tpu.ops import spmm_fast as jfast
from adaqp_tpu.ops import spmm_strip as jstrip
from adaqp_tpu_torch.ops import spmm_fast as tfast
from adaqp_tpu_torch.ops import spmm_strip as tstrip


def _edges(rng, n, e, n_src=None):
    ns = n if n_src is None else n_src
    src = rng.integers(0, ns, e).astype(np.int32)
    dst = np.where(
        rng.random(e) < 0.5,
        (src + rng.integers(-300, 300, e)) % n,
        rng.integers(0, n, e),
    ).astype(np.int32)
    return src, dst


def _both(src, dst, n, min_edges, n_src=None):
    jl = jstrip.strip_layout(src, dst, n, min_edges=min_edges, n_src=n_src)
    tl = tstrip.strip_layout(src, dst, n, min_edges=min_edges, n_src=n_src)
    return jl, tl


def _feats(rng, rows, f, dtype=np.float32):
    return rng.normal(size=(rows, f)).astype(dtype)


def _ell_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.n == b.n and a.row_chunk == b.row_chunk
    assert len(a.buckets) == len(b.buckets)
    for (wa, *xa), (wb, *xb) in zip(a.buckets, b.buckets):
        assert wa == wb
        for u, v in zip(xa, xb):
            np.testing.assert_array_equal(u, v)


# (n, e, min_edges, n_src): square with an ELL tail, dense-only, and a
# rectangular halo-shaped layout (r_pad source rows -> l_max rows)
CASES = [(3000, 20000, 64, None), (3000, 50000, 1, None), (2100, 30000, 8, 5000)]


@pytest.mark.parametrize("n,e,min_edges,n_src", CASES)
def test_layout_arrays_match_jax(rng, n, e, min_edges, n_src):
    src, dst = _edges(rng, n, e, n_src)
    jl, tl = _both(src, dst, n, min_edges, n_src)
    assert (jl.n, jl.n_pad, jl.n_src_pad) == (tl.n, tl.n_pad, tl.n_src_pad)
    for name in ("masks", "tile_src", "tile_dst"):
        np.testing.assert_array_equal(getattr(jl, name), getattr(tl, name))
    _ell_equal(jl.straggler, tl.straggler)
    # the CUDA kernel's per-block tile ranges cover the tiles in order
    ptr = tstrip.block_pointers(tl.tile_dst, tl.n_pad)
    assert ptr[0] == 0 and ptr[-1] == len(tl.tile_dst)
    for b in range(len(ptr) - 1):
        assert (tl.tile_dst[ptr[b]:ptr[b + 1]] == b).all()


def test_ell_from_csr_matches_jax(rng):
    # segments longer than WMAX split; widths span the bucket ladder
    n = 700
    deg = rng.integers(0, 1200, n)
    dst = np.repeat(np.arange(n), deg).astype(np.int32)
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    _ell_equal(jfast.ell_from_csr(src, dst, n), tfast.ell_from_csr(src, dst, n))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_run_ell_matches_jax(rng, dtype):
    # rows gathered in h's dtype, summed in f32 by both: only the order differs
    n = 700
    src, dst = _edges(rng, n, 30000)
    lay = tfast.ell_from_csr(src, dst, n)
    h = _feats(rng, n, 24)
    hj = jnp.asarray(h, dtype)
    ht = torch.from_numpy(h).to(torch.float32 if dtype == np.float32 else torch.bfloat16)
    want = jfast._run_ell(jfast.ell_from_csr(src, dst, n).to_device(), hj, acc_dtype=jnp.float32)
    got = tfast._run_ell(lay.to_device("cpu"), ht, acc_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("n,e,min_edges,n_src", CASES)
def test_plain_matches_jax_twin_f32(rng, n, e, min_edges, n_src):
    src, dst = _edges(rng, n, e, n_src)
    jl, tl = _both(src, dst, n, min_edges, n_src)
    h = _feats(rng, tl.n_src_pad, 32)
    want = np.asarray(jstrip.run_strip(jl.to_device(), jnp.asarray(h), use_pallas=False))
    got = tstrip.run_strip(tl.to_device("cpu"), torch.from_numpy(h))
    assert got.dtype == torch.float32 and got.shape == (tl.n_pad, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_plain_matches_jax_twin_bf16(rng):
    # bf16 h: both sum in f32 and round once; only the order differs
    src, dst = _edges(rng, 3000, 20000)
    jl, tl = _both(src, dst, 3000, 64)
    h = _feats(rng, tl.n_src_pad, 32)
    want = jstrip.run_strip(jl.to_device(), jnp.asarray(h, jnp.bfloat16), use_pallas=False)
    got = tstrip.run_strip(tl.to_device("cpu"), torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=0.05, rtol=0.01
    )


def test_plain_matches_jax_interpret_kernel(rng):
    # the JAX accelerator kernel itself (interpret mode) plus its ELL tail
    src, dst = _edges(rng, 3000, 30000)
    jl, tl = _both(src, dst, 3000, 4)
    h = _feats(rng, tl.n_src_pad, 128)
    dev = jl.to_device()
    hj = jnp.asarray(h)
    want = jstrip._run_strip_pallas(dev, hj, interpret=True)
    if jl.straggler is not None:
        want = want + jfast._run_ell(
            jl.straggler.to_device(), hj, acc_dtype=jnp.float32
        ).astype(hj.dtype)
    got = tstrip.run_strip(tl.to_device("cpu"), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.05, rtol=0.01)


@pytest.mark.parametrize("n_src", [None, 4096])
def test_empty_layout_gives_zeros(n_src):
    # no edges at all: every destination block takes the zero-write path
    # (at K=1 this is every halo aggregation)
    e = np.zeros(0, np.int32)
    lay = tstrip.strip_layout(e, e, 2048, n_src=n_src).to_device("cpu")
    assert int(lay.blk_ptr[-1]) == 0 and lay.straggler is None
    h = torch.ones(lay.n_src_pad, 16, dtype=torch.bfloat16)
    out = tstrip.run_strip(lay, h)
    assert out.shape == (2048, 16) and out.dtype == torch.bfloat16
    assert not out.any()


def test_grad_matches_jax_custom_vjp(rng):
    n, f = 2100, 16
    src, dst = _edges(rng, n, 15000)
    jf = jstrip.strip_layout(src, dst, n, min_edges=8)
    jb = jstrip.strip_layout(dst, src, n, min_edges=8)
    tf = tstrip.strip_layout(src, dst, n, min_edges=8).to_device("cpu")
    tb = tstrip.strip_layout(dst, src, n, min_edges=8).to_device("cpu")
    h = _feats(rng, jf.n_src_pad, f)
    g = _feats(rng, jf.n_pad, f)

    def loss(hj):
        return (jstrip.spmm_strip(jf.to_device(), hj, jb.to_device(), False)
                * jnp.asarray(g)).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(h)))
    ht = torch.from_numpy(h).requires_grad_()
    (tstrip.spmm_strip(tf, ht, tb) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), want, atol=1e-4)


def test_layout_cache_roundtrip(rng, tmp_path):
    src, dst = _edges(rng, 3000, 20000)
    key = str(tmp_path / "strip")
    a = tstrip.strip_layout(src, dst, 3000, min_edges=16, cache_key=key)
    b = tstrip.strip_layout(src, dst, 3000, min_edges=16, cache_key=key)
    for name in ("masks", "tile_src", "tile_dst"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    _ell_equal(a.straggler, b.straggler)


def test_select_keeps_one_shard(rng):
    # each rank keeps only its own shard's layouts; its operators are the
    # same before and after the selection
    from adaqp_tpu_torch.common.types import GNNType
    from adaqp_tpu_torch.graph import build_layout, partition_graph
    from adaqp_tpu_torch.graph.strip_shards import build_strip_shards
    from adaqp_tpu_torch.helper.dataset import sbm_graph

    g = sbm_graph(n=900, blocks=3, num_feats=8, seed=2)
    lay = build_layout(g, partition_graph(g, 3, "ldg"), GNNType.GCN, pad_multiple=2048)
    shards = build_strip_shards(lay, min_edges=400)  # some tiles to the ELL tail
    assert shards.selected is None and shards.ell_widths[0]
    for rank in range(3):
        before = shards.devices(rank)
        sel = shards.select(rank)
        assert sel.selected == rank and sel.fwd_local[0].shape[0] == 1
        for a, b in zip(sel.devices(rank), before):
            for name in ("n", "n_pad", "n_src_pad"):
                assert getattr(a, name) == getattr(b, name)
            for name in ("masks", "tile_src", "blk_ptr"):
                assert torch.equal(getattr(a, name), getattr(b, name))
            assert (a.straggler is None) == (b.straggler is None)
            if a.straggler is not None:
                for x, y in zip(a.straggler.buckets, b.straggler.buckets):
                    assert x[0] == y[0] and all(torch.equal(u, v) for u, v in zip(x[1:], y[1:]))
        assert all(torch.equal(a.masks, b.masks) for a, b in zip(sel.devices(), before))
        with pytest.raises(ValueError):
            sel.devices((rank + 1) % 3)
        with pytest.raises(ValueError):
            sel.select(rank)
