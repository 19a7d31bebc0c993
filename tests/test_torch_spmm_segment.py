"""The port's segment-sum aggregation (``spmm_impl=segment``) against the
JAX package's, on the CPU.

``segment_spmm``, ``spmm_csr`` and ``pad_edges`` take the same numpy edges
and features in both packages; both gather and add in f32, so only the
order of the adds differs (1e-5 absolute on sums of a few N(0, 1)
values). The local + halo pair with its gather-form backward
(``PairSegSpmm`` against the JAX ``pair_seg_spmm`` custom VJP) must give
the same gradients, in each input's dtype.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaqp_tpu_torch.ops import spmm as tspmm
from adaqp_tpu_torch.ops.dist_ops import PairSegSpmm

jspmm = importlib.import_module("adaqp_tpu.ops.spmm")
jdist = importlib.import_module("adaqp_tpu.ops.dist_ops")


def _edges(rng, n_src, n_dst, e, pad_to=None):
    """dst-sorted edges; with ``pad_to``, padded with the sentinel dst."""
    src = rng.integers(0, n_src, e).astype(np.int32)
    dst = np.sort(rng.integers(0, n_dst, e)).astype(np.int32)
    if pad_to:
        src, dst, _ = jspmm.pad_edges(src, dst, None, n_dst, pad_to)
    return src, dst


@pytest.mark.parametrize("weighted", [False, True])
def test_segment_spmm_matches_jax(rng, weighted):
    src, dst = _edges(rng, 500, 300, 4000, pad_to=64)
    w = rng.random(len(src)).astype(np.float32) if weighted else None
    h = rng.normal(size=(500, 24)).astype(np.float32)
    want = jspmm.segment_spmm(jnp.asarray(src), jnp.asarray(dst),
                              None if w is None else jnp.asarray(w), jnp.asarray(h), 300)
    got = tspmm.segment_spmm(torch.from_numpy(src), torch.from_numpy(dst),
                             None if w is None else torch.from_numpy(w), torch.from_numpy(h), 300)
    assert got.shape == (300, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_csr_matches_jax(rng, weighted):
    src, dst = _edges(rng, 500, 300, 4000, pad_to=256)
    w = rng.random(len(src)).astype(np.float32) if weighted else None
    h = rng.normal(size=(500, 16)).astype(np.float32)
    want = jspmm.spmm_csr(jnp.asarray(src), jnp.asarray(dst),
                          None if w is None else jnp.asarray(w), jnp.asarray(h), 300, chunk=256)
    got = tspmm.spmm_csr(torch.from_numpy(src), torch.from_numpy(dst),
                         None if w is None else torch.from_numpy(w), torch.from_numpy(h), 300,
                         chunk=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), tspmm.segment_spmm(torch.from_numpy(src), torch.from_numpy(dst),
                                        None if w is None else torch.from_numpy(w),
                                        torch.from_numpy(h), 300).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tspmm.spmm_csr(torch.from_numpy(src[:-1]), torch.from_numpy(dst[:-1]), None,
                       torch.from_numpy(h), 300, chunk=256)


@pytest.mark.parametrize("e,multiple", [(1000, 64), (1024, 64), (0, 8)])
def test_pad_edges_matches_jax(rng, e, multiple):
    src, dst = _edges(rng, 50, 40, e)
    w = rng.random(e).astype(np.float32)
    for a, b in zip(tspmm.pad_edges(src, dst, w, 40, multiple),
                    jspmm.pad_edges(src, dst, w, 40, multiple)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [None, 128])
def test_pair_gradients_match_jax(rng, chunk):
    l_max, r_pad = 256, 128
    fl = _edges(rng, l_max, l_max, 2000, pad_to=128)
    fh = _edges(rng, r_pad, l_max, 900, pad_to=128)
    # the transposed lists, dst-sorted, padded like the layout's
    order = np.argsort(fl[0], kind="stable")
    bl = jspmm.pad_edges(fl[1][order][fl[1][order] < l_max], fl[0][order][fl[1][order] < l_max],
                         None, l_max, 128)[:2]
    valid = fh[1] < l_max
    order = np.argsort(fh[0][valid], kind="stable")
    bh = jspmm.pad_edges(fh[1][valid][order], fh[0][valid][order], None, r_pad, 128)[:2]
    edges = (*fl, *fh, *bl, *bh)
    hl = rng.normal(size=(l_max, 16)).astype(np.float32)
    hr = rng.normal(size=(r_pad, 16)).astype(np.float32)
    g = rng.normal(size=(l_max, 16)).astype(np.float32)

    jedges = tuple(jnp.asarray(x) for x in edges)
    out_j, vjp = jax.vjp(
        lambda a, b: jdist.pair_seg_spmm(l_max, r_pad, chunk, a, b, jedges),
        jnp.asarray(hl), jnp.asarray(hr),
    )
    gl_j, gr_j = vjp(jnp.asarray(g))
    tl = torch.from_numpy(hl).requires_grad_()
    tr = torch.from_numpy(hr).requires_grad_()
    out = PairSegSpmm.apply(tl, tr, tuple(torch.from_numpy(x) for x in edges), l_max, r_pad,
                            chunk)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(gl_j), atol=1e-5)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gr_j), atol=1e-5)

    # bf16 inputs get their gradients back in bf16
    tl = torch.from_numpy(hl).to(torch.bfloat16).requires_grad_()
    out = PairSegSpmm.apply(tl, torch.from_numpy(hr), tuple(torch.from_numpy(x) for x in edges),
                            l_max, r_pad, chunk)
    out.float().sum().backward()
    assert tl.grad.dtype == torch.bfloat16
