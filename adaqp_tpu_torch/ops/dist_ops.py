"""Distributed GNN aggregation — the analog of the reference's autograd ops
layer (``AdaQP/model/ops.py``); the JAX package's ``ops/dist_ops.py`` is the
reference.

:func:`dist_aggregate` splits the aggregation by EDGE SOURCE into a
local-source part and a halo-source part; the halo rows come from the
boundary exchange (``comm/exchange_ragged.py``) over the wire plan the
caller passes: the fp wire (Vanilla, AdaQP-p, and evaluation in every mode)
or the quantized one (AdaQP, AdaQP-q in training). The schedule follows the
run mode (reference ``ops.py:132-193``):

- serial modes (Vanilla, AdaQP-q): the exchange finishes before the local
  aggregation starts (the JAX package's ``optimization_barrier``);
- overlapped modes (AdaQP, AdaQP-p): the all-to-all is in flight while the
  local aggregation runs, and is waited for just before the halo part.

Both schedules run the same operations on the same data, so they give the
same bits. At K=1 no message crosses partitions: the halo input is a
constant zero block.

The aggregation ``A^T h`` runs on the run's tile kernel, chosen by the
layout type of ``blocks`` (:func:`pick_block_kernel`: strip, block or
compact), in the aggregation dtype; with no ``blocks`` (``spmm_impl=
segment``) it is a segment sum over the shard's edge lists
(:class:`PairSegSpmm`) in the dtype of its inputs, as in the JAX package.

Aggregation math (reference ``ops.py:17-67``, global degrees clamped >= 1):

- GCN      : out = D_in^-1/2 * A^T * (D_out^-1/2 * h)
- SAGE mean: out = (A^T h) / d_in
- SAGE gcn : out = (A^T h + h) / (d_in + 1)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..comm.exchange import variance_proxy
from ..comm.exchange_ragged import exchange_finish, exchange_start
from ..common.types import AggregatorType, GNNType
from ..graph.device import ShardArrays, ShardStatic, agg_torch_dtype
from .spmm import segment_spmm, spmm_csr
from .spmm_block import BlockDevice, spmm_block
from .spmm_compact import CompactDevice, spmm_compact
from .spmm_strip import StripDevice, spmm_strip


def pick_block_kernel(dev):
    """Tile aggregation by device-layout type (strip, block or compact)."""
    for cls, fn in ((StripDevice, spmm_strip), (BlockDevice, spmm_block),
                    (CompactDevice, spmm_compact)):
        if isinstance(dev, cls):
            return fn
    raise TypeError(f"no tile aggregation for {type(dev).__name__}")


def _seg(src, dst, h, num_out, chunk):
    if chunk is None:
        return segment_spmm(src, dst, None, h, num_out)
    return spmm_csr(src, dst, None, h, num_out, chunk)


class PairSegSpmm(torch.autograd.Function):
    """Local + halo segment-sum aggregation with a gather-form backward.

    ``edges = (fl_src, fl_dst, fh_src, fh_dst, bl_src, bl_dst, bh_src,
    bh_dst)``: the forward lists and their prebuilt dst-sorted transposes
    (``graph/layout.py``). The backward runs the same gather + sum on the
    transposed lists (the reference aggregating gradients on its prebuilt
    ``bwd_graph``, ``AdaQP/model/ops.py:83-95``) and returns each gradient
    in its input's dtype."""

    @staticmethod
    def forward(ctx, hl, hr, edges, l_max: int, r_pad: int, chunk):
        ctx.edges, ctx.dims, ctx.chunk = edges, (l_max, r_pad), chunk
        ctx.dtypes = (hl.dtype, hr.dtype)
        fl_s, fl_d, fh_s, fh_d = edges[:4]
        return _seg(fl_s, fl_d, hl, l_max, chunk) + _seg(fh_s, fh_d, hr, l_max, chunk)

    @staticmethod
    def backward(ctx, g):
        bl_s, bl_d, bh_s, bh_d = ctx.edges[4:]
        (l_max, r_pad), (dl, dr) = ctx.dims, ctx.dtypes
        g_l = g_r = None
        if ctx.needs_input_grad[0]:
            g_l = _seg(bl_s, bl_d, g, l_max, ctx.chunk).to(dl)
        if ctx.needs_input_grad[1]:
            g_r = _seg(bh_s, bh_d, g, r_pad, ctx.chunk).to(dr)
        return g_l, g_r, None, None, None, None


def dist_aggregate(
    h: torch.Tensor,
    sh: ShardArrays,
    cfg: ShardStatic,
    blocks,
    f_true: Optional[int] = None,
    wire=None,
    keys: Tuple[int, int] = (0, 0),
    sink: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregate one partition's rows ``h`` [L, F] over the graph.

    ``blocks``: the rank's tile shards (strip, block or compact), or None
    for the segment sum over ``sh``'s edge lists. At K>1: ``wire`` is this
    layer's ``(fwd, bwd)`` pair of
    :class:`~adaqp_tpu_torch.comm.wire.LocalWire` (bwd None for layer 0),
    ``keys`` the (forward, backward) generator keys of its quantized
    buckets, and ``sink`` a ``[r_pad]`` leaf whose gradient becomes the
    backward variance trace (or None).

    Returns ``(out [L, F], fwd_trace [K, S])``; fwd_trace is the
    per-sent-lane variance proxy (reference ``@trace_input``,
    ``op_util.py:91-99``), a value with no gradient.
    """
    ft = h.shape[1] if f_true is None else f_true
    fwd_trace = variance_proxy(h.detach()[sh.send_idx], ft)

    pending = None
    if cfg.k == 1:
        remote = torch.zeros((cfg.r_pad, h.shape[1]), dtype=torch.float32, device=h.device)
    else:
        if wire is None:
            raise ValueError("K>1 aggregation needs this layer's wire plans")
        wfwd, wbwd = wire
        pending = exchange_start(h, wfwd, keys[0], ft)

        def finish():
            return exchange_finish(h, sink, pending, wbwd, keys[1])

        if not cfg.mode.overlapped:
            remote, pending = finish(), None

    l = cfg.l_max
    if blocks is None:
        # one function sums both parts (its backward needs both lists), so
        # the segment sum runs once the exchange is done, in every mode
        edges = sh.edges()

        def local_part(hl):
            return hl

        def pair(hl, hr):
            return PairSegSpmm.apply(hl, hr, edges, l, cfg.r_pad, cfg.edge_chunk)
    else:
        fl, bl, fh, bh = blocks.devices()
        kernel = pick_block_kernel(fl)
        dt = agg_torch_dtype(cfg)

        # the local part first: in overlapped modes it runs while the
        # exchange is in flight; the kernel emits dt (f32 accumulation inside)
        def local_part(hl):
            return kernel(fl, hl.to(dt), bl)

        def pair(local, hr):
            return local + kernel(fh, hr.to(dt), bh)

    if cfg.model is GNNType.GCN:
        local = local_part(h * torch.rsqrt(sh.deg_out[:l])[:, None])
    elif cfg.model is GNNType.SAGE:
        local = local_part(h)
    else:
        raise ValueError(f"unknown model {cfg.model}")
    if pending is not None:
        remote = finish()
    if cfg.model is GNNType.GCN:
        hs_remote = remote * torch.rsqrt(sh.deg_out[l:])[:, None]
        out = pair(local, hs_remote) * torch.rsqrt(sh.deg_in[:l])[:, None]
    else:
        agg = pair(local, remote)
        if cfg.agg_type is AggregatorType.MEAN:
            out = agg / sh.deg_in[:l, None]
        else:  # 'gcn' aggregator (reference ops.py:41-46)
            out = (agg + h) / (sh.deg_in[:l, None] + 1.0)
    return out, fwd_trace
