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
from .spmm_strip import spmm_strip


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

    ``blocks``: the rank's :class:`~adaqp_tpu_torch.graph.strip_shards.
    StripShards`. At K>1: ``wire`` is this layer's ``(fwd, bwd)`` pair of
    :class:`~adaqp_tpu_torch.comm.wire.LocalWire` (bwd None for layer 0),
    ``keys`` the (forward, backward) generator keys of its quantized
    buckets, and ``sink`` a ``[r_pad]`` leaf whose gradient becomes the
    backward variance trace (or None).

    Returns ``(out [L, F], fwd_trace [K, S])``; fwd_trace is the
    per-sent-lane variance proxy (reference ``@trace_input``,
    ``op_util.py:91-99``), a value with no gradient.
    """
    if blocks is None:
        raise NotImplementedError(
            "only the strip tile aggregation is ported (ROADMAP Queue 1, "
            "'Segment SpMM')"
        )
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

    fl, bl, fh, bh = blocks.devices()
    dt = agg_torch_dtype(cfg)
    l = cfg.l_max
    # local part first: in overlapped modes it runs while the exchange is
    # in flight; the kernel emits dt (f32 accumulation inside)
    if cfg.model is GNNType.GCN:
        local = spmm_strip(fl, (h * torch.rsqrt(sh.deg_out[:l])[:, None]).to(dt), bl)
    elif cfg.model is GNNType.SAGE:
        local = spmm_strip(fl, h.to(dt), bl)
    else:
        raise ValueError(f"unknown model {cfg.model}")
    if pending is not None:
        remote = finish()
    if cfg.model is GNNType.GCN:
        hs_remote = remote * torch.rsqrt(sh.deg_out[l:])[:, None]
        agg = local + spmm_strip(fh, hs_remote.to(dt), bh)
        out = agg * torch.rsqrt(sh.deg_in[:l])[:, None]
    else:
        agg = local + spmm_strip(fh, remote.to(dt), bh)
        if cfg.agg_type is AggregatorType.MEAN:
            out = agg / sh.deg_in[:l, None]
        else:  # 'gcn' aggregator (reference ops.py:41-46)
            out = (agg + h) / (sh.deg_in[:l, None] + 1.0)
    return out, fwd_trace
