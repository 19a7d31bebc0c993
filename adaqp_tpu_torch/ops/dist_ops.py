"""Distributed GNN aggregation — the analog of the reference's autograd ops
layer (``AdaQP/model/ops.py``).

:func:`dist_aggregate` splits the aggregation by EDGE SOURCE into a
local-source part and a halo-source part (the halo rows come from the
boundary exchange). Only the single-partition (K=1) branch is ported: no
cross-partition messages exist, so the halo input is a constant zero block
and the run modes differ in nothing. K>1 (the exchange over
``torch.distributed``) is the next slice.

Aggregation math (reference ``ops.py:17-67``, global degrees clamped >= 1):

- GCN      : out = D_in^-1/2 * A^T * (D_out^-1/2 * h)
- SAGE mean: out = (A^T h) / d_in
- SAGE gcn : out = (A^T h + h) / (d_in + 1)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..comm.exchange import variance_proxy
from ..common.types import AggregatorType, GNNType
from ..graph.device import ShardArrays, ShardStatic, agg_torch_dtype
from .spmm_strip import spmm_strip


def dist_aggregate(
    h: torch.Tensor,
    sh: ShardArrays,
    cfg: ShardStatic,
    blocks,
    f_true: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregate one partition's rows ``h`` [L, F] over the graph.

    ``blocks`` is the run's :class:`~adaqp_tpu_torch.graph.strip_shards.
    StripShards`. Returns ``(out [L, F], fwd_trace [K, S])`` where fwd_trace
    is the per-sent-lane variance proxy (reference ``@trace_input``,
    ``op_util.py:91-99``), a value with no gradient.
    """
    if cfg.k != 1:
        raise NotImplementedError(
            "dist_aggregate runs K=1 only; the K>1 exchange is not ported "
            "(ROADMAP Queue 1, 'Exchange')"
        )
    if blocks is None:
        raise NotImplementedError(
            "only the strip tile aggregation is ported (ROADMAP Queue 1, "
            "'Segment SpMM')"
        )
    ft = h.shape[1] if f_true is None else f_true
    fwd_trace = variance_proxy(h.detach()[sh.send_idx], ft)
    # single partition: no cross-partition messages exist
    remote = torch.zeros((cfg.r_pad, h.shape[1]), dtype=torch.float32, device=h.device)

    fl, bl, fh, bh = blocks.devices()
    dt = agg_torch_dtype(cfg)

    def pair(hl, hr):
        # the kernel emits dt (f32 accumulation inside); the sum stays in dt
        a = spmm_strip(fl, hl.to(dt), bl)
        b = spmm_strip(fh, hr.to(dt), bh)
        return a + b

    l = cfg.l_max
    if cfg.model is GNNType.GCN:
        hs_local = h * torch.rsqrt(sh.deg_out[:l])[:, None]
        hs_remote = remote * torch.rsqrt(sh.deg_out[l:])[:, None]
        out = pair(hs_local, hs_remote) * torch.rsqrt(sh.deg_in[:l])[:, None]
    elif cfg.model is GNNType.SAGE:
        agg = pair(h, remote)
        if cfg.agg_type is AggregatorType.MEAN:
            out = agg / sh.deg_in[:l, None]
        else:  # 'gcn' aggregator (reference ops.py:41-46)
            out = (agg + h) / (sh.deg_in[:l, None] + 1.0)
    else:
        raise ValueError(f"unknown model {cfg.model}")
    return out, fwd_trace
