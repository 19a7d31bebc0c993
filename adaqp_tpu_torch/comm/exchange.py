"""Boundary-message exchange — only the variance proxy is ported so far.

The exchange itself (fp32 and quantized wires over ``torch.distributed``)
belongs to the K>1 slices. :func:`variance_proxy` is here because the
aggregation returns the forward variance trace at every K.
"""
from __future__ import annotations

import torch


def variance_proxy(rows: torch.Tensor, num_feats: int) -> torch.Tensor:
    """Per-row quantization-variance proxy ``(F/6) * (rmax - rmin)^2``
    (reference: ``op_util.py:91-99``). ``num_feats`` is the TRUE feature
    count; columns beyond it are layout padding and are masked out of the
    range (the reference traces exact-F rows)."""
    f = rows.shape[-1]
    if num_feats < f:
        col = torch.arange(f, device=rows.device) < num_feats
        inf = torch.tensor(float("inf"), dtype=rows.dtype, device=rows.device)
        rmin = torch.where(col, rows, inf).amin(dim=-1)
        rmax = torch.where(col, rows, -inf).amax(dim=-1)
    else:
        rmin = rows.amin(dim=-1)
        rmax = rows.amax(dim=-1)
    return (num_feats / 6.0) * (rmax - rmin) ** 2
