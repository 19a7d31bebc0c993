"""Segment-sum neighbor aggregation (``spmm_impl=segment``).

The reference delegates SpMM to DGL's ``update_all(copy_src, sum)``
(``AdaQP/model/ops.py:17-32``); the JAX package writes it as a gather and a
``segment_sum`` outside any kernel, and so does the port, in PyTorch ops:

- :func:`segment_spmm` gathers ``h[src]`` and adds it into ``dst`` rows with
  ``index_add_``, in ``h``'s dtype. It materialises an [E, F] intermediate.
- :func:`spmm_csr` does the same over edge chunks of ``chunk`` edges, so
  the intermediate is [chunk, F] whatever the edge count.

Destinations at or past ``num_nodes`` (the layouts pad edge lists with the
sentinel ``dst = num_nodes``) are dropped, as JAX's ``segment_sum`` drops
them. On the card ``index_add_`` adds with atomics, so a row's sum may be
taken in another order from run to run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _drop_out_of_range(dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    return torch.where((dst >= 0) & (dst < num_nodes), dst, num_nodes).long()


def segment_spmm(src: torch.Tensor, dst: torch.Tensor, w: Optional[torch.Tensor],
                 h: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of w_e * h[u].

    ``src``/``dst`` int [E], ``w`` f32 [E] or None (= 1), ``h`` [N_in, F].
    Returns [num_nodes, F] in ``h.dtype``."""
    msg = h[src.long()]
    if w is not None:
        msg = msg * w[:, None].to(msg.dtype)
    out = torch.zeros((num_nodes + 1, h.shape[1]), dtype=h.dtype, device=h.device)
    out.index_add_(0, _drop_out_of_range(dst, num_nodes), msg)
    return out[:num_nodes]


def spmm_csr(src: torch.Tensor, dst: torch.Tensor, w: Optional[torch.Tensor],
             h: torch.Tensor, num_nodes: int, chunk: int = 1 << 16) -> torch.Tensor:
    """:func:`segment_spmm` over chunks of ``chunk`` edges. Requires
    ``E % chunk == 0`` (pad edges with ``dst = num_nodes``, which drop), as
    the JAX package's ``spmm_csr`` does."""
    e = src.shape[0]
    if e % chunk:
        raise ValueError(f"edge count {e} must be padded to a multiple of chunk={chunk}")
    out = torch.zeros((num_nodes + 1, h.shape[1]), dtype=h.dtype, device=h.device)
    for s in range(0, e, chunk):
        msg = h[src[s:s + chunk].long()]
        if w is not None:
            msg = msg * w[s:s + chunk, None].to(h.dtype)
        out.index_add_(0, _drop_out_of_range(dst[s:s + chunk], num_nodes), msg)
    return out[:num_nodes]


def pad_edges(src, dst, w, num_nodes: int, multiple: int):
    """Pad edge arrays to a multiple of ``multiple`` with dropped sentinels
    (``dst = num_nodes``). Host-side (numpy in, numpy out)."""
    e = len(src)
    e_pad = -(-e // multiple) * multiple
    if e_pad == e:
        return src, dst, w
    pad = e_pad - e
    src = np.concatenate([src, np.zeros(pad, dtype=src.dtype)])
    dst = np.concatenate([dst, np.full(pad, num_nodes, dtype=dst.dtype)])
    if w is not None:
        w = np.concatenate([w, np.zeros(pad, dtype=w.dtype)])
    return src, dst, w
