"""Per-shard tile layouts for the distributed path — only the ELL straggler
stacking, which the strip shards share, is ported so far.

ELL buckets are padded to a SHARD-UNIFORM shape: the union of widths
across shards, each width's segment count padded to the max (padding
segments scatter to the drop row).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.spmm_fast import ROW_CHUNK


def _stack_ells(lays, n_out: int):
    """Union per-shard straggler EllLayouts into shard-uniform buckets:
    ``(widths, stacks)`` with ``stacks[i] = (rows [K, NB], idx [K, NB, w],
    lens [K, NB])`` int32 tensors for ``widths[i]``.

    Padding segments target the drop row ``n_out`` with a single (masked)
    lane, exactly like ``ell_from_csr``'s row_chunk padding."""
    widths = sorted(
        {w for lay in lays if lay is not None for w, *_ in lay.buckets}
    )
    if not widths:
        return (), ()
    stacks = []
    for w in widths:
        per_shard = []
        for lay in lays:
            found = None
            if lay is not None:
                for bw, rows, idx, lens in lay.buckets:
                    if bw == w:
                        found = (rows, idx, lens)
                        break
            per_shard.append(found)
        nb_max = max(f[0].shape[0] for f in per_shard if f is not None)
        nb_max = -(-nb_max // ROW_CHUNK) * ROW_CHUNK
        rows_s, idx_s, lens_s = [], [], []
        for f in per_shard:
            if f is None:
                rows = np.full(nb_max, n_out, np.int32)
                idx = np.zeros((nb_max, w), np.int32)
                lens = np.ones(nb_max, np.int32)
            else:
                rows, idx, lens = f
                pad = nb_max - rows.shape[0]
                rows = np.concatenate([rows, np.full(pad, n_out, np.int32)])
                idx = np.concatenate([idx, np.zeros((pad, w), np.int32)])
                lens = np.concatenate([lens, np.ones(pad, np.int32)])
            rows_s.append(rows)
            idx_s.append(idx)
            lens_s.append(lens)
        stacks.append(
            tuple(torch.as_tensor(np.stack(x)) for x in (rows_s, idx_s, lens_s))
        )
    return tuple(widths), tuple(stacks)
