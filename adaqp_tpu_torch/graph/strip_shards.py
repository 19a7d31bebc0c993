"""Per-shard strip (bitmask tile) SpMM layouts for the distributed path.

Lowers a PartitionLayout's four per-partition edge groups to strip layouts
stacked on a leading ``[K, ...]`` axis, like the JAX package's
``StripShards``, so that shard ``p``'s four operators are
``devices(p)``:

- ``fwd_local``: local rows -> local rows (``l_max`` x ``l_max``);
- ``bwd_local``: its transpose, or None when the graph is bidirected (the
  symmetric local operator is its own transpose, so ``devices`` aliases
  ``fwd_local``; the reference aliases too, ``graphEngine.py:135-147``);
- ``fwd_halo``: remote slots -> local rows, rectangular (``n_src = r_pad``);
- ``bwd_halo``: local rows -> remote slots.

Each shard's destination-block tile ranges (``blk_ptr``) are computed from
its own tiles BEFORE the tile arrays are padded to the shard maximum; the
padding tiles are then never read. ELL straggler stacking is shared with
block_shards (same format).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..common.backend import DeviceLike
from ..ops.spmm_block import MIN_EDGES
from ..ops.spmm_fast import ROW_CHUNK, EllDevice
from ..ops.spmm_strip import STRIP, StripDevice, block_pointers, strip_layout
from .block_shards import _stack_ells
from .layout import PartitionLayout

_GROUPS = ("fwd_local", "bwd_local", "fwd_halo", "bwd_halo")

# stacked per-group tensors: (masks [K, T, BD, WORDS], tile_src [K, T'],
# blk_ptr [K, n_pad // BD + 1])
Group = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class StripShards:
    """Stacked [K, ...] strip-layout groups + shard-uniform ELL buckets."""

    fwd_local: Group
    bwd_local: Optional[Group]  # None when bidirected (aliases fwd_local)
    fwd_halo: Group
    bwd_halo: Group
    ells: Tuple[Tuple, Tuple, Tuple, Tuple]
    l_max: int
    r_pad: int
    ell_widths: Tuple[Tuple[int, ...], ...]
    # per group: (dense tiles, ELL edges) summed over shards
    counts: Tuple[Tuple[int, int], ...] = ()

    def to(self, device: DeviceLike) -> "StripShards":
        def mv(group):
            return None if group is None else tuple(x.to(device) for x in group)

        return dataclasses.replace(
            self,
            fwd_local=mv(self.fwd_local), bwd_local=mv(self.bwd_local),
            fwd_halo=mv(self.fwd_halo), bwd_halo=mv(self.bwd_halo),
            ells=tuple(tuple(mv(s) for s in stacks) for stacks in self.ells),
        )

    def devices(self, rank: int = 0):
        """Shard ``rank``'s StripDevice objects:
        (fwd_local, bwd_local, fwd_halo, bwd_halo)."""

        def dev(i, grp, n_pad, n_src_pad):
            masks, tile_src, blk_ptr = grp
            straggler = None
            if self.ell_widths[i]:
                buckets = tuple(
                    (w, rows[rank], idx[rank], lens[rank])
                    for w, (rows, idx, lens) in zip(self.ell_widths[i], self.ells[i])
                )
                straggler = EllDevice(n_pad, buckets, ROW_CHUNK)
            return StripDevice(
                n_pad, n_pad, n_src_pad, masks[rank], tile_src[rank],
                blk_ptr[rank], straggler,
            )

        fl = dev(0, self.fwd_local, self.l_max, self.l_max)
        bl = fl if self.bwd_local is None else dev(1, self.bwd_local, self.l_max, self.l_max)
        return (
            fl,
            bl,
            dev(2, self.fwd_halo, self.l_max, self.r_pad),
            dev(3, self.bwd_halo, self.r_pad, self.l_max),
        )


def _pad_group(lays) -> Group:
    """Stack per-shard StripLayouts: tile ranges first, then zero padding."""
    t_max = max(lay.masks.shape[0] for lay in lays)
    tt_max = max(lay.tile_src.shape[0] for lay in lays)
    masks, tile_src, blk_ptr = [], [], []
    for lay in lays:
        blk_ptr.append(block_pointers(lay.tile_dst, lay.n_pad))
        masks.append(np.concatenate([
            lay.masks,
            np.zeros((t_max - lay.masks.shape[0],) + lay.masks.shape[1:], np.int16),
        ]))
        tile_src.append(np.concatenate(
            [lay.tile_src, np.zeros(tt_max - lay.tile_src.shape[0], np.int32)]
        ))
    return tuple(torch.as_tensor(np.stack(x)) for x in (masks, tile_src, blk_ptr))


def _ell_edges(lay) -> int:
    if lay.straggler is None:
        return 0
    return int(sum(
        lens[rows < lay.straggler.n].sum() for _, rows, _, lens in lay.straggler.buckets
    ))


def build_strip_shards(
    layout: PartitionLayout, min_edges: int = MIN_EDGES,
    cache_prefix: Optional[str] = None,
) -> StripShards:
    """Strip layouts of every partition's four edge groups, stacked."""
    l_max = layout.l_max
    r_pad = layout.plan_fwd.r_pad
    if l_max % STRIP or r_pad % STRIP:
        raise ValueError(
            f"strip shards need l_max/r_pad padded to {STRIP} (got {l_max}, "
            f"{r_pad}); build the layout with pad_multiple={STRIP}"
        )
    k = layout.k
    groups = {name: [] for name in _GROUPS}
    for p in range(k):
        ls, ld = layout.fwd_local[0][p], layout.fwd_local[1][p]
        valid = ld < l_max
        ls, ld = ls[valid], ld[valid]
        hs, hd = layout.fwd_halo[0][p], layout.fwd_halo[1][p]
        validh = hd < l_max
        hs, hd = hs[validh] - l_max, hd[validh]  # halo srcs stored Lmax+slot
        mk = lambda s, d, n, n_src, name: strip_layout(
            s.astype(np.int32), d.astype(np.int32), n,
            min_edges=min_edges, dedup=False, n_src=n_src,
            cache_key=(
                f"{cache_prefix}_me{min_edges}_p{p}_{name}"
                if cache_prefix else None
            ),
        )
        groups["fwd_local"].append(mk(ls, ld, l_max, l_max, "fl"))
        if not layout.is_bidirected:
            groups["bwd_local"].append(mk(ld, ls, l_max, l_max, "bl"))
        groups["fwd_halo"].append(mk(hs, hd, l_max, r_pad, "fh"))
        groups["bwd_halo"].append(mk(hd, hs, r_pad, l_max, "bh"))

    out = {}
    widths_all, ells_all, counts = [], [], []
    n_out = {"fwd_local": l_max, "bwd_local": l_max, "fwd_halo": l_max,
             "bwd_halo": r_pad}
    for name in _GROUPS:
        if name == "bwd_local" and layout.is_bidirected:
            out[name] = None
            widths_all.append(())
            ells_all.append(())
            counts.append((0, 0))
            continue
        lays = groups[name]
        out[name] = _pad_group(lays)
        widths, stacks = _stack_ells([l.straggler for l in lays], n_out[name])
        widths_all.append(widths)
        ells_all.append(stacks)
        counts.append((sum(len(l.tile_src) for l in lays),
                       sum(_ell_edges(l) for l in lays)))
    return StripShards(
        out["fwd_local"], out["bwd_local"], out["fwd_halo"], out["bwd_halo"],
        tuple(ells_all), l_max, r_pad, tuple(widths_all), tuple(counts),
    )
