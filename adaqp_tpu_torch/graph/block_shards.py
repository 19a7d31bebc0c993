"""Per-shard tile layouts for the distributed path: the container and
builder shared by the strip, block and compact shards, and the block
(``spmm_impl=block``) shards themselves.

A PartitionLayout's four per-partition edge groups are lowered to tile
layouts stacked on a leading ``[K, ...]`` axis, like the JAX package's
``BlockShards``, so that shard ``p``'s four operators are ``devices(p)``. A
rank keeps only its own shard (``select(rank)``) before moving the layouts
to its device:

- ``fwd_local``: local rows -> local rows (``l_max`` x ``l_max``);
- ``bwd_local``: its transpose, or None when the graph is bidirected (the
  symmetric local operator is its own transpose, so ``devices`` aliases
  ``fwd_local``; the reference aliases too, ``graphEngine.py:135-147``);
- ``fwd_halo``: remote slots -> local rows, rectangular (``n_src = r_pad``);
- ``bwd_halo``: local rows -> remote slots.

Each shard's per-destination ranges (``blk_ptr`` of the strip and block
layouts, ``item_ptr`` of the compact one) are computed from its own
unpadded layout BEFORE the arrays are padded to the shard maximum with
zeros, so the kernels never read the padding. (The JAX shards pad with
inert tiles or items that revisit a destination after the sorted ones,
which a range read after padding would walk wrongly.) ELL buckets are
padded to a SHARD-UNIFORM shape: the union of widths across shards, each
width's segment count padded to the max (padding segments scatter to the
drop row).

Moved to a CUDA device (``to``), the shards also carry each shard's walk
arrays for the tile kernel (``walks``: a ``StripWalk`` of stacked tensors a
group), built there by ``with_walks`` from each shard's device layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.backend import DeviceLike
from ..ops.spmm_block import MIN_EDGES, BlockDevice, block_layout, block_pointers
from ..ops.spmm_fast import ROW_CHUNK, EllDevice
from ..ops.spmm_walk import StripWalk
from .layout import PartitionLayout

GROUPS = ("fwd_local", "bwd_local", "fwd_halo", "bwd_halo")

# one group's stacked tensors, [K, ...] each (fields depend on the layout)
Group = Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class TileShards:
    """Stacked [K, ...] tile-layout groups + shard-uniform ELL buckets.
    Subclasses name the device layout a group's tensors make."""

    fwd_local: Group
    bwd_local: Optional[Group]  # None when bidirected (aliases fwd_local)
    fwd_halo: Group
    bwd_halo: Group
    ells: Tuple[Tuple, Tuple, Tuple, Tuple]
    l_max: int
    r_pad: int
    ell_widths: Tuple[Tuple[int, ...], ...]
    # per group: (tiles or items, ELL edges) summed over shards
    counts: Tuple[Tuple[int, int], ...] = ()
    # the one shard kept by select(), or None while all K are stacked
    selected: Optional[int] = None
    # per group: each shard's walk (a StripWalk of [K, ...] tensors, None
    # for an aliased group), once ``with_walks`` has built them
    walks: Optional[Tuple[Optional[StripWalk], ...]] = None

    @staticmethod
    def _device(tensors: Group, n_pad: int, n_src_pad: int, straggler, walk):
        raise NotImplementedError

    def _map(self, fn) -> "TileShards":
        def mv(group):
            return None if group is None else tuple(fn(x) for x in group)

        walks = None if self.walks is None else tuple(
            None if w is None else StripWalk(*mv(w.tensors())) for w in self.walks
        )
        return dataclasses.replace(
            self,
            fwd_local=mv(self.fwd_local), bwd_local=mv(self.bwd_local),
            fwd_halo=mv(self.fwd_halo), bwd_halo=mv(self.bwd_halo),
            ells=tuple(tuple(mv(s) for s in stacks) for stacks in self.ells),
            walks=walks,
        )

    def to(self, device: DeviceLike) -> "TileShards":
        """These shards on ``device``; on a CUDA device with each shard's
        walk arrays (``with_walks``), built there."""
        out = self._map(lambda x: x.to(device))
        return out.with_walks() if out.fwd_local[0].is_cuda and out.walks is None else out

    def with_walks(self) -> "TileShards":
        """These shards with each group's walk arrays, built on the shards'
        device from each shard's device layout (``build_walk``), stacked
        [K, ...] and zero-padded to the longest (no pointer reaches the
        padding)."""
        ranks = range(self.fwd_local[0].shape[0]) if self.selected is None else [self.selected]
        per_rank = [self.devices(p) for p in ranks]
        walks = []
        for i, name in enumerate(GROUPS):
            if getattr(self, name) is None:
                walks.append(None)
                continue
            stacked = []
            for field in zip(*(devs[i].build_walk().tensors() for devs in per_rank)):
                n = max(x.shape[0] for x in field)
                stacked.append(torch.stack([
                    torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])]) for x in field
                ]))
            walks.append(StripWalk(*stacked))
        return dataclasses.replace(self, walks=tuple(walks))

    def select(self, rank: int) -> "TileShards":
        """Only shard ``rank``'s arrays (a leading axis of one), so that a
        rank moves its own layouts to its device and not all K shards'.
        ``devices(rank)`` gives the same operators before and after."""
        if self.selected is not None:
            raise ValueError(f"already reduced to shard {self.selected}")
        out = self._map(lambda x: x[rank:rank + 1].clone())
        return dataclasses.replace(out, selected=rank)

    def devices(self, rank: Optional[int] = None):
        """Shard ``rank``'s device layouts: (fwd_local, bwd_local,
        fwd_halo, bwd_halo). ``rank`` defaults to the selected shard, or
        shard 0 while all are stacked."""
        if rank is None:
            rank = 0 if self.selected is None else self.selected
        if self.selected is not None:
            if rank != self.selected:
                raise ValueError(
                    f"shard {rank} asked of shards reduced to {self.selected}"
                )
            rank = 0

        def dev(i, grp, n_pad, n_src_pad):
            straggler = None
            if self.ell_widths[i]:
                buckets = tuple(
                    (w, rows[rank], idx[rank], lens[rank])
                    for w, (rows, idx, lens) in zip(self.ell_widths[i], self.ells[i])
                )
                straggler = EllDevice(n_pad, buckets, ROW_CHUNK)
            walk = None
            if self.walks is not None:
                walk = StripWalk(*(x[rank] for x in self.walks[i].tensors()))
            return self._device(tuple(x[rank] for x in grp), n_pad, n_src_pad, straggler, walk)

        fl = dev(0, self.fwd_local, self.l_max, self.l_max)
        bl = fl if self.bwd_local is None else dev(1, self.bwd_local, self.l_max, self.l_max)
        return (
            fl,
            bl,
            dev(2, self.fwd_halo, self.l_max, self.r_pad),
            dev(3, self.bwd_halo, self.r_pad, self.l_max),
        )


def stack_padded(per_shard: Sequence[Sequence[np.ndarray]]) -> Group:
    """``per_shard[p]`` is shard p's arrays of one group; stack each field
    over shards, zero-padding its leading axis to the shard maximum."""
    out = []
    for field in zip(*per_shard):
        t_max = max(a.shape[0] for a in field)
        out.append(torch.as_tensor(np.stack([
            np.concatenate([a, np.zeros((t_max - a.shape[0],) + a.shape[1:], a.dtype)])
            for a in field
        ])))
    return tuple(out)


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


def _ell_edges(straggler) -> int:
    if straggler is None:
        return 0
    return int(sum(
        lens[rows < straggler.n].sum() for _, rows, _, lens in straggler.buckets
    ))


def build_tile_shards(
    cls, layout: PartitionLayout, multiple: int,
    make: Callable[[np.ndarray, np.ndarray, int, int, str], object],
    arrays: Callable[[object], Sequence[np.ndarray]],
    units: Callable[[object], int],
) -> TileShards:
    """Lower every partition's four edge groups with ``make(src, dst, n,
    n_src, cache_tag)`` (a host layout), keep ``arrays(host layout)`` of
    each (its ranges built before padding) and stack them into ``cls``.
    ``units(host layout)`` counts its tiles or items for ``counts``."""
    l_max = layout.l_max
    r_pad = layout.plan_fwd.r_pad
    if l_max % multiple or r_pad % multiple:
        raise ValueError(
            f"{cls.__name__} need l_max/r_pad padded to {multiple} (got {l_max}, "
            f"{r_pad}); build the layout with pad_multiple={multiple}"
        )
    groups: Dict[str, List] = {name: [] for name in GROUPS}
    for p in range(layout.k):
        ls, ld = layout.fwd_local[0][p], layout.fwd_local[1][p]
        valid = ld < l_max
        ls, ld = ls[valid], ld[valid]
        hs, hd = layout.fwd_halo[0][p], layout.fwd_halo[1][p]
        validh = hd < l_max
        hs, hd = hs[validh] - l_max, hd[validh]  # halo srcs stored Lmax+slot

        def mk(s, d, n, n_src, name):
            return make(s.astype(np.int32), d.astype(np.int32), n, n_src, f"p{p}_{name}")

        groups["fwd_local"].append(mk(ls, ld, l_max, l_max, "fl"))
        if not layout.is_bidirected:
            groups["bwd_local"].append(mk(ld, ls, l_max, l_max, "bl"))
        groups["fwd_halo"].append(mk(hs, hd, l_max, r_pad, "fh"))
        groups["bwd_halo"].append(mk(hd, hs, r_pad, l_max, "bh"))

    out = {}
    widths_all, ells_all, counts = [], [], []
    n_out = {"fwd_local": l_max, "bwd_local": l_max, "fwd_halo": l_max,
             "bwd_halo": r_pad}
    for name in GROUPS:
        if name == "bwd_local" and layout.is_bidirected:
            out[name] = None
            widths_all.append(())
            ells_all.append(())
            counts.append((0, 0))
            continue
        lays = groups[name]
        out[name] = stack_padded([arrays(lay) for lay in lays])
        widths, stacks = _stack_ells([l.straggler for l in lays], n_out[name])
        widths_all.append(widths)
        ells_all.append(stacks)
        counts.append((sum(units(l) for l in lays),
                       sum(_ell_edges(l.straggler) for l in lays)))
    return cls(
        out["fwd_local"], out["bwd_local"], out["fwd_halo"], out["bwd_halo"],
        tuple(ells_all), l_max, r_pad, tuple(widths_all), tuple(counts),
    )


class BlockShards(TileShards):
    """Block layouts, per group (masks [K, T, BD, WORDS], src_start [K, T],
    dst_blk [K, T], blk_ptr [K, n_pad // BD + 1])."""

    @staticmethod
    def _device(tensors, n_pad, n_src_pad, straggler, walk):
        return BlockDevice(n_pad, n_pad, n_src_pad, *tensors, straggler, walk)


def build_block_shards(
    layout: PartitionLayout, min_edges: int = MIN_EDGES,
    cache_prefix: Optional[str] = None,
) -> BlockShards:
    """Block layouts of every partition's four edge groups, stacked.
    ``cache_prefix`` enables the per-(shard, group) ``block_layout`` npz
    cache (the JAX package's names and format)."""
    def make(s, d, n, n_src, tag):
        return block_layout(
            s, d, n, min_edges=min_edges, dedup=False, n_src=n_src,
            cache_key=f"{cache_prefix}_me{min_edges}_{tag}" if cache_prefix else None,
        )

    return build_tile_shards(
        BlockShards, layout, 2048, make,
        lambda lay: (lay.masks, lay.src_start, lay.dst_blk,
                     block_pointers(lay.dst_blk, lay.n_pad)),
        lambda lay: len(lay.dst_blk),
    )
