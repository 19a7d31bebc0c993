"""Per-shard compact-column SpMM layouts (``spmm_impl=compact``) for the
distributed path: a PartitionLayout's four per-partition edge groups
lowered to compact layouts and stacked on a leading ``[K, ...]`` axis, like
the JAX package's ``CompactShards``. The container, the builder and the
ELL tail stacking are the block shards' (``block_shards.py``). Each shard's
per-strip item ranges (``item_ptr``) are computed from its own unpadded
layout before the item arrays are zero-padded to the shard maximum, so the
padding is never read; the JAX shards instead append inert items that
repeat the last real item's strip and window slot, which its TPU grid
needs and a range read after padding would walk wrongly. Moved to a CUDA
device, each group also carries each shard's walk (``compact_walk``).
"""
from __future__ import annotations

from typing import Optional

from ..ops.spmm_compact import (
    FULL_COLS, ME_ELL, STRIP, CompactDevice, compact_layout, item_pointers,
)
from .block_shards import TileShards, build_tile_shards
from .layout import PartitionLayout


class CompactShards(TileShards):
    """Compact layouts, per group (kind [K, T], masks [K, T, BD, WORDS],
    col_idx [K, T, BS], src_start [K, T], dst_off [K, T, GROUP], nsub
    [K, T], item_ptr [K, n_pad // STRIP + 1])."""

    @staticmethod
    def _device(tensors, n_pad, n_src_pad, straggler, walk):
        return CompactDevice(n_pad, n_pad, n_src_pad, *tensors, straggler, walk)


def build_compact_shards(
    layout: PartitionLayout,
    me_ell: int = ME_ELL,
    full_cols: int = FULL_COLS,
    cache_prefix: Optional[str] = None,
) -> CompactShards:
    """Compact layouts of every partition's four edge groups, stacked.
    ``cache_prefix`` enables the per-(shard, group) ``compact_layout`` npz
    cache (the JAX package's names and format)."""
    def make(s, d, n, n_src, tag):
        return compact_layout(
            s, d, n, n_src=n_src, me_ell=me_ell, full_cols=full_cols, dedup=False,
            cache_key=(f"{cache_prefix}_me{me_ell}_fc{full_cols}_{tag}"
                       if cache_prefix else None),
        )

    return build_tile_shards(
        CompactShards, layout, STRIP, make,
        lambda lay: (lay.kind, lay.masks, lay.col_idx, lay.src_start, lay.dst_off,
                     lay.nsub, item_pointers(lay.strip_id, lay.n_pad)),
        lambda lay: len(lay.kind),
    )
