"""Per-shard strip (bitmask tile) SpMM layouts for the distributed path:
a PartitionLayout's four per-partition edge groups lowered to strip
layouts and stacked on a leading ``[K, ...]`` axis, like the JAX package's
``StripShards``. The container (``select``, ``devices``), the builder and
the ELL straggler stacking are shared with the block and compact shards
(``block_shards.py``, which describes the four groups); each shard's
destination-block tile ranges (``blk_ptr``) are computed from its own tiles
before the tile arrays are padded, so the padding is never read. Moved to a
CUDA device (``to``), each group also carries each shard's walk arrays for
the CUDA kernel (``strip_walk``), built there.
"""
from __future__ import annotations

from typing import Optional

from ..ops.spmm_block import MIN_EDGES
from ..ops.spmm_strip import STRIP, StripDevice, block_pointers, strip_layout
from .block_shards import TileShards, build_tile_shards
from .layout import PartitionLayout


class StripShards(TileShards):
    """Strip layouts, per group (masks [K, T, BD, WORDS], tile_src [K, T],
    blk_ptr [K, n_pad // BD + 1])."""

    @staticmethod
    def _device(tensors, n_pad, n_src_pad, straggler, walk):
        return StripDevice(n_pad, n_pad, n_src_pad, *tensors, straggler, walk)


def build_strip_shards(
    layout: PartitionLayout, min_edges: int = MIN_EDGES,
    cache_prefix: Optional[str] = None,
) -> StripShards:
    """Strip layouts of every partition's four edge groups, stacked."""
    def make(s, d, n, n_src, tag):
        return strip_layout(
            s, d, n, min_edges=min_edges, dedup=False, n_src=n_src,
            cache_key=f"{cache_prefix}_me{min_edges}_{tag}" if cache_prefix else None,
        )

    return build_tile_shards(
        StripShards, layout, STRIP, make,
        lambda lay: (lay.masks, lay.tile_src, block_pointers(lay.tile_dst, lay.n_pad)),
        lambda lay: len(lay.tile_src),
    )
