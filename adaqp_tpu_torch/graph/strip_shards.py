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

import dataclasses
from typing import Optional

import torch

from ..common.backend import DeviceLike
from ..ops.spmm_block import MIN_EDGES
from ..ops.spmm_strip import (
    STRIP, StripDevice, StripWalk, block_pointers, strip_layout, strip_walk,
)
from .block_shards import TileShards, build_tile_shards
from .layout import PartitionLayout


def _stack_walks(group):
    """A group's first three fields, then each shard's walk arrays stacked
    [K, ...] and zero-padded to the longest (the pointers never reach the
    padding)."""
    masks, tile_src, blk_ptr = group[:3]
    walks = [strip_walk(masks[p], tile_src[p], blk_ptr[p]).tensors()
             for p in range(masks.shape[0])]
    stacked = []
    for field in zip(*walks):
        n = max(x.shape[0] for x in field)
        stacked.append(torch.stack([
            torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])]) for x in field
        ]))
    return (masks, tile_src, blk_ptr, *stacked)


class StripShards(TileShards):
    """Strip layouts, per group (masks [K, T, BD, WORDS], tile_src [K, T],
    blk_ptr [K, n_pad // BD + 1]; after ``to`` a CUDA device, the six walk
    arrays)."""

    @staticmethod
    def _device(tensors, n_pad, n_src_pad, straggler):
        walk = StripWalk(*tensors[3:]) if len(tensors) > 3 else None
        return StripDevice(n_pad, n_pad, n_src_pad, *tensors[:3], straggler, walk)

    def with_walks(self) -> "StripShards":
        """These shards with each group's walk arrays, built on the shards'
        device; ``to`` a CUDA device calls it."""
        return dataclasses.replace(self, **{
            name: None if getattr(self, name) is None else _stack_walks(getattr(self, name))
            for name in ("fwd_local", "bwd_local", "fwd_halo", "bwd_halo")
        })

    def to(self, device: DeviceLike) -> "StripShards":
        out = super().to(device)
        return out.with_walks() if out.fwd_local[0].is_cuda else out


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
