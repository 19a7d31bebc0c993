"""Bitmask tile constants and edge deduplication shared by the tile layouts.

The adjacency is tiled into (BD=256 dst x BS=2048 src) blocks; every tile
holding >= ``MIN_EDGES`` edges is packed as a BITMASK of 16-bit halfwords,
int16 ``[BD, WORDS]``: column ``j`` of the tile lives at halfword
``j % WORDS``, bit ``j // WORDS``. Leftover edges in sparse tiles go to the
ELLPACK gather path (``spmm_fast``). The format is the JAX package's, so
layouts and caches built by either package are the same arrays.

Only the host side of the block (v1) kernel's module is ported; its layout
builder and kernel are still to come.

Duplicate edges are not representable in a bitmask; layouts are built from
de-duplicated edge lists (all four reference datasets are simple graphs).
"""
from __future__ import annotations

import numpy as np

BD = 256  # dst rows per tile
BS = 2048  # src cols per tile
WORDS = BS // 16  # int16 halfwords per tile row
MASK_SCHEME = 2  # cache-format version (bump when the packing changes)
# tiles below this go to the ELL straggler path
MIN_EDGES = 192


def _dedup(src: np.ndarray, dst: np.ndarray, n: int):
    key = src.astype(np.int64) * n + dst
    uniq = np.unique(key)
    return (uniq // n).astype(np.int32), (uniq % n).astype(np.int32)
