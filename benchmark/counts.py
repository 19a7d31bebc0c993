"""The benchmark's yardstick: operations and bytes of the work, from the
graph's edges, rows and widths, and the peaks of one NVIDIA H100 SXM.

Nothing here reads the program's walk arrays or knows its kernels' designs:
a redesigned kernel or walk is held to the same work.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

# one H100 SXM, NVIDIA's data sheet, dense, at a 700 W power limit
PEAK_BF16_FLOP_S = 989e12
PEAK_BYTES_S = 3.35e12

# the tile format the program's tile layouts hold their edges in: tiles of
# TILE_ROWS destination rows by TILE_COLS source rows, each row TILE_WORDS
# 16-bit words, column j being bit j // TILE_WORDS of word j % TILE_WORDS
TILE_ROWS, TILE_COLS = 256, 2048
TILE_WORDS = TILE_COLS // 16
COLUMN_INDEX_BYTES = 4


def tile_work(masks: torch.Tensor, tile_src: torch.Tensor, tiles: int, n_src: int,
              chunk: int = 32) -> Tuple[int, int]:
    """(edges, distinct source rows) of the first ``tiles`` tiles of a tile
    layout: ``masks`` int16 [T, TILE_ROWS, TILE_WORDS], ``tile_src`` each
    tile's first source row, ``n_src`` the source rows there are."""
    dev = masks.device
    seen = torch.zeros(n_src + TILE_COLS, dtype=torch.bool, device=dev)
    bit = torch.arange(16, device=dev, dtype=torch.int32)
    col = bit[:, None] * TILE_WORDS + torch.arange(TILE_WORDS, device=dev)[None, :]
    edges = 0
    for s in range(0, tiles, chunk):
        m = masks[s:min(tiles, s + chunk)].to(torch.int32) & 0xFFFF
        bits = (m[:, :, None, :] >> bit[None, None, :, None]) & 1  # [t, rows, 16, words]
        edges += int(bits.sum())
        hit = bits.amax(dim=1).bool()  # the tile's occupied columns
        rows = tile_src[s:s + m.shape[0]].long()[:, None, None] + col[None]
        seen[rows[hit]] = True
    return edges, int(seen[:n_src].sum())


def gather_bytes(edges: int, src_rows: int, out_rows: int, width: int, elt: int) -> int:
    """Least bytes of one sparse aggregation ``out = A^T h``: each edge's
    column index once, each distinct source row it reads once, each output
    row written once, rows ``width`` elements of ``elt`` bytes."""
    return COLUMN_INDEX_BYTES * edges + (src_rows + out_rows) * width * elt


def epoch_flops(nodes: int, edges: int, dims: Sequence[Tuple[int, int]],
                products_per_layer: int) -> int:
    """Model operations of one full-graph training epoch of a GNN whose
    layer i aggregates its input (``dims[i][0]`` wide) over ``edges``
    directed edges and multiplies ``products_per_layer`` matrices
    ``[nodes, din] @ [din, dout]`` (GCN 1; GraphSAGE-mean 2, the self and
    the neighbour term). Forward, then backward: each product's weight
    gradient, and its input gradient except in layer 0, whose input (the
    features) needs none; each aggregation again in the backward except in
    layer 0. Recomputation is not counted."""
    total = 0
    for i, (din, dout) in enumerate(dims):
        back = i > 0
        dense = 2 * nodes * din * dout * products_per_layer
        total += dense * (2 + int(back))  # forward, weight gradient, input gradient
        total += 2 * edges * din * (1 + int(back))  # forward and backward sums
    return total


def mfu_pct(flops_per_epoch: float, epoch_s: float, chips: int) -> float:
    return 100.0 * flops_per_epoch / epoch_s / (PEAK_BF16_FLOP_S * chips)


def roofline_pct(nbytes: float, device_s: float) -> float:
    return 100.0 * (nbytes / PEAK_BYTES_S) / device_s
