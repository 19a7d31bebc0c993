"""Block bitmask SpMM (``spmm_impl=block``) and the tile format it shares
with the strip and compact layouts.

The adjacency is tiled into (BD=256 dst x BS=2048 src) blocks; every tile
holding >= ``min_edges`` edges is packed as a BITMASK of 16-bit halfwords,
int16 ``[BD, WORDS]``: column ``j`` of the tile lives at halfword
``j % WORDS``, bit ``j // WORDS``. Leftover edges in sparse tiles go to the
ELLPACK gather path (``spmm_fast``). The format is the JAX package's, so
layouts and caches built by either package are the same arrays.

Host side: :func:`block_layout` packs the tiles exactly as the JAX
package's ``block_layout`` does (tiles sorted by destination block, an
all-zero tile for every destination block that has none, windows
ascending within a block). Each destination block's tile range is
:func:`block_pointers`.

Device side: :func:`block_spmm` is the kernel wrapper. On a CUDA tensor it
launches the strip layout's window-stationary kernel
(``csrc/spmm_strip.cu``) on the layout's walk: the block layout holds the
strip layout's tiles, whose windows start at multiples of ``BS``, so its
tiles are the walk's tiles as they are (:func:`~.spmm_walk.strip_walk`,
built where the layout reaches a CUDA device); the all-zero tiles cost a
list of no columns. A non-square layout pads its rows to ``BD`` only; its
last strip is part-filled. On a CPU tensor the wrapper runs the plain
PyTorch version :func:`_run_block_torch`; there is no fallback from one to
the other. Both sum in f32 and round once to ``h.dtype``. (The JAX
package's accelerator kernel rounds f32 windows to bf16 before its matrix
product; the port follows its portable twin.)

Duplicate edges are not representable in a bitmask; layouts are built from
de-duplicated edge lists (all four reference datasets are simple graphs).
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..common.backend import DeviceLike, resolve_device
from ..utils.timer import span
from .spmm_fast import EllDevice, EllLayout, _run_ell, ell_from_csr
from .spmm_walk import BD, BS, WORDS, StripWalk, WalkedLayout, run_walk, strip_walk

MASK_SCHEME = 2  # cache-format version (bump when the packing changes)
# tiles below this go to the ELL straggler path
MIN_EDGES = 192
# tiles expanded at once by the plain versions (a [chunk, 256, 2048] f32 tile)
_PLAIN_TILES = 16


def _dedup(src: np.ndarray, dst: np.ndarray, n: int):
    key = src.astype(np.int64) * n + dst
    uniq = np.unique(key)
    return (uniq // n).astype(np.int32), (uniq % n).astype(np.int32)


def range_pointers(keys: np.ndarray, n_groups: int) -> np.ndarray:
    """int32 [n_groups + 1]: entries ``ptr[g]`` .. ``ptr[g + 1]`` of the
    ascending ``keys`` of one unpadded layout equal ``g``."""
    keys = np.asarray(keys)
    if len(keys) and (np.any(np.diff(keys) < 0) or keys[0] < 0 or keys[-1] >= n_groups):
        raise ValueError(f"keys must be ascending and in [0, {n_groups})")
    return np.searchsorted(keys, np.arange(n_groups + 1), side="left").astype(np.int32)


def block_pointers(tile_dst: np.ndarray, n_pad: int) -> np.ndarray:
    """int32 [n_pad // BD + 1] tile range per destination block, from the
    (ascending) per-tile destination blocks of one unpadded layout."""
    return range_pointers(tile_dst, n_pad // BD)


@dataclass
class BlockLayout:
    """Host-side block-sparse bitmask layout + ELL straggler layout.

    Rectangular in general: source rows (the ``h`` operand, padded to
    ``n_src_pad``) and destination rows (the output, padded to ``n_pad``)
    may differ — e.g. halo aggregation maps remote slots -> local rows.
    """

    n: int
    n_pad: int  # out rows padded to a BD multiple (BS multiple when square)
    masks: np.ndarray  # int16 [T, BD, WORDS]
    src_start: np.ndarray  # int32 [T]
    dst_blk: np.ndarray  # int32 [T], ascending
    is_first: np.ndarray  # int32 [T] (first tile of its dst block)
    straggler: Optional[EllLayout]
    n_src_pad: int = 0  # h rows (== n_pad when square)

    def __post_init__(self):
        if self.n_src_pad == 0:
            self.n_src_pad = self.n_pad

    def to_device(self, device: DeviceLike = None) -> "BlockDevice":
        dev = resolve_device(device)
        return BlockDevice(
            self.n, self.n_pad, self.n_src_pad,
            *(torch.as_tensor(a, device=dev) for a in (
                self.masks, self.src_start, self.dst_blk,
                block_pointers(self.dst_blk, self.n_pad))),
            self.straggler.to_device(dev) if self.straggler else None,
        ).with_walk()


@dataclass
class BlockDevice(WalkedLayout):
    """A block layout's tensors on one device. Tiles ``blk_ptr[b]`` ..
    ``blk_ptr[b + 1]`` belong to destination block ``b``; rows of the tile
    arrays past ``blk_ptr[-1]`` are shard padding and are never read. The
    plain version reads the masks, the CUDA kernel ``walk``, which is built
    where a layout reaches a CUDA device."""

    n: int
    n_pad: int
    n_src_pad: int
    masks: torch.Tensor  # int16 [T', BD, WORDS], T' >= blk_ptr[-1]
    src_start: torch.Tensor  # int32 [T']
    dst_blk: torch.Tensor  # int32 [T']
    blk_ptr: torch.Tensor  # int32 [n_pad // BD + 1]
    straggler: Optional[EllDevice]
    walk: Optional[StripWalk] = None  # what the CUDA kernel reads

    def build_walk(self) -> StripWalk:
        return strip_walk(self.masks, self.src_start, self.blk_ptr)

    def to(self, device: DeviceLike) -> "BlockDevice":
        return BlockDevice(
            self.n, self.n_pad, self.n_src_pad,
            *(x.to(device) for x in (self.masks, self.src_start, self.dst_blk, self.blk_ptr)),
            self.straggler.to(device) if self.straggler else None,
            None if self.walk is None else self.walk.to(device),
        ).with_walk()


def block_layout(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    min_edges: int = MIN_EDGES,
    cache_key: Optional[str] = None,
    dedup: bool = True,
    n_src: Optional[int] = None,
) -> BlockLayout:
    """Build the tile layout for edges src -> dst; ``n`` destination rows,
    ``n_src`` source rows (defaults to ``n`` — the square case)."""
    from .spmm_fast import ell_cache_ok, ell_load_npz, ell_save_npz

    z = None
    if cache_key and os.path.exists(cache_key + ".npz"):
        z = np.load(cache_key + ".npz")
        # legacy caches lack the min_edges key; treat missing as a match
        # (every cache key mangles min_edges into the filename)
        stale = (
            int(z.get("mask_scheme", 1)) != MASK_SCHEME
            or not ell_cache_ok(z)
            or int(z.get("min_edges", min_edges)) != min_edges
            or int(z["n"]) != n
        )
        if stale:
            z = None
    if z is not None:
        return BlockLayout(
            int(z["n"]), int(z["n_pad"]), z["masks"], z["src_start"],
            z["dst_blk"], z["is_first"], ell_load_npz(z),
            int(z.get("n_src_pad", z["n_pad"])),
        )

    square = n_src is None
    if n_src is None:
        n_src = n
    if dedup:
        nn = max(n, n_src)
        src, dst = _dedup(src, dst, nn)
    elif len(src) and len(np.unique(src.astype(np.int64) * n + dst)) != len(src):
        # a bitmask cannot represent edge multiplicity; silently dropping
        # duplicates would diverge from the segment path's semantics
        raise ValueError(
            "block layout requires a simple graph (duplicate edges found); "
            "deduplicate upstream or pass dedup=True"
        )
    n_pad = -(-n // BS) * BS if square else -(-n // BD) * BD
    n_src_pad = n_pad if square else -(-n_src // BS) * BS
    tb = dst.astype(np.int64) // BD
    sb = src.astype(np.int64) // BS
    tile_key = tb * (n_src_pad // BS) + sb
    order = np.argsort(tile_key, kind="stable")
    tile_key_s = tile_key[order]
    src_s, dst_s = src[order], dst[order]
    uniq_tiles, tile_ptr = np.unique(tile_key_s, return_index=True)
    tile_ptr = np.append(tile_ptr, len(tile_key_s))
    counts = np.diff(tile_ptr)

    dense = counts >= min_edges
    str_edges_mask = np.zeros(len(src_s), bool)
    for ti in np.where(~dense)[0]:
        str_edges_mask[tile_ptr[ti] : tile_ptr[ti + 1]] = True
    straggler = None
    if str_edges_mask.any():
        straggler = ell_from_csr(
            src_s[str_edges_mask], dst_s[str_edges_mask], n_pad
        )

    sel = np.where(dense)[0]
    n_blocks = n_pad // BD
    covered = np.zeros(n_blocks, bool)
    masks_list = []
    src_start = []
    dst_blk = []
    for ti in sel:
        key = uniq_tiles[ti]
        b_dst = int(key // (n_src_pad // BS))
        b_src = int(key % (n_src_pad // BS))
        sl = slice(tile_ptr[ti], tile_ptr[ti + 1])
        i = (dst_s[sl] - b_dst * BD).astype(np.int64)
        j = (src_s[sl] - b_src * BS).astype(np.int64)
        m = np.zeros(BD * WORDS, np.uint16)
        np.bitwise_or.at(
            m, i * WORDS + j % WORDS, np.uint16(1) << (j // WORDS).astype(np.uint16)
        )
        masks_list.append(m.reshape(BD, WORDS))
        src_start.append(b_src * BS)
        dst_blk.append(b_dst)
        covered[b_dst] = True
    # every dst block gets at least one (maybe all-zero) tile, as in the
    # JAX package, whose kernel zero-initialises a block on its first tile
    for b in np.where(~covered)[0]:
        masks_list.append(np.zeros((BD, WORDS), np.uint16))
        src_start.append(0)
        dst_blk.append(int(b))
    if not masks_list:  # completely empty graph
        masks_list.append(np.zeros((BD, WORDS), np.uint16))
        src_start.append(0)
        dst_blk.append(0)
    masks = np.stack(masks_list).view(np.int16)
    src_start = np.asarray(src_start, np.int32)
    dst_blk = np.asarray(dst_blk, np.int32)
    order = np.argsort(dst_blk, kind="stable")
    masks, src_start, dst_blk = masks[order], src_start[order], dst_blk[order]
    is_first = np.ones(len(dst_blk), np.int32)
    is_first[1:] = (dst_blk[1:] != dst_blk[:-1]).astype(np.int32)

    lay = BlockLayout(n, n_pad, masks, src_start, dst_blk, is_first, straggler, n_src_pad)
    if cache_key:
        os.makedirs(os.path.dirname(cache_key) or ".", exist_ok=True)
        save = dict(
            n=n, n_pad=n_pad, n_src_pad=n_src_pad, masks=masks,
            src_start=src_start, dst_blk=dst_blk, is_first=is_first,
            min_edges=min_edges, mask_scheme=MASK_SCHEME,
        )
        ell_save_npz(save, straggler)
        np.savez(cache_key + ".npz", **save)
    return lay


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def expand_masks(words: torch.Tensor) -> torch.Tensor:
    """int16 [c, BD, WORDS] masks -> 0/1 f32 [c, BD, BS] (column j is bit
    ``j // WORDS`` of halfword ``j % WORDS``)."""
    shifts = torch.arange(16, dtype=torch.int32, device=words.device)
    bits = ((words.to(torch.int32) & 0xFFFF)[..., None] >> shifts) & 1  # [c, BD, WORDS, 16]
    return bits.transpose(2, 3).reshape(words.shape[0], BD, BS).to(torch.float32)


def run_tiles_torch(masks: torch.Tensor, src_start: torch.Tensor, tile_dst: torch.Tensor,
                    n_pad: int, h: torch.Tensor,
                    expand: Callable[[torch.Tensor], torch.Tensor] = expand_masks,
                    ) -> torch.Tensor:
    """Plain ``A^T h`` over the first ``len(tile_dst)`` tiles: expand each
    tile's bits (``expand``: int16 [c, BD, WORDS] -> f32 [c, BD, BS]),
    multiply with its source window in f32, ``index_add_`` into the f32
    output at its destination block, and round once to ``h.dtype``. Tiles
    go ``_PLAIN_TILES`` at a time, so all masks are never expanded at once;
    no tile gives zeros."""
    dev, f = h.device, h.shape[1]
    out = torch.zeros((n_pad, f), dtype=torch.float32, device=dev)
    win = torch.arange(BS, device=dev)
    rows = torch.arange(BD, device=dev)
    tile_dst = tile_dst.to(dev, torch.int64)
    for s in range(0, tile_dst.numel(), _PLAIN_TILES):
        e = min(s + _PLAIN_TILES, tile_dst.numel())
        a = expand(masks[s:e].to(dev))
        src_rows = src_start[s:e].to(dev, torch.int64)[:, None] + win
        tile_out = torch.bmm(a, h[src_rows].to(torch.float32))  # [c, BD, F]
        dst_rows = (tile_dst[s:e, None] * BD + rows).reshape(-1)
        out.index_add_(0, dst_rows, tile_out.reshape(-1, f))
    return out.to(h.dtype)


def _run_block_torch(layout: BlockDevice, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX package's
    ``_run_block_jnp``): every tile's product added at its ``dst_blk``."""
    if h.shape[0] != layout.n_src_pad:
        raise ValueError(f"h has {h.shape[0]} rows, layout wants {layout.n_src_pad}")
    t = int(layout.blk_ptr[-1])
    return run_tiles_torch(layout.masks, layout.src_start, layout.dst_blk[:t], layout.n_pad, h)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _run_block_cuda(layout: BlockDevice, h: torch.Tensor) -> torch.Tensor:
    """Launch the window-stationary kernel on ``h``'s device and current
    stream."""
    out = run_walk(layout, h, "block")
    block_spmm.launches += 1
    return out


def block_spmm(layout: BlockDevice, h: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: the tile part of ``A^T h`` in ``h.dtype``.

    CUDA ``h``: the hand-written kernel (each launch adds one to
    ``block_spmm.launches``). CPU ``h``: the plain PyTorch version. Both
    inside the span ``adaqp.tile``."""
    with span("adaqp.tile"):
        if h.device.type == "cuda":
            return _run_block_cuda(layout, h)
        if h.device.type == "cpu":
            return _run_block_torch(layout, h)
    raise ValueError(f"no block SpMM for device {h.device}")


block_spmm.launches = 0


def with_straggler(out: torch.Tensor, straggler: Optional[EllDevice],
                   h: torch.Tensor) -> torch.Tensor:
    """``out`` plus the ELL straggler's sums, accumulated in f32 and added
    in ``h.dtype``: the ELL tail, inside the span ``adaqp.ell``."""
    if straggler is None:
        return out
    with span("adaqp.ell"):
        return out + _run_ell(straggler, h, acc_dtype=torch.float32).to(h.dtype)


def run_block(layout: BlockDevice, h: torch.Tensor) -> torch.Tensor:
    """out = A^T h in ``h.dtype``: the tiles plus the ELL straggler."""
    return with_straggler(block_spmm(layout, h), layout.straggler, h)


class ReverseSpmm(torch.autograd.Function):
    """``run(layout_fwd, h)``, whose backward runs ``run(reverse, g)`` (the
    reference aggregating gradients on its prebuilt ``bwd_graph``,
    ``AdaQP/model/ops.py:83-95``) and returns the gradient in ``h``'s
    dtype. ``part``: the span the forward runs in (``adaqp.central`` or
    ``adaqp.marginal``), which the backward opens too; None opens none."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, run: Callable, layout_fwd, reverse,
                part: Optional[str] = None):
        ctx.run, ctx.reverse, ctx.h_dtype, ctx.part = run, reverse, h.dtype, part
        return run(layout_fwd, h)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        with span(ctx.part) if ctx.part else contextlib.nullcontext():
            gh = ctx.run(ctx.reverse, g.to(ctx.h_dtype).contiguous())
        return gh.to(ctx.h_dtype), None, None, None, None


def spmm_block(layout_fwd: BlockDevice, h: torch.Tensor, reverse: BlockDevice,
               part: Optional[str] = None) -> torch.Tensor:
    """A^T h with bitmask tiles; the backward runs the reverse layout
    (argument order of the JAX package's ``spmm_block``) inside the span
    ``part`` (:class:`ReverseSpmm`)."""
    return ReverseSpmm.apply(h, run_block, layout_fwd, reverse, part)
