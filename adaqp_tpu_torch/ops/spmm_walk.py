"""The window-stationary walk: what the tile kernel of every tile layout reads.

The strip, block and compact layouts (``spmm_strip``, ``spmm_block``,
``spmm_compact``) all compute ``out = A^T h`` over 0/1 regions of 256
destination rows by one 2048-row source window, and on the card all three
launch one kernel (``csrc/spmm_strip.cu``). It reads a :class:`StripWalk`:

- **walk tiles**, at most one for each (destination block, window): each
  tile row's set columns, window-local and ascending, decoded once per
  layout into column lists laid out for the kernel's warps
  (:func:`strip_groups`);
- **a schedule** (:func:`strip_schedule`): each strip of ``SB`` destination
  blocks' windows, ascending, and each block's walk tile in them, so that a
  CTA copies a window slice into shared memory once and applies it to all
  the strip's blocks.

A strip or block layout's tiles are walk tiles as they are
(:func:`strip_walk`); a compact layout's items decode into them, the
subtiles that land on one (strip, window, block) merged into one tile
(:func:`compact_walk`). The walk is built with torch ops where a layout
reaches a CUDA device (:class:`WalkedLayout`); on the CPU only the plain
versions run, which read the masks. :func:`run_walk` launches the kernel.

On an NVIDIA H100 80GB HBM3 (700 W; ``chip_smoke.py``, the products
forward local layout of 131,072 nodes) :func:`compact_walk` decodes the
1,116 items into 3,968 walk tiles over 579 window steps in 0.022-0.056 s,
and :func:`strip_walk` the block layout's 2,043 tiles (278 steps) in
0.021-0.023 s.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..common.backend import DeviceLike
from ..utils.cuda_build import raise_on

# the tile format (see spmm_block): BD destination rows x BS source rows,
# row j of the window at halfword j % WORDS, bit j // WORDS of a tile row
BD = 256
BS = 2048
WORDS = BS // 16
SB = 8             # dst blocks per strip: a CTA of the kernel takes one strip
STRIP = SB * BD    # 2048 dst rows
SLICE_BYTES = 32   # bytes of a source row in one column slice of the kernel
GROUP = 16         # tile rows a warp of the kernel walks together
BATCH = 8          # columns a row in one batch of that walk (one 16-byte read)
CSUB = 256         # virtual columns of a compact subtile

_WALK_TILES = 64  # tiles (or items) whose bits are expanded at once


@dataclass
class StripWalk:
    """What the CUDA kernel walks. The rows of walk tile ``t`` go in groups
    of ``GROUP`` (a warp's rows): group ``g = t * BD // GROUP + i`` (rows
    ``GROUP i`` ..) holds ``grp_len[g]`` columns a row (its longest row's)
    in batches ``grp_ptr[g]`` .. ``grp_ptr[g + 1]`` of ``cols`` viewed as
    ``[batches, GROUP, BATCH]``: row ``GROUP i + p``'s columns of its
    window, ascending, at ``[:, p, :]``, padded with ``BS`` (the kernel's
    zero row). Strip ``s`` (destination blocks ``SB s`` .. ``SB s + SB -
    1``) takes steps ``strip_ptr[s]`` .. ``strip_ptr[s + 1]``; step ``k``
    reads the window at row ``step_win[k]`` (ascending within a strip),
    where block ``SB s + b`` has walk tile ``step_tile[k, b]`` (-1 for
    none)."""

    grp_ptr: torch.Tensor    # int32 [T * BD // GROUP + 1]
    grp_len: torch.Tensor    # int32 [T * BD // GROUP]
    cols: torch.Tensor       # int16 [batches * GROUP * BATCH] (uint16 for the kernel)
    strip_ptr: torch.Tensor  # int32 [ceil(n_pad / STRIP) + 1]
    step_win: torch.Tensor   # int32 [S]
    step_tile: torch.Tensor  # int32 [S, SB]

    def tensors(self):
        return (self.grp_ptr, self.grp_len, self.cols, self.strip_ptr, self.step_win,
                self.step_tile)

    def to(self, device: DeviceLike) -> "StripWalk":
        return StripWalk(*(x.to(device) for x in self.tensors()))

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self.tensors())


def _set_bits(masks: torch.Tensor) -> torch.Tensor:
    """int16 [c, BD, WORDS] masks -> bool [c, BD, BS] (column j is bit
    ``j // WORDS`` of halfword ``j % WORDS``: planes major)."""
    shifts = torch.arange(16, dtype=torch.int32, device=masks.device)
    words = masks.to(torch.int32) & 0xFFFF
    bits = ((words[..., None] >> shifts) & 1).bool().transpose(2, 3)
    return bits.reshape(masks.shape[0], BD, BS)


def _row_pointers(counts: torch.Tensor) -> torch.Tensor:
    total = int(counts.sum())
    if total >= 2 ** 31:
        raise ValueError(f"{total} tile edges overflow the int32 row pointers")
    row_ptr = torch.zeros(counts.numel() + 1, dtype=torch.int32, device=counts.device)
    row_ptr[1:] = counts.cumsum(0)
    return row_ptr


def strip_columns(masks: torch.Tensor, n_tiles: int):
    """Each of the first ``n_tiles`` tiles' rows decoded into its set
    columns, ascending: ``(row_ptr int32 [n_tiles * BD + 1], cols int16)``
    on the masks' device (torch ops, ``_WALK_TILES`` tiles at a time)."""
    dev = masks.device
    counts = torch.zeros(n_tiles * BD, dtype=torch.int64, device=dev)
    cols = []
    for s in range(0, n_tiles, _WALK_TILES):
        e = min(s + _WALK_TILES, n_tiles)
        ti, r, j = _set_bits(masks[s:e]).nonzero(as_tuple=True)
        counts[s * BD:e * BD] = torch.bincount(ti * BD + r, minlength=(e - s) * BD)
        cols.append(j.to(torch.int16))
    cols = torch.cat(cols) if cols else torch.zeros(0, dtype=torch.int16, device=dev)
    return _row_pointers(counts), cols


def strip_schedule(tile_src: np.ndarray, blk_ptr: np.ndarray):
    """Each strip's source windows, ascending, and each of its ``SB``
    blocks' tile in them: ``(strip_ptr [n_strips + 1], step_win [S],
    step_tile [S, SB])`` int32, from the tiles of one layout (``blk_ptr``
    ranges, ``tile_src`` window starts, at most one tile a window and
    windows ascending within a block). A last strip of fewer than ``SB``
    blocks (a layout whose rows are padded to ``BD`` only) is filled with
    blocks that have no tile."""
    blk_ptr = np.asarray(blk_ptr, np.int64)
    n_blocks = len(blk_ptr) - 1
    n_strips = -(-n_blocks // SB)
    blk_ptr = np.concatenate([blk_ptr, np.full(n_strips * SB - n_blocks, blk_ptr[-1])])
    t = int(blk_ptr[-1])
    tile_blk = np.repeat(np.arange(n_strips * SB), np.diff(blk_ptr))
    win = np.asarray(tile_src[:t], np.int64) // BS
    n_win = int(win.max()) + 1 if t else 1
    steps, step_of = np.unique(tile_blk // SB * n_win + win, return_inverse=True)
    step_tile = np.full((len(steps), SB), -1, np.int32)
    step_tile[step_of.reshape(-1), tile_blk % SB] = np.arange(t)
    strip_ptr = np.searchsorted(steps // n_win, np.arange(n_strips + 1))
    return (strip_ptr.astype(np.int32), (steps % n_win * BS).astype(np.int32), step_tile)


def strip_groups(row_ptr: torch.Tensor, cols: torch.Tensor):
    """Per-row column lists (:func:`strip_columns`) laid out for the
    kernel's warps: ``(grp_ptr int32 [G + 1], grp_len int32 [G], cols int16
    [batches * GROUP * BATCH])`` for the ``G`` groups of ``GROUP`` rows
    (torch ops, on the lists' device)."""
    dev = cols.device
    lens = row_ptr.diff().long()
    grp_len = lens.view(-1, GROUP).amax(1)
    grp_ptr = torch.zeros(grp_len.numel() + 1, dtype=torch.int64, device=dev)
    grp_ptr[1:] = ((grp_len + BATCH - 1) // BATCH).cumsum(0)
    if int(grp_ptr[-1]) * GROUP * BATCH >= 2 ** 31:
        raise ValueError("the column batches overflow the kernel's int32 offsets")
    out = torch.full((int(grp_ptr[-1]) * GROUP * BATCH,), BS, dtype=torch.int16, device=dev)
    row = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens)
    i = torch.arange(row.numel(), device=dev) - row_ptr[row].long()
    out[(grp_ptr[row // GROUP] + i // BATCH) * (GROUP * BATCH) + row % GROUP * BATCH
        + i % BATCH] = cols
    return grp_ptr.to(torch.int32), grp_len.to(torch.int32), out


def _walk(row_ptr, cols, tile_src, blk_ptr) -> StripWalk:
    """The walk of tiles given as row lists, window starts and block
    ranges; the schedule from the (small) tile arrays on the host."""
    sched = strip_schedule(tile_src.cpu().numpy(), blk_ptr.cpu().numpy())
    return StripWalk(*strip_groups(row_ptr, cols),
                     *(torch.as_tensor(a, device=cols.device) for a in sched))


def strip_walk(masks: torch.Tensor, tile_src: torch.Tensor, blk_ptr: torch.Tensor) -> StripWalk:
    """The walk of a strip or block layout on its device: its tiles
    (``blk_ptr`` ranges of ``masks`` and ``tile_src``, one a window within
    a block, windows ascending) are the walk tiles."""
    return _walk(*strip_columns(masks, int(blk_ptr[-1])), tile_src, blk_ptr)


def compact_walk(kind: torch.Tensor, masks: torch.Tensor, col_idx: torch.Tensor,
                 src_start: torch.Tensor, dst_off: torch.Tensor,
                 item_ptr: torch.Tensor) -> StripWalk:
    """The walk of a compact layout on its device (torch ops). Set bit
    ``(r, v)`` of item ``i`` of strip ``st`` reads window row ``v`` (kind 0)
    or ``col_idx[i, v]`` (kind 1) and lands at row ``r`` of destination
    block ``SB st + dst_off[i, s] // BD`` (``s = 0`` for kind 0, ``v //
    CSUB`` for kind 1). Every bit of one (block, window) goes to one walk
    tile, its rows' columns ascending: the subtiles of every item that
    lands there merge (a region's occupied columns are distinct, so a row
    holds at most ``BS``). Walk tiles go in (block, window) order."""
    dev = masks.device
    item_ptr = item_ptr.long()
    t = int(item_ptr[-1])
    n_blocks = (item_ptr.numel() - 1) * SB
    strip = torch.repeat_interleave(torch.arange(n_blocks // SB, device=dev), item_ptr.diff())
    if (dst_off[:t] % BD).any():
        raise ValueError("compact subtiles must land on whole destination blocks")
    n_win = int(src_start[:t].max()) // BS + 1 if t else 1
    keys, rows, cols = [], [], []
    for s in range(0, t, _WALK_TILES):
        e = min(s + _WALK_TILES, t)
        ti, r, v = _set_bits(masks[s:e]).nonzero(as_tuple=True)
        it = s + ti
        grp = kind[it] == 1
        slot = torch.where(grp, v // CSUB, 0)
        blk = strip[it] * SB + dst_off[it, slot].long() // BD
        keys.append(blk * n_win + src_start[it].long() // BS)
        rows.append(r)
        cols.append(torch.where(grp, col_idx[it, v].long(), v))
    if keys:
        key, r, col = torch.cat(keys), torch.cat(rows), torch.cat(cols)
    else:
        key = r = col = torch.zeros(0, dtype=torch.int64, device=dev)
    tiles, tile_of = torch.unique(key, return_inverse=True)  # ascending: (block, window)
    row = tile_of * BD + r
    order = torch.argsort(row * BS + col)
    counts = torch.bincount(row, minlength=tiles.numel() * BD)
    blk_ptr = torch.searchsorted(tiles // n_win, torch.arange(n_blocks + 1, device=dev))
    return _walk(_row_pointers(counts), col[order].to(torch.int16), tiles % n_win * BS, blk_ptr)


class WalkedLayout:
    """What the device layouts of the strip, block and compact paths share
    (dataclasses with ``masks`` and ``walk`` fields): the plain version
    reads the layout, the CUDA kernel ``walk``, which :meth:`build_walk`
    decodes where the layout lies on a CUDA device (on the CPU nothing
    decodes lists that nobody reads)."""

    def build_walk(self) -> StripWalk:
        raise NotImplementedError

    def with_walk(self):
        """This layout, with its walk where it lies on a CUDA device."""
        if self.walk is not None or not self.masks.is_cuda:
            return self
        return dataclasses.replace(self, walk=self.build_walk())


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def check_cuda_operands(h: torch.Tensor, n_src_pad: int,
                        tensors: Sequence[tuple]) -> None:
    """Raise unless ``h`` is a contiguous, 16-byte aligned bf16/f32
    ``[n_src_pad, F]`` matrix whose rows are whole 16-byte vectors, and each
    ``(name, tensor, dtype)`` a contiguous tensor of that dtype on its
    device — what the tile kernels take."""
    if h.dim() != 2 or h.shape[0] != n_src_pad:
        raise ValueError(f"h must be [{n_src_pad}, F], got {tuple(h.shape)}")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"h must be bfloat16 or float32, got {h.dtype}")
    f = h.shape[1]
    vec = 8 if h.dtype == torch.bfloat16 else 4  # values per 16-byte load
    if f % vec or not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError(
            f"h must be contiguous, 16-byte aligned, with F % {vec} == 0 (F={f})"
        )
    for name, x, dt in tensors:
        if x.device != h.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(
                f"layout {name} must be contiguous {dt} on {h.device}, "
                f"got {x.dtype} on {x.device}"
            )


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("spmm_strip")
    if lib.adaqp_strip_spmm.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.adaqp_strip_spmm.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        lib.adaqp_strip_spmm.restype = ci
        lib.adaqp_strip_kernel_info.argtypes = [ci, ctypes.POINTER(ci)]
        lib.adaqp_strip_kernel_info.restype = ci
        lib.adaqp_cuda_error_string.argtypes = [ci]
        lib.adaqp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def run_walk(layout, h: torch.Tensor, what: str) -> torch.Tensor:
    """Launch the kernel on ``layout.walk`` (a strip, block or compact
    device layout: ``n_pad`` output rows, ``n_src_pad`` rows of ``h``) on
    ``h``'s device and current stream: ``out [n_pad, F]`` in ``h.dtype``.
    Raises when the layout carries no walk (it is built where a layout
    reaches a CUDA device) or the operands are not what the kernel takes."""
    walk = layout.walk
    if walk is None:
        raise ValueError(f"the {what} layout is on {layout.masks.device}, h on {h.device}")
    check_cuda_operands(h, layout.n_src_pad, (
        ("grp_ptr", walk.grp_ptr, torch.int32), ("grp_len", walk.grp_len, torch.int32),
        ("cols", walk.cols, torch.int16),
        ("strip_ptr", walk.strip_ptr, torch.int32), ("step_win", walk.step_win, torch.int32),
        ("step_tile", walk.step_tile, torch.int32),
    ))
    n_strips = -(-layout.n_pad // STRIP)
    if layout.n_pad % BD or layout.n_src_pad % BS or walk.strip_ptr.numel() != n_strips + 1:
        raise ValueError("layout shapes do not match n_pad")
    if walk.cols.data_ptr() % 16:
        raise ValueError("the column batches must be 16-byte aligned")
    f = h.shape[1]
    out = torch.empty((layout.n_pad, f), dtype=h.dtype, device=h.device)
    lib = _lib()
    rc = lib.adaqp_strip_spmm(
        *(x.data_ptr() for x in walk.tensors()), h.data_ptr(), out.data_ptr(),
        n_strips, layout.n_pad, layout.n_src_pad, f, int(h.dtype == torch.bfloat16),
        h.device.index, torch.cuda.current_stream(h.device).cuda_stream,
    )
    raise_on(lib.adaqp_cuda_error_string, rc, f"{what} SpMM")
    return out


def walk_kernel_info(dtype: torch.dtype) -> dict:
    """The compiled kernel's registers a thread, static and dynamic
    shared-memory bytes, spill bytes a thread and columns a slice."""
    lib = _lib()
    info = (ctypes.c_int * 5)()
    rc = lib.adaqp_strip_kernel_info(int(dtype == torch.bfloat16), info)
    if rc:
        raise RuntimeError(f"strip kernel attributes: {lib.adaqp_cuda_error_string(rc).decode()}")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "spill_bytes", "columns"), info))
