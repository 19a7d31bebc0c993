"""Strip-ordered bitmask SpMM — the aggregation kernel of the main path.

``out = A^T h`` for a 0/1 adjacency tiled into (BD=256 dst x BS=2048 src)
bitmask tiles (format: ``spmm_block``), plus an ELLPACK straggler
(``spmm_fast``) for the edges of sparse tiles. The backward pass runs the
same kernel on the pre-built REVERSE layout (the reference aggregating
gradients on its ``bwd_graph``, ``AdaQP/model/ops.py:83-95``).

Host side: :func:`strip_layout` packs the dense tiles exactly as the JAX
package's ``strip_layout`` does (masks in destination-block-major order).
When a layout reaches a CUDA device, :func:`strip_walk` derives there what
the CUDA kernel walks (a :class:`StripWalk`): each strip's schedule of source
windows with each destination block's tile in them (the idea of the JAX
package's ``w_ord``/``sub``/``mask_idx`` for its window ring, packed for
the kernel's grid), and every tile row's set columns decoded once into a
list, so that no column slice of a pass re-reads the masks.

Device side: :func:`strip_spmm` is the kernel wrapper. On a CUDA tensor it
launches the hand-written kernel (``csrc/spmm_strip.cu``), on a CPU tensor
it runs the plain PyTorch version :func:`_run_strip_torch`; there is no
fallback from one to the other. Numerics: both sum in f32 and round once to
``h.dtype``, so for bf16 ``h`` they differ only in summation order, and for
f32 ``h`` both are exact f32 sums. (The JAX package's accelerator kernel
also rounds f32 windows to bf16 before its matrix product; the port
follows the JAX package's portable twin there.)
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.backend import DeviceLike, resolve_device
from .spmm_block import (
    BD, BS, WORDS, ReverseSpmm, _dedup, block_pointers, check_cuda_operands,
    run_tiles_torch, with_straggler,
)
from .spmm_fast import EllDevice, EllLayout, ell_from_csr

SB = 8             # dst blocks per strip
SLICE_BYTES = 32   # bytes of a source row in one column slice of the CUDA kernel
GROUP = 16         # tile rows a warp of the CUDA kernel walks together
BATCH = 8          # columns a row in one batch of that walk (one 16-byte read)
STRIP = SB * BD    # 2048 dst rows: output rows are padded to this multiple
MIN_EDGES = 192
STRIP_SCHEME = 1   # cache-format version


@dataclass
class StripLayout:
    """Host-side dense bitmask tiles + ELL straggler."""

    n: int
    n_pad: int        # out rows, STRIP multiple
    n_src_pad: int    # h rows, BS multiple
    masks: np.ndarray     # int16 [max(T, 1), BD, WORDS] (one zero row if T=0)
    tile_src: np.ndarray  # int32 [T] tile window start row (BS multiple)
    tile_dst: np.ndarray  # int32 [T] tile dst block, ascending
    straggler: Optional[EllLayout]

    def to_device(self, device: DeviceLike = None) -> "StripDevice":
        dev = resolve_device(device)
        masks = torch.as_tensor(self.masks, device=dev)
        tile_src = torch.as_tensor(self.tile_src, device=dev)
        blk_ptr = torch.as_tensor(block_pointers(self.tile_dst, self.n_pad), device=dev)
        return StripDevice(
            self.n, self.n_pad, self.n_src_pad, masks, tile_src, blk_ptr,
            self.straggler.to_device(dev) if self.straggler else None,
            cuda_walk(masks, tile_src, blk_ptr),
        )


@dataclass
class StripWalk:
    """What the CUDA kernel walks, derived from a device layout's masks,
    tile_src and blk_ptr by :func:`strip_walk`. The rows of tile ``t`` go
    in groups of ``GROUP`` (a warp's rows): group ``g = t * BD // GROUP +
    i`` (rows ``GROUP i`` ..) holds ``grp_len[g]`` columns a row (its
    longest row's) in batches ``grp_ptr[g]`` .. ``grp_ptr[g + 1]`` of
    ``cols`` viewed as ``[batches, GROUP, BATCH]``: row ``GROUP i + p``'s
    columns of its window, ascending, at ``[:, p, :]``, padded with ``BS``
    (the kernel's zero row). Strip ``s`` (destination blocks ``SB s`` ..
    ``SB s + SB - 1``) takes steps ``strip_ptr[s]`` .. ``strip_ptr[s + 1]``;
    step ``k`` reads the window at row ``step_win[k]`` (ascending within a
    strip), where block ``SB s + b`` has tile ``step_tile[k, b]`` (-1 for
    none)."""

    grp_ptr: torch.Tensor    # int32 [T * BD // GROUP + 1]
    grp_len: torch.Tensor    # int32 [T * BD // GROUP]
    cols: torch.Tensor       # int16 [batches * GROUP * BATCH] (uint16 for the kernel)
    strip_ptr: torch.Tensor  # int32 [n_pad // STRIP + 1]
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


@dataclass
class StripDevice:
    """A strip layout's tensors on one device. Tiles ``blk_ptr[b]`` ..
    ``blk_ptr[b + 1]`` of ``masks``/``tile_src`` belong to destination
    block ``b``; rows of ``masks`` past ``blk_ptr[-1]`` are padding. The
    plain version reads the masks, the CUDA kernel ``walk``, which is built
    where a layout reaches a CUDA device."""

    n: int
    n_pad: int
    n_src_pad: int
    masks: torch.Tensor     # int16 [T', BD, WORDS], T' >= blk_ptr[-1]
    tile_src: torch.Tensor  # int32 [T'']
    blk_ptr: torch.Tensor   # int32 [n_pad // BD + 1]
    straggler: Optional[EllDevice]
    walk: Optional[StripWalk] = None  # what the CUDA kernel reads

    def to(self, device: DeviceLike) -> "StripDevice":
        masks, tile_src, blk_ptr = (x.to(device) for x in (self.masks, self.tile_src, self.blk_ptr))
        walk = (self.walk.to(device) if self.walk is not None
                else cuda_walk(masks, tile_src, blk_ptr))
        return StripDevice(
            self.n, self.n_pad, self.n_src_pad, masks, tile_src, blk_ptr,
            self.straggler.to(device) if self.straggler else None, walk,
        )


def strip_layout(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    min_edges: int = MIN_EDGES,
    cache_key: Optional[str] = None,
    dedup: bool = True,
    n_src: Optional[int] = None,
) -> StripLayout:
    """Build the dense-tile layout for edges src -> dst: ``n`` destination
    rows, ``n_src`` source rows (defaults to ``n``; halo groups are
    rectangular)."""
    from .spmm_fast import ell_cache_ok, ell_load_npz, ell_save_npz

    if cache_key and os.path.exists(cache_key + ".npz"):
        z = np.load(cache_key + ".npz")
        if (
            int(z.get("strip_scheme", 0)) == STRIP_SCHEME
            and ell_cache_ok(z)
            and int(z.get("min_edges", -1)) == min_edges
            and int(z["n"]) == n
        ):
            return StripLayout(
                int(z["n"]), int(z["n_pad"]), int(z["n_src_pad"]), z["masks"],
                z["tile_src"], z["tile_dst"], ell_load_npz(z),
            )

    if n_src is None:
        n_src = n
    if dedup:
        nn = max(n, n_src)
        src, dst = _dedup(src, dst, nn)
    elif len(src) and len(np.unique(src.astype(np.int64) * n + dst)) != len(src):
        raise ValueError(
            "strip layout requires a simple graph (duplicate edges found); "
            "deduplicate upstream or pass dedup=True"
        )
    n_pad = -(-n // STRIP) * STRIP
    n_src_pad = -(-n_src // BS) * BS

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

    straggler = None
    str_mask = np.zeros(len(src_s), bool)
    for ti in np.where(~dense)[0]:
        str_mask[tile_ptr[ti] : tile_ptr[ti + 1]] = True
    if str_mask.any():
        straggler = ell_from_csr(src_s[str_mask], dst_s[str_mask], n_pad)

    # pack dense tile masks in tile_key order: dst block major, window minor
    sel = np.where(dense)[0]
    t_sb = np.empty(len(sel), np.int64)
    t_tb = np.empty(len(sel), np.int64)
    masks_list = []
    for oi, ti in enumerate(sel):
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
        t_sb[oi] = b_src
        t_tb[oi] = b_dst
    if not masks_list:  # keep the mask array non-empty, like the reference's
        masks_list.append(np.zeros((BD, WORDS), np.uint16))
    masks = np.stack(masks_list).view(np.int16)
    tile_src = (t_sb * BS).astype(np.int32)
    tile_dst = t_tb.astype(np.int32)

    lay = StripLayout(n, n_pad, n_src_pad, masks, tile_src, tile_dst, straggler)
    if cache_key:
        os.makedirs(os.path.dirname(cache_key) or ".", exist_ok=True)
        save = dict(
            n=n, n_pad=n_pad, n_src_pad=n_src_pad, masks=masks,
            tile_src=tile_src, tile_dst=tile_dst,
            min_edges=min_edges, strip_scheme=STRIP_SCHEME,
        )
        ell_save_npz(save, straggler)
        np.savez(cache_key + ".npz", **save)
    return lay


# ---------------------------------------------------------------------------
# the walk arrays of the CUDA kernel
# ---------------------------------------------------------------------------

_WALK_TILES = 64  # tiles whose bits are expanded at once


def strip_columns(masks: torch.Tensor, n_tiles: int):
    """Each of the first ``n_tiles`` tiles' rows decoded into its set
    columns, ascending: ``(row_ptr int32 [n_tiles * BD + 1], cols int16)``
    on the masks' device (torch ops, ``_WALK_TILES`` tiles at a time)."""
    dev = masks.device
    shifts = torch.arange(16, dtype=torch.int32, device=dev)
    counts = torch.zeros(n_tiles * BD, dtype=torch.int64, device=dev)
    cols = []
    for s in range(0, n_tiles, _WALK_TILES):
        e = min(s + _WALK_TILES, n_tiles)
        words = masks[s:e].to(torch.int32) & 0xFFFF
        # column j is bit j // WORDS of halfword j % WORDS: planes major
        bits = ((words[..., None] >> shifts) & 1).bool().transpose(2, 3)
        ti, r, j = bits.reshape(e - s, BD, BS).nonzero(as_tuple=True)
        counts[s * BD:e * BD] = torch.bincount(ti * BD + r, minlength=(e - s) * BD)
        cols.append(j.to(torch.int16))
    total = int(counts.sum())
    if total >= 2 ** 31:
        raise ValueError(f"{total} tile edges overflow the int32 row pointers")
    row_ptr = torch.zeros(n_tiles * BD + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = counts.cumsum(0)
    cols = torch.cat(cols) if cols else torch.zeros(0, dtype=torch.int16, device=dev)
    return row_ptr, cols


def strip_schedule(tile_src: np.ndarray, blk_ptr: np.ndarray):
    """Each strip's source windows, ascending, and each of its ``SB``
    blocks' tile in them: ``(strip_ptr [n_strips + 1], step_win [S],
    step_tile [S, SB])`` int32, from the tiles of one layout (``blk_ptr``
    ranges, ``tile_src`` window starts, windows ascending within a block)."""
    blk_ptr = np.asarray(blk_ptr, np.int64)
    n_blocks = len(blk_ptr) - 1
    if n_blocks % SB:
        raise ValueError(f"{n_blocks} destination blocks are not whole strips of {SB}")
    t = int(blk_ptr[-1])
    tile_blk = np.repeat(np.arange(n_blocks), np.diff(blk_ptr))
    win = np.asarray(tile_src[:t], np.int64) // BS
    n_win = int(win.max()) + 1 if t else 1
    steps, step_of = np.unique(tile_blk // SB * n_win + win, return_inverse=True)
    step_tile = np.full((len(steps), SB), -1, np.int32)
    step_tile[step_of.reshape(-1), tile_blk % SB] = np.arange(t)
    strip_ptr = np.searchsorted(steps // n_win, np.arange(n_blocks // SB + 1))
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


def strip_walk(masks: torch.Tensor, tile_src: torch.Tensor, blk_ptr: torch.Tensor) -> StripWalk:
    """The CUDA kernel's walk arrays of one device layout, on its device:
    the column lists decoded from the masks there, the schedule from the
    (small) tile arrays on the host."""
    sched = strip_schedule(tile_src.cpu().numpy(), blk_ptr.cpu().numpy())
    groups = strip_groups(*strip_columns(masks, int(blk_ptr[-1])))
    return StripWalk(*groups, *(torch.as_tensor(a, device=masks.device) for a in sched))


def cuda_walk(masks: torch.Tensor, tile_src: torch.Tensor,
              blk_ptr: torch.Tensor) -> Optional[StripWalk]:
    """:func:`strip_walk` of a layout on a CUDA device; None elsewhere, where
    only the plain version runs, which reads the masks."""
    return strip_walk(masks, tile_src, blk_ptr) if masks.is_cuda else None


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _run_strip_torch(layout: StripDevice, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: each dense tile's product with
    its source window, summed in f32 at its destination block
    (:func:`~adaqp_tpu_torch.ops.spmm_block.run_tiles_torch`); a layout with
    no tiles gives zeros."""
    if h.shape[0] != layout.n_src_pad:
        raise ValueError(f"h has {h.shape[0]} rows, layout wants {layout.n_src_pad}")
    blk_ptr = layout.blk_ptr.to(torch.int64)
    tile_dst = torch.repeat_interleave(
        torch.arange(blk_ptr.numel() - 1, device=blk_ptr.device), blk_ptr.diff()
    )
    return run_tiles_torch(layout.masks, layout.tile_src, tile_dst, layout.n_pad, h)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("spmm_strip")
    if lib.adaqp_strip_spmm.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.adaqp_strip_spmm.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        lib.adaqp_strip_spmm.restype = ci
        lib.adaqp_strip_kernel_info.argtypes = [ci, ctypes.POINTER(ci)]
        lib.adaqp_strip_kernel_info.restype = ci
        lib.adaqp_cuda_error_string.argtypes = [ci]
        lib.adaqp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _run_strip_cuda(layout: StripDevice, h: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``h``'s device and current stream."""
    walk = layout.walk
    if walk is None:  # built where the layout reaches a CUDA device
        raise ValueError(f"the strip layout is on {layout.masks.device}, h on {h.device}")
    check_cuda_operands(h, layout.n_src_pad, (
        ("grp_ptr", walk.grp_ptr, torch.int32), ("grp_len", walk.grp_len, torch.int32),
        ("cols", walk.cols, torch.int16),
        ("strip_ptr", walk.strip_ptr, torch.int32), ("step_win", walk.step_win, torch.int32),
        ("step_tile", walk.step_tile, torch.int32),
    ))
    n_strips = layout.n_pad // STRIP
    if layout.n_pad % STRIP or layout.n_src_pad % BS or walk.strip_ptr.numel() != n_strips + 1:
        raise ValueError("layout shapes do not match n_pad")
    if walk.cols.data_ptr() % 16:
        raise ValueError("the column batches must be 16-byte aligned")
    f = h.shape[1]
    out = torch.empty((layout.n_pad, f), dtype=h.dtype, device=h.device)
    lib = _lib()
    rc = lib.adaqp_strip_spmm(
        *(x.data_ptr() for x in walk.tensors()), h.data_ptr(), out.data_ptr(),
        n_strips, layout.n_src_pad, f, int(h.dtype == torch.bfloat16),
        h.device.index, torch.cuda.current_stream(h.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(
            f"strip SpMM launch failed: {lib.adaqp_cuda_error_string(rc).decode()}"
        )
    strip_spmm.launches += 1
    return out


def strip_kernel_info(dtype: torch.dtype) -> dict:
    """The compiled kernel's registers a thread, static and dynamic
    shared-memory bytes, spill bytes a thread and columns a slice."""
    lib = _lib()
    info = (ctypes.c_int * 5)()
    rc = lib.adaqp_strip_kernel_info(int(dtype == torch.bfloat16), info)
    if rc:
        raise RuntimeError(f"strip kernel attributes: {lib.adaqp_cuda_error_string(rc).decode()}")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "spill_bytes", "columns"), info))


def strip_spmm(layout: StripDevice, h: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: the dense-tile part of ``A^T h`` in ``h.dtype``.

    CUDA ``h``: the hand-written kernel (each launch adds one to
    ``strip_spmm.launches``). CPU ``h``: the plain PyTorch version."""
    if h.device.type == "cuda":
        return _run_strip_cuda(layout, h)
    if h.device.type == "cpu":
        return _run_strip_torch(layout, h)
    raise ValueError(f"no strip SpMM for device {h.device}")


strip_spmm.launches = 0


def run_strip(layout: StripDevice, h: torch.Tensor) -> torch.Tensor:
    """out = A^T h in ``h.dtype``: the dense tiles plus the ELL straggler,
    which is accumulated in f32 and added in ``h.dtype``."""
    return with_straggler(strip_spmm(layout, h), layout.straggler, h)


def spmm_strip(layout_fwd: StripDevice, h: torch.Tensor, reverse: StripDevice) -> torch.Tensor:
    """A^T h with strip bitmask tiles; the backward runs the reverse layout
    through the same kernel (argument order of the JAX package's
    ``spmm_strip``)."""
    return ReverseSpmm.apply(h, run_strip, layout_fwd, reverse)
