"""Compact-column block-sparse SpMM (``spmm_impl=compact``).

Work items are ordered by (destination STRIP of 2048 rows, source window
of 2048 rows, kind), and each region (256 destination rows x one window)
is placed in one of three tiers by its edge count and occupied columns:

  kind 0 (FULL):  a region with more than ``full_cols`` occupied source
                  columns keeps its full [256, 2048] bitmask tile, added at
                  its strip row ``dst_off[0]``.
  kind 1 (GROUP): a sparser region's occupied columns are split into
                  compact subtiles of up to 256 columns; eight subtiles of
                  one (strip, window) share an item, whose ``col_idx`` maps
                  each of its 2048 virtual columns to a window row, and
                  subtile ``s`` (virtual columns [256 s, 256 (s + 1)), bit
                  planes 2s and 2s+1) lands at its own strip row
                  ``dst_off[s]``.
  ELL tail:       regions under ``me_ell`` edges ride the ELLPACK gather
                  path (``spmm_fast``).

The format is the JAX package's (``compact_layout`` builds the same 14
arrays), so layouts and caches of either package are the same. The
per-item ``new_window``/``wslot``/``strip_first``/``strip_last`` flags drive
the TPU kernel's window ring and stay in :class:`CompactLayout`; the device
layout keeps each strip's item range, :func:`item_pointers`.

Device side: :func:`compact_spmm` is the kernel wrapper. On a CUDA tensor
it launches the strip layout's window-stationary kernel
(``csrc/spmm_strip.cu``) on the layout's walk: the TPU kernel is
window-stationary already (items sorted by strip and window), and each item
decodes into window-local column lists for each destination row, the
subtiles that land on one (strip, window, block) merged into one walk tile
(:func:`~.spmm_walk.compact_walk`, built where the layout reaches a CUDA
device). A CPU tensor takes the plain PyTorch version
:func:`_run_compact_torch`; there is no fallback from one to the other.
:func:`gather_rows` is the row-gather probe's kernel wrapper, and
:func:`dynamic_gather_supported` the gate the Trainer runs before the
compact path on the card. Semantics match ``spmm_block``: out = A^T h over
deduplicated edges, summed in f32 and rounded once to ``h.dtype``; the
backward runs the reverse layout.
"""
from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..common.backend import DeviceLike, resolve_device
from ..utils.cuda_build import raise_on
from .spmm_block import (
    _PLAIN_TILES, ReverseSpmm, _dedup, expand_masks, range_pointers, with_straggler,
)
from .spmm_fast import EllDevice, EllLayout, ell_from_csr
from .spmm_walk import (
    BD, BS, CSUB, SB, STRIP, WORDS, StripWalk, WalkedLayout, compact_walk, run_walk,
)

GROUP = BS // CSUB  # subtiles per group (8)
COMPACT_SCHEME = 1  # cache-format version

# tiering defaults
ME_ELL = 64       # regions below this edge count go to the ELLPACK tail
FULL_COLS = 1024  # regions with more occupied columns stay full-bitmask


@dataclass
class CompactLayout:
    """Host-side compact/full/ELL three-tier layout (see module doc)."""

    n: int
    n_pad: int        # out rows padded to a STRIP multiple
    n_src_pad: int    # h rows padded to a BS multiple
    kind: np.ndarray       # int32 [T] (0 full, 1 group)
    masks: np.ndarray      # int16 [T, BD, WORDS]
    col_idx: np.ndarray    # int32 [T, BS] window-local gather columns
    src_start: np.ndarray  # int32 [T] window start row
    strip_id: np.ndarray   # int32 [T], ascending
    new_window: np.ndarray  # int32 [T] (TPU window ring: DMA this item's window)
    wslot: np.ndarray       # int32 [T] (TPU window ring: buffer slot)
    strip_first: np.ndarray  # int32 [T] (TPU: zero the strip accumulator)
    strip_last: np.ndarray   # int32 [T] (TPU: flush the accumulator)
    dst_off: np.ndarray    # int32 [T, GROUP] row offset in strip per subtile
    nsub: np.ndarray       # int32 [T] used subtile slots (kind-1 items)
    straggler: Optional[EllLayout]

    def to_device(self, device: DeviceLike = None) -> "CompactDevice":
        dev = resolve_device(device)
        arrays = (self.kind, self.masks, self.col_idx, self.src_start, self.dst_off,
                  self.nsub, item_pointers(self.strip_id, self.n_pad))
        return CompactDevice(
            self.n, self.n_pad, self.n_src_pad,
            *(torch.as_tensor(a, device=dev) for a in arrays),
            self.straggler.to_device(dev) if self.straggler else None,
        ).with_walk()


@dataclass
class CompactDevice(WalkedLayout):
    """A compact layout's tensors on one device. Items ``item_ptr[st]`` ..
    ``item_ptr[st + 1]`` belong to strip ``st``; rows of the item arrays
    past ``item_ptr[-1]`` are shard padding and are never read. The plain
    version reads the items, the CUDA kernel ``walk``, which is built where
    a layout reaches a CUDA device."""

    n: int
    n_pad: int
    n_src_pad: int
    kind: torch.Tensor       # int32 [T']
    masks: torch.Tensor      # int16 [T', BD, WORDS]
    col_idx: torch.Tensor    # int32 [T', BS]
    src_start: torch.Tensor  # int32 [T']
    dst_off: torch.Tensor    # int32 [T', GROUP]
    nsub: torch.Tensor       # int32 [T']
    item_ptr: torch.Tensor   # int32 [n_pad // STRIP + 1]
    straggler: Optional[EllDevice]
    walk: Optional[StripWalk] = None  # what the CUDA kernel reads

    def build_walk(self) -> StripWalk:
        return compact_walk(self.kind, self.masks, self.col_idx, self.src_start, self.dst_off,
                            self.item_ptr)

    def to(self, device: DeviceLike) -> "CompactDevice":
        return CompactDevice(
            self.n, self.n_pad, self.n_src_pad,
            *(x.to(device) for x in (self.kind, self.masks, self.col_idx, self.src_start,
                                     self.dst_off, self.nsub, self.item_ptr)),
            self.straggler.to(device) if self.straggler else None,
            None if self.walk is None else self.walk.to(device),
        ).with_walk()


def item_pointers(strip_id: np.ndarray, n_pad: int) -> np.ndarray:
    """int32 [n_pad // STRIP + 1] item range per strip, from the (ascending)
    per-item strips of one unpadded layout."""
    return range_pointers(strip_id, n_pad // STRIP)


def nsub_from_masks(masks: np.ndarray) -> np.ndarray:
    """[T] count of USED subtile slots per item, derived from the group
    bitmask: slot s owns virtual columns [CSUB s, CSUB (s+1)), i.e. bit
    pairs (2s, 2s+1) across every halfword. Dummy-padded slots are always
    a zero tail (the group builder packs real subtiles first), so the
    kernel can skip slots >= nsub. Full items derive GROUP (their kind-0
    path ignores it)."""
    t = masks.shape[0]
    used = np.zeros((t, GROUP), bool)
    m = masks.view(np.uint16)
    for s in range(GROUP):
        used[:, s] = ((m >> (2 * s)) & 3).any(axis=(1, 2))
    # highest used slot + 1 (>= 1)
    return np.maximum(
        GROUP - np.argmax(used[:, ::-1], axis=1) - (~used.any(axis=1)) * GROUP,
        1,
    ).astype(np.int32)


def _pack_bits(rows: np.ndarray, vcols: np.ndarray) -> np.ndarray:
    """[BD, WORDS] halfword mask with virtual column v at
    (halfword v % WORDS, bit v // WORDS), as in every tile layout."""
    m = np.zeros(BD * WORDS, np.uint16)
    np.bitwise_or.at(
        m,
        rows.astype(np.int64) * WORDS + vcols % WORDS,
        np.uint16(1) << (vcols // WORDS).astype(np.uint16),
    )
    return m.reshape(BD, WORDS)


def compact_layout(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    n_src: Optional[int] = None,
    me_ell: int = ME_ELL,
    full_cols: int = FULL_COLS,
    cache_key: Optional[str] = None,
    dedup: bool = True,
) -> CompactLayout:
    """Build the three-tier layout for edges src -> dst (``n`` dst rows,
    ``n_src`` source rows; defaults to square)."""
    from .spmm_fast import ell_cache_ok, ell_load_npz, ell_save_npz

    if cache_key and os.path.exists(cache_key + ".npz"):
        z = np.load(cache_key + ".npz")
        # a cache hit must have been built with the SAME tiering parameters
        # and graph dims (legacy caches lack the keys; their filenames
        # mangle the parameters)
        ok = (
            int(z.get("compact_scheme", 0)) == COMPACT_SCHEME
            and ell_cache_ok(z)
            and int(z.get("me_ell", me_ell)) == me_ell
            and int(z.get("full_cols", full_cols)) == full_cols
            and int(z["n"]) == n
            and int(z.get("n_src", n if n_src is None else n_src))
            == (n if n_src is None else n_src)
        )
        if ok:
            straggler = ell_load_npz(z)
            nsub = z["nsub"] if "nsub" in z else nsub_from_masks(z["masks"])
            return CompactLayout(
                int(z["n"]), int(z["n_pad"]), int(z["n_src_pad"]),
                z["kind"], z["masks"], z["col_idx"], z["src_start"],
                z["strip_id"], z["new_window"], z["wslot"],
                z["strip_first"], z["strip_last"], z["dst_off"], nsub,
                straggler,
            )

    if n_src is None:
        n_src = n
    if dedup:
        nn = max(n, n_src)
        src, dst = _dedup(src, dst, nn)
    elif len(src) and len(np.unique(src.astype(np.int64) * n + dst)) != len(src):
        raise ValueError(
            "compact layout requires a simple graph (duplicate edges found); "
            "deduplicate upstream or pass dedup=True"
        )
    n_pad = -(-n // STRIP) * STRIP
    n_src_pad = -(-n_src // BS) * BS
    nw = n_src_pad // BS
    n_strips = n_pad // STRIP

    blk = dst.astype(np.int64) // BD
    win = src.astype(np.int64) // BS
    region = blk * nw + win
    order = np.argsort(region, kind="stable")
    region_s, src_s, dst_s = region[order], src[order], dst[order]
    uniq, ptr = np.unique(region_s, return_index=True)
    ptr = np.append(ptr, len(region_s))
    counts = np.diff(ptr)

    # per-item lists, keyed for the final (strip, window, kind) order
    it_key, it_kind, it_masks, it_cols, it_start, it_strip, it_doff = (
        [], [], [], [], [], [], []
    )
    # pending compact subtiles per (strip, window): list of
    # (dst_blk_local, cols_local[<=CSUB], rows, cols_pos)
    pending: dict = {}
    ell_src, ell_dst = [], []

    for ri in range(len(uniq)):
        r = int(uniq[ri])
        b, w = r // nw, r % nw
        sl = slice(ptr[ri], ptr[ri + 1])
        e = counts[ri]
        s_loc = (src_s[sl] - w * BS).astype(np.int64)
        d_loc = (dst_s[sl] - b * BD).astype(np.int64)
        if e < me_ell:
            ell_src.append(src_s[sl])
            ell_dst.append(dst_s[sl])
            continue
        cols = np.unique(s_loc)
        if len(cols) > full_cols:
            it_key.append((b // SB, w, 0))
            it_kind.append(0)
            it_masks.append(_pack_bits(d_loc, s_loc).view(np.int16))
            it_cols.append(np.zeros(BS, np.int32))
            it_start.append(w * BS)
            it_strip.append(b // SB)
            doff = np.zeros(GROUP, np.int32)
            doff[0] = (b % SB) * BD
            it_doff.append(doff)
            continue
        # compact: split occupied columns into CSUB-wide subtiles
        pos = np.searchsorted(cols, s_loc)  # edge -> occupied-col rank
        key = (int(b // SB), int(w))
        lst = pending.setdefault(key, [])
        for s0 in range(0, len(cols), CSUB):
            sel = (pos >= s0) & (pos < s0 + CSUB)
            lst.append(
                (int(b % SB), cols[s0 : s0 + CSUB].astype(np.int32),
                 d_loc[sel], (pos[sel] - s0).astype(np.int64))
            )

    # pack pending subtiles into groups of GROUP within each (strip, window)
    for (st, w), subs in pending.items():
        for g0 in range(0, len(subs), GROUP):
            chunk = subs[g0 : g0 + GROUP]
            mask = np.zeros((BD, WORDS), np.uint16)
            cols = np.zeros(BS, np.int32)
            doff = np.zeros(GROUP, np.int32)
            for s, (blk_loc, ccols, rows, cpos) in enumerate(chunk):
                cols[s * CSUB : s * CSUB + len(ccols)] = ccols
                doff[s] = blk_loc * BD
                mask |= _pack_bits(rows, cpos + s * CSUB)
            it_key.append((st, w, 1))
            it_kind.append(1)
            it_masks.append(mask.view(np.int16))
            it_cols.append(cols)
            it_start.append(w * BS)
            it_strip.append(st)
            it_doff.append(doff)

    # every strip gets at least one item (the TPU kernel zeroes and
    # flushes a strip's output on its items)
    seen = set(it_strip)
    for st in range(n_strips):
        if st not in seen:
            it_key.append((st, 0, 0))
            it_kind.append(0)
            it_masks.append(np.zeros((BD, WORDS), np.int16))
            it_cols.append(np.zeros(BS, np.int32))
            it_start.append(0)
            it_strip.append(st)
            it_doff.append(np.zeros(GROUP, np.int32))
    if not it_kind:  # completely empty graph
        it_key.append((0, 0, 0))
        it_kind.append(0)
        it_masks.append(np.zeros((BD, WORDS), np.int16))
        it_cols.append(np.zeros(BS, np.int32))
        it_start.append(0)
        it_strip.append(0)
        it_doff.append(np.zeros(GROUP, np.int32))

    order = sorted(range(len(it_key)), key=lambda i: it_key[i])
    kind = np.asarray([it_kind[i] for i in order], np.int32)
    masks = np.stack([it_masks[i] for i in order])
    col_idx = np.stack([it_cols[i] for i in order])
    src_start = np.asarray([it_start[i] for i in order], np.int32)
    strip_id = np.asarray([it_strip[i] for i in order], np.int32)
    dst_off = np.stack([it_doff[i] for i in order]).astype(np.int32)

    new_window = np.ones(len(kind), np.int32)
    new_window[1:] = (src_start[1:] != src_start[:-1]).astype(np.int32)
    wslot = (np.cumsum(new_window) - 1) % 2
    strip_first = np.ones(len(kind), np.int32)
    strip_first[1:] = (strip_id[1:] != strip_id[:-1]).astype(np.int32)
    strip_last = np.ones(len(kind), np.int32)
    strip_last[:-1] = (strip_id[1:] != strip_id[:-1]).astype(np.int32)

    straggler = None
    if ell_src:
        straggler = ell_from_csr(
            np.concatenate(ell_src), np.concatenate(ell_dst), n_pad
        )

    lay = CompactLayout(
        n, n_pad, n_src_pad, kind, masks, col_idx, src_start, strip_id,
        new_window, wslot.astype(np.int32), strip_first, strip_last,
        dst_off, nsub_from_masks(masks), straggler,
    )
    if cache_key:
        os.makedirs(os.path.dirname(cache_key) or ".", exist_ok=True)
        save = dict(
            n=n, n_src=n_src, n_pad=n_pad, n_src_pad=n_src_pad, kind=kind,
            masks=masks, col_idx=col_idx, src_start=src_start,
            strip_id=strip_id, new_window=new_window, wslot=lay.wslot,
            strip_first=strip_first, strip_last=strip_last, dst_off=dst_off,
            nsub=lay.nsub, me_ell=me_ell, full_cols=full_cols,
            compact_scheme=COMPACT_SCHEME,
        )
        ell_save_npz(save, straggler)
        np.savez(cache_key + ".npz", **save)
    return lay


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _run_compact_torch(layout: CompactDevice, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX package's
    ``_run_compact_jnp``), ``_PLAIN_TILES`` items at a time: gather each
    item's 2048 source rows (a kind-0 item its window in order, a kind-1
    item ``col_idx``), multiply each 256-column slot of its expanded mask
    with its rows in f32, and ``index_add_`` the product at the slot's strip
    row (every slot of a kind-0 item at ``dst_off[0]``); round once to
    ``h.dtype``."""
    if h.shape[0] != layout.n_src_pad:
        raise ValueError(f"h has {h.shape[0]} rows, layout wants {layout.n_src_pad}")
    dev, f = h.device, h.shape[1]
    out = torch.zeros((layout.n_pad, f), dtype=torch.float32, device=dev)
    item_ptr = layout.item_ptr.to(dev, torch.int64)
    strip_id = torch.repeat_interleave(
        torch.arange(item_ptr.numel() - 1, device=dev), item_ptr.diff()
    )
    win = torch.arange(BS, device=dev)
    rows = torch.arange(BD, device=dev)
    for s in range(0, strip_id.numel(), _PLAIN_TILES):
        e = min(s + _PLAIN_TILES, strip_id.numel())
        a = expand_masks(layout.masks[s:e].to(dev))  # [c, BD, BS]
        grp = (layout.kind[s:e].to(dev) == 1)[:, None]
        cols = torch.where(grp, layout.col_idx[s:e].to(dev, torch.int64), win)
        g = h[layout.src_start[s:e].to(dev, torch.int64)[:, None] + cols].to(torch.float32)
        doff = layout.dst_off[s:e].to(dev, torch.int64)
        doff = torch.where(grp, doff, doff[:, :1])
        base = strip_id[s:e, None] * STRIP
        for slot in range(GROUP):
            c0 = slot * CSUB
            part = torch.bmm(a[:, :, c0:c0 + CSUB], g[:, c0:c0 + CSUB])  # [c, BD, F]
            dst_rows = (base + doff[:, slot:slot + 1] + rows).reshape(-1)
            out.index_add_(0, dst_rows, part.reshape(-1, f))
    return out.to(h.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    """The row gather's launcher and error string, their argument types
    bound once."""
    from ..utils.cuda_build import load_library

    lib = load_library("spmm_compact")
    fn, err = lib.adaqp_gather_rows, lib.adaqp_compact_error_string
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp] + [ci] * 8 + [vp]
    fn.restype = ci
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return fn, err


def _run_compact_cuda(layout: CompactDevice, h: torch.Tensor) -> torch.Tensor:
    """Launch the window-stationary kernel on ``h``'s device and current
    stream."""
    out = run_walk(layout, h, "compact")
    compact_spmm.launches += 1
    return out


def compact_spmm(layout: CompactDevice, h: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: the item part of ``A^T h`` in ``h.dtype``.

    CUDA ``h``: the hand-written kernel (each launch adds one to
    ``compact_spmm.launches``). CPU ``h``: the plain PyTorch version."""
    if h.device.type == "cuda":
        return _run_compact_cuda(layout, h)
    if h.device.type == "cpu":
        return _run_compact_torch(layout, h)
    raise ValueError(f"no compact SpMM for device {h.device}")


compact_spmm.launches = 0


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, c] = x[idx[r, c], c]`` (``take_along_axis`` along rows) for
    f32 ``x`` and int32 ``idx`` of one shape [R, C].

    CUDA tensors: the hand-written kernel on the plan of
    :func:`gather_plan` (each launch adds one to ``gather_rows.launches``),
    after a check of idx's range that reads its least and greatest values
    back to the host. CPU tensors: ``torch.take_along_dim``."""
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError(f"x and idx must share one [R, C] shape, got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}")
    if x.device.type == "cpu":
        return torch.take_along_dim(x, idx.long(), dim=0)
    if x.device.type != "cuda":
        raise ValueError(f"no row gather for device {x.device}")
    if (x.dtype != torch.float32 or idx.dtype != torch.int32 or idx.device != x.device
            or not x.is_contiguous() or not idx.is_contiguous()):
        raise ValueError("gather_rows takes contiguous f32 x and int32 idx on one card")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= x.shape[0]):
        raise IndexError(f"idx outside [0, {x.shape[0]})")
    return _launch_gather_rows(x, idx)


class GatherPlan(NamedTuple):
    """One launch of ``gather_rows``: thread (x, y) of block (i, j) owns
    columns ``[width * (bx i + x), width * (bx i + x) + width)`` of rows
    ``r0 + k by`` for ``k < unroll``, from ``r0 = by unroll j + y`` in
    steps of ``gy by unroll``."""
    width: int   # columns a thread: 4 (16-byte idx loads and out stores) or 1
    unroll: int  # rows a thread a pass: 4 gathers in flight
    block: tuple  # (bx: column groups, by: rows), 128 threads
    grid: tuple   # (gx: column groups, gy: rows), gy at most one wave


GATHER_THREADS = 128  # threads a block
GATHER_LOADS = 4      # gathers a thread has in flight (csrc/spmm_compact.cu's kLoads)


@functools.lru_cache(maxsize=256)
def gather_plan(rows: int, cols: int, aligned: bool, sms: int = 132) -> GatherPlan:
    """The launch plan of ``gather_rows`` for ``[rows, cols]`` operands,
    ``aligned`` when idx and out start on 16 bytes: 4 columns a thread where
    cols allows it, else 1; a block 32 column groups wide (fewer, a power of
    two, for narrow rows); as many row blocks as cover the rows, at most
    one wave of 16 blocks an SM in all."""
    width = 4 if aligned and cols % 4 == 0 else 1
    groups = cols // width
    bx = min(32, 1 << max(groups - 1, 0).bit_length())
    by = GATHER_THREADS // bx
    unroll = GATHER_LOADS // width
    gx = -(-groups // bx)
    wave = sms * (2048 // GATHER_THREADS)
    gy = max(1, min(-(-rows // (by * unroll)), wave // gx, 65535))
    return GatherPlan(width, unroll, (bx, by), (gx, gy))


@functools.lru_cache(maxsize=256)
def _gather_args(rows: int, cols: int, aligned: bool, index: int) -> tuple:
    plan = gather_plan(rows, cols, aligned,
                       torch.cuda.get_device_properties(index).multi_processor_count)
    return (plan.width, *plan.block, *plan.grid)


def _launch_gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the gather kernel on operands :func:`gather_rows` checked, on
    the plan of :func:`gather_plan`."""
    out = torch.empty_like(x)
    if not x.numel():
        return out
    rows, cols = x.shape
    ip, op, index = idx.data_ptr(), out.data_ptr(), x.device.index
    fn, err = _lib()
    aligned = (ip | op) % 16 == 0
    rc = fn(x.data_ptr(), ip, op, rows, cols, *_gather_args(rows, cols, aligned, index), index,
            torch._C._cuda_getCurrentRawStream(index))
    raise_on(err, rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


@functools.lru_cache(maxsize=None)
def dynamic_gather_supported() -> bool:
    """Whether the card runs the compact kernel's row gather: on a machine
    with a CUDA card, build ``gather_rows``, launch it once on a [2048, 128]
    probe (the JAX package's probe shape) and compare it with
    ``torch.take_along_dim`` bit for bit. True, or an exception if the
    build, the launch or the comparison fails; False without building
    anything where PyTorch sees no card. The answer is cached per process
    (``dynamic_gather_supported.cache_clear()`` probes again)."""
    if not torch.cuda.is_available():
        return False
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(BS, 128, generator=gen)
    idx = torch.randint(0, BS, (BS, 128), generator=gen, dtype=torch.int32)
    got = gather_rows(x.cuda(), idx.cuda())
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), torch.take_along_dim(x, idx.long(), dim=0)):
        raise RuntimeError("gather_rows disagrees with torch.take_along_dim on the probe")
    return True


def run_compact(layout: CompactDevice, h: torch.Tensor) -> torch.Tensor:
    """out = A^T h in ``h.dtype``: the items plus the ELL tail."""
    return with_straggler(compact_spmm(layout, h), layout.straggler, h)


def spmm_compact(layout_fwd: CompactDevice, h: torch.Tensor,
                 reverse: CompactDevice) -> torch.Tensor:
    """A^T h with compact-column items; the backward runs the reverse
    layout (argument order of the JAX package's ``spmm_compact``)."""
    return ReverseSpmm.apply(h, run_compact, layout_fwd, reverse)
