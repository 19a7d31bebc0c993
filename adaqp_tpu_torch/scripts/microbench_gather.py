"""Microbench: element gathers inside a window, and one compact work item.

The port's counterpart of ``scripts/microbench_gather.py``, with two
kernels in place of its three TPU kernels:

- ``window_gather`` (``csrc/window_gather.cu``) replaces ``kern`` of
  ``mk_kernel`` (``:72``) and of ``mk_sq`` (``:130``):
  ``sum_{k < iters} take_along_axis(x, idx, axis)`` summed in x's dtype,
  with a full index of x's shape or a 1-D column list ``[1,
  x.shape[axis]]`` broadcast inside the kernel;
- ``compact_item`` (``csrc/compact_item.cu``) replaces ``kern`` of
  ``mk_item`` (``:212``): one compact work item -- expand a [256, 128]
  halfword mask to a 0/1 [256, 2048] A, then A @ win (kind 0, a full item)
  or A's eight 256-column subtiles times the matching row slices of
  ``win[col]`` (kind 1, a group item), summed in f32 over ``iters`` and
  rounded once to bf16: the cost model of ``spmm_compact``. The TPU kernel
  never zeroed its accumulator; this one starts from zero.

    python -m adaqp_tpu_torch.scripts.microbench_gather [--iters 200]
    python -m adaqp_tpu_torch.scripts.microbench_gather --device cpu --iters 1

``--iters`` takes the place of ``GB_ITERS``, ``--device cpu`` that of
``GB_INTERPRET`` (the plain versions run). The sections run in the
script's order: the library row gather, the element gather at [4096, 256]
f32 and bf16, the depth variants 8/256/1024, the square-window
permutations (axis 0 and 1, full and 1-D index, F 256 and 640), the
library gather over F, then the compact full and group items at fc 256
and 384. Every kernel's single-iteration output is held against its plain
version on the host, and a mismatch raises. Times are per iteration of
one call of ``iters`` iterations (CUDA events after a warm-up call).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..common.backend import resolve_device
from ..ops.spmm_block import expand_masks
from ..ops.spmm_compact import BD, BS, CSUB, GROUP, WORDS
from ..utils.cuda_build import raise_on
from . import sm_count, time_call

R, F = 4096, 256
D = 2048           # the square window's depth
SBK = 8            # destination blocks of an item's accumulator
# |kernel - plain| for compact_item: one bf16 rounding of f32 sums taken in
# another order
ITEM_RTOL, ITEM_ATOL = 2.0 ** -7, 1e-6
MAX_SMEM = 227 * 1024  # shared memory a block can use on Hopper
ITEM_ROWS, ITEM_COLS = 64, 128  # compact_item: A's rows and win's columns a CTA
SMS = 132              # an H100's SMs, the plan's default


# ---------------------------------------------------------------------------
# window_gather
# ---------------------------------------------------------------------------


def _is_full(x: torch.Tensor, idx: torch.Tensor, axis: int) -> bool:
    """True for a full index (x's shape), False for a 1-D one ([1,
    x.shape[axis]]); raises on any other shape."""
    if tuple(idx.shape) == tuple(x.shape):
        return True
    if tuple(idx.shape) == (1, x.shape[axis]):
        return False
    raise ValueError(f"idx of shape {tuple(idx.shape)} is neither x's {tuple(x.shape)} nor "
                     f"(1, {x.shape[axis]})")


def full_index(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``idx`` as the int64 index of x's shape that ``torch.gather`` takes
    (a 1-D index broadcast along the other axis)."""
    full = idx.long()
    if _is_full(x, idx, axis):
        return full
    v = full.reshape(-1)
    return (v[:, None] if axis == 0 else v[None, :]).expand(x.shape)


class WindowPlan(NamedTuple):
    """One launch of ``window_gather``: block b stages lines ``[b * lines,
    (b + 1) * lines)`` of the non-gather axis (x's columns for axis 0, its
    rows for axis 1) at every position of the gather axis."""
    lines: int   # lines a block
    blocks: int  # blocks of the grid
    stride: int  # slab elements between positions (axis 0) or lines (axis 1)
    unit: int    # bytes of each staging load
    smem: int    # shared bytes a block: the slab and the staged index


def _unit(*nbytes: int) -> int:
    """The widest load (2 to 16 bytes) that divides every byte count."""
    return next(u for u in (16, 8, 4, 2, 1) if all(n % u == 0 for n in nbytes))


@functools.lru_cache(maxsize=256)
def window_plan(rows: int, cols: int, axis: int, esize: int, full: bool = True,
                sms: int = SMS, lines: int | None = None, align: int = 16) -> WindowPlan:
    """The launch plan of ``window_gather`` for x ``[rows, cols]`` of
    ``esize``-byte elements and a full (``full``) or 1-D int32 index, both
    at addresses aligned to ``align`` bytes of x (the index: as many of its
    own elements).

    The gather axis has length L, the other M lines. By default ``lines``
    makes about one wave of one or two blocks an SM: of ``ceil(M / (2
    sms))`` to ``ceil(M / sms)`` lines, the count that gives the busiest
    SM the fewest lines (every iteration waits for it), then whose staged
    segments take the widest loads, then the largest; fewer when the
    block's shared memory would exceed 227 KB. Axis 0's slab is
    ``[L][stride]`` with each position's lines an odd number of words apart
    (a warp's random rows spread over the banks); axis 1's
    ``[lines][stride]`` with each line padded to 16 bytes. The staged index
    follows it: a full one ``[L][lines]`` (axis 0) or ``[lines][L]`` (axis
    1, L rounded up to 4), a 1-D one ``[L]``. Raises when one line cannot
    fit."""
    L, M = (rows, cols) if axis == 0 else (cols, rows)
    ls = -(-L // 4) * 4

    def plan(s):
        if axis == 0:
            words = -(-s * esize // 4)
            stride = (words | 1) * 4 // esize
            unit = _unit(s * esize, M % s * esize, cols * esize, align, 16)
            slab = L * stride * esize
        else:
            stride = -(-L * esize // 16) * 16 // esize
            unit = _unit(L * esize, align, 16)
            slab = s * stride * esize
        index = (L if axis == 0 else ls) * s * 4 if full else ls * 4
        return WindowPlan(s, -(-M // s), stride, unit, -(-slab // 16) * 16 + index)

    if lines is None:
        lo, hi = -(-M // (2 * sms)), -(-M // sms)

        def busiest(s):  # lines on the SM with the most blocks
            return -(-plan(s).blocks // sms) * s

        lines = max(range(lo, hi + 1), key=lambda s: (-busiest(s), plan(s).unit, s))
        while lines > 1 and plan(lines).smem > MAX_SMEM:
            lines -= 1
    got = plan(max(1, min(lines, M)))
    if got.smem > MAX_SMEM:
        raise ValueError(f"window_gather: {got.lines} line(s) of {L} x {esize} bytes need "
                         f"{got.smem} bytes of shared memory, more than a block's {MAX_SMEM}")
    return got


def _align(mod: int, cap: int) -> int:
    """The largest power of two up to ``cap`` that divides an address whose
    remainder modulo ``cap`` is ``mod``."""
    return mod & -mod if mod else cap


def _window_args(x: torch.Tensor, idx: torch.Tensor, iters: int, axis: int,
                 lines: int | None = None) -> bool:
    """Raises on arguments :func:`window_gather` does not take; returns
    whether ``idx`` is a full index."""
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D f32 or bf16 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if axis not in (0, 1) or iters < 1:
        raise ValueError(f"axis must be 0 or 1 and iters at least 1, got {axis}, {iters}")
    if idx.dtype != torch.int32 or idx.device != x.device:
        raise ValueError(f"idx must be int32 on {x.device}, got {idx.dtype} on {idx.device}")
    if lines is not None and lines < 1:
        raise ValueError(f"lines must be at least 1, got {lines}")
    return _is_full(x, idx, axis)


def _window_gather_torch(x: torch.Tensor, idx: torch.Tensor, iters: int, axis: int
                         ) -> torch.Tensor:
    full = full_index(x, idx, axis)
    acc = torch.zeros_like(x)
    for _ in range(iters):
        acc = acc + torch.gather(x, axis, full)
    return acc


@functools.lru_cache(maxsize=None)
def _window_lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("window_gather")
    if lib.adaqp_window_gather.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.adaqp_window_gather.argtypes = [vp, vp, vp] + [ci] * 10 + [vp]
        lib.adaqp_window_gather.restype = ci
        lib.adaqp_window_gather_error_string.argtypes = [ci]
        lib.adaqp_window_gather_error_string.restype = ctypes.c_char_p
    return lib


# (x's shape and dtype, axis, full, lines, x's address mod 16 and idx's mod
# 32, device) -> the launch's arguments before and after iters: a call looks
# its plan up once, in one dict. The plan reads alignments up to 16 bytes of
# x, and as many of a full index's elements (32 bytes of a bf16 x's index).
_LAUNCHES: dict = {}


def _launch_args(x, axis, full, lines, x_mod, idx_mod, index):
    esize = x.element_size()
    align = _align(x_mod, 16)
    if full:
        align = min(align, _align(idx_mod, 32) * esize // 4)
    plan = window_plan(x.shape[0], x.shape[1], axis, esize, full,
                       sm_count(torch.device("cuda", index)), lines, align)
    return ((x.shape[0], x.shape[1], axis, int(full), int(x.dtype == torch.bfloat16)),
            (plan.lines, plan.stride, plan.unit, index))


def _window_gather_cuda(x, idx, iters, axis, full, lines):
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    xp, ip, index = x.data_ptr(), idx.data_ptr(), x.device.index
    key = (x.shape, x.dtype, axis, full, lines, xp & 15, ip & 31, index)
    args = _LAUNCHES.get(key)
    if args is None:
        args = _LAUNCHES[key] = _launch_args(x, axis, full, lines, xp & 15, ip & 31, index)
    lib = _window_lib()
    rc = lib.adaqp_window_gather(xp, ip, out.data_ptr(), *args[0], iters, *args[1],
                                 torch._C._cuda_getCurrentRawStream(index))
    raise_on(lib.adaqp_window_gather_error_string, rc, "window_gather")
    window_gather.launches += 1
    return out


def window_gather(x: torch.Tensor, idx: torch.Tensor, iters: int, axis: int,
                  lines: int | None = None) -> torch.Tensor:
    """``sum_{k < iters} take_along_axis(x, idx, axis)`` summed in x's
    dtype (one rounding an iteration), for contiguous f32 or bf16 ``x``
    [R, C] and int32 ``idx`` of x's shape (a full index) or of shape ``[1,
    x.shape[axis]]`` (a 1-D one: position p along the axis gathers
    ``idx[0, p]``), values in ``[0, x.shape[axis])``.

    CUDA ``x``: the kernel on the grid of :func:`window_plan` (``lines``
    sets its lines a block), one more ``window_gather.launches`` per
    launch; a line of the gather axis must fit a block's shared memory
    (227 KB) and the indices are trusted. CPU ``x``: the plain version.
    Any other device raises."""
    full = _window_args(x, idx, iters, axis, lines)
    if x.device.type == "cuda":
        return _window_gather_cuda(x, idx.contiguous(), iters, axis, full, lines)
    if x.device.type == "cpu":
        return _window_gather_torch(x, idx, iters, axis)
    raise ValueError(f"no window_gather for device {x.device}")


window_gather.launches = 0


# ---------------------------------------------------------------------------
# compact_item
# ---------------------------------------------------------------------------


def _compact_item_torch(mask: torch.Tensor, col: torch.Tensor, win: torch.Tensor,
                        kind: int, iters: int) -> torch.Tensor:
    a = expand_masks(mask[None])[0]  # f32 [BD, BS]
    w = win.float()
    if kind == 0:
        prods = [(0, a @ w)]
    else:
        g = w[col.reshape(-1).long()]
        prods = [(s * BD, a[:, s * CSUB:(s + 1) * CSUB] @ g[s * CSUB:(s + 1) * CSUB])
                 for s in range(GROUP)]
    acc = torch.zeros((SBK * BD, win.shape[1]), dtype=torch.float32, device=win.device)
    for _ in range(iters):
        for r0, prod in prods:
            acc[r0:r0 + BD] += prod
    return acc.to(torch.bfloat16)


class ItemPlan(NamedTuple):
    """One launch of ``compact_item``: a CTA a (slice, chunk, share) of
    ``grid``, each multiplying rows ``[64 share, 64 share + 64)`` of A's
    columns ``[256 slice, 256 slice + 256)`` by the matching 256 rows of win
    (kind 1: of ``win[col]``) at columns ``[128 chunk, 128 chunk + 128)``
    below fc."""
    ld: int       # win's row stride in the kernel: fc rounded up to 8 (16 bytes)
    grid: tuple   # (slices, chunks, shares); kind 0's 8 slices are a cluster that adds up


@functools.lru_cache(maxsize=64)
def item_plan(fc: int) -> ItemPlan:
    """The launch plan of ``compact_item`` for win ``[2048, fc]``, the same
    units for both kinds: kind 0 spreads its depth over as many CTAs as
    kind 1 (96 at fc 384, 64 at fc 256)."""
    if fc < 1:
        raise ValueError(f"fc must be at least 1, got {fc}")
    return ItemPlan(-(-fc // 8) * 8, (GROUP, -(-fc // ITEM_COLS), BD // ITEM_ROWS))


@functools.lru_cache(maxsize=None)
def _item_lib():
    """The launcher, kind 0's map encoder and the error string, their
    argument types bound once."""
    from ..utils.cuda_build import load_library

    lib = load_library("compact_item")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    launch, encode, err = (lib.adaqp_compact_item, lib.adaqp_compact_item_map,
                           lib.adaqp_compact_item_error_string)
    launch.argtypes = [vp] * 5 + [ci] * 6 + [vp]
    launch.restype = ci
    encode.argtypes = [vp, ci, vp]
    encode.restype = ci
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return launch, encode, err


@functools.lru_cache(maxsize=256)
def _item_map(win_ptr: int, ld: int):
    """Kind 0's TMA map of win (128 bytes), encoded once a signature: a map
    names an address and a shape, nothing else."""
    _, encode, err = _item_lib()
    buf = ctypes.create_string_buffer(128)
    raise_on(err, encode(win_ptr, ld, buf), "compact_item's tensor map")
    return buf


def _compact_item_cuda(mask, col, win, kind, iters):
    fc = win.shape[1]
    plan = item_plan(fc)
    if plan.ld != fc:  # TMA and the 16-byte pieces need rows of a multiple of 16 bytes
        win = torch.nn.functional.pad(win, (0, plan.ld - fc))
    elif win.data_ptr() % 16:
        win = win.clone()
    if mask.data_ptr() % 4:
        raise ValueError("compact_item reads the mask a 32-bit word at a time: align it to 4 "
                         "bytes")
    out = torch.empty((SBK * BD, fc), dtype=torch.bfloat16, device=win.device)
    index = win.device.index
    launch, _, err = _item_lib()
    rc = launch(_item_map(win.data_ptr(), plan.ld) if kind == 0 else None, mask.data_ptr(),
                col.data_ptr(), win.data_ptr(), out.data_ptr(), fc, plan.ld, plan.grid[1], kind,
                iters, index, torch._C._cuda_getCurrentRawStream(index))
    raise_on(err, rc, "compact_item")
    compact_item.launches += 1
    return out


def _item_args(mask: torch.Tensor, col: torch.Tensor, win: torch.Tensor, kind: int,
               iters: int) -> None:
    """Raises on arguments :func:`compact_item` does not take."""
    if mask.shape != (BD, WORDS) or mask.dtype != torch.int16:
        raise ValueError(f"mask must be int16 [{BD}, {WORDS}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if col.numel() != BS or col.dtype != torch.int32:
        raise ValueError(f"col must be int32 with {BS} entries, got {col.dtype} {col.numel()}")
    if win.dim() != 2 or win.shape[0] != BS or win.dtype != torch.bfloat16 or win.shape[1] < 1:
        raise ValueError(f"win must be bf16 [{BS}, fc], got {win.dtype} {tuple(win.shape)}")
    if kind not in (0, 1) or iters < 1:
        raise ValueError(f"kind must be 0 or 1 and iters at least 1, got {kind}, {iters}")
    if not (mask.device == col.device == win.device):
        raise ValueError("mask, col and win must lie on one device")


def compact_item(mask: torch.Tensor, col: torch.Tensor, win: torch.Tensor, kind: int,
                 iters: int) -> torch.Tensor:
    """One compact work item summed over ``iters`` iterations -> bf16
    [2048, fc]. ``mask`` int16 [256, 128] (A[r, l] is bit ``l // 128`` of
    halfword ``mask[r, l % 128]``), ``col`` int32 with 2,048 entries in
    [0, 2048) (read for kind 1), ``win`` contiguous bf16 [2048, fc]. Kind 0:
    rows 0..255 are ``iters`` times A @ win, the rest zero; kind 1: rows
    256s..256s+255 are ``iters`` times A[:, 256s:256s+256] @
    win[col[256s:256s+256]]. Sums in f32, rounded once to bf16.

    CUDA ``win``: the kernel on the grid of :func:`item_plan` (one more
    ``compact_item.launches`` per launch; where fc is not a multiple of 8,
    or win not 16-byte aligned, it reads a padded copy of win made first);
    ``col`` is trusted. CPU ``win``: the plain version. Any other device
    raises."""
    _item_args(mask, col, win, kind, iters)
    if win.device.type == "cuda":
        return _compact_item_cuda(mask.contiguous(), col.contiguous().reshape(-1),
                                  win.contiguous(), kind, iters)
    if win.device.type == "cpu":
        return _compact_item_torch(mask, col, win, kind, iters)
    raise ValueError(f"no compact_item for device {win.device}")


compact_item.launches = 0


def item_within(got: torch.Tensor, want: torch.Tensor) -> bool:
    """compact_item's tolerance: ``|got - want| <= 2^-7 |want| + 1e-6``."""
    err = (got.float() - want.float()).abs()
    return bool((err <= ITEM_RTOL * want.float().abs() + ITEM_ATOL).all())


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def library_gather(x: torch.Tensor, i: torch.Tensor, iters: int) -> torch.Tensor:
    """The script's ``xla_gather`` in torch ops: ``x[i]`` added into an
    accumulator like x ``iters`` times."""
    acc = torch.zeros_like(x)
    for _ in range(iters):
        acc = acc + x.index_select(0, i)
    return acc


def _checked(what: str, ok: bool) -> bool:
    if not ok:
        raise RuntimeError(f"{what}: the kernel differs from its plain version")
    return ok


def main(argv=None) -> dict:
    """Print the probe's lines; returns the launches of each TPU kernel's
    counterpart: ``{"microbench_gather.py:72": ..., ":130": ..., ":212":
    ...}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=200, help="iterations in one call")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; raises without one)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    iters = args.iters
    rng = np.random.default_rng(args.seed)
    launches = {}

    def on(t):
        return t.to(dev)

    def per_iter(fn):
        return time_call(fn, dev) / iters

    x_host = torch.from_numpy(rng.normal(size=(R, F)).astype(np.float32))
    idx_rows = torch.from_numpy(rng.integers(0, R, R).astype(np.int32))
    idx_full = idx_rows[:, None].expand(R, F).contiguous()

    # --- the library row gather (the ELL path's primitive)
    x, i = on(x_host), on(idx_rows)
    t = per_iter(lambda: library_gather(x, i, iters))
    print(f"library row gather  [{R},{F}] f32 : {t * 1e6:8.1f} us/iter ({t / R * 1e9:.1f} ns/row)",
          flush=True)

    # --- the element gather over a whole window
    before = window_gather.launches
    for name, xx_host in (("f32", x_host), ("bf16", x_host.to(torch.bfloat16))):
        xx, ii = on(xx_host), on(idx_full)
        t = per_iter(lambda: window_gather(xx, ii, iters, 0))
        ok = _checked(f"element gather {name}", torch.equal(
            window_gather(xx, ii, 1, 0).cpu(), window_gather(xx_host, idx_full, 1, 0)))
        print(f"element gather      [{R},{F}] {name:4s}: {t * 1e6:8.1f} us/iter "
              f"({t / R * 1e9:.1f} ns/row) correct={ok}", flush=True)

    # --- smaller depth variants
    for depth in (8, 256, 1024):
        xx_host = x_host[:depth].contiguous()
        ii_host = torch.from_numpy(rng.integers(0, depth, depth).astype(np.int32)
                                   )[:, None].expand(depth, F).contiguous()
        xx, ii = on(xx_host), on(ii_host)
        t = per_iter(lambda: window_gather(xx, ii, iters, 0))
        ok = _checked(f"element gather depth={depth}", torch.equal(
            window_gather(xx, ii, 1, 0).cpu(), window_gather(xx_host, ii_host, 1, 0)))
        print(f"element gather      [{depth},{F}] f32 : {t * 1e6:8.1f} us/iter "
              f"({t / depth * 1e9:.1f} ns/row) correct={ok}", flush=True)
    launches["microbench_gather.py:72"] = window_gather.launches - before

    # --- the compact kernel's primitive: a square-window permutation, along
    # axis 0 ([D, F] window) and axis 1 ([F, D]), with a full index and with
    # a 1-D column list broadcast inside the kernel
    before = window_gather.launches
    for ff in (256, 640):
        for axis in (0, 1):
            shape = (D, ff) if axis == 0 else (ff, D)
            xx_host = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                       ).to(torch.bfloat16)
            col = torch.from_numpy(rng.integers(0, D, D).astype(np.int32))
            for iname, ii_host in (
                    ("full-idx", (col[:, None] if axis == 0 else col[None, :]
                                  ).expand(shape).contiguous()),
                    ("1d-idx", col[None, :])):
                xx, ii = on(xx_host), on(ii_host)
                t = per_iter(lambda: window_gather(xx, ii, iters, axis))
                ok = _checked(f"window perm ax={axis} {iname} F={ff}", torch.equal(
                    window_gather(xx, ii, 1, axis).cpu(),
                    window_gather(xx_host, ii_host, 1, axis)))
                print(f"window perm ax={axis} {iname:8s} [{shape[0]},{shape[1]}] bf16: "
                      f"{t * 1e6:8.2f} us/iter ({t / D * 1e9:.2f} ns/vcol) correct={ok}",
                      flush=True)
    launches["microbench_gather.py:130"] = window_gather.launches - before

    # --- the library gather over F (bytes against descriptors at the
    # tail's widths)
    for ff in (256, 640):
        xx = on(torch.from_numpy(rng.normal(size=(R, ff)).astype(np.float32)
                                 ).to(torch.bfloat16))
        t = per_iter(lambda: library_gather(xx, i, iters))
        print(f"library row gather  [{R},{ff}] bf16: {t * 1e6:8.1f} us/iter "
              f"({t / R * 1e9:.1f} ns/row)", flush=True)

    # --- one compact work item (expand, [gather +] products into f32)
    before = compact_item.launches
    for fc in (256, 384):
        mask_host = torch.from_numpy(
            rng.integers(0, 1 << 16, (BD, WORDS)).astype(np.uint16).view(np.int16))
        col_host = torch.from_numpy(rng.integers(0, BS, BS).astype(np.int32).reshape(16, 128))
        win_host = torch.from_numpy(rng.normal(size=(BS, fc)).astype(np.float32)
                                    ).to(torch.bfloat16)
        mask, col, win = on(mask_host), on(col_host), on(win_host)
        for kind, name in ((0, "full"), (1, "group")):
            t = per_iter(lambda: compact_item(mask, col, win, kind, iters))
            ok = _checked(f"compact {name}-item fc={fc}", item_within(
                compact_item(mask, col, win, kind, 1).cpu(),
                compact_item(mask_host, col_host, win_host, kind, 1)))
            print(f"compact {name}-item  fc={fc}: {t * 1e6:8.2f} us/item correct={ok}",
                  flush=True)
    launches["microbench_gather.py:212"] = compact_item.launches - before
    return launches


if __name__ == "__main__":
    main()
