"""Probes for the wire's compute: a word transpose, scatter-adds, plane copies.

The port's counterpart of ``scripts/probe_r5.py``. Its kernel
``transpose_u32`` (``csrc/transpose_u32.cu``) replaces the TPU kernel
``kern`` of that script's ``probe_transpose`` (``:63``, called at ``:68``):
``out = x.T`` for a [4096, 25] array of 32-bit words, the question being
whether a kernel can write the wire's plane-major word stream without
lane padding. The script's other two probes are XLA ops, so here they are
torch ops, timed as the script times them:

1. scatter-add of f32 [N, 128] rows into [OUT, 128] with random and with
   sorted indices (``index_add_``), the sorted runs summed once each
   (``segment_reduce`` + ``index_copy_``, standing for the script's
   ``indices_are_sorted=True``), and the permutation gather;
2. the wire's per-peer blocks of ``wpr`` words a row copied into and out
   of a flat buffer as 2-D ``[*, wpr]`` blocks against one 1-D copy a
   plane.

    python -m adaqp_tpu_torch.scripts.probe_r5                # the script's sizes
    python -m adaqp_tpu_torch.scripts.probe_r5 --device cpu --n 4096 --cnt 512 --sbcap 100000

Each timing is the slope of CUDA events around a loop of 2 and of 10
iterations, the least of ``--reps`` runs each, as the script's ``timeit``
takes it (``:40-57``); every iteration does the whole op (the script's
``[:8]`` slices only keep the result small). Words are int32 tensors
holding the u32 bit patterns (torch has few uint32 ops). Where the script
asserted a TPU, this runs on the card unless ``--device cpu`` is given;
where it printed ``UNSUPPORTED`` and went on, this raises.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import time

import numpy as np
import torch

from ..common.backend import resolve_device
from ..utils.cuda_build import raise_on

N = 1_857_024  # ~products boundary rows (multiple of 1024)
OUT = 1_857_024
REPS = 6
RB, TRANSPOSE_PROGRAMS = 1024, 4  # the TPU transpose: 4 programs of 1,024 rows
WPR, CNT, K1, SBCAP = 25, 265_216, 7, 56_000_000  # the plane probe's sizes


# ---------------------------------------------------------------------------
# the transpose kernel
# ---------------------------------------------------------------------------


def _transpose_torch(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    """The launcher and its error string, their argument types bound once."""
    from ..utils.cuda_build import load_library

    lib = load_library("transpose_u32")
    fn, err = lib.adaqp_transpose_u32, lib.adaqp_transpose_error_string
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, cl, ci, ci, vp]
    fn.restype = ci
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return fn, err


def _transpose_cuda(x: torch.Tensor) -> torch.Tensor:
    rows, cols = x.shape
    out = x.new_empty((cols, rows))
    if not rows or not cols:
        return out
    index = x.get_device()
    fn, err = _lib()
    rc = fn(x.data_ptr(), out.data_ptr(), rows, cols, index,
            torch._C._cuda_getCurrentRawStream(index))
    raise_on(err, rc, "transpose_u32")
    transpose_u32.launches += 1
    return out


def transpose_u32(x: torch.Tensor) -> torch.Tensor:
    """``x.T`` as a contiguous ``[C, R]`` tensor, for a contiguous ``[R, C]``
    tensor of 32-bit words (int32, uint32 or float32: the bits move as
    they are). An empty matrix launches nothing.

    CUDA ``x``: the kernel (one more ``transpose_u32.launches`` per
    launch). CPU ``x``: the plain version. Any other device raises."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D tensor, got {tuple(x.shape)}")
    if x.element_size() != 4:
        raise TypeError(f"x must hold 32-bit words, got {x.dtype}")
    if x.is_cuda:
        return _transpose_cuda(x)
    if x.device.type == "cpu":
        return _transpose_torch(x)
    raise ValueError(f"no transpose_u32 for device {x.device}")


transpose_u32.launches = 0


# ---------------------------------------------------------------------------
# the scatter and gather bodies (the script's probe_scatter)
# ---------------------------------------------------------------------------


def scatter_inputs(n: int = N, out: int = OUT, seed: int = 0) -> dict:
    """The script's draws, in its order: rows f32 [n, 128], random indices
    into ``out`` rows, the same sorted, and a permutation of ``out``."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, 128)).astype(np.float32)
    idx_r = rng.integers(0, out, n).astype(np.int32)
    return {"rows": rows, "rand": idx_r, "sorted": np.sort(idx_r),
            "perm": rng.permutation(out).astype(np.int32)}


def scatter_add(i: int, r: torch.Tensor, ix: torch.Tensor, out: int) -> torch.Tensor:
    """``zeros[out, 128].at[ix].add(r + i * 1e-30)``: one ``index_add_``."""
    tgt = torch.zeros((out, r.shape[1]), dtype=torch.float32, device=r.device)
    return tgt.index_add_(0, ix, r + i * 1e-30)


def scatter_add_runs(i: int, r: torch.Tensor, uniq: torch.Tensor, lengths: torch.Tensor,
                     out: int) -> torch.Tensor:
    """The sorted scatter-add knowing its indices are sorted: the script's
    ``scatter_add(..., indices_are_sorted=True)`` lets XLA sum each run of
    equal indices in one pass and write it once, without colliding
    updates. Torch has no such hint, so this does that itself:
    ``segment_reduce`` sums the contiguous runs (``lengths``) and one
    ``index_copy_`` places each sum at its index (``uniq``). The runs are a
    property of the static index, as the hint is, and are found once
    outside (:func:`sorted_runs`)."""
    tgt = torch.zeros((out, r.shape[1]), dtype=torch.float32, device=r.device)
    sums = torch.segment_reduce(r + i * 1e-30, "sum", lengths=lengths, axis=0)
    return tgt.index_copy_(0, uniq, sums)


def sorted_runs(ix: torch.Tensor) -> tuple:
    """(the distinct indices as int64, each one's run length) of sorted
    ``ix``."""
    uniq, lengths = torch.unique_consecutive(ix, return_counts=True)
    return uniq.long(), lengths


def gather_perm(i: int, r: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """``r[(ix + i) % N]``: the forward form, a gather by permutation."""
    return r.index_select(0, (ix + i) % r.shape[0])


# ---------------------------------------------------------------------------
# the plane bodies (the script's probe_plane_dus)
# ---------------------------------------------------------------------------


def plane_bases(k1: int = K1, cnt: int = CNT, wpr: int = WPR) -> list:
    """Each peer's word offset in the flat buffer (the script's ``bases``:
    ``cnt * (wpr + 1) + 512`` words apart, no multiple of ``wpr``)."""
    return [j * (cnt * (wpr + 1) + 512) for j in range(k1)]


def check_plane_sizes(wpr: int, cnt: int, k1: int, sbcap: int) -> None:
    """Raise unless every block lies inside the buffer: the script's
    dynamic-update-slices clamp a block that would not, and these copies
    do not."""
    last = plane_bases(k1, cnt, wpr)[-1]
    if sbcap % wpr or last // wpr + cnt > sbcap // wpr or last + wpr * cnt > sbcap:
        raise ValueError(f"wpr={wpr} cnt={cnt} k1={k1} do not fit a buffer of {sbcap} words "
                         f"as {sbcap // wpr} rows of {wpr}")


def plane_inputs(wpr: int = WPR, cnt: int = CNT, k1: int = K1, sbcap: int = SBCAP,
                 seed: int = 0) -> dict:
    """The script's draws, in its order, as int32 bit patterns: words
    [k1 * cnt, wpr], their transpose [wpr, k1 * cnt], and a buffer of
    ``sbcap`` words."""
    check_plane_sizes(wpr, cnt, k1, sbcap)
    rng = np.random.default_rng(seed)
    words2 = rng.integers(0, 2**31, (k1 * cnt, wpr), dtype=np.int64).astype(np.uint32)
    buf0 = rng.integers(0, 2**31, sbcap, dtype=np.int64).astype(np.uint32)
    return {"words2": words2.view(np.int32), "wordsT": np.ascontiguousarray(words2.T).view(np.int32),
            "buf0": buf0.view(np.int32)}


def dus_2d(i: int, w2: torch.Tensor, k1: int, cnt: int, sbcap: int) -> torch.Tensor:
    """Each peer's ``[cnt, wpr]`` block written into the buffer's
    ``[*, wpr]`` view at row ``bases[j] // wpr`` (rounded down, as the
    script's offsets are)."""
    wpr = w2.shape[1]
    w2 = w2 ^ i
    buf = torch.zeros(sbcap, dtype=w2.dtype, device=w2.device)
    b2 = buf.view(-1, wpr)
    for j, base in enumerate(plane_bases(k1, cnt, wpr)):
        b2[base // wpr: base // wpr + cnt] = w2[j * cnt:(j + 1) * cnt]
    return buf


def dus_plane(i: int, wt: torch.Tensor, k1: int, cnt: int, sbcap: int) -> torch.Tensor:
    """One 1-D copy a plane and peer: plane ``c`` of peer ``j`` at
    ``bases[j] + c * cnt`` (``k1 * wpr`` copies)."""
    wpr = wt.shape[0]
    wt = wt ^ i
    buf = torch.zeros(sbcap, dtype=wt.dtype, device=wt.device)
    for j, base in enumerate(plane_bases(k1, cnt, wpr)):
        for c in range(wpr):
            buf[base + c * cnt: base + (c + 1) * cnt] = wt[c, j * cnt:(j + 1) * cnt]
    return buf


def slice_2d(i: int, buf: torch.Tensor, wpr: int, k1: int, cnt: int) -> torch.Tensor:
    """Each peer's ``[cnt, wpr]`` block read from the ``[*, wpr]`` view,
    stacked into ``[k1 * cnt, wpr]``."""
    buf = buf ^ i
    b2 = buf.view(-1, wpr)
    return torch.cat([b2[base // wpr: base // wpr + cnt]
                      for base in plane_bases(k1, cnt, wpr)], dim=0)


def slice_plane(i: int, buf: torch.Tensor, wpr: int, k1: int, cnt: int) -> torch.Tensor:
    """Each plane's ``k1`` 1-D runs read and joined: ``[wpr, k1 * cnt]``."""
    buf = buf ^ i
    bases = plane_bases(k1, cnt, wpr)
    return torch.stack([torch.cat([buf[base + c * cnt: base + (c + 1) * cnt] for base in bases])
                        for c in range(wpr)], dim=0)


# ---------------------------------------------------------------------------
# timing and the probe's lines
# ---------------------------------------------------------------------------


def timeit(body, args: tuple, device: torch.device, reps: int = REPS) -> float:
    """Milliseconds an iteration: ``(t(10) - t(2)) / 8``, each ``t`` the
    least of ``reps`` loops after a warm-up loop, a loop running ``body(i,
    *args)`` for each ``i`` and summing the first 8 words of each result (as
    the script's ``timeit``). CUDA events on the card, the host clock on
    the CPU."""
    def loop(iters):
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(iters):
            acc += body(i, *args).reshape(-1)[:8].float().sum()
        return acc

    def run(iters):
        loop(iters)
        best = float("inf")
        for _ in range(reps):
            if device.type == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(device)
                a.record()
                loop(iters)
                b.record()
                b.synchronize()
                best = min(best, a.elapsed_time(b) / 1e3)
            else:
                t0 = time.perf_counter()
                loop(iters)
                best = min(best, time.perf_counter() - t0)
        return best

    t2, t10 = run(2), run(10)
    return (t10 - t2) / 8 * 1e3


def probe_transpose(device: torch.device) -> None:
    x = torch.arange(TRANSPOSE_PROGRAMS * RB * WPR, dtype=torch.int32).reshape(-1, WPR)
    ok = torch.equal(transpose_u32(x.to(device)).cpu(), x.t())
    if not ok:
        raise RuntimeError(f"transpose_u32 of [{x.shape[0]}, {WPR}] differs from x.T")
    print(f"transpose kernel (rb={RB}, wpr={WPR}): ok={ok}", flush=True)


def probe_scatter(device: torch.device, n: int = N, out: int = OUT, reps: int = REPS,
                  seed: int = 0) -> None:
    inp = scatter_inputs(n, out, seed)
    rows = torch.from_numpy(inp["rows"]).to(device)
    for name in ("rand", "sorted"):
        ix = torch.from_numpy(inp[name]).to(device)
        t = timeit(scatter_add, (rows, ix, out), device, reps)
        print(f"scatter-add f32 [N,128] {name:12s} {t:8.2f} ms", flush=True)
    uniq, lengths = sorted_runs(torch.from_numpy(inp["sorted"]).to(device))
    t = timeit(scatter_add_runs, (rows, uniq, lengths, out), device, reps)
    print(f"scatter-add f32 [N,128] {'sorted+hint':12s} {t:8.2f} ms", flush=True)
    t = timeit(gather_perm, (rows, torch.from_numpy(inp["perm"]).to(device)), device, reps)
    print(f"gather      f32 [N,128] perm   {t:8.2f} ms", flush=True)


def probe_plane_dus(device: torch.device, wpr: int = WPR, cnt: int = CNT, k1: int = K1,
                    sbcap: int = SBCAP, reps: int = REPS, seed: int = 0) -> None:
    inp = {k: torch.from_numpy(v).to(device)
           for k, v in plane_inputs(wpr, cnt, k1, sbcap, seed).items()}
    t = timeit(dus_2d, (inp["words2"], k1, cnt, sbcap), device, reps)
    print(f"DUS 2-D [*,{wpr}] view        {t:8.2f} ms", flush=True)
    t = timeit(dus_plane, (inp["wordsT"], k1, cnt, sbcap), device, reps)
    print(f"DUS per-plane 1-D ({k1 * wpr} ops) {t:8.2f} ms", flush=True)
    t = timeit(slice_2d, (inp["buf0"], wpr, k1, cnt), device, reps)
    print(f"slices 2-D [*,{wpr}] view     {t:8.2f} ms", flush=True)
    t = timeit(slice_plane, (inp["buf0"], wpr, k1, cnt), device, reps)
    print(f"slices per-plane 1-D          {t:8.2f} ms", flush=True)


def main(argv=None) -> dict:
    """Print the probe's lines; returns ``{"transpose_u32": launches}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; raises without one)")
    p.add_argument("--n", type=int, default=N, help="rows scattered and target rows")
    p.add_argument("--cnt", type=int, default=CNT, help="rows of a peer's block")
    p.add_argument("--sbcap", type=int, default=SBCAP, help="words of the flat buffer")
    p.add_argument("--reps", type=int, default=REPS, help="timed loops, the least kept")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    before = transpose_u32.launches
    probe_transpose(dev)
    probe_scatter(dev, args.n, args.n, args.reps, args.seed)
    probe_plane_dus(dev, WPR, args.cnt, K1, args.sbcap, args.reps, args.seed)
    return {"transpose_u32": transpose_u32.launches - before}


if __name__ == "__main__":
    main()
