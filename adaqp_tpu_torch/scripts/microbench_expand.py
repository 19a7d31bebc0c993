"""Microbench: block SpMM through dense 0/1 tiles on the tensor cores.

The port's counterpart of ``scripts/microbench_expand.py``. Its kernel
``expand_spmm`` (``csrc/expand_tile.cu``) replaces the TPU kernel
``kernel`` of that script's ``make_run`` (``:48``, called at ``:149``):
one block-SpMM pass ``out = A^T h`` over a block layout, where each
tile's bitmask is expanded into a dense 0/1 bf16 matrix and multiplied
with its 2,048-row source window (f32 accumulate), under four ways of
computing the expansion:

    v0  (w >> bit) & 1 -> f32 -> bf16
    v1  (w >> bit) & 1 -> bf16 directly
    v2  (w << (31 - bit)) < 0 -> select 1 / 0
    v3  w -> bf16 (WRONG math on purpose: the timing floor)

On the card the question is whether a dense tensor-core product of the
expanded tiles beats the set-bit walk of the port's tile kernels
(``ops/spmm_block.py::block_spmm``).

    python -m adaqp_tpu_torch.scripts.microbench_expand [--f 640] [--iters 5]
    python -m adaqp_tpu_torch.scripts.microbench_expand --n 32768 --e 16121856
    python -m adaqp_tpu_torch.scripts.microbench_expand --device cpu --n 4096 --e 262144 --f 128

The reference reads the cached forward layout of ``python bench.py``; the
port builds its own from ``helper/dataset.py::synth_reddit`` (the same
laws, other draws; Reddit's 232,965 nodes and 114,615,892 edges by
default, ``--n``/``--e`` to cut it) with ``block_layout(min_edges=192)``,
cached under ``data/expand_cache/`` at the checkout's root
(``--cache_dir``). Each variant chains ``--iters`` passes, each on the
previous output; timings are CUDA events around one chain after a warm-up
chain. Where the reference printed ``FAILED`` and went on, this raises:
on a failed launch, a non-finite v0-v2 output, or v1/v2 output that
differs from v0's.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import time

import numpy as np
import torch

from ..common.backend import resolve_device
from ..helper.dataset import REDDIT_C, REDDIT_E, REDDIT_N, synth_reddit
from ..ops.spmm_block import (BD, WORDS, BlockDevice, _run_block_torch, block_layout,
                              check_cuda_operands, expand_masks, run_tiles_torch)
from ..utils.cuda_build import raise_on
from . import time_call

VARIANTS = ("v0", "v1", "v2", "v3")
MIN_EDGES = 192  # the reference layout's dense-tile threshold
COLS = 128  # output columns of one kernel block: F must be a multiple
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "data",
                         "expand_cache")


def expand_raw(words: torch.Tensor) -> torch.Tensor:
    """v3's ``a``: int16 [c, BD, WORDS] -> f32 [c, BD, 16 * WORDS] holding
    the sign-extended halfword ``j % WORDS`` at column ``j``, rounded to
    bf16 (the reference's ``repeat(words.astype(int32)).astype(bf16)``)."""
    return words.to(torch.int32).repeat(1, 1, 16).to(torch.bfloat16).to(torch.float32)


def _run_expand_torch(layout: BlockDevice, h: torch.Tensor, variant: str) -> torch.Tensor:
    """Plain version: v0-v2 expand to the same 0/1 matrix, so theirs is
    the block twin ``_run_block_torch``; v3 the same loop on
    :func:`expand_raw`. f32 sums, rounded once to bf16."""
    if variant != "v3":
        return _run_block_torch(layout, h.float()).to(torch.bfloat16)
    t = int(layout.blk_ptr[-1])
    return run_tiles_torch(layout.masks, layout.src_start, layout.dst_blk[:t], layout.n_pad,
                           h.float(), expand_raw).to(torch.bfloat16)


def term_magnitudes(layout: BlockDevice, h: torch.Tensor, variant: str) -> torch.Tensor:
    """f32 ``[n_pad, F]``: the sum of ``|a[r, j] * h[j, c]|`` over the tiles,
    the scale of the error of an f32 sum of those terms taken in another
    order (the kernel's comparisons use it: the kernel sums on the tensor
    cores, and v3's terms reach 3e4 |h| of both signs)."""
    t = int(layout.blk_ptr[-1])
    expand = (lambda w: expand_raw(w).abs()) if variant == "v3" else expand_masks
    return run_tiles_torch(layout.masks, layout.src_start, layout.dst_blk[:t], layout.n_pad,
                           h.float().abs(), expand)


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("expand_tile")
    if lib.adaqp_expand_spmm.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.adaqp_expand_spmm.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.adaqp_expand_spmm.restype = ci
        lib.adaqp_expand_error_string.argtypes = [ci]
        lib.adaqp_expand_error_string.restype = ctypes.c_char_p
    return lib


def _expand_cuda(layout: BlockDevice, h: torch.Tensor, variant: str) -> torch.Tensor:
    check_cuda_operands(h, layout.n_src_pad, (
        ("masks", layout.masks, torch.int16),
        ("src_start", layout.src_start, torch.int32),
        ("blk_ptr", layout.blk_ptr, torch.int32),
    ))
    n_blocks = layout.n_pad // BD
    if layout.blk_ptr.numel() != n_blocks + 1 or tuple(layout.masks.shape[1:]) != (BD, WORDS):
        raise ValueError("layout shapes do not match n_pad")
    if layout.masks.data_ptr() % 16:
        raise ValueError("expand_spmm's 16-byte mask loads need 16-byte-aligned masks")
    out = torch.empty((layout.n_pad, h.shape[1]), dtype=torch.bfloat16, device=h.device)
    lib = _lib()
    rc = lib.adaqp_expand_spmm(
        layout.masks.data_ptr(), layout.src_start.data_ptr(), layout.blk_ptr.data_ptr(),
        h.data_ptr(), out.data_ptr(), n_blocks, h.shape[1], VARIANTS.index(variant),
        h.device.index,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    raise_on(lib.adaqp_expand_error_string, rc, "expand_spmm")
    expand_spmm.launches += 1
    return out


def expand_spmm(layout: BlockDevice, h: torch.Tensor, variant: str) -> torch.Tensor:
    """One pass ``A^T h`` over the tiles of a square block layout, each
    tile expanded to a dense ``a`` as ``variant`` (v0-v3) says; bf16 ``h``
    ``[n_pad, F]`` with F a positive multiple of 128; bf16 out ``[n_pad, F]``
    (f32 sums rounded once).

    CUDA ``h``: the kernel (one more ``expand_spmm.launches`` per launch).
    CPU ``h``: the plain version. Any other device raises, as does any
    other F, dtype or a rectangular layout: nothing is padded quietly."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if layout.n_src_pad != layout.n_pad:
        raise ValueError(f"expand_spmm takes square layouts (passes chain); this one maps "
                         f"{layout.n_src_pad} source rows to {layout.n_pad}")
    if h.dtype != torch.bfloat16:
        raise TypeError(f"h must be bfloat16 (the tensor cores' operand), got {h.dtype}")
    if h.dim() != 2 or h.shape[0] != layout.n_pad:
        raise ValueError(f"h must be [{layout.n_pad}, F], got {tuple(h.shape)}")
    if h.shape[1] <= 0 or h.shape[1] % COLS:
        raise ValueError(f"F must be a positive multiple of {COLS}, got {h.shape[1]}")
    if h.device.type == "cuda":
        return _expand_cuda(layout, h, variant)
    if h.device.type == "cpu":
        return _run_expand_torch(layout, h, variant)
    raise ValueError(f"no expand_spmm for device {h.device}")


expand_spmm.launches = 0


def reddit_layout(n: int, e: int, seed: int, device: torch.device,
                  cache_dir: str = CACHE_DIR) -> tuple:
    """``(BlockLayout, host seconds, cache hit)`` of the forward block layout
    of ``synth_reddit(n, e, seed=seed)`` at ``min_edges=192``, its edges
    drawn on ``device``; cached as ``<cache_dir>/blk_synthreddit_...npz``
    (an empty ``cache_dir`` builds it every time)."""
    t0 = time.perf_counter()
    key = None
    if cache_dir:
        key = os.path.join(cache_dir, f"blk_synthreddit_{n}_{e}_s{seed}_me{MIN_EDGES}_fwd")
        if os.path.exists(key + ".npz"):
            empty = np.zeros(0, np.int32)
            lay = block_layout(empty, empty, n, min_edges=MIN_EDGES, cache_key=key)
            return lay, time.perf_counter() - t0, True
    g = synth_reddit(n, e, 1, REDDIT_C, seed=seed, device=device)
    lay = block_layout(g.src, g.dst, n, min_edges=MIN_EDGES, cache_key=key)
    return lay, time.perf_counter() - t0, False


def main(argv=None) -> dict:
    """Print the probe's lines; returns ``{"expand_spmm": launches}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--f", type=int, default=640, help="columns of h (a multiple of 128)")
    p.add_argument("--iters", type=int, default=5, help="chained passes a timed call")
    p.add_argument("--n", type=int, default=REDDIT_N, help="nodes of the synthetic graph")
    p.add_argument("--e", type=int, default=REDDIT_E, help="directed edges, self-loops included")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; raises without one)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache_dir", type=str, default=CACHE_DIR,
                   help="where the layout is cached ('' to build it every time)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    before = expand_spmm.launches
    lay, secs, hit = reddit_layout(args.n, args.e, args.seed, dev, args.cache_dir)
    print(f"layout n={args.n} e={args.e} min_edges={MIN_EDGES}: {secs:.1f} s on the host "
          f"({'cached' if hit else 'built'})", flush=True)
    d = lay.to_device(dev)
    t = int(d.blk_ptr[-1])
    rng = np.random.default_rng(args.seed)
    h = torch.from_numpy(rng.normal(size=(lay.n_pad, args.f)).astype(np.float32)).to(
        dev, torch.bfloat16)
    print(f"tiles={t} n_pad={lay.n_pad} f={args.f}", flush=True)

    outs = {}

    def chain(variant):
        cur = h
        for _ in range(args.iters):
            cur = expand_spmm(d, cur, variant)
        outs[variant] = cur

    for variant in VARIANTS:
        secs = time_call(lambda: chain(variant), dev)
        dt = secs / args.iters
        print(f"{variant}: {dt * 1e3:8.2f} ms/pass  ({dt / max(t, 1) * 1e6:.2f} us/tile)",
              flush=True)
    if not torch.isfinite(outs["v0"].float()).all():
        raise RuntimeError("v0's chained output is not finite")
    for variant in ("v1", "v2"):
        if not torch.equal(outs[variant], outs["v0"]):
            raise RuntimeError(f"{variant} expands to another matrix than v0")
    return {"expand_spmm": expand_spmm.launches - before}


if __name__ == "__main__":
    main()
