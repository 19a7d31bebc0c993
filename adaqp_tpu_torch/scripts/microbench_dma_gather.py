"""Microbench: a ring of in-flight row copies against the library row gather.

The port's counterpart of ``scripts/microbench_dma_gather.py``. Its kernel
``ring_gather`` (``csrc/ring_gather.cu``) replaces the TPU kernel ``kern``
of that script's ``mk_dma_gather`` (``:72``, called at ``:116``):
``out[j] = h[idx[j]]`` for ``j < chunk``, repeated over ``iters`` passes in
one launch, with ``depth`` row copies in flight per thread block through a
ring of shared-memory slots (one ``cp.async.bulk`` and one ``mbarrier`` a
slot). It asks how fast the card gathers rows by index, and how much index
locality (uniform, sorted or banded indices) matters, against the library
gather (``index_select`` summed over the same passes).

The grid is a second knob (:func:`ring_plan`): by default the reference's
form, one program keeping ``depth`` copies in flight over the whole
stream; ``--many_blocks`` the many-block form, 4 rows a block. Each line
prints the copies in flight for the stream.

    python -m adaqp_tpu_torch.scripts.microbench_dma_gather            # bf16
    python -m adaqp_tpu_torch.scripts.microbench_dma_gather --f32      # and f32
    python -m adaqp_tpu_torch.scripts.microbench_dma_gather --many_blocks
    python -m adaqp_tpu_torch.scripts.microbench_dma_gather --device cpu --f 8

Flags take the place of the script's environment variables: ``--iters``
(``DG_ITERS``), ``--f`` (``DG_F``), ``--f32`` (``DG_F32``). Each depth's
output is held against the plain version (``h[idx]`` on the host), and a
mismatch raises. Timings are CUDA events around one launch after a
warm-up launch; on the card the index's 4,096 rows stay in L2 after the
first pass, so these are warm numbers (``chip_smoke.py`` also times a pass
with L2 flushed).
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..common.backend import resolve_device
from ..utils.cuda_build import raise_on
from . import time_call

N = 233_472        # source rows (Reddit scale)
CHUNK = 4096       # gathered rows a pass
DEPTHS = (4, 8, 16, 32, 64)
MAX_SMEM = 227 * 1024  # shared memory a block can use on Hopper
ROWS_A_BLOCK = 4  # rows a block owns in the many-block form


def idx_variants(rng: np.random.Generator, n: int = N, chunk: int = CHUNK) -> dict:
    """int32 [chunk] indices into ``n`` rows, drawn from ``rng`` as the
    script draws them: uniform, the same sorted, and banded (row j near
    ``j * (n // chunk)``)."""
    uni = rng.integers(0, n, chunk).astype(np.int32)
    return {
        "uniform": uni,
        "sorted": np.sort(uni),
        "banded": ((np.arange(chunk) * (n // chunk)) + rng.integers(0, 1024, chunk)
                   ).astype(np.int32) % n,
    }


def ring_plan(chunk: int, iters: int, depth: int, many_blocks: bool = False,
              sms: int = 1) -> tuple:
    """``(blocks, rows a block, copies in flight)`` of one launch.

    By default the reference's form: one block over the whole stream.
    ``many_blocks``: ``ROWS_A_BLOCK`` rows a block, and at least one block
    an SM (``sms``) while rows last. A block keeps ``min(depth, its rows *
    iters)`` row copies in flight; the third entry sums them over blocks."""
    if chunk <= 0:
        return 0, 0, 0
    blocks = 1
    if many_blocks:
        blocks = -(-chunk // ROWS_A_BLOCK)
        if blocks < sms:
            blocks = min(sms, chunk)
    rows = -(-chunk // blocks)
    blocks = -(-chunk // rows)
    last = chunk - (blocks - 1) * rows
    in_flight = (blocks - 1) * min(depth, rows * iters) + min(depth, last * iters)
    return blocks, rows, in_flight


def _ring_gather_torch(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return h.index_select(0, idx)


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("ring_gather")
    if lib.adaqp_ring_gather.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.adaqp_ring_gather.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.adaqp_ring_gather.restype = ci
        lib.adaqp_ring_gather_smem.argtypes = [ci, ci, ci]
        lib.adaqp_ring_gather_smem.restype = ctypes.c_size_t
        lib.adaqp_ring_gather_error_string.argtypes = [ci]
        lib.adaqp_ring_gather_error_string.restype = ctypes.c_char_p
    return lib


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (1 for the CPU)."""
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ring_gather_cuda(h, idx, iters, depth, many_blocks):
    chunk, row_bytes = idx.numel(), h.shape[1] * h.element_size()
    out = torch.empty((chunk, h.shape[1]), dtype=h.dtype, device=h.device)
    if chunk == 0:
        return out
    if h.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("ring_gather's bulk copies need 16-byte-aligned h and out")
    grid, rows, _ = ring_plan(chunk, iters, depth, many_blocks, sm_count(h.device))
    lib = _lib()
    smem = lib.adaqp_ring_gather_smem(depth, row_bytes, rows)
    if smem > MAX_SMEM:
        raise ValueError(f"depth {depth} of {row_bytes}-byte rows and {rows} rows a block need "
                         f"{smem} bytes of shared memory, more than a block's {MAX_SMEM}")
    rc = lib.adaqp_ring_gather(
        h.data_ptr(), idx.data_ptr(), out.data_ptr(), chunk, iters, depth, row_bytes, grid,
        rows, h.device.index, torch.cuda.current_stream(h.device).cuda_stream,
    )
    raise_on(lib.adaqp_ring_gather_error_string, rc, "ring_gather")
    ring_gather.launches += 1
    return out


def ring_gather(h: torch.Tensor, idx: torch.Tensor, iters: int, depth: int,
                many_blocks: bool = False) -> torch.Tensor:
    """``h[idx]`` for contiguous 2-D ``h`` and int32 ``idx`` [chunk] in
    ``[0, h.shape[0])``, computed ``iters`` times over in one launch with
    ``depth`` row copies in flight per thread block, on the grid of
    :func:`ring_plan` (one block over the whole stream, the reference's
    form; ``many_blocks``: 4 rows a block). Rows must be a multiple of 16
    bytes (the bulk copy's unit). An empty ``idx`` launches nothing.

    CUDA ``h``: the kernel (one more ``ring_gather.launches`` per launch);
    the indices are trusted, as by the library's gather on the card. CPU
    ``h``: the plain version. Any other device raises."""
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous 2-D tensor, got {tuple(h.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or idx.device != h.device:
        raise ValueError(f"idx must be 1-D int32 on {h.device}, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    if (h.shape[1] * h.element_size()) % 16:
        raise ValueError(f"rows of {h.shape[1]} x {h.element_size()} bytes are no multiple "
                         "of the bulk copy's 16 bytes")
    if iters < 1 or depth < 1:
        raise ValueError(f"iters ({iters}) and depth ({depth}) must be at least 1")
    if h.device.type == "cuda":
        return _ring_gather_cuda(h, idx.contiguous(), iters, depth, many_blocks)
    if h.device.type == "cpu":
        return _ring_gather_torch(h, idx)
    raise ValueError(f"no ring_gather for device {h.device}")


ring_gather.launches = 0


def library_gather(x: torch.Tensor, i: torch.Tensor, iters: int) -> torch.Tensor:
    """The script's ``xla_gather`` in torch ops: ``x[i]`` added into an
    accumulator of x's dtype ``iters`` times."""
    acc = torch.zeros((i.numel(), x.shape[1]), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        acc += x.index_select(0, i)
    return acc


def main(argv=None) -> dict:
    """Print the probe's lines; returns ``{"ring_gather": launches}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=50, help="passes over the chunk in one call")
    p.add_argument("--f", type=int, default=256, help="columns of h")
    p.add_argument("--f32", action="store_true", help="also run f32 rows after bf16")
    p.add_argument("--many_blocks", action="store_true",
                   help="the many-block form, 4 rows a block (default: the reference's one "
                        "program over the stream)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; raises without one)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    iters, f = args.iters, args.f
    before = ring_gather.launches
    rng = np.random.default_rng(args.seed)
    variants = idx_variants(rng, N, CHUNK)
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        h_host = torch.from_numpy(rng.normal(size=(N, f)).astype(np.float32)).to(dtype)
        h = h_host.to(dev)
        for vname, vi in variants.items():
            i = torch.from_numpy(vi).to(dev)
            t = time_call(lambda: library_gather(h, i, iters), dev)
            print(f"library gather {name} {vname:8s} [{CHUNK},{f}] of [{N}]: "
                  f"{t / (iters * CHUNK) * 1e9:7.1f} ns/row", flush=True)
        for vname in ("uniform", "banded"):
            i_host = torch.from_numpy(variants[vname])
            want = ring_gather(h_host, i_host, 1, 1)  # the plain version, on the host
            i = i_host.to(dev)
            for depth in DEPTHS:
                ok = torch.equal(ring_gather(h, i, iters, depth, args.many_blocks).cpu(), want)
                if not ok:
                    raise RuntimeError(f"ring_gather {name} {vname} depth={depth} differs "
                                       "from h[idx]")
                t = time_call(lambda: ring_gather(h, i, iters, depth, args.many_blocks), dev)
                grid, _, flight = ring_plan(CHUNK, iters, depth, args.many_blocks, sm_count(dev))
                print(f"ring gather {name} {vname:8s} depth={depth:3d} blocks={grid:4d} "
                      f"in_flight={flight:5d}: {t / (iters * CHUNK) * 1e9:7.1f} ns/row  "
                      f"correct={ok}", flush=True)
        if not args.f32:
            break
    return {"ring_gather": ring_gather.launches - before}


if __name__ == "__main__":
    main()
