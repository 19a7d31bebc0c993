"""The port's counterparts of the repository's ``scripts/`` probes.

Each module holds the kernels of one probe (a wrapper that launches a
hand-written CUDA kernel on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor, with a launch count) and a ``main()`` that prints
the probe's lines:

    python -m adaqp_tpu_torch.scripts.microbench_dma_gather [--f32] [--many_blocks] [--device cpu]
    python -m adaqp_tpu_torch.scripts.microbench_gather [--iters N] [--device cpu]
    python -m adaqp_tpu_torch.scripts.microbench_expand [--f 640] [--n N --e E] [--device cpu]
    python -m adaqp_tpu_torch.scripts.probe_r5 [--device cpu]

The mains run on the CUDA card unless ``--device cpu`` is given, and raise
where the script they replace printed ``FAILED`` and went on.
"""
from __future__ import annotations

import time

import torch


def time_call(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn`` after a warm-up call: CUDA events on
    the card, the host clock on the CPU (where nothing is asynchronous)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
