"""Network cost-model profiling over ``torch.distributed`` (reference:
``AdaQP/assigner/profile.py``; the JAX package's ``assigner/profile.py``).

The reference times warmed-up blocking p2p sends per ordered pair and fits
a per-channel linear alpha-beta model (``profile.py:46-106``). Here each
probe is the exchange's own transport, ``all_to_all_single``, with every
split zero except one:

- ``mode="pair"``: K*(K-1) probes, each ordered pair (s, r) alone;
- ``mode="offset"``: K-1 probes, in round ``o`` every rank sends to
  ``(i + o) % K``, so one collective times one ring-offset class (its
  slowest channel sets the time of all of them);
- ``mode="auto"``: ``pair`` for K <= 8, ``offset`` above.

Every rank takes part in every probe and times it on the host clock (after
a device synchronisation when the buffers are on a card); the times are
then all-reduced with MAX on the group's device (a card under NCCL, which
carries no CPU tensor; the CPU under gloo), so all ranks hold the same
``[K, K, S]`` curves and fit the same model. :func:`fit_cost_model` is the
JAX package's, unchanged.
"""
from __future__ import annotations

import logging
import time
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..comm.ragged import ragged_all_to_all

logger = logging.getLogger("adaqp_tpu_torch")


def _probe_sizes(max_bytes_per_pair: int, num_sizes: int) -> np.ndarray:
    sizes = np.linspace(
        max(1024, max_bytes_per_pair // num_sizes),
        max(2048, max_bytes_per_pair),
        num_sizes,
    ).astype(np.int64)
    return (sizes // 128 + 1) * 128  # 128-byte multiples: whole u32 words


def _time_a2a(pairs, nbytes: int, reps: int, device: torch.device) -> float:
    """Host-clock milliseconds of one all-to-all in which each ``(s, r)``
    of ``pairs`` ships ``nbytes`` and every other split is empty."""
    k, me = dist.get_world_size(), dist.get_rank()
    words = int(nbytes) // 4
    send, recv = [0] * k, [0] * k
    for s, r in pairs:
        if s == me:
            send[r] = words
        if r == me:
            recv[s] = words
    buf = torch.zeros(sum(send), dtype=torch.int32, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ragged_all_to_all(buf, send, recv)  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        ragged_all_to_all(buf, send, recv)
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def profile_cost_model(
    max_bytes_per_pair: int,
    num_sizes: int = 8,
    reps: int = 5,
    mode: str = "auto",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Probe the transport with buffers on ``device``; returns ``(sizes_mb
    [S], times_ms [K, K, S])``, the same on every rank (the diagonal stays
    0). The times are all-reduced on ``device`` under NCCL and on the CPU
    under gloo. Collective: every rank of the default process group must
    call it."""
    k = dist.get_world_size() if dist.is_initialized() else 1
    if mode == "auto":
        mode = "pair" if k <= 8 else "offset"
    if mode not in ("pair", "offset"):
        raise ValueError(f"unknown profile mode {mode!r}")
    sizes = _probe_sizes(max_bytes_per_pair, num_sizes)
    times = np.zeros((k, k, len(sizes)))
    if k == 1:
        return sizes / 1e6, times
    device = torch.device("cpu") if device is None else torch.device(device)
    if mode == "offset":
        groups = [[(i, (i + off) % k) for i in range(k)] for off in range(1, k)]
    else:
        groups = [[(s, r)] for s in range(k) for r in range(k) if s != r]
    for pairs in groups:
        for si, sz in enumerate(sizes):
            t = _time_a2a(pairs, sz, reps, device)
            for s, r in pairs:
                times[s, r, si] = t
    on = device if dist.get_backend() == "nccl" else torch.device("cpu")
    agreed = torch.as_tensor(times, dtype=torch.float64, device=on)
    dist.all_reduce(agreed, op=dist.ReduceOp.MAX)
    return sizes / 1e6, agreed.cpu().numpy()


def fit_cost_model(
    sizes_mb: np.ndarray, times_ms: np.ndarray, min_r2: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel least-squares fit -> ``(alpha [K,K] ms/MB, beta [K,K]
    ms)`` (reference: per-channel ``np.polyfit(size, time, 1)``,
    ``profile.py:97-106``).

    Accepts ``times_ms`` of shape [S] (one global curve; returns scalars)
    or [K, K, S]. Channels with R^2 below ``min_r2`` (and non-trivial
    timing spread) are logged — the MILP consumes a linear model, so a bad
    fit means its time term misranks those channels.
    """
    times_ms = np.asarray(times_ms)
    if times_ms.ndim == 1:
        alpha, beta = np.polyfit(sizes_mb, times_ms, 1)
        return float(max(alpha, 1e-6)), float(max(beta, 0.0))

    k = times_ms.shape[0]
    alphas = np.zeros((k, k))
    betas = np.zeros((k, k))
    bad = []
    for s in range(k):
        for r in range(k):
            if s == r or not times_ms[s, r].any():
                continue
            t = times_ms[s, r]
            a, b = np.polyfit(sizes_mb, t, 1)
            alphas[s, r] = max(a, 1e-6)
            betas[s, r] = max(b, 0.0)
            resid = t - (alphas[s, r] * sizes_mb + betas[s, r])
            ss_tot = float(((t - t.mean()) ** 2).sum())
            if ss_tot > 1e-12:
                r2 = 1.0 - float((resid**2).sum()) / ss_tot
                if r2 < min_r2:
                    bad.append((s, r, r2))
    if bad:
        worst = min(bad, key=lambda x: x[2])
        logger.warning(
            "cost-model fit is poor on %d/%d channels (worst %d->%d R^2=%.2f): "
            "the fabric's timing is not linear in payload size; the MILP's "
            "time term will misrank those channels",
            len(bad), k * (k - 1), worst[0], worst[1], worst[2],
        )
    return alphas, betas
