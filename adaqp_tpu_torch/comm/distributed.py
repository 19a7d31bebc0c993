"""Process groups for K>1: one ``torch.distributed`` rank per partition.

Reference: torchrun rendezvous + gloo process group
(``AdaQP/communicator/comm.py:28-35``); the JAX package's
``comm/distributed.py`` connects its hosts with ``jax.distributed``.

Backends. ``nccl`` needs one CUDA card per rank. When ranks share a card
(K ranks on one card) or run on the CPU, the backend is ``gloo``; gloo takes
CUDA tensors and stages them through host memory, so the kernels and the
aggregation still run on the card and only the transport crosses the host.
The backend is not a choice: it is ``nccl`` exactly when every rank on
this host has its own card, else ``gloo``. A rank's card is
``cuda:(local rank % cards)``.

:func:`spawn` starts the ranks of one run on this machine with
``torch.multiprocessing`` and a ``file://`` rendezvous (no port to collide
on), runs a worker function in each, and returns each rank's result; a
rank's exception fails the whole launch. :func:`run_from_env` runs one
rank under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set).
"""
from __future__ import annotations

import datetime
import os
import pickle
import time
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from ..common.backend import DeviceLike

# a collective that waits longer than this fails the run instead of hanging
DEFAULT_TIMEOUT_S = 900


def resolve_backend(local_world: int, device: DeviceLike) -> str:
    """The process-group backend for ``local_world`` ranks on this host on
    ``device``'s kind: ``nccl`` when each has a card of its own, else
    ``gloo``."""
    kind = torch.device(device).type if device is not None else "cuda"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if kind == "cuda" and cards >= local_world else "gloo"


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank % cards``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is visible")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(rank: int, world: int, backend: str, init_method: str,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group as ``rank`` of ``world``."""
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _entry(rank, world, device, backend, init_method, timeout_s, worker, args, out_dir):
    # the ranks share this host's cores: K ranks with a thread per core each
    # oversubscribe them (tenfold slower CPU runs); fewer when the
    # environment asks for fewer (OMP_NUM_THREADS)
    cores = (os.cpu_count() or 1) // world
    torch.set_num_threads(max(1, min(torch.get_num_threads(), cores)))
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(rank, world, backend, init_method, timeout_s)
    try:
        result = worker(rank, world, dev, *args)
        dist.barrier()
    finally:
        destroy_distributed()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(worker: Callable, world: int, device: DeviceLike = "cuda",
          args: Sequence = (), workdir: str = "build/launch",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``worker(rank, world, device, *args)`` on ``world`` new
    processes joined in one process group; returns the workers' results in
    rank order. ``worker`` and ``args`` must pickle (a module-level
    function). Files of the rendezvous and the results go under
    ``workdir``."""
    backend = resolve_backend(world, device)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to PyTorch; pass device='cpu'")
    run_dir = os.path.abspath(os.path.join(workdir, f"run_{os.getpid()}_{time.time_ns()}"))
    os.makedirs(run_dir)
    init_method = "file://" + os.path.join(run_dir, "rendezvous")
    torch.multiprocessing.spawn(
        _entry, nprocs=world, join=True,
        args=(world, device, backend, init_method, timeout_s, worker, tuple(args), run_dir),
    )
    out = []
    for r in range(world):
        with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def run_from_env(worker: Callable, device: DeviceLike = "cuda",
                 args: Sequence = (), timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """Run ``worker(rank, world, device, *args)`` as one rank of a
    ``torchrun`` launch (rendezvous from the environment)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = resolve_backend(int(os.environ.get("LOCAL_WORLD_SIZE", world)), device)
    dev = rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(rank, world, backend, "env://", timeout_s)
    try:
        return worker(rank, world, dev, *args)
    finally:
        destroy_distributed()
