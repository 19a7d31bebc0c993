"""Helpers that several of the port's test files share (not collected as
tests): random edge lists, the small strip layouts the strip kernel's walk
must take, and a launch of two CPU ranks beside the caller's JAX training.
Imports only numpy and pytest at the top, so that the card's machine (no
JAX there) imports it with ``tests/test_torch_gpu.py``."""
import numpy as np
import pytest


def random_edges(rng, n, e, n_src=None):
    """``e`` edges into ``n`` rows from ``n_src`` (default ``n``) sources:
    half near the diagonal, half uniform."""
    ns = n if n_src is None else n_src
    src = rng.integers(0, ns, e).astype(np.int32)
    dst = np.where(
        rng.random(e) < 0.5,
        (src + rng.integers(-300, 300, e)) % n,
        rng.integers(0, n, e),
    ).astype(np.int32)
    return src, dst


def strip_cases(rng):
    """name -> (src, dst, n, n_src, min_edges): the layouts the strip
    kernel's walk must take (tests/test_torch_spmm_strip.py checks their
    walk arrays on the CPU, tests/test_torch_gpu.py the kernel on them)."""
    e0 = np.zeros(0, np.int32)
    rs, rd = random_edges(rng, 2100, 30000, 5000)
    fs, fd = random_edges(rng, 2048, 6000, 4096)
    blk = np.repeat(np.arange(8), 400)  # block b's edges all in window b
    return {
        "empty": (e0, e0, 2048, 4096, 1),
        "rectangular": (rs, rd, 2100, 5000, 8),
        "full row": (np.concatenate([np.arange(2048, dtype=np.int32), fs]),
                     np.concatenate([np.full(2048, 300, np.int32), fd]), 2048, 4096, 1),
        "single edge": (np.array([3000], np.int32), np.array([100], np.int32), 2048, 4096, 1),
        "disjoint windows": ((blk * 2048 + rng.integers(0, 2048, blk.size)).astype(np.int32),
                             (blk * 256 + rng.integers(0, 256, blk.size)).astype(np.int32),
                             2048, 8 * 2048, 1),
    }


def spawn_beside(worker, args, tmp):
    """Start the two CPU ranks in a thread (one torch thread a rank) and
    return a function that joins them and gives their results, so that the
    caller's JAX training overlaps theirs."""
    import threading

    from adaqp_tpu_torch.comm.distributed import spawn

    out = {}

    def launch():
        try:
            out["res"] = spawn(worker, 2, "cpu", args=args, workdir=f"{tmp}/launch")
        except BaseException as exc:  # re-raised by join
            out["exc"] = exc

    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")  # one thread a rank beside other test workers
    thread = threading.Thread(target=launch)
    thread.start()

    def join():
        thread.join()
        mp.undo()
        if "exc" in out:
            raise out["exc"]
        return out["res"]

    return join
