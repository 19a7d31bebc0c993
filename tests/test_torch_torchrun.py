"""The port under ``torchrun``: two CPU processes started by
``python -m torch.distributed.run`` each run one rank of ``python -m
adaqp_tpu_torch`` (``comm/distributed.py::run_from_env``, rendezvous from
the environment), and rank 0 writes the run's artifacts. The counterpart of
the JAX package's two-process ``tests/test_multihost.py``."""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _LaunchFailed(Exception):
    pass


def _torchrun(workdir: pathlib.Path):
    workdir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
         "-m", "adaqp_tpu_torch", "--dataset", "sbm", "--num_parts", "2", "--mode", "Vanilla",
         "--num_epochs", "2", "--hidden_dim", "16", "--device", "cpu",
         "--exp_path", str(workdir / "exp")],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=300,
    )
    if out.returncode != 0:
        raise _LaunchFailed(out.stderr[-4000:])
    return out, workdir / "exp" / "sbm400" / "2part" / "gcn"


def test_torchrun_two_ranks_write_the_artifacts(tmp_path):
    # the free port can be taken between the probe and the bind, and the
    # rendezvous can time out on a loaded host: a failed launch is retried
    # once in a fresh directory; the checks below are not
    try:
        out, base = _torchrun(tmp_path / "try1")
    except (_LaunchFailed, subprocess.TimeoutExpired):
        out, base = _torchrun(tmp_path / "try2")
    # each process is one rank of the group torchrun set up
    for rank in (0, 1):
        assert f"K=2 rank={rank}" in out.stderr, out.stderr[-3000:]
    metrics = (base / "metrics" / "Vanilla.txt").read_text()
    assert metrics.startswith("best epoch: ")
    csv = np.genfromtxt(base / "time" / "Vanilla.csv", delimiter=",", names=True)
    assert csv["Worker"].tolist() == [0.0, 1.0]
    assert (csv["Per_epoch"] > 0).all()
    assert len(np.load(base / "val_curve" / "Vanilla.npy")) == 2
