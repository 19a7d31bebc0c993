"""The port's partitioning: the native library (``adaqp_tpu_torch/native``)
against the numpy path and the JAX package's native path, the logged
fallback, and ``python -m adaqp_tpu_torch.graph_partition`` against the
repository's ``graph_partition.py``."""
import logging
import os
import sys
import types

import numpy as np
import pytest
from torch_helpers import random_edges

from adaqp_tpu_torch import graph_partition, native
from adaqp_tpu_torch.graph import partition as part_mod
from adaqp_tpu_torch.helper.dataset import sbm_graph
from adaqp_tpu_torch.trainer import RunConfig, Trainer


def _edges(rng, n, e):
    src, dst = random_edges(rng, n, e)
    keep = src != dst  # as partition_graph drops self-loops
    return src[keep], dst[keep]


def test_native_csr_equals_numpy(rng):
    src, dst = _edges(rng, 3000, 40_000)
    indptr, indices = native.build_csr(src, dst, 3000)
    want = part_mod._csr_from_edges(src, dst, 3000)
    assert np.array_equal(indptr, want[0]) and np.array_equal(indices, want[1])
    with pytest.raises(ValueError, match="outside"):
        native.build_csr(src, dst, 100)


@pytest.mark.parametrize("n,k", [(5000, 4), (20_000, 8)])
def test_native_ldg_equals_numpy_and_the_jax_package(rng, n, k):
    from adaqp_tpu.native import ldg_partition as jax_package_ldg

    src, dst = _edges(rng, n, 12 * n)
    got = part_mod.partition_ldg(src, dst, n, k)
    assert got.dtype == np.int32 and np.bincount(got, minlength=k).min() > 0
    assert np.array_equal(got, part_mod.partition_ldg(src, dst, n, k, native=False))
    assert np.array_equal(got, jax_package_ldg(src, dst, n, k))


@pytest.mark.parametrize("broken", [False, True])
def test_partition_graph_logs_its_path(tmp_path, monkeypatch, caplog, broken):
    g = sbm_graph(n=400, seed=3)
    if broken:  # a source that does not compile: the compiler's message, then numpy
        bad = tmp_path / "bad.cc"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SRC", str(bad))
        monkeypatch.setattr(native, "LIB", str(tmp_path / "lib.so"))
        monkeypatch.setattr(native, "_lib", None)
    with caplog.at_level(logging.INFO, logger="adaqp_tpu_torch"):
        part = part_mod.partition_graph(g, 4, "ldg")
    path = "numpy" if broken else "native"
    assert f"nodes into 4 parts: {path} path" in caplog.text
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    if broken:
        assert len(warned) == 1 and "g++ failed" in warned[0].getMessage()
        assert "bad.cc" in warned[0].getMessage()  # the compiler's own words
    else:
        assert warned == []
    keep = g.src != g.dst
    assert np.array_equal(part, part_mod.partition_ldg(g.src[keep], g.dst[keep], 400, 4,
                                                       native=False))


def _reference_cli(argv, monkeypatch):
    """Run the repository's graph_partition.py with ``argv``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    monkeypatch.setattr(sys, "argv", ["graph_partition.py", *argv])
    import graph_partition as reference

    reference.main()


def test_cli_writes_the_reference_file(tmp_path, monkeypatch, capsys):
    common = ["--dataset", "sbm", "--partition_size", "4"]
    out = graph_partition.main([*common, "--partition_dir", str(tmp_path / "port")])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    _reference_cli([*common, "--partition_dir", str(tmp_path / "ref")], monkeypatch)
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert out == f"{tmp_path}/port/sbm400_4part_ldg.npy"
    with open(out, "rb") as a, open(tmp_path / "ref" / "sbm400_4part_ldg.npy", "rb") as b:
        assert a.read() == b.read()
    assert port_line.replace("/port/", "/ref/") == ref_line


def test_trainer_reads_the_cli_file(tmp_path, caplog):
    out = graph_partition.main(["--dataset", "sbm", "--partition_size", "4",
                                "--partition_dir", str(tmp_path), "--method", "random"])
    cfg = RunConfig.from_yaml("sbm", {"num_parts": 4, "partition_method": "random",
                                      "partition_dir": str(tmp_path), "seed": 5})
    # the Trainer's cache lookup, without the four ranks a K=4 Trainer needs
    stub = types.SimpleNamespace(cfg=cfg, graph=sbm_graph())
    with caplog.at_level(logging.INFO, logger="adaqp_tpu_torch"):
        part = Trainer._load_or_partition(stub)
    assert f"loaded partition cache {out}" in caplog.text
    # the file's partition (seed 0), not the one seed 5 would draw
    assert np.array_equal(part, np.load(out))
    assert not np.array_equal(part, part_mod.partition_random(400, 4, 5))
