"""The port stands alone: no JAX, no JAX package, and no silent CPU runs."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import adaqp_tpu_torch
from adaqp_tpu_torch import __main__ as cli
from adaqp_tpu_torch.comm.distributed import resolve_backend, spawn
from adaqp_tpu_torch.ops import spmm_strip
from adaqp_tpu_torch.trainer import RunConfig, Trainer

PKG = pathlib.Path(adaqp_tpu_torch.__file__).parent


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import adaqp_tpu_torch\n"
        "for m in pkgutil.walk_packages(adaqp_tpu_torch.__path__, 'adaqp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'adaqp_tpu' or k.startswith('adaqp_tpu.'))\n"
        "need = ['adaqp_tpu_torch.__main__', 'adaqp_tpu_torch.comm.exchange_ragged',\n"
        "        'adaqp_tpu_torch.ops.quant_cuda', 'adaqp_tpu_torch.assigner.profile',\n"
        "        'adaqp_tpu_torch.ops.spmm_compact', 'adaqp_tpu_torch.graph.compact_shards',\n"
        "        'adaqp_tpu_torch.ops.spmm', 'adaqp_tpu_torch.comm.exchange',\n"
        "        'adaqp_tpu_torch.scripts.microbench_dma_gather',\n"
        "        'adaqp_tpu_torch.scripts.microbench_gather',\n"
        "        'adaqp_tpu_torch.scripts.microbench_expand',\n"
        "        'adaqp_tpu_torch.scripts.probe_r5']\n"
        "assert all(m in sys.modules for m in need), need\n"
        "from adaqp_tpu_torch.comm.exchange import exchange_fp, exchange_quant, padded_start\n"
        "from adaqp_tpu_torch.ops.quant_cuda import quant_rows, dequant_rows\n"
        "from adaqp_tpu_torch.assigner.assignment import buckets_from_assignment\n"
        "print(len([k for k in sys.modules if k.startswith('adaqp_tpu_torch.')]), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        cwd=PKG.parent,
    ).stdout.split()
    assert int(out[0]) >= 30 and out[1] == "[]", out
    for src in ("quant_rows.cu", "quant_pack.cu", "counter_hash.cuh", "ring_gather.cu",
                "window_gather.cu", "compact_item.cu", "expand_tile.cu", "transpose_u32.cu"):
        assert (PKG / "csrc" / src).is_file(), src


def test_sources_never_name_the_jax_package():
    pattern = re.compile(r"\badaqp_tpu\b")
    files = [p for p in PKG.rglob("*") if p.is_file() and p.suffix in (".py", ".cu", ".yaml")]
    assert any(p.suffix == ".cu" for p in files)
    hits = [f"{p}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert hits == []


def test_entry_points_need_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour cannot show")
    cfg = RunConfig.from_yaml("sbm", {
        "num_parts": 1, "num_epochs": 1, "hidden_dim": 8,
        "synth_kwargs": {"n": 100, "num_feats": 8},
        "partition_dir": str(tmp_path / "p"), "exp_path": str(tmp_path / "e"),
        "mode": "Vanilla",
    })
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    assert Trainer(cfg, device="cpu").device.type == "cpu"

    e = np.zeros(0, np.int32)
    lay = spmm_strip.strip_layout(e, e, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lay.to_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lay.to_device("cuda")
    before = spmm_strip.strip_spmm.launches
    out = spmm_strip.strip_spmm(lay.to_device("cpu"), torch.ones(lay.n_src_pad, 8))
    assert not out.any() and spmm_strip.strip_spmm.launches == before  # plain version
    with pytest.raises(ValueError, match="no strip SpMM"):
        spmm_strip.strip_spmm(lay.to_device("cpu"), torch.ones(lay.n_src_pad, 8, device="meta"))
    # the launcher and the command line land on the card unless asked
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(print, 2, device="cuda", workdir=str(tmp_path / "l"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dataset", "sbm", "--num_parts", "1", "--mode", "Vanilla",
                  "--exp_path", str(tmp_path / "e")])


@pytest.mark.parametrize("over,what", [
    ({"ckpt_every": 5}, "checkpointing"),
    ({"resume": True}, "checkpointing"),
])
def test_unported_options_raise(tmp_path, over, what):
    cfg = RunConfig.from_yaml("sbm", {
        "num_parts": 1, "mode": "Vanilla", "partition_dir": str(tmp_path), **over,
    })
    with pytest.raises(NotImplementedError, match=what):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("impl", ["block", "compact"])
def test_tile_kernels_refuse_other_devices(impl):
    # as strip_spmm: a CPU tensor takes the plain version, a CUDA one the
    # kernel, and any other device raises
    import importlib

    mod = importlib.import_module(f"adaqp_tpu_torch.ops.spmm_{impl}")
    e = np.zeros(0, np.int32)
    lay = getattr(mod, f"{impl}_layout")(e, e, 2048).to_device("cpu")
    wrapper = getattr(mod, f"{impl}_spmm")
    with pytest.raises(ValueError, match=f"no {impl} SpMM"):
        wrapper(lay, torch.ones(lay.n_src_pad, 8, device="meta"))


def test_nccl_needs_a_card_per_rank(tmp_path, monkeypatch):
    cards = torch.cuda.device_count()
    assert resolve_backend(cards + 1, "cuda") == "gloo"
    assert resolve_backend(2, "cpu") == "gloo"
    if cards:
        assert resolve_backend(cards, "cuda") == "nccl"
    cfg = RunConfig.from_yaml("sbm", {
        "num_parts": 2, "mode": "Vanilla", "partition_dir": str(tmp_path),
    })
    with pytest.raises(RuntimeError, match="process group|torch.distributed"):
        Trainer(cfg, device="cpu")
    # a group the caller made over nccl while the ranks share a card (or
    # the CPU) is refused with a message naming gloo
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "nccl")
    with pytest.raises(ValueError, match="gloo"):
        Trainer(cfg, device="cpu")
