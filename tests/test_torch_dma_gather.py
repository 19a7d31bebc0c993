"""The ring gather of the port against the TPU kernel it replaces, on the CPU.

``scripts/microbench_dma_gather.py::mk_dma_gather`` is module-level: the
script is imported by path, ``pallas_call`` runs in interpret mode and the
script's ``F`` is set to the test width. Its output (``h[idx]`` through a
ring of DMA semaphores, 8-row tiles and a masked reduce) must equal the
port's ``ring_gather`` bit for bit; on the CPU the port runs its plain
version, which ``chip_smoke.py`` and the ``gpu`` test below hold the CUDA
kernel against on the card.
"""
import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from adaqp_tpu_torch.scripts import microbench_dma_gather as dg

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "microbench_dma_gather.py"
F = 128


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("ref_microbench_dma_gather", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(script, monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(script, "F", F)
    return script


@pytest.mark.parametrize("n,chunk", [(64, 16), (256, 64), (1024, 4096)])
def test_idx_variants_match_the_script(script, monkeypatch, n, chunk):
    monkeypatch.setattr(script, "N", n)
    monkeypatch.setattr(script, "CHUNK", chunk)
    want = script.idx_variants(np.random.default_rng(3))
    got = dg.idx_variants(np.random.default_rng(3), n, chunk)
    assert list(got) == list(want) == ["uniform", "sorted", "banded"]
    for k in want:
        assert got[k].dtype == np.int32 and np.array_equal(got[k], want[k]), k
        assert got[k].min() >= 0 and got[k].max() < n


@pytest.mark.parametrize("variant", ["uniform", "sorted", "banded"])
@pytest.mark.parametrize("depth", [4, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ring_gather_matches_the_tpu_kernel(interpret, dtype, depth, variant):
    n, chunk, iters = (256, 64, 2) if depth == 4 else (128, 32, 1)
    rng = np.random.default_rng(depth)
    idx = dg.idx_variants(rng, n, chunk)[variant]
    h = rng.normal(size=(n, F)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    hj = jnp.asarray(h).astype(jdt)
    ref = interpret.mk_dma_gather(depth, iters, chunk, jdt)(
        jnp.asarray(idx), hj.reshape(n // interpret.GRP, interpret.GRP, F))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    ht = torch.from_numpy(h).to(getattr(torch, dtype))
    before = dg.ring_gather.launches
    got = dg.ring_gather(ht, torch.from_numpy(idx), iters, depth)
    assert dg.ring_gather.launches == before  # the plain version: no launch
    assert got.dtype == ht.dtype and got.shape == (chunk, F)
    assert torch.equal(got.float(), ref)
    assert torch.equal(got, ht[torch.from_numpy(idx).long()])


def test_ring_gather_takes_the_edges_and_no_rows():
    h = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    idx = torch.tensor([0, 63, 63, 0], dtype=torch.int32)
    assert torch.equal(dg.ring_gather(h, idx, 3, 2), h[[0, 63, 63, 0]])
    empty = dg.ring_gather(h, torch.zeros(0, dtype=torch.int32), 1, 4)
    assert empty.shape == (0, 8)


@pytest.mark.parametrize("bad,match", [
    (dict(h=torch.zeros(8, 6)), "multiple of the bulk copy"),      # 24-byte rows
    (dict(h=torch.zeros(8, 12, dtype=torch.bfloat16)), "multiple of the bulk copy"),
    (dict(idx=torch.zeros(4, dtype=torch.int64)), "int32"),
    (dict(idx=torch.zeros(2, 2, dtype=torch.int32)), "1-D"),
    (dict(h=torch.zeros(8, 8).t()), "contiguous"),
    (dict(depth=0), "at least 1"),
    (dict(iters=0), "at least 1"),
    (dict(h=torch.zeros(8, 8, device="meta"), idx=torch.zeros(4, dtype=torch.int32,
                                                                device="meta")), "no ring_gather"),
])
def test_ring_gather_refuses(bad, match):
    args = dict(h=torch.zeros(8, 8), idx=torch.zeros(4, dtype=torch.int32), iters=1, depth=4)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        dg.ring_gather(**args)


def test_main_prints_the_probe_on_the_cpu(capsys):
    assert dg.main(["--device", "cpu", "--f", "8", "--iters", "1", "--f32"]) == {
        "ring_gather": 0}
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 * (3 + 2 * len(dg.DEPTHS))
    for name in ("bf16", "f32"):
        mine = [x for x in lines if f" {name} " in x]
        assert [x.split()[0] for x in mine] == ["library"] * 3 + ["ring"] * 10
        assert all(x.endswith("correct=True") for x in mine if x.startswith("ring"))
    assert "[4096,8] of [233472]" in lines[0]


def test_main_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dg.main(["--iters", "1"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(dg.N, 256)).astype(np.float32)).to(cuda_device, dtype)
    for vname, vi in dg.idx_variants(rng).items():
        i = torch.from_numpy(vi).to(cuda_device)
        for depth in (1, 4, 64):
            before = dg.ring_gather.launches
            got = dg.ring_gather(h, i, 3, depth)
            assert dg.ring_gather.launches == before + 1
            assert torch.equal(got, dg._ring_gather_torch(h, i)), (vname, depth)
