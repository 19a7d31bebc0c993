"""The round-5 probes of the port against ``scripts/probe_r5.py``.

The script is imported by path (it changes into the repository's root
when imported: ``monkeypatch.chdir`` puts the worker's directory back).
Its Pallas transpose runs in interpret mode and its output must equal the
port's ``transpose_u32`` (on the CPU its plain version) bit for bit. Its
scatter and gather bodies are captured through its ``timeit`` at small
``N``/``OUT`` (module globals) and held against the port's bodies on the
same inputs: the gather exactly, the scatter-adds within f32 summation
error (other orders of the same few adds). The plane bodies' sizes are
locals, so they are restated here in JAX at small sizes and held against
the port's bit for bit. The CUDA transpose is held against the plain
version by ``chip_smoke.py`` and the ``gpu`` tests of
``tests/test_torch_gpu.py``.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from adaqp_tpu_torch.scripts import probe_r5 as pr

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "probe_r5.py"


@pytest.fixture
def script(monkeypatch):
    monkeypatch.chdir(REPO)
    spec = importlib.util.spec_from_file_location("ref_probe_r5", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "log", lambda *a: None)
    return mod


def test_transpose_matches_the_tpu_kernel(script, monkeypatch):
    outs, real = [], pl.pallas_call

    def interpreted(*a, **k):
        call = real(*a, interpret=True, **k)

        def run(*args):
            outs.append(np.asarray(call(*args)))
            return outs[-1]
        return run

    monkeypatch.setattr(script.pl, "pallas_call", interpreted)
    script.probe_transpose()
    assert len(outs) == 1 and outs[0].shape == (25, 4096) and outs[0].dtype == np.uint32
    x = torch.arange(4 * 1024 * 25, dtype=torch.int32).reshape(4096, 25)
    before = pr.transpose_u32.launches
    got = pr.transpose_u32(x)
    assert pr.transpose_u32.launches == before  # the plain version: no launch
    assert got.is_contiguous() and np.array_equal(got.numpy().view(np.uint32), outs[0])


@pytest.mark.parametrize("shape", [(1, 1), (33, 31), (1000, 7), (7, 1000), (4097, 65), (0, 5)])
def test_transpose_takes_any_shape(shape):
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))
    got = pr.transpose_u32(x)
    assert got.shape == shape[::-1] and torch.equal(got, x.t())
    f = x.view(torch.float32)
    assert torch.equal(pr.transpose_u32(f).view(torch.int32), x.t())


@pytest.mark.parametrize("bad,exc,match", [
    (torch.zeros(4, 6, dtype=torch.int32).t(), ValueError, "contiguous"),
    (torch.zeros(8, dtype=torch.int32), ValueError, "2-D"),
    (torch.zeros(4, 6, dtype=torch.int16), TypeError, "32-bit"),
    (torch.zeros(4, 6, dtype=torch.int64), TypeError, "32-bit"),
    (torch.zeros(4, 6, dtype=torch.int32, device="meta"), ValueError, "no transpose_u32"),
])
def test_transpose_refuses(bad, exc, match):
    with pytest.raises(exc, match=match):
        pr.transpose_u32(bad)


def _capture(script, monkeypatch, n):
    monkeypatch.setattr(script, "N", n)
    monkeypatch.setattr(script, "OUT", n)
    seen = []
    monkeypatch.setattr(script, "timeit", lambda body, *a: seen.append((body, a)) or 0.0)
    script.probe_scatter()
    return seen


@pytest.mark.parametrize("i", [0, 3])
def test_scatter_and_gather_match_the_script(script, monkeypatch, i):
    n = 2048
    seen = _capture(script, monkeypatch, n)
    assert len(seen) == 4
    inp = pr.scatter_inputs(n, n, seed=0)
    (rand, (rows, ix_r)), (srt, (_, ix_s)), (hint, (_, ix_h)), (gat, (_, perm)) = seen
    for mine, ref in ((inp["rows"], rows), (inp["rand"], ix_r), (inp["sorted"], ix_s),
                      (inp["sorted"], ix_h), (inp["perm"], perm)):
        assert mine.dtype == np.asarray(ref).dtype and np.array_equal(mine, np.asarray(ref))
    r = torch.from_numpy(inp["rows"])
    ii = jnp.int32(i)
    # the script's first 8 rows, and the whole result against a float64 sum
    for body, ix, got in (
            (rand, ix_r, pr.scatter_add(i, r, torch.from_numpy(inp["rand"]), n)),
            (srt, ix_s, pr.scatter_add(i, r, torch.from_numpy(inp["sorted"]), n)),
            (hint, ix_h, pr.scatter_add_runs(
                i, r, *pr.sorted_runs(torch.from_numpy(inp["sorted"])), n))):
        ref = torch.from_numpy(np.array(body(ii, rows, ix)))
        assert got.shape == (n, 128) and got.dtype == torch.float32
        torch.testing.assert_close(got[:8], ref, rtol=1e-6, atol=1e-6)
        exact = np.zeros((n, 128))
        np.add.at(exact, np.asarray(ix), inp["rows"].astype(np.float64) + i * 1e-30)
        torch.testing.assert_close(got.double(), torch.from_numpy(exact), rtol=1e-6, atol=1e-6)
    got = pr.gather_perm(i, r, torch.from_numpy(inp["perm"]))  # the script's gather is whole
    assert torch.equal(got, torch.from_numpy(np.array(gat(ii, rows, perm))))


# the script's plane bodies (:128-177), restated at small sizes: the sizes
# are locals there; only the final [:8] slices are left off, so the whole
# results compare
WPR, CNT, K1, SBCAP = 5, 64, 3, 2500


def _j_bodies(wpr, cnt, k1, sbcap):
    bases = (np.arange(k1) * (cnt * (wpr + 1) + 512)).astype(np.int32)

    def dus2d(i, w2):
        w2 = w2 ^ i.astype(jnp.uint32)
        buf = jnp.zeros((sbcap,), jnp.uint32)
        for j in range(k1):
            blk = lax.dynamic_slice(w2, (j * cnt, 0), (cnt, wpr))
            b2 = buf.reshape(-1, wpr)
            b2 = lax.dynamic_update_slice(b2, blk, (bases[j] // wpr, 0))
            buf = b2.reshape(-1)
        return buf

    def dusplane(i, wT):
        wT = wT ^ i.astype(jnp.uint32)
        buf = jnp.zeros((sbcap,), jnp.uint32)
        for j in range(k1):
            for c in range(wpr):
                blk = lax.dynamic_slice(wT, (c, j * cnt), (1, cnt))[0]
                buf = lax.dynamic_update_slice_in_dim(buf, blk, bases[j] + c * cnt, 0)
        return buf

    def slice2d(i, buf):
        buf = buf ^ i.astype(jnp.uint32)
        out = []
        for j in range(k1):
            out.append(lax.dynamic_slice(
                buf.reshape(-1, wpr), (bases[j] // wpr, 0), (cnt, wpr)))
        return jnp.concatenate(out, axis=0)

    def sliceplane(i, buf):
        buf = buf ^ i.astype(jnp.uint32)
        planes = []
        for c in range(wpr):
            parts = [lax.dynamic_slice_in_dim(buf, bases[j] + c * cnt, cnt, 0)
                     for j in range(k1)]
            planes.append(jnp.concatenate(parts, 0))
        return jnp.stack(planes, 0)

    return dus2d, dusplane, slice2d, sliceplane


@pytest.mark.parametrize("i", [0, 5])
def test_plane_bodies_match_the_script(i):
    assert pr.plane_bases(K1, CNT, WPR) == list(
        (np.arange(K1) * (CNT * (WPR + 1) + 512)).astype(np.int32))
    inp = pr.plane_inputs(WPR, CNT, K1, SBCAP, seed=0)
    ju = {k: jnp.asarray(v.view(np.uint32)) for k, v in inp.items()}
    tt = {k: torch.from_numpy(v) for k, v in inp.items()}
    dus2d, dusplane, slice2d, sliceplane = _j_bodies(WPR, CNT, K1, SBCAP)
    ii = jnp.int32(i)
    for mine, ref in (
            (pr.dus_2d(i, tt["words2"], K1, CNT, SBCAP), dus2d(ii, ju["words2"])),
            (pr.dus_plane(i, tt["wordsT"], K1, CNT, SBCAP), dusplane(ii, ju["wordsT"])),
            (pr.slice_2d(i, tt["buf0"], WPR, K1, CNT), slice2d(ii, ju["buf0"])),
            (pr.slice_plane(i, tt["buf0"], WPR, K1, CNT), sliceplane(ii, ju["buf0"]))):
        ref = np.asarray(ref)
        assert mine.shape == ref.shape and mine.dtype == torch.int32
        assert np.array_equal(mine.numpy().view(np.uint32), ref)


def test_plane_inputs_are_the_scripts_draws():
    rng = np.random.default_rng(0)
    words2 = rng.integers(0, 2**31, (K1 * CNT, WPR), dtype=np.int64).astype(np.uint32)
    buf0 = rng.integers(0, 2**31, SBCAP, dtype=np.int64).astype(np.uint32)
    inp = pr.plane_inputs(WPR, CNT, K1, SBCAP, seed=0)
    assert np.array_equal(inp["words2"].view(np.uint32), words2)
    assert np.array_equal(inp["wordsT"].view(np.uint32), words2.T)
    assert np.array_equal(inp["buf0"].view(np.uint32), buf0)


@pytest.mark.parametrize("wpr,cnt,k1,sbcap", [(5, 64, 3, 2501), (5, 64, 3, 2000), (25, 265_216, 7, 40_000_000)])
def test_plane_sizes_that_would_clamp_raise(wpr, cnt, k1, sbcap):
    with pytest.raises(ValueError, match="do not fit"):
        pr.check_plane_sizes(wpr, cnt, k1, sbcap)
    pr.check_plane_sizes(pr.WPR, pr.CNT, pr.K1, pr.SBCAP)  # the script's sizes fit


def test_main_prints_the_probes_on_the_cpu(capsys):
    got = pr.main(["--device", "cpu", "--n", "2048", "--cnt", "64", "--sbcap", "50000",
                   "--reps", "1"])
    assert got == {"transpose_u32": 0}
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 9 and lines[0] == "transpose kernel (rb=1024, wpr=25): ok=True"
    assert [x.split()[0] for x in lines[1:]] == ["scatter-add"] * 3 + ["gather", "DUS", "DUS",
                                                                       "slices", "slices"]
    assert all(x.endswith(" ms") for x in lines[1:])


def test_main_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pr.main(["--n", "2048"])
