"""Layer recomputation (``remat``) and the memory report (``log_hbm``) in
the port's Trainer, on the CPU.

Recomputation changes memory and time and nothing else: with ``remat`` on,
a run gives the losses, parameters, validation curve, variance traces and
reassigned lane widths of the run with it off, bit for bit. At K=1 with
dropout 0.5 (the recompute draws its mask again from the generator state
the layer first drew from), and at K=2 over gloo in AdaQP adaptive on both
wires (overlapped) and in AdaQP-q (serial). The recompute ships nothing
again: the wire's kernels run as often as without it, the tile kernel
twice a layer more, as the Trainer's plans say; the overlapped modes keep
their exchange in flight across the local aggregation. The two runs of a
K=2 case read one transport profile, so their MILPs solve with one
alpha-beta fit. Against the JAX package: both Trainers with ``remat``
give the same losses and parameters. ``python -m adaqp_tpu_torch`` takes
``--remat``, ``--log_hbm`` and ``--static_wire``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from adaqp_tpu_torch.comm.distributed import spawn
from adaqp_tpu_torch.trainer import RunConfig, Trainer

SYNTH = {"n": 600, "blocks": 4, "num_feats": 16, "seed": 9}
K2_RUNS = {
    "AdaQP adaptive ragged": {"mode": "AdaQP"},
    "AdaQP adaptive padded": {"mode": "AdaQP", "wire_impl": "padded"},
    "AdaQP-q adaptive": {"mode": "AdaQP-q"},
}


def _cfg(tmp, cls=RunConfig, **over):
    return cls.from_yaml("sbm", {
        "num_parts": 1, "num_epochs": 4, "hidden_dim": 16, "mode": "Vanilla",
        "log_steps": 100, "measure_breakdown": False, "synth_kwargs": SYNTH,
        "logger_level": "WARNING", "partition_dir": f"{tmp}/parts", "exp_path": f"{tmp}/exp",
        # the last destination block (88 rows) goes to the ELL tail
        "block_min_edges": 2000, **over,
    })


class _Counts:
    """Counts the calls that launch a kernel on the card (the wrappers'
    counters count only there): every strip call, and every lane kernel
    call that has lanes; and logs the order of the exchanges' starts and
    finishes around the tile calls."""

    def __init__(self, mp):
        from adaqp_tpu_torch.comm import exchange as ex
        from adaqp_tpu_torch.comm import exchange_ragged as er
        from adaqp_tpu_torch.ops import dist_ops as do
        from adaqp_tpu_torch.ops import spmm_strip as ss

        self.n = dict.fromkeys(("strip", "quant", "dequant"), 0)
        self.events = []

        def count(mod, name, key, lanes):
            fn = getattr(mod, name)

            def wrapped(*a, **kw):
                if key == "strip" or lanes(a).n:
                    self.n[key] += 1
                if key == "strip":
                    self.events.append("tile")
                return fn(*a, **kw)

            mp.setattr(mod, name, wrapped)

        def log(name, event):
            fn = getattr(do, name)
            mp.setattr(do, name, lambda *a, **kw: (self.events.append(event), fn(*a, **kw))[1])

        count(ss, "strip_spmm", "strip", None)
        count(er, "pack_lanes", "quant", lambda a: a[1])
        count(er, "unpack_lanes", "dequant", lambda a: a[1])
        count(ex, "quant_frames", "quant", lambda a: a[1])
        count(ex, "dequant_frames", "dequant", lambda a: a[1])
        for name in ("exchange_start", "padded_start", "quant_start"):
            log(name, "start")
        for name in ("exchange_finish", "padded_finish"):
            log(name, "finish")

    def reset(self):
        self.n = dict.fromkeys(self.n, 0)
        self.events = []


def _run(tmp, device, counts, **over):
    """One training run: its results, with the calls ``counts`` saw."""
    t = Trainer(_cfg(tmp, **over), device=device)
    reassigned, reassign = [], t._reassign
    t._reassign = lambda e: (reassigned.append(e), reassign(e))
    counts.reset()
    rec = t.train()
    return {
        "losses": rec["loss_curve"], "val": rec["val_curve"],
        "params": [p.detach().clone() for _, p in t._named_params()],
        "traces": [t.trace_fwd.clone(), t.trace_bwd.clone()],
        "asg": (None if t.assignment is None
                else [np.asarray(a) for a in t.assignment.fwd + t.assignment.bwd]),
        "reassigned": reassigned, "counts": dict(counts.n), "events": list(counts.events),
        "planned": (rec["planned_tile_launches"], *rec["planned_quant_launches"]),
        "hbm": rec["hbm"],
        "cost": None if t.assigner is None else (t.assigner.alpha, t.assigner.beta),
    }


def _same(a, b):
    assert np.array_equal(a["losses"], b["losses"])
    assert np.array_equal(a["val"], b["val"])
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"], strict=True))
    assert all(torch.equal(x, y) for x, y in zip(a["traces"], b["traces"], strict=True))
    assert (a["asg"] is None) == (b["asg"] is None)
    if a["asg"] is not None:
        assert all(np.array_equal(x, y) for x, y in zip(a["asg"], b["asg"], strict=True))
    assert a["reassigned"] == b["reassigned"]


def test_k1_remat_equals_the_plain_run_with_dropout(tmp_path, monkeypatch):
    counts = _Counts(monkeypatch)
    plain, remat = (_run(tmp_path, "cpu", counts, dropout_rate=0.5, log_hbm=True, remat=r)
                    for r in (False, True))
    _same(plain, remat)
    assert plain["losses"][-1] < plain["losses"][0]
    # the recompute runs each layer's two forward aggregations once more a
    # step: 4 epochs x 3 layers x 2
    assert remat["counts"]["strip"] == remat["planned"][0] == plain["planned"][0] + 24
    assert plain["counts"]["strip"] == plain["planned"][0]
    assert plain["hbm"] is remat["hbm"] is None  # no analysis on the CPU


@pytest.mark.parametrize("peak_before,peak,temps,exact", [
    (5_000, 9_000, 8_000, True),  # the step set the peak: its own
    (12_000, 12_000, 11_000, False),  # an earlier peak hides the step's: a bound
])
def test_log_hbm_line_reads_the_counters_without_resetting(tmp_path, monkeypatch, caplog,
                                                           peak_before, peak, temps, exact):
    # the card's counters, faked: the report reads them and resets nothing
    t = Trainer(_cfg(tmp_path, num_epochs=1, logger_level="INFO"), device="cpu")
    for p in t.params[0].values():
        p.grad = torch.zeros_like(p)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: peak)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: pytest.fail("the report reset the peak counter"))
    grads = sum(p.numel() * 4 for p in t.params[0].values())
    got = t._log_step_memory((1_000, peak_before))
    assert got == {"args": 1_000, "temps": temps, "output": grads, "temps_exact": exact}
    line = [r.getMessage() for r in caplog.records if "train-step HBM" in r.getMessage()]
    assert len(line) == 1 and ("at most" in line[0]) == (not exact)
    assert f"temps {temps}, args 1000, output {grads}" in line[0]


def _one_cost_model(mp):
    """Every Trainer of this process reads the transport profile that the
    first one took: two adaptive runs compared bit for bit must feed their
    MILP one alpha-beta fit, and the timings of two profiles differ."""
    from adaqp_tpu_torch.trainer import trainer as tr

    profile, taken = tr.profile_cost_model, {}

    def once(**kw):
        key = tuple(sorted(kw.items()))
        if key not in taken:  # collective: every rank reaches it together
            taken[key] = profile(**kw)
        return taken[key]

    mp.setattr(tr, "profile_cost_model", once)


def _k2_rank(rank, world, device, tmp):
    """Each run of K2_RUNS with remat off and on (dropout 0.5, assign_cycle
    2: a reassignment at epoch 3), the two reading one cost model; each
    run's results and the calls it made."""
    mp = pytest.MonkeyPatch()
    counts = _Counts(mp)
    _one_cost_model(mp)
    out = {}
    try:
        for name, over in K2_RUNS.items():
            for remat in (False, True):
                out[name, remat] = _run(
                    tmp, device, counts, num_parts=2, assign_scheme="adaptive",
                    assign_cycle=2, dropout_rate=0.5, block_min_edges=1, remat=remat, **over)
    finally:
        mp.undo()
    assert "jax" not in sys.modules and "adaqp_tpu" not in sys.modules
    return out


@pytest.fixture(scope="module")
def k2(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("k2"))
    return spawn(_k2_rank, 2, "cpu", args=(tmp,), workdir=f"{tmp}/launch")


@pytest.mark.parametrize("name", list(K2_RUNS))
def test_k2_remat_equals_the_plain_run(k2, name):
    for rank in k2:
        plain, remat = rank[name, False], rank[name, True]
        assert all(np.array_equal(x, y) for x, y in zip(plain["cost"], remat["cost"], strict=True))
        _same(plain, remat)
        assert plain["reassigned"] == [3]
        assert plain["traces"][0].abs().sum() > 0 and plain["traces"][1].abs().sum() > 0


@pytest.mark.parametrize("name", list(K2_RUNS))
def test_k2_remat_ships_once_and_launches_as_planned(k2, name):
    layers, epochs = 3, 4
    for rank in k2:
        plain, remat = rank[name, False], rank[name, True]
        for run in (plain, remat):
            got = run["counts"]
            assert (got["strip"], got["quant"], got["dequant"]) == run["planned"]
            assert got["quant"] > 0
        # the same exchanges: no second shipment in the recompute
        assert (remat["counts"]["quant"], remat["counts"]["dequant"]) == \
            (plain["counts"]["quant"], plain["counts"]["dequant"])
        assert remat["counts"]["strip"] == plain["counts"]["strip"] + 2 * layers * epochs
        assert remat["events"].count("start") == plain["events"].count("start")


@pytest.mark.parametrize("name", list(K2_RUNS))
def test_k2_remat_keeps_the_schedule(k2, name):
    # overlapped modes: the local aggregation runs while the exchange is in
    # flight (start, tile, finish); serial modes finish first
    overlapped = K2_RUNS[name]["mode"] == "AdaQP"
    for rank in k2:
        for remat in (False, True):
            ev = rank[name, remat]["events"]
            after = [ev[i + 1] for i, e in enumerate(ev) if e == "start"]
            assert after and set(after) == {"tile" if overlapped else "finish"}, (remat, after)


def test_matches_jax_trainer_with_remat(tmp_path):
    # test_torch_trainer.py::test_matches_jax_trainer's pairing: the port's
    # strip against the JAX Trainer's block, both recomputing their layers
    import jax

    from adaqp_tpu.trainer import RunConfig as JRunConfig
    from adaqp_tpu.trainer import Trainer as JTrainer

    over = dict(dropout_rate=0.0, remat=True, num_epochs=6)
    jt = JTrainer(_cfg(tmp_path / "jax", JRunConfig, spmm_impl="block", **over))
    assert jt.static.remat
    jlosses, make = [], jt._make_train_step

    def recording_step():
        step = make()

        def run(*args):
            out = step(*args)
            jlosses.append(float(out[2]))
            return out

        return run

    jt._make_train_step = recording_step
    init = jax.tree.map(np.asarray, jt.params)
    jrec = jt.train()
    t = Trainer(_cfg(tmp_path / "port", **over), device="cpu")
    assert t.static.remat and t.blocks.counts[0][1] > 0
    t.load_params(init)
    rec = t.train()
    assert len(jlosses) == len(rec["loss_curve"]) == 6
    np.testing.assert_allclose(rec["loss_curve"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(rec["val_curve"], jrec["val_curve"], atol=1e-4)
    want = jax.tree.map(np.asarray, jt.params)
    for layer, jlayer in zip(t.params, want):
        assert layer.keys() == jlayer.keys()
        for name, p in layer.items():
            np.testing.assert_allclose(
                p.detach().numpy(), jlayer[name], rtol=1e-3, atol=1e-4, err_msg=name
            )


def test_command_line_takes_remat_log_hbm_and_static_wire(tmp_path):
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "adaqp_tpu_torch", "--dataset", "sbm", "--num_parts", "2",
         "--assign_scheme", "uniform", "--num_epochs", "2", "--hidden_dim", "16",
         "--remat", "1", "--log_hbm", "--static_wire", "1", "--device", "cpu",
         "--exp_path", str(tmp_path / "exp")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    # one line a rank: the CPU has no memory analysis
    assert out.stderr.count("hbm analysis unavailable on this backend") == 2, out.stderr[-3000:]
    assert (tmp_path / "exp" / "sbm400" / "2part" / "gcn" / "metrics" / "AdaQP_uniform.txt").exists()


def test_command_line_flags_reach_the_config():
    from adaqp_tpu_torch.__main__ import config_from_args, parse_args

    cfg = config_from_args(parse_args(["--remat", "1", "--log_hbm", "--static_wire", "0"]))
    assert (cfg.remat, cfg.log_hbm, cfg.static_wire) == (True, True, False)
    cfg = config_from_args(parse_args([]))
    assert (cfg.remat, cfg.log_hbm, cfg.static_wire) == (False, False, None)
