"""The port's Trainer on the padded dense wire (``wire_impl="padded"``) at
K=2 over gloo ranks on the CPU, against the JAX package's padded Trainer
and against the port's own ragged wire.

One launch of two ranks trains, in turn, on the SBM (600 nodes):

- Vanilla, AdaQP-p, AdaQP and AdaQP-q (uniform 8 bits) on the padded wire
  and Vanilla on the ragged wire, 5 epochs from the JAX Trainer's initial
  parameters, f32, no dropout; Vanilla and AdaQP uniform with the
  breakdown probe on;
- AdaQP with the adaptive scheme (14 epochs, ``assign_cycle=6``:
  reassignments at epochs 7 and 13) and with the random scheme, with
  dropout, as ``tests/test_trainer.py`` trains them;
- AdaQP uniform with ``spmm_impl="block"`` and the probe on.

The JAX side runs its padded Trainer in Vanilla (``spmm_impl="block"``,
which pads like the port's strip path). The ranks import only torch and
the port.
"""
import sys

import numpy as np
import pytest
from torch_helpers import spawn_beside

SYNTH = {"n": 600, "blocks": 4, "num_feats": 16, "seed": 9}
EXACT = {"dropout_rate": 0.0, "num_epochs": 5, "init": True}
RUNS = {
    "Vanilla": {"mode": "Vanilla", "measure_breakdown": True, **EXACT},
    "Vanilla ragged": {"mode": "Vanilla", "wire_impl": "ragged", **EXACT},
    "AdaQP-p": {"mode": "AdaQP-p", **EXACT},
    "AdaQP uniform": {"mode": "AdaQP", "assign_scheme": "uniform", "measure_breakdown": True,
                      **EXACT},
    "AdaQP-q uniform": {"mode": "AdaQP-q", "assign_scheme": "uniform", **EXACT},
    "AdaQP adaptive": {"mode": "AdaQP", "assign_scheme": "adaptive", "num_epochs": 14,
                       "assign_cycle": 6},
    "AdaQP random": {"mode": "AdaQP", "assign_scheme": "random", "num_epochs": 14,
                     "assign_cycle": 6},
    "AdaQP uniform block": {"mode": "AdaQP", "assign_scheme": "uniform", "spmm_impl": "block",
                            "measure_breakdown": True, "num_epochs": 3},
}


def _cfg(cls, tmp, tag, **over):
    return cls.from_yaml("sbm", {
        "num_parts": 2, "hidden_dim": 24, "log_steps": 100, "measure_breakdown": False,
        "synth_kwargs": SYNTH, "assign_bits": 8, "logger_level": "WARNING",
        "profile_data_length": 2, "wire_impl": "padded", "block_min_edges": 1,
        "partition_dir": f"{tmp}/parts_{tag}", "exp_path": f"{tmp}/exp_{tag}", **over,
    })


def _rank_train(rank, world, device, tmp, init):
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    out = {}
    for name, over in RUNS.items():
        over = dict(over)
        load = over.pop("init", False)
        t = Trainer(_cfg(RunConfig, tmp, name.replace(" ", "_"), **over), device=device)
        if load:
            t.load_params(init)
        n = []
        reassign = t._reassign
        t._reassign = lambda epoch: (n.append(epoch), reassign(epoch))
        rec = t.train()
        t.save(rec)
        params = np.concatenate([p.detach().reshape(-1).numpy()
                                 for layer in t.params for p in layer.values()])
        out[name] = {"loss": rec["loss_curve"], "params": params, "reassigned": n,
                     "best": rec["best"], "planned": rec["planned_quant_launches"],
                     "buckets": t.timer.epoch_traced_time(), "probe": rec["probe_launches"]}
    assert "jax" not in sys.modules and "adaqp_tpu" not in sys.modules
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from adaqp_tpu.trainer import RunConfig as JRunConfig
    from adaqp_tpu.trainer import Trainer as JTrainer

    tmp = str(tmp_path_factory.mktemp("pad"))
    over = {k: v for k, v in RUNS["Vanilla"].items() if k != "init"}
    jt = JTrainer(_cfg(JRunConfig, tmp, "jax", spmm_impl="block",
                       **{**over, "measure_breakdown": False}))
    init = jax.tree.map(np.asarray, jt.params)
    losses = []
    make = jt._make_train_step

    def recording_step():
        step = make()

        def run(*args):
            out = step(*args)
            losses.append(float(out[2]))
            return out

        return run

    jt._make_train_step = recording_step
    # the ranks need only the initial parameters: they train while JAX does
    join = spawn_beside(_rank_train, (tmp, init), tmp)
    try:
        jt.train()
    finally:
        res = join()
    assert jt.buckets_dev is None and jt.wire_fp_dev is None  # the padded fp exchange
    return np.asarray(losses), res, tmp


def test_vanilla_matches_jax_padded_trainer(runs):
    jlosses, res, _ = runs
    losses = res[0]["Vanilla"]["loss"]
    assert len(losses) == len(jlosses) == 5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


@pytest.mark.parametrize("a,b", [("Vanilla", "Vanilla ragged"), ("AdaQP-p", "Vanilla"),
                                 ("AdaQP uniform", "AdaQP-q uniform")])
def test_runs_equal_bit_for_bit(runs, a, b):
    # padded fp == ragged fp; overlapped == serial on the padded wire
    res = runs[1]
    for r in range(2):
        np.testing.assert_array_equal(res[r][a]["loss"], res[r][b]["loss"])
        np.testing.assert_array_equal(res[r][a]["params"].view(np.int32),
                                      res[r][b]["params"].view(np.int32))


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_stay_identical_and_learn(runs, name):
    res = runs[1]
    r0, r1 = res[0][name], res[1][name]
    np.testing.assert_array_equal(r0["loss"], r1["loss"])
    np.testing.assert_array_equal(r0["params"].view(np.int32), r1["params"].view(np.int32))
    assert np.isfinite(r0["loss"]).all() and r0["loss"][-1] < r0["loss"][0]
    quantized = name.startswith("AdaQP ") or name.startswith("AdaQP-q")
    # the ragged wire launches its pair for full-precision lanes too
    assert ((r0["planned"][0] > 0) == (quantized or "ragged" in name)
            and r0["planned"][0] == r0["planned"][1])
    assert r0["reassigned"] == r1["reassigned"] == (
        [7, 13] if name in ("AdaQP adaptive", "AdaQP random") else [])
    if r0["reassigned"]:
        assert r0["best"][2] > 0.9  # best val accuracy, as tests/test_trainer.py asks


@pytest.mark.parametrize("name,quant", [("AdaQP uniform", True), ("AdaQP uniform block", True),
                                        ("Vanilla", False)])
def test_breakdown_buckets_in_the_time_csv(runs, name, quant):
    _, res, tmp = runs
    mode = name.split()[0]
    stem = mode + ("_uniform" if quant else "")
    csv = np.genfromtxt(f"{tmp}/exp_{name.replace(' ', '_')}/sbm600/2part/gcn/time/{stem}.csv",
                        delimiter=",", names=True)
    np.testing.assert_array_equal(csv["Worker"], [0, 1])
    for bucket in ("Comm", "Central", "Marginal"):
        assert (csv[bucket] > 0).all(), bucket
    assert (csv["Quant"] > 0).all() if quant else not csv["Quant"].any()
    probe = res[0][name]["probe"]
    kernel = "block_spmm" if "block" in name else "strip_spmm"
    assert probe[kernel] == 6 * (2 * 3 + 2 * 2)  # warm-up + 5 timed calls a part
    assert probe.get("quant_rows", 0) == probe.get("dequant_rows", 0) == (18 if quant else 0)


def test_fp32_lanes_needs_the_ragged_wire(tmp_path):
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    cfg = _cfg(RunConfig, str(tmp_path), "x", mode="AdaQP", fp32_lanes=True, num_parts=1)
    with pytest.raises(ValueError, match="ragged wire"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="wire_impl"):
        Trainer(_cfg(RunConfig, str(tmp_path), "x", wire_impl="dense", num_parts=1), device="cpu")


def test_breakdown_probe_at_k1(tmp_path):
    # one partition: no exchange, so Comm and Quant stay 0; the probe runs
    # the aggregation a step runs (no halo transpose at K=1)
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    cfg = _cfg(RunConfig, str(tmp_path), "k1", num_parts=1, mode="AdaQP", num_epochs=1,
               measure_breakdown=True)
    t = Trainer(cfg, device="cpu")
    rec = t.train()
    comm, quant, central, marginal, _ = t.timer.epoch_traced_time()
    assert comm == quant == 0 and central > 0 and marginal > 0
    assert rec["probe_launches"] == t.probe_launches() == {"strip_spmm": 6 * (2 * 3 + 2)}
