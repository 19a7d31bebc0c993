"""The port's Trainer at K=2 over gloo ranks on the CPU, and its assigner,
against the JAX package's.

One launch of two ranks trains, in turn and from the JAX Trainer's initial
parameters (f32, no dropout, 5 epochs on the SBM): Vanilla, AdaQP-p (the
same math overlapped), AdaQP and AdaQP-q with uniform 8-bit widths (the
quantized wire, overlapped and serial), and AdaQP with the adaptive scheme
and ``assign_cycle=2`` (profiling, two reassignments). The ranks import
only torch and the port. The JAX side runs ``spmm_impl="block"``, which
pads like the port's strip path (2048 rows, 128 feature lanes). The same
launch then trains Vanilla with ``spmm_impl`` block, compact and segment,
each from the JAX Trainer's initial parameters for that impl (its own
first-weight shape), against the JAX Trainer with the same impl. After
AdaQP uniform has trained, each rank runs one more step under
``torch.profiler``: the exchange's spans, and the ragged wire's byte
counter against the wires in force.
"""
import sys

import numpy as np
import pytest
from torch_helpers import spawn_beside

SYNTH = {"n": 600, "blocks": 4, "num_feats": 16, "seed": 9}
EPOCHS = 5
RUNS = {
    "Vanilla": {"mode": "Vanilla"},
    "AdaQP-p": {"mode": "AdaQP-p"},
    "AdaQP uniform": {"mode": "AdaQP", "assign_scheme": "uniform"},
    "AdaQP-q uniform": {"mode": "AdaQP-q", "assign_scheme": "uniform"},
    "AdaQP adaptive": {"mode": "AdaQP", "assign_scheme": "adaptive", "assign_cycle": 2},
}
IMPLS = ("block", "compact", "segment")


def _cfg(cls, tmp, tag, **over):
    return cls.from_yaml("sbm", {
        "num_parts": 2, "num_epochs": EPOCHS, "hidden_dim": 16, "mode": "Vanilla",
        "log_steps": 100, "measure_breakdown": False, "synth_kwargs": SYNTH,
        "dropout_rate": 0.0, "assign_bits": 8, "logger_level": "WARNING",
        "partition_dir": f"{tmp}/parts_{tag}", "exp_path": f"{tmp}/exp_{tag}",
        **over,
    })


def _traced_step(t):
    """One more training step of ``t`` under the profiler: the bytes the
    ragged wire sent, 4 (an int32 word) times the send splits of the wires
    in force (each layer's forward, and its backward but layer 0's), and the
    ``adaqp.*`` spans as (name, start, end)."""
    from torch.profiler import ProfilerActivity, profile

    from adaqp_tpu_torch.comm.ragged import ragged_all_to_all

    sent = ragged_all_to_all.bytes
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t._train_step(EPOCHS + 1)
    sent = ragged_all_to_all.bytes - sent
    planned = 4 * sum(sum(w.send_splits) for pair in t.wire_q for w in pair if w is not None)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("adaqp.")]
    return sent, planned, spans


def _rank_train(rank, world, device, tmp, inits):
    """Every run of RUNS in turn on this rank, then a Vanilla run of each of
    IMPLS; returns each run's losses, parameters, reassignment epochs and
    planned quant launches, and under ``"traced"`` AdaQP uniform's
    :func:`_traced_step`."""
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    out = {}
    runs = [(name, over, "strip") for name, over in RUNS.items()]
    runs += [(impl, {"mode": "Vanilla", "spmm_impl": impl}, impl) for impl in IMPLS]
    for name, over, init in runs:
        t = Trainer(_cfg(RunConfig, tmp, "port", block_min_edges=1, **over), device=device)
        t.load_params(inits[init])
        n = []
        reassign = t._reassign
        t._reassign = lambda epoch: (n.append(epoch), reassign(epoch))
        rec = t.train()
        t.save(rec)
        params = np.concatenate([p.detach().reshape(-1).numpy()
                                 for layer in t.params for p in layer.values()])
        out[name] = (rec["loss_curve"], params, n, rec["planned_quant_launches"])
        if name == "AdaQP uniform":
            out["traced"] = _traced_step(t)
    assert "jax" not in sys.modules and "adaqp_tpu" not in sys.modules
    return out


def _jax_trainer(cfg):
    """The JAX Trainer of ``cfg``, its initial parameters, and the list its
    training steps' losses go into."""
    import jax

    from adaqp_tpu.trainer import Trainer as JTrainer

    t = JTrainer(cfg)
    losses = []
    make = t._make_train_step

    def recording_step():
        step = make()

        def run(*args):
            out = step(*args)
            losses.append(float(out[2]))
            return out

        return run

    t._make_train_step = recording_step
    return t, jax.tree.map(np.asarray, t.params), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from adaqp_tpu.trainer import RunConfig as JRunConfig

    tmp = str(tmp_path_factory.mktemp("k2"))
    jax_runs = {impl: _jax_trainer(_cfg(JRunConfig, tmp, "jax" if impl == "block" else f"jax_{impl}",
                                        spmm_impl=impl)) for impl in IMPLS}
    inits = {"strip": jax_runs["block"][1], **{impl: r[1] for impl, r in jax_runs.items()}}
    # the ranks need only the initial parameters: they train while JAX does
    join = spawn_beside(_rank_train, (tmp, inits), tmp)
    try:
        jrec = {impl: t.train() for impl, (t, _, _) in jax_runs.items()}
    finally:
        res = join()
    jt = jax_runs["block"][0]
    impl_losses = {impl: np.asarray(r[2]) for impl, r in jax_runs.items()}
    return jt, jrec["block"], impl_losses["block"], res, tmp, inits, impl_losses


def test_vanilla_matches_jax_trainer(runs):
    jt, jrec, jlosses, res, *_ = runs
    assert jt.layout.l_max == 2048 and jt.static.f_pad == 128 and jt.k == 2
    losses = res[0]["Vanilla"][0]
    assert len(losses) == len(jlosses) == EPOCHS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_stay_identical_and_learn(runs, name):
    res = runs[3]
    (l0, p0, n0, q0), (l1, p1, n1, q1) = res[0][name], res[1][name]
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(p0.view(np.int32), p1.view(np.int32))
    assert np.isfinite(l0).all() and l0[-1] < l0[0]
    # one quant_pack and one unpack_dequant launch per exchange direction in
    # every mode (32-bit lanes too): 3 forward and 2 backward in training,
    # 3 forward in evaluation, each epoch
    assert tuple(q0) == tuple(q1) == (8 * EPOCHS, 8 * EPOCHS)
    assert n0 == n1 == ([3, 5] if "adaptive" in name else [])


@pytest.mark.parametrize("overlapped,serial", [
    ("AdaQP-p", "Vanilla"), ("AdaQP uniform", "AdaQP-q uniform")])
def test_overlap_equals_serial(runs, overlapped, serial):
    res = runs[3]
    for r in range(2):
        np.testing.assert_array_equal(res[r][overlapped][0], res[r][serial][0])
        np.testing.assert_array_equal(res[r][overlapped][1].view(np.int32),
                                      res[r][serial][1].view(np.int32))


def test_exchange_spans_and_wire_bytes(runs):
    res = runs[3]
    for r in range(2):
        sent, planned, spans = res[r]["traced"]
        assert sent == planned > 0
        inside = lambda sp, outer: any(o[0] == outer and o[1] <= sp[1] and sp[2] <= o[2]
                                       for o in spans)
        for part in ("adaqp.communication.start", "adaqp.communication.wait",
                     "adaqp.quantization"):
            mine = [sp for sp in spans if sp[0] == part]
            # both directions: three layers forward inside the aggregation,
            # two backward (layer 0 has none)
            assert sum(inside(sp, "adaqp.aggregate") for sp in mine) >= 3, part
            assert sum(inside(sp, "adaqp.backward") for sp in mine) >= 2, part


def test_time_csv_has_a_row_per_rank(runs):
    tmp = runs[4]
    csv = np.genfromtxt(f"{tmp}/exp_port/sbm600/2part/gcn/time/AdaQP_adaptive.csv",
                        delimiter=",", names=True)
    np.testing.assert_array_equal(csv["Worker"], [0, 1])


@pytest.mark.parametrize("impl", IMPLS)
def test_impl_vanilla_matches_jax_trainer(runs, impl):
    # the JAX parameters carry across with each impl's first-weight shape
    res, inits, impl_losses = runs[3], runs[5], runs[6]
    assert inits[impl][0]["w"].shape[0] == {"block": 128, "compact": 384, "segment": 16}[impl]
    (l0, p0, n0, q0), (l1, p1, _, _) = res[0][impl], res[1][impl]
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(p0.view(np.int32), p1.view(np.int32))
    assert n0 == [] and tuple(q0) == (8 * EPOCHS, 8 * EPOCHS)
    np.testing.assert_allclose(l0, impl_losses[impl], rtol=1e-5)


def _plan_and_traces(seed):
    from adaqp_tpu.common.types import GNNType
    from adaqp_tpu.graph import build_layout, partition_graph
    from adaqp_tpu.helper import sbm_graph

    g = sbm_graph(n=400, blocks=4, num_feats=16, seed=3)
    lay = build_layout(g, partition_graph(g, 4, "ldg"), GNNType.GCN)
    plan = lay.plan_fwd
    rng = np.random.default_rng(seed)
    tf = rng.gamma(2.0, size=(3, 4, 4, plan.s_pad)).astype(np.float32)
    tb = rng.gamma(2.0, size=(3, 4, plan.r_pad)).astype(np.float32)
    alpha = rng.uniform(0.5, 4.0, size=(4, 4))
    beta = rng.uniform(0.01, 0.2, size=(4, 4))
    return lay, plan, tf, tb, (alpha, beta)


@pytest.mark.parametrize("normal_mode", ["nadir_utopia", "magnitude"])
@pytest.mark.parametrize("fp32", [False, True])
def test_assigner_matches_jax(normal_mode, fp32):
    from adaqp_tpu.assigner import Assigner as JAssigner
    from adaqp_tpu.assigner import AssignerConfig as JAssignerConfig
    from adaqp_tpu.common.types import BITS_SET, WIRE_BITS_SET
    from adaqp_tpu_torch.assigner import Assigner, AssignerConfig
    from adaqp_tpu_torch.graph.layout import ExchangePlan

    lay, jplan, tf, tb, cost = _plan_and_traces(1)
    plan = ExchangePlan(**{f: getattr(jplan, f) for f in (
        "send_idx", "recv_slot", "counts", "num_remote", "scores_fp", "scores_bp",
        "remote_global", "s_pad", "r_pad")})
    kw = dict(group_size=20, coe_lambda=0.5, assign_bits=8, wire_feats=lay.f_true,
              normal_mode=normal_mode, bits_options=WIRE_BITS_SET if fp32 else BITS_SET)
    dims = [lay.f_true, 16, 16]
    want = JAssigner(jplan, 3, JAssignerConfig(**kw), cost).assign(tf, tb, dims)
    got = Assigner(plan, 3, AssignerConfig(**kw), cost).assign(tf, tb, dims)
    for a, b in zip(got.fwd + got.bwd, want.fwd + want.bwd):
        np.testing.assert_array_equal(a, b)
    assert len({int(b) for a in got.fwd for b in np.unique(a)} - {0}) > 1  # mixed widths


def test_cost_model_fit_matches_jax():
    from adaqp_tpu.assigner.profile import fit_cost_model as jfit
    from adaqp_tpu_torch.assigner.profile import _probe_sizes, fit_cost_model

    rng = np.random.default_rng(4)
    sizes = _probe_sizes(2_000_000, 8) / 1e6
    times = rng.uniform(0.5, 2.0, (3, 3, 1)) * sizes + rng.uniform(0, 0.3, (3, 3, 8))
    for i in range(3):
        times[i, i] = 0
    for a, b in zip(fit_cost_model(sizes, times), jfit(sizes, times)):
        np.testing.assert_array_equal(a, b)


def test_command_line_trains_two_cpu_ranks(tmp_path):
    # `python -m adaqp_tpu_torch` spawns the ranks through the launcher
    import os
    import pathlib
    import subprocess

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "adaqp_tpu_torch", "--dataset", "sbm", "--num_parts", "2",
         "--mode", "AdaQP", "--assign_scheme", "uniform", "--num_epochs", "2",
         "--hidden_dim", "16", "--device", "cpu", "--exp_path", str(tmp_path / "exp")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    base = tmp_path / "exp" / "sbm400" / "2part" / "gcn"
    assert (base / "metrics" / "AdaQP_uniform.txt").exists()
    csv = np.genfromtxt(base / "time" / "AdaQP_uniform.csv", delimiter=",", names=True)
    np.testing.assert_array_equal(csv["Worker"], [0, 1])
