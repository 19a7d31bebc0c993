"""Checkpoint and resume in the port (``utils/checkpoint.py``, the
Trainer's ``ckpt_every``/``resume``), on the CPU.

The file format: named arrays round trip bit for bit, writes are atomic,
the latest epoch wins, and a checkpoint of another model is refused. The
Trainer: a run resumed from a checkpoint equals the straight run bit for
bit, at K=1 with dropout and at K=2 in AdaQP adaptive across a
reassignment (every random stream of the port comes from the epoch index,
and the cost model comes from the checkpoint, not a new profile). Against
the JAX package: both Trainers, from the same initial parameters,
checkpoint the same parameters, Adam moments, step and recorder.
"""
import os

import numpy as np
import pytest
import torch

from adaqp_tpu_torch.comm.distributed import spawn
from adaqp_tpu_torch.trainer import RunConfig, Trainer
from adaqp_tpu_torch.utils import checkpoint as ck

SYNTH = {"n": 600, "blocks": 4, "num_feats": 16, "seed": 9}


def _cfg(tmp, cls=RunConfig, **over):
    return cls.from_yaml("sbm", {
        "num_parts": 1, "num_epochs": 6, "hidden_dim": 16, "mode": "Vanilla",
        "log_steps": 100, "measure_breakdown": False, "synth_kwargs": SYNTH,
        "logger_level": "WARNING", "partition_dir": f"{tmp}/parts", "exp_path": f"{tmp}/exp",
        "ckpt_dir": f"{tmp}/ckpt", **over,
    })


def _state(rng):
    return {"params.0.w": rng.standard_normal((5, 3)).astype(np.float32),
            "opt.0.w.step": np.float32(3.0), "asg.fwd.0": rng.integers(0, 9, (2, 4), np.int32),
            "cost.alpha": np.float64(0.25), "recorder": rng.random((4, 3))}


def test_round_trip_is_bit_exact(tmp_path, rng):
    state = _state(rng)
    ck.save_checkpoint(str(tmp_path / "ckpt_2"), 2, state, {"mode": "AdaQP"})
    step, got, meta = ck.load_checkpoint(str(tmp_path / "ckpt_2"),
                                         {k: v.shape for k, v in state.items()})
    assert step == 2 and meta == {"mode": "AdaQP"} and got.keys() == state.keys()
    for k, v in state.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("crash", [False, True])
def test_write_is_atomic(tmp_path, rng, monkeypatch, crash):
    path = str(tmp_path / "ckpt_4")
    if crash:  # the archive's write fails half-way: nothing of it stays
        def savez(f, **arrays):
            f.write(b"partial")
            raise OSError("disk full")

        monkeypatch.setattr(ck.np, "savez", savez)
        with pytest.raises(OSError, match="disk full"):
            ck.save_checkpoint(path, 4, _state(rng))
        assert os.listdir(tmp_path) == [] and ck.latest_checkpoint(str(tmp_path)) is None
    else:
        ck.save_checkpoint(path, 4, _state(rng))
        assert sorted(os.listdir(tmp_path)) == ["ckpt_4.json", "ckpt_4.npz"]


def test_latest_checkpoint_takes_the_highest_epoch(tmp_path, rng):
    assert ck.latest_checkpoint(str(tmp_path / "absent")) is None
    assert ck.latest_checkpoint(str(tmp_path)) is None
    for epoch in (3, 12, 7):
        ck.save_checkpoint(str(tmp_path / f"ckpt_{epoch}"), epoch, _state(rng))
    for stray in ("ckpt_x.json", "ckpt_40.npz", "other_50.json", ".ckpt_60.json.a1.tmp"):
        (tmp_path / stray).write_text("{}")
    assert ck.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_12")


@pytest.mark.parametrize("change,match", [
    (lambda s: s.update({"opt.0.w.exp_avg": (5, 3)}), r"missing \['opt.0.w.exp_avg'\]"),
    (lambda s: s.pop("opt.0.w.step"), r"unexpected \['opt.0.w.step'\]"),
    (lambda s: s.update({"params.0.w": (5, 4)}), r"params.0.w \(5, 3\) != \(5, 4\)"),
], ids=["missing", "unexpected", "shape"])
def test_another_model_is_refused(tmp_path, rng, change, match):
    state = _state(rng)
    ck.save_checkpoint(str(tmp_path / "ckpt_1"), 1, state)
    shapes = {k: v.shape for k, v in state.items()}
    change(shapes)  # what this run expects
    with pytest.raises(ValueError, match=match):
        ck.load_checkpoint(str(tmp_path / "ckpt_1"), shapes)


def _adam(t):
    """name -> (step, exp_avg, exp_avg_sq) of the Trainer's Adam."""
    return {key: tuple(t.opt.state[p][f] for f in ("step", "exp_avg", "exp_avg_sq"))
            for key, p in t._named_params()}


def test_k1_resume_equals_the_straight_run(tmp_path):
    over = {"dropout_rate": 0.5, "block_min_edges": 2000}  # strip tiles and an ELL tail
    straight = Trainer(_cfg(tmp_path, **over), device="cpu")
    rec = straight.train()
    first = Trainer(_cfg(tmp_path, num_epochs=3, ckpt_every=3, **over), device="cpu")
    first.train()
    resumed = Trainer(_cfg(tmp_path, resume=True, **over), device="cpu")
    assert resumed.start_epoch == 3
    rrec = resumed.train()
    assert len(rrec["loss_curve"]) == 3
    assert torch.equal(torch.as_tensor(rrec["loss_curve"]), torch.as_tensor(rec["loss_curve"][3:]))
    for (key, p), (_, q) in zip(straight._named_params(), resumed._named_params(), strict=True):
        assert torch.equal(p, q), key
    sa, sb = _adam(straight), _adam(resumed)
    assert sa.keys() == sb.keys()
    for key in sa:
        assert all(torch.equal(x, y) for x, y in zip(sa[key], sb[key], strict=True)), key
    assert np.array_equal(straight.recorder.metrics, resumed.recorder.metrics)
    assert rrec["best"] == rec["best"]
    assert rrec["planned_tile_launches"] == 3 * straight.tile_launches_per_epoch()


def test_resume_without_a_checkpoint_starts_fresh(tmp_path, caplog):
    t = Trainer(_cfg(tmp_path, num_epochs=2, resume=True, logger_level="INFO"), device="cpu")
    assert t.start_epoch == 0
    assert "no checkpoint under" in caplog.text
    assert len(t.train()["loss_curve"]) == 2


def _k2_rank(rank, world, device, tmp):
    """AdaQP adaptive at K=2, assign_cycle 2: 6 epochs that checkpoint at 4,
    then a run resumed from it; each run's reassignment epochs, losses,
    final state, and the traces at the save (first run) or after the load
    (resumed run)."""
    import sys

    def run(**over):
        t = Trainer(_cfg(tmp, num_parts=2, mode="AdaQP", assign_scheme="adaptive",
                         assign_cycle=2, dropout_rate=0.5, block_min_edges=1, **over),
                    device=device)
        out = {"start": t.start_epoch, "profile_s": t.profile_s, "reassigned": [],
               "traces": [t.trace_fwd.clone(), t.trace_bwd.clone()]}
        reassign, save = t._reassign, t._save_checkpoint
        t._reassign = lambda e: (out["reassigned"].append(e), reassign(e))

        def recording_save(epoch):
            out["traces"] = [t.trace_fwd.clone(), t.trace_bwd.clone()]
            save(epoch)

        t._save_checkpoint = recording_save
        rec = t.train()
        out.update(losses=rec["loss_curve"], recorder=t.recorder.metrics.copy(),
                   params=[p.detach().clone() for _, p in t._named_params()],
                   adam=list(_adam(t).values()),
                   final=[t.trace_fwd.clone(), t.trace_bwd.clone()],
                   asg=[np.asarray(a) for a in t.assignment.fwd + t.assignment.bwd],
                   planned=rec["planned_quant_launches"])
        return out

    out = run(ckpt_every=4), run(resume=True)
    assert "jax" not in sys.modules and "adaqp_tpu" not in sys.modules
    return out


@pytest.fixture(scope="module")
def k2(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("k2"))
    return spawn(_k2_rank, 2, "cpu", args=(tmp,), workdir=f"{tmp}/launch")


def test_k2_adaptive_resume_equals_the_straight_run(k2):
    for straight, resumed in k2:
        assert straight["reassigned"] == [3, 5] and resumed["reassigned"] == [5]
        assert straight["profile_s"] > 0 and resumed["profile_s"] == 0
        assert straight["start"] == 0 and resumed["start"] == 4
        # this rank's own traces of epochs 3-4, from the one shared file
        for a, b in zip(straight["traces"], resumed["traces"]):
            assert a.abs().sum() > 0 and torch.equal(a, b)
        assert np.array_equal(resumed["losses"], straight["losses"][4:])
        assert all(np.array_equal(a, b) for a, b in zip(straight["asg"], resumed["asg"]))
        for key in ("params", "final"):
            assert all(torch.equal(a, b) for a, b in zip(straight[key], resumed[key])), key
        assert all(torch.equal(x, y) for a, b in zip(straight["adam"], resumed["adam"])
                   for x, y in zip(a, b))
        assert np.array_equal(straight["recorder"], resumed["recorder"])
        assert straight["planned"][0] > resumed["planned"][0] > 0
    # the ranks' traces differ: each took its own slice
    assert not torch.equal(k2[0][1]["traces"][1], k2[1][1]["traces"][1])


def _adam_moments(opt_state):
    """The ScaleByAdamState inside an optax state."""
    if hasattr(opt_state, "mu"):
        return opt_state
    for s in opt_state if isinstance(opt_state, (tuple, list)) else ():
        found = _adam_moments(s)
        if found is not None:
            return found
    return None


def test_checkpoint_matches_the_jax_package(tmp_path):
    import jax

    from adaqp_tpu.trainer import RunConfig as JRunConfig
    from adaqp_tpu.trainer import Trainer as JTrainer
    from adaqp_tpu.utils.checkpoint import load_checkpoint

    # the JAX side runs block: it pads like strip, and its strip twin
    # crashes on the empty K=1 halo (ROADMAP Queue 3)
    over = {"num_epochs": 3, "ckpt_every": 3, "dropout_rate": 0.0, "block_min_edges": 2000}
    jt = JTrainer(_cfg(tmp_path / "jax", JRunConfig, spmm_impl="block", **over))
    init = jax.tree.map(np.asarray, jt.params)
    jt.train()
    jpath = jt._ckpt_path(3)
    jstep, jstate, _ = load_checkpoint(jpath, jt._ckpt_state())
    t = Trainer(_cfg(tmp_path / "port", **over), device="cpu")
    t.load_params(init)
    t.train()
    step, state, _ = ck.load_checkpoint(t._ckpt_path(3), t._ckpt_shapes())
    assert step == jstep == 3
    adam = _adam_moments(jstate["opt"])
    assert int(np.asarray(adam.count)) == 3
    for i, layer in enumerate(jstate["params"]):
        for name, value in layer.items():
            key = f"{i}.{name}"
            np.testing.assert_allclose(state[f"params.{key}"], value, rtol=1e-3, atol=1e-4,
                                       err_msg=key)
            np.testing.assert_allclose(state[f"opt.{key}.exp_avg"], adam.mu[i][name],
                                       rtol=1e-3, atol=1e-4, err_msg=key)
            # second moments are squared gradients, far below 1e-4
            np.testing.assert_allclose(state[f"opt.{key}.exp_avg_sq"], adam.nu[i][name],
                                       rtol=1e-3, atol=1e-9, err_msg=key)
            assert state[f"opt.{key}.step"] == 3
    np.testing.assert_allclose(state["recorder"], np.asarray(jstate["rec"]), atol=1e-4)
