"""The port's K=1 Trainer against the JAX package's, on the CPU.

Both train the same SBM graph from the same initial parameters (the JAX
init carried across, with each aggregation's own first-weight shape) with
f32 aggregation and no dropout. For the port's strip run the JAX side runs
``spmm_impl="block"``: it pads like the strip path (2048 rows / 128
feature lanes), so its shapes and init match, and its portable twin handles
the empty K=1 halo layouts (the JAX strip twin does not; see ROADMAP). The
port runs the strip tiles (plain version on the CPU) with an ELL tail. The
port's block, compact and segment runs face the JAX Trainer with the same
``spmm_impl``.
"""
import pytest
import os

import jax
import numpy as np

from adaqp_tpu.trainer import RunConfig as JRunConfig
from adaqp_tpu.trainer import Trainer as JTrainer
from adaqp_tpu_torch.trainer import RunConfig, Trainer

SYNTH = {"n": 600, "blocks": 4, "num_feats": 16, "seed": 9}


def _cfg(cls, tmp_path, tag, **over):
    return cls.from_yaml("sbm", {
        "num_parts": 1, "num_epochs": 6, "hidden_dim": 16, "mode": "Vanilla",
        "log_steps": 100, "measure_breakdown": False, "synth_kwargs": SYNTH,
        "partition_dir": str(tmp_path / f"parts_{tag}"),
        "exp_path": str(tmp_path / f"exp_{tag}"),
        # the last destination block (88 rows) goes to the ELL tail
        "block_min_edges": 2000,
        **over,
    })


def _jax_run(cfg):
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
    init = jax.tree.map(np.asarray, t.params)
    rec = t.train()
    return t, rec, init, np.asarray(losses)


def test_matches_jax_trainer(tmp_path):
    jt, jrec, init, jlosses = _jax_run(
        _cfg(JRunConfig, tmp_path, "jax", spmm_impl="block", dropout_rate=0.0)
    )
    t = Trainer(_cfg(RunConfig, tmp_path, "port", dropout_rate=0.0), device="cpu")
    tiles, ell_edges = t.blocks.counts[0]
    assert tiles > 0 and ell_edges > 0
    assert t.layout.l_max == jt.layout.l_max == 2048
    assert t.static.f_pad == jt.static.f_pad == 128
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


@pytest.mark.parametrize("impl,f_pad", [("block", 128), ("compact", 384), ("segment", 16)])
def test_impl_matches_jax_trainer(tmp_path, impl, f_pad):
    # each impl's padding sets the first weight's shape; the JAX parameters
    # carry across unchanged and give the same losses
    _, jrec, init, jlosses = _jax_run(
        _cfg(JRunConfig, tmp_path, "jax", spmm_impl=impl, dropout_rate=0.0, num_epochs=4)
    )
    t = Trainer(_cfg(RunConfig, tmp_path, "port", spmm_impl=impl, dropout_rate=0.0,
                     num_epochs=4), device="cpu")
    assert t.static.f_pad == f_pad and init[0]["w"].shape == (f_pad, 16)
    assert tuple(t.params[0]["w"].shape) == init[0]["w"].shape
    assert (t.blocks is None) == (impl == "segment") and (t.sh.fl_src.numel() > 0) == (impl == "segment")
    t.load_params(init)
    rec = t.train()
    np.testing.assert_allclose(rec["loss_curve"], jlosses, rtol=1e-5)
    np.testing.assert_allclose(rec["val_curve"], jrec["val_curve"], atol=1e-4)
    assert rec["planned_tile_launches"] == (0 if impl == "segment" else 4 * 14)


def test_bf16_learns_and_writes_reference_artifacts(tmp_path):
    t = Trainer(_cfg(RunConfig, tmp_path, "bf16", agg_dtype="bfloat16", num_epochs=12),
                device="cpu")
    rec = t.train()
    t.save(rec)
    _, tr, va, te = rec["best"]
    assert va > 0.9, f"val acc {va}"
    assert np.isfinite(rec["loss_curve"]).all()
    assert rec["loss_curve"][-1] < rec["loss_curve"][0]
    base = os.path.join(str(tmp_path / "exp_bf16"), "sbm600", "1part", "gcn")
    assert os.path.exists(os.path.join(base, "metrics", "Vanilla.txt"))
    csv = np.genfromtxt(os.path.join(base, "time", "Vanilla.csv"), delimiter=",", names=True)
    assert set(csv.dtype.names) == {
        "Worker", "Overhead", "Total", "Per_epoch", "Comm", "Quant",
        "Central", "Marginal", "Full",
    }
    assert len(np.load(os.path.join(base, "val_curve", "Vanilla.npy"))) == 12
