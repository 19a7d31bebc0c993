"""GraphSAGE (both aggregators) and the multilabel task in the port's
Trainer at K=2 over gloo ranks on the CPU, against the JAX package.

One launch of two ranks trains, from the JAX Trainers' initial parameters
(f32, no dropout, 5 epochs on the 600-node SBM; multilabel labels: the
block plus one block drawn at random): SAGE-mean multilabel in Vanilla
(against the JAX Trainer: losses, the validation micro-F1 curve and the
final parameters), SAGE with the ``gcn`` aggregator single-label in
Vanilla (the same comparison), SAGE-mean multilabel in AdaQP and AdaQP-q
with uniform 8-bit widths (the quantized wire, overlapped and serial:
equal bit for bit), in AdaQP adaptive on the ragged wire (two
reassignments, the ranks identical) and in Vanilla on the padded wire
(equal to the ragged wire's run bit for bit). The port runs ``strip``,
the JAX package ``block``, which pads alike (2048 rows, 128 feature
lanes). Without a launch: the multilabel loss and the micro-F1 pieces,
and the SAGE layouts' aggregation scores, plans and degrees, against the
JAX package's.
"""
import sys

import numpy as np
import pytest
from torch_helpers import spawn_beside

SYNTH = {"n": 600, "blocks": 4, "num_feats": 16, "seed": 9}
MULTI = {**SYNTH, "multilabel": True}
EPOCHS = 5
RUNS = {
    "mean multilabel Vanilla": {"mode": "Vanilla", "synth_kwargs": MULTI},
    "gcn Vanilla": {"mode": "Vanilla", "aggregator_type": "gcn"},
    "mean multilabel AdaQP uniform": {"mode": "AdaQP", "assign_scheme": "uniform",
                                      "synth_kwargs": MULTI},
    "mean multilabel AdaQP-q uniform": {"mode": "AdaQP-q", "assign_scheme": "uniform",
                                        "synth_kwargs": MULTI},
    "mean multilabel AdaQP adaptive": {"mode": "AdaQP", "assign_scheme": "adaptive",
                                       "assign_cycle": 2, "synth_kwargs": MULTI},
    "mean multilabel Vanilla padded": {"mode": "Vanilla", "wire_impl": "padded",
                                       "synth_kwargs": MULTI},
}
# the runs the JAX Trainer repeats; every other run starts from the first's
# parameters
JAX_RUNS = ("mean multilabel Vanilla", "gcn Vanilla")


def _cfg(cls, tmp, tag, over):
    # the graph's name (sbm600) does not say whether its labels are
    # multilabel, so each kind of graph keeps its own partition directory
    kind = "multi" if "synth_kwargs" in over else "single"
    return cls.from_yaml("sbm", {
        "num_parts": 2, "num_epochs": EPOCHS, "hidden_dim": 16, "mode": "Vanilla",
        "model_name": "sage", "log_steps": 100, "measure_breakdown": False,
        "synth_kwargs": SYNTH, "dropout_rate": 0.0, "assign_bits": 8,
        "profile_data_length": 2, "logger_level": "WARNING",
        "partition_dir": f"{tmp}/parts_{tag}_{kind}", "exp_path": f"{tmp}/exp_{tag}",
        **over,
    })


def _init_of(name):
    return "gcn Vanilla" if RUNS[name].get("aggregator_type") == "gcn" else JAX_RUNS[0]


def _rank_train(rank, world, device, tmp, inits):
    """Every run of RUNS in turn on this rank: each run's losses, validation
    curve, parameters by name, reassignment epochs and planned quant
    launches."""
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    out = {}
    for name, over in RUNS.items():
        t = Trainer(_cfg(RunConfig, tmp, "port", {"block_min_edges": 1, **over}), device=device)
        assert t.static.multilabel == ("synth_kwargs" in over)
        t.load_params(inits[_init_of(name)])
        n, reassign = [], t._reassign
        t._reassign = lambda epoch: (n.append(epoch), reassign(epoch))
        rec = t.train()
        params = {name: p.detach().numpy().copy() for name, p in t._named_params()}
        out[name] = {"losses": rec["loss_curve"], "val": np.asarray(rec["val_curve"]),
                     "params": params, "reassigned": n,
                     "quant": tuple(rec["planned_quant_launches"])}
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
    import jax

    from adaqp_tpu.trainer import RunConfig as JRunConfig

    tmp = str(tmp_path_factory.mktemp("sage"))
    jax_runs = {name: _jax_trainer(_cfg(JRunConfig, tmp, "jax", {"spmm_impl": "block",
                                                                   **RUNS[name]}))
                for name in JAX_RUNS}
    inits = {name: r[1] for name, r in jax_runs.items()}
    # the ranks need only the initial parameters: they train while JAX does
    join = spawn_beside(_rank_train, (tmp, inits), tmp)
    try:
        jrec = {}
        for name, (t, _, losses) in jax_runs.items():
            rec = t.train()
            jrec[name] = {"losses": np.asarray(losses), "val": np.asarray(rec["val_curve"]),
                          "params": {f"{i}.{k}": v for i, layer in
                                     enumerate(jax.tree.map(np.asarray, t.params))
                                     for k, v in layer.items()},
                          "multilabel": t.layout.multilabel, "k": t.k}
    finally:
        res = join()
    return jrec, res


@pytest.mark.parametrize("name", JAX_RUNS)
def test_vanilla_matches_jax_trainer(runs, name):
    jrec, res = runs
    want, got = jrec[name], res[0][name]
    assert want["k"] == 2 and want["multilabel"] == ("synth_kwargs" in RUNS[name])
    assert len(got["losses"]) == len(want["losses"]) == EPOCHS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    # accuracy, or for the multilabel task micro-F1, at every epoch
    np.testing.assert_allclose(got["val"], want["val"], atol=1e-3)
    assert got["params"].keys() == want["params"].keys()
    for key, p in got["params"].items():
        np.testing.assert_allclose(p, want["params"][key], rtol=1e-3, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_stay_identical_and_learn(runs, name):
    a, b = (r[name] for r in runs[1])
    np.testing.assert_array_equal(a["losses"], b["losses"])
    np.testing.assert_array_equal(a["val"], b["val"])
    for key, p in a["params"].items():
        np.testing.assert_array_equal(p.view(np.int32), b["params"][key].view(np.int32))
    assert np.isfinite(a["losses"]).all() and a["losses"][-1] < a["losses"][0]
    # one quant_pack and one unpack_dequant launch a direction of each
    # exchange (32-bit lanes too): 3 forward and 2 backward in training, 3
    # forward in evaluation, each epoch
    quant = (0, 0) if RUNS[name].get("wire_impl") == "padded" else (8 * EPOCHS, 8 * EPOCHS)
    assert a["quant"] == b["quant"] == quant
    assert a["reassigned"] == b["reassigned"] == ([3, 5] if "adaptive" in name else [])


@pytest.mark.parametrize("one,other", [
    ("mean multilabel AdaQP uniform", "mean multilabel AdaQP-q uniform"),
    ("mean multilabel Vanilla", "mean multilabel Vanilla padded"),
])
def test_equal_runs_are_equal_bit_for_bit(runs, one, other):
    # overlapped against serial on the quantized wire; the ragged wire
    # against the padded one in f32
    for rank in runs[1]:
        np.testing.assert_array_equal(rank[one]["losses"], rank[other]["losses"])
        np.testing.assert_array_equal(rank[one]["val"], rank[other]["val"])
        for key, p in rank[one]["params"].items():
            np.testing.assert_array_equal(p.view(np.int32), rank[other]["params"][key].view(np.int32))


def test_multilabel_loss_and_f1_pieces_match_jax():
    import jax.numpy as jnp
    import torch

    from adaqp_tpu.model import loss as jloss
    from adaqp_tpu_torch.model import loss

    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(300, 7)) * 3).astype(np.float32)
    labels = (rng.random((300, 7)) < 0.3).astype(np.float32)
    mask = rng.random(300) < 0.6  # rows outside the mask count for nothing
    got = loss.masked_loss_sum(torch.tensor(logits), torch.tensor(labels),
                               torch.tensor(mask), multilabel=True)
    want = jloss.masked_loss_sum(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(mask), True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    spoiled = logits.copy()
    spoiled[~mask] = 1e4
    again = loss.masked_loss_sum(torch.tensor(spoiled), torch.tensor(labels),
                                 torch.tensor(mask), multilabel=True)
    assert again.item() == got.item()
    pieces = [int(x) for x in loss.f1_pieces(torch.tensor(logits), torch.tensor(labels),
                                             torch.tensor(mask))]
    jpieces = [int(x) for x in jloss.f1_pieces(jnp.asarray(logits), jnp.asarray(labels),
                                               jnp.asarray(mask))]
    assert pieces == jpieces and min(pieces) > 0
    assert sum(pieces) == int(mask.sum()) * 7 - int(((logits <= 0) & (labels < 0.5))[mask].sum())


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_layout_scores_match_jax(k, model):
    from adaqp_tpu.common.types import GNNType as JGNNType
    from adaqp_tpu.graph import build_layout as jbuild_layout
    from adaqp_tpu.graph import partition_graph as jpartition_graph
    from adaqp_tpu.helper import sbm_graph as jsbm_graph
    from adaqp_tpu_torch.common.types import GNNType
    from adaqp_tpu_torch.graph.layout import build_layout
    from adaqp_tpu_torch.graph.partition import partition_graph
    from adaqp_tpu_torch.helper.dataset import sbm_graph

    g, jg = sbm_graph(**MULTI), jsbm_graph(**MULTI)
    for field in ("src", "dst", "feats", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(g, field), getattr(jg, field), err_msg=field)
    part = partition_graph(g, k, "ldg")
    np.testing.assert_array_equal(part, jpartition_graph(jg, k, "ldg"))
    lay = build_layout(g, part, GNNType(model), pad_multiple=8, feat_pad_multiple=128)
    want = jbuild_layout(jg, part, JGNNType(model), pad_multiple=8, feat_pad_multiple=128)
    assert lay.multilabel and lay.labels.shape[-1] == SYNTH["blocks"]
    for field in ("part_id", "local_ids", "num_local", "feats", "labels", "train_mask",
                  "deg_in_fwd", "deg_out_fwd", "fwd_local", "fwd_halo", "bwd_local",
                  "bwd_halo"):
        np.testing.assert_array_equal(getattr(lay, field), getattr(want, field), err_msg=field)
    for field in ("send_idx", "recv_slot", "counts", "num_remote", "scores_fp", "scores_bp",
                  "remote_global"):
        np.testing.assert_array_equal(getattr(lay.plan_fwd, field),
                                      getattr(want.plan_fwd, field), err_msg=field)
    assert (lay.plan_fwd.s_pad, lay.plan_fwd.r_pad) == (want.plan_fwd.s_pad, want.plan_fwd.r_pad)
    # every node sent carries a positive score, and nothing else does
    assert (lay.plan_fwd.scores_fp > 0).sum() == lay.plan_fwd.counts.sum() > 0


def test_fork_adds_the_gradients_in_one_order_whatever_the_schedule():
    # three consumers of one tensor, made in every order: the aggregation's
    # two (the exchange, the local part) and a SAGE layer's self term.
    # Without the fork autograd adds their gradients in the order their
    # nodes run, which follows the order they were made
    import itertools

    import torch

    from adaqp_tpu_torch.ops.dist_ops import fork

    gen = torch.Generator().manual_seed(3)
    h0 = torch.randn(4096, 8, generator=gen)
    weights = [torch.randn(4096, 8, generator=gen) for _ in range(3)]

    def grad(order, forked):
        h = h0.clone().requires_grad_()
        agg, own = fork(h) if forked else (h, h)
        terms = {c: ((own if c == 2 else agg) * weights[c]).sum() for c in order}
        (terms[0] + terms[1] + terms[2]).backward()
        return h.grad

    orders = list(itertools.permutations(range(3)))
    forked = [grad(o, True) for o in orders]
    assert all(torch.equal(forked[0], g) for g in forked[1:])
    plain = [grad(o, False) for o in orders]
    assert not all(torch.equal(plain[0], g) for g in plain[1:])
    # the aggregation's two first, then the self term
    assert torch.equal(forked[0], (weights[0] + weights[1]) + weights[2])
