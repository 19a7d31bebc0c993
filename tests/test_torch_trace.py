"""The port's spans and set-up clocks on the CPU (``utils/timer.py::span``).

One training step of a tiny K=1 GCN and a tiny K=1 GraphSAGE Trainer runs
under ``torch.profiler``: the ``adaqp.*`` spans nest as the program opens
them, in the forward and again in the backward pass. Without a profiler
``span`` hands out one shared context that does nothing. The constructor's
set-up clocks; the transport profile's all-reduce on the device the
process group's backend takes. The exchange's
spans and the wire's byte counter are checked at K=2 in
``test_torch_trainer_k.py``, inside its launch.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adaqp_tpu_torch.trainer import RunConfig, Trainer
from adaqp_tpu_torch.utils import timer

SYNTH = {"n": 600, "blocks": 4, "num_feats": 16, "seed": 9}
LAYERS = 3
PHASES = {"layout", "device", "assign"}


def _trainer(tmp_path, model: str) -> Trainer:
    cfg = RunConfig.from_yaml("sbm", {
        "num_parts": 1, "num_epochs": 2, "hidden_dim": 16, "mode": "Vanilla",
        "model_name": model, "num_layers": LAYERS, "log_steps": 100,
        "measure_breakdown": False, "synth_kwargs": SYNTH, "logger_level": "WARNING",
        "partition_dir": str(tmp_path / "parts"), "exp_path": str(tmp_path / "exp"),
        # the last destination block (88 rows) goes to the ELL tail
        "block_min_edges": 2000,
    })
    return Trainer(cfg, device="cpu")


def _spans(prof):
    """The ``adaqp.*`` ranges of a trace as (name, start, end), in µs."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("adaqp.")]


def _parent(sp, spans):
    """The innermost other span that encloses ``sp`` (None at the top)."""
    around = [o for o in spans if o is not sp and o[1] <= sp[1] and sp[2] <= o[2]
              and (o[1], o[2]) != (sp[1], sp[2])]
    return min(around, key=lambda o: o[2] - o[1], default=None)


@pytest.fixture(scope="module", params=["gcn", "sage"])
def traced(request, tmp_path_factory):
    t = _trainer(tmp_path_factory.mktemp(request.param), request.param)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t._train_step(1)
    return t, _spans(prof)


def test_spans_nest_forward_and_backward(traced):
    _, spans = traced
    parent = {sp: _parent(sp, spans) for sp in spans}
    name = lambda sp: None if sp is None else sp[0]
    top = [sp for sp in spans if parent[sp] is None]
    assert sorted(name(sp) for sp in top) == ["adaqp.backward", "adaqp.forward",
                                              "adaqp.optimizer"]
    # the forward: an aggregation a layer, its central and marginal sums,
    # and in them the tile kernel and the ELL tail
    aggs = [sp for sp in spans if sp[0] == "adaqp.aggregate"]
    assert len(aggs) == LAYERS and {name(parent[sp]) for sp in aggs} == {"adaqp.forward"}
    # at K=1 the halo rows are a constant: only the central sum has a
    # backward, which the reverse layout runs in the central span
    for part, want in (("adaqp.central", {"adaqp.aggregate", "adaqp.backward"}),
                       ("adaqp.marginal", {"adaqp.aggregate"})):
        assert {name(parent[sp]) for sp in spans if sp[0] == part} == want, part
    for leaf in ("adaqp.tile", "adaqp.ell"):
        where = {(name(parent[sp]), name(parent[parent[sp]])) for sp in spans if sp[0] == leaf}
        assert ("adaqp.central", "adaqp.aggregate") in where, leaf
        assert ("adaqp.central", "adaqp.backward") in where, leaf
        assert {p for p, _ in where} <= {"adaqp.central", "adaqp.marginal"}, leaf
    back = [sp for sp in spans if sp[0] == "adaqp.central" and name(parent[sp]) == "adaqp.backward"]
    assert len(back) == LAYERS - 1  # layer 0's input carries no gradient


def test_setup_clocks(traced):
    t, _ = traced
    assert set(t.setup_phases_s) == PHASES
    assert all(v >= 0 for v in t.setup_phases_s.values())
    # K=1: no assigner, so neither a profile nor an assignment
    assert t.setup_phases_s["assign"] == t.profile_s == 0.0
    assert t.assign_s == t.assign_solve_s == t.assign_lower_s == []
    assert t.setup_phases_s["layout"] + t.setup_phases_s["device"] <= t.overhead_s


def test_span_is_free_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert timer.span("adaqp.aggregate") is timer.span("adaqp.ell") is timer._NO_SPAN
    with timer.span("adaqp.tile"):
        pass


def test_span_records_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.span("adaqp.central"):
            torch.ones(4).sum()
    assert [sp[0] for sp in _spans(prof)] == ["adaqp.central"]


class _Reduced(Exception):
    """Raised by the stand-in all-reduce once it has seen a tensor that
    holds no data to read back."""


@pytest.mark.parametrize("backend,want", [("gloo", "cpu"), ("nccl", "meta")])
def test_profile_all_reduces_on_the_group_device(monkeypatch, backend, want):
    """gloo reduces the probe times on the CPU; NCCL, which carries no CPU
    tensor, on the buffers' device (the meta device stands in for a card)."""
    import adaqp_tpu_torch.assigner.profile as prof

    seen = []

    def all_reduce(t, op=None):
        seen.append((t.device.type, t.dtype, op))
        if t.is_meta:
            raise _Reduced

    monkeypatch.setattr(prof.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(prof.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(prof.dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(prof, "_time_a2a", lambda pairs, nbytes, reps, device: 1.5)
    monkeypatch.setattr(prof.dist, "all_reduce", all_reduce)
    if want == "meta":
        with pytest.raises(_Reduced):
            prof.profile_cost_model(4096, num_sizes=3, device="meta")
    else:
        sizes, times = prof.profile_cost_model(4096, num_sizes=3, device="meta")
        assert times.shape == (2, 2, 3) and (times[0, 1] == 1.5).all()
        assert times[0, 0].sum() == 0
    assert seen == [(want, torch.float64, prof.dist.ReduceOp.MAX)]
