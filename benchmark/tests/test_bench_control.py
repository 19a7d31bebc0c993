"""The comparison that decides ``correct``, driven through a whole run on
the CPU with the committed limits: the program as it is passes, and with
its timed path broken underneath (a step that leaves the parameters
unchanged; half of the training rows left out and the mean taken over the
rest; at four ranks the exchange left out) the run comes out not correct.
The control, the reference computed in float8 in the program's place,
fails the limits. The harness's look for a card is skipped: the run is
driven below ``run.py``.

bf16's share of the first gradient's difference (``grad_dev``) shrinks as
the graph grows (products' cell: 0.024 at 4,096 nodes, 0.0068 at 65,536,
0.0035-0.0049 at 612,257 on the card), so the sound runs here take
products' configuration at 32,768 nodes, where the limits hold; Yelp's
needs more than a CPU test can hold, and its broken runs are checked at a
small size (its sound run at full size is the card test's)."""
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import check, control, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2 ** 31 + 977


SOUND_NODES = 32768


def _small(name, nodes=4096):
    cell = harness.load_cell(name)
    conf = cell["configuration"]
    conf["num_nodes"] = nodes
    if conf["graph"]["generator"] == "banded":
        conf["graph"]["edges"] = nodes * 20
    if "pairs" in conf["graph"]:  # a small R-MAT draws fewer pairs than Yelp's degree asks
        conf["graph"]["pairs"] = 0
    conf["name"] += "-small"
    return cell


CELLS = ("ogbn-products-gcn.k1", "yelp-sage.k1")


def test_program_is_correct():
    out, rec = harness.run(_small(CELLS[0], SOUND_NODES), SEED, 0.0, False, "cpu",
                           time.perf_counter())
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def _frozen(monkeypatch):
    from adaqp_tpu_torch.trainer import trainer as tr

    step = tr.Trainer._train_step

    def frozen(self, epoch):
        self.opt.step = lambda *a, **k: None
        return step(self, epoch)
    monkeypatch.setattr(tr.Trainer, "_train_step", frozen)


def _half_batch(monkeypatch):
    from adaqp_tpu_torch.trainer import trainer as tr

    loss = tr.masked_loss_sum

    def half(logits, labels, mask, multilabel):
        kept = mask.clone()
        kept[1::2] = False
        return loss(logits, labels, kept, multilabel) * (mask.sum() / kept.sum())
    monkeypatch.setattr(tr, "masked_loss_sum", half)


@pytest.mark.parametrize("fault", [_frozen, _half_batch], ids=["frozen", "half_batch"])
@pytest.mark.parametrize("name,nodes", [(CELLS[0], SOUND_NODES), (CELLS[1], 4096)])
def test_broken_program_is_not_correct(monkeypatch, name, nodes, fault):
    fault(monkeypatch)
    out, _ = harness.run(_small(name, nodes), SEED, 0.0, False, "cpu", time.perf_counter())
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = _small(name)
    readings = {kind: nums for _, kind, nums in control.reference_readings(cell, [SEED], "cpu")}
    ok, rows = check.judge(readings["control_fp8"], cell["limits"])
    assert not ok, rows
    for kind in ("fault_frozen", "fault_half_batch"):
        assert not check.judge(readings[kind], cell["limits"])[0], (kind, readings[kind])


def test_rows_held_elsewhere_are_not_correct(monkeypatch):
    """The program names another node than the one a row holds: the
    reference would place the dropout masks wrongly, and row_order fails."""
    from adaqp_tpu_torch.trainer import trainer as tr

    init = tr.Trainer.__init__

    def swapped(self, *a, **k):
        init(self, *a, **k)
        ids = self.layout.local_ids[0]
        ids[[0, 1]] = ids[[1, 0]]
    monkeypatch.setattr(tr.Trainer, "__init__", swapped)
    out, _ = harness.run(_small(CELLS[0]), SEED, 0.0, False, "cpu", time.perf_counter())
    row = next(r for r in out["check"] if r["name"] == "row_order")
    assert not out["correct"] and row["value"] == 0, out["check"]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                        "--seed", str(SEED), "--seconds", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


# ---- four ranks over gloo on the CPU, the four-card cell's path ----

def _small_k4(nodes=SOUND_NODES):
    cell = _small("ogbn-products-gcn.k1", nodes)
    cell["mix"] = {**cell["mix"], "ranks": 4}
    cell["chips"] = 4
    cell["per_layer"] = []
    return cell


def frozen_worker(*args):
    from adaqp_tpu_torch.trainer import trainer as tr

    step = tr.Trainer._train_step

    def frozen(self, epoch):
        self.opt.step = lambda *a, **k: None
        return step(self, epoch)
    tr.Trainer._train_step = frozen
    return harness.rank_worker(*args)


def half_batch_worker(*args):
    from adaqp_tpu_torch.trainer import trainer as tr

    loss = tr.masked_loss_sum

    def half(logits, labels, mask, multilabel):
        kept = mask.clone()
        kept[1::2] = False
        return loss(logits, labels, kept, multilabel) * (mask.sum() / kept.sum())
    tr.masked_loss_sum = half
    return harness.rank_worker(*args)


def no_exchange_worker(*args):
    """The halo rows each exchange delivers replaced by zeros (the exchange
    still runs, so the ranks stay in step)."""
    from adaqp_tpu_torch.ops import dist_ops

    finish = dist_ops.exchange_finish
    dist_ops.exchange_finish = lambda *a, **k: finish(*a, **k) * 0.0
    return harness.rank_worker(*args)


@pytest.mark.parametrize("worker", [None, frozen_worker, half_batch_worker, no_exchange_worker],
                         ids=["sound", "frozen", "half_batch", "no_exchange"])
def test_four_ranks(worker):
    out, _ = harness.run(_small_k4(), SEED, 0.0, False, "cpu", time.perf_counter(), worker=worker)
    assert out["correct"] == (worker is None), out["check"]


def test_exchange_fault_fails_the_limits():
    cell = _small_k4()
    readings = {kind: nums for _, kind, nums in control.reference_readings(cell, [SEED], "cpu")}
    assert not check.judge(readings["fault_no_exchange"], cell["limits"])[0], readings
