"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's.

Four numbers, each with a limit of its own (``limits/<cell>.json``):

- ``loss_gap``: the largest relative gap of a step's loss over the first
  steps;
- ``grad_gap``: the first gradient (the program's worked out from Adam's
  first moment after one step), by the worst leaf: the gap between the
  two norms of a leaf over the larger of the reference's norm of that leaf
  and of the median leaf;
- ``change_gap``: each leaf's change over the first steps, by the worst
  leaf the same way. Leaves whose reference gradient is under a thousandth
  of the median leaf's (their moves are round-off under Adam) are left
  out;
- ``grad_dev``: the first gradient's difference, by the worst leaf: the
  norm of the program's gradient less the reference's over the same scale.
  A leaf's norm moves little when a gradient gains a part at right angles
  to it, its difference does: half of the training rows left out adds such
  a part, and on a graph of some hundred thousand training rows no gap of
  norms tells it from rounding.

A leaf that the program holds wider than the reference (layer 0's weight
over zero-padded feature columns) is compared whole: its padding rows
would have to stay at zero.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch

NOUGHT = 1e-3  # a leaf whose first gradient is under this share of the median's


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in leaves.items()}


def _worst(prog: Dict[str, float], ref: Dict[str, float], keys: Sequence[str]) -> float:
    med = statistics.median(ref[k] for k in keys)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]
    return float("inf") if any(g != g for g in gaps) else max(gaps)


def _deviation(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    norms = _norms(ref)
    med = statistics.median(norms.values())
    gaps = []
    for k, r in ref.items():
        p = prog[k].detach().double()
        wide = torch.zeros_like(p)  # the reference's leaf in the program's shape
        wide[tuple(slice(0, n) for n in r.shape)] = r.detach().double()
        gaps.append(float((p - wide).norm()) / max(norms[k], med))
    return float("inf") if any(g != g for g in gaps) else max(gaps)


def leaf_deviations(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> dict:
    """Each leaf's reference norm and the relative norm of the difference."""
    out = {}
    for k, r in ref.items():
        p = prog[k][tuple(slice(0, n) for n in r.shape)].double()
        norm = float(r.double().norm())
        out[k] = [norm, float((p - r.double()).norm()) / max(norm, 1e-30)]
    return out


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [...], "grad1": {leaf: tensor},
    "delta": {leaf: tensor}} over the same leaves."""
    if sorted(prog["grad1"]) != sorted(ref["grad1"]):
        raise ValueError(f"leaves differ: {sorted(prog['grad1'])} / {sorted(ref['grad1'])}")
    steps = len(ref["losses"])
    lp, lr = prog["losses"][:steps], ref["losses"]
    gaps = [abs(a - b) / abs(b) if a == a else float("inf") for a, b in zip(lp, lr)]
    gr, gp = _norms(ref["grad1"]), _norms(prog["grad1"])
    keys = sorted(gr)
    med = statistics.median(gr.values())
    moved = [k for k in keys if gr[k] >= NOUGHT * med]
    return {
        "loss_gap": max(gaps),
        "grad_gap": _worst(gp, gr, keys),
        "change_gap": _worst(_norms(prog["delta"]), _norms(ref["delta"]), moved),
        "grad_dev": _deviation(prog["grad1"], ref["grad1"]),
    }


def on_cpu(result: dict) -> dict:
    """A training result ({"losses", "grad1", "delta"}) with its tensors on the CPU."""
    return {"losses": result["losses"],
            "grad1": {k: v.cpu() for k, v in result["grad1"].items()},
            "delta": {k: v.cpu() for k, v in result["delta"].items()}}


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """Whether every limited number is within its limit, and each number
    beside its limit (None: read, not compared)."""
    rows = [{"name": k, "value": v, "limit": limits.get(k)} for k, v in nums.items()]
    ok = all(r["limit"] is None or r["value"] <= r["limit"] for r in rows)
    return ok, rows
