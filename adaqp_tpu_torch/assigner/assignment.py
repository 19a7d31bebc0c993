"""Bit-width assignment representation and the uniform/random schemes.

Reference: ``AdaQP/assigner/assigner.py:95-120`` (uniform / random) and the
per-bits train-buffer grouping in ``AdaQP/communicator/buffer.py:181-217``.

An :class:`Assignment` holds, per GNN layer, the bit-width of every
boundary message in both directions:

- forward : ``fwd[layer][s, r, j]`` — bits for the j-th lane sender s ->
  receiver r (aligned with ``plan.send_idx``); 0 on padding lanes.
- backward: ``bwd[layer][r, slot]`` — bits for the gradient message the
  receiver r returns to the owner of halo ``slot``; 0 on padding slots.
  (The reference solves separate ILPs for backward layers,
  ``assigner.py:275-285``; backward of layer 0 is never exchanged since
  input features need no gradient.)

``comm/wire.py`` lowers an Assignment to the exact-size ragged wire's
layouts; :func:`buckets_from_assignment` lowers it to the padded dense
wire's per-width buckets (``comm/exchange.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..common.types import BITS_SET
from ..graph.layout import ExchangePlan


@dataclass
class Assignment:
    """Per-layer, per-direction bit-widths for boundary messages."""

    fwd: List[np.ndarray]  # num_layers x int32 [K, K, S_pad]
    bwd: List[np.ndarray]  # num_layers x int32 [K, R_pad] (layer 0 unused)

    @property
    def num_layers(self) -> int:
        return len(self.fwd)


def _lane_mask(plan: ExchangePlan) -> np.ndarray:
    """bool [K, K, S]: valid forward lanes."""
    k, _, s = plan.send_idx.shape
    lane = np.arange(s)[None, None, :]
    return lane < plan.counts[:, :, None]


def _slot_mask(plan: ExchangePlan) -> np.ndarray:
    """bool [K, R_pad]: valid remote slots."""
    slot = np.arange(plan.r_pad)[None, :]
    return slot < plan.num_remote[:, None]


def uniform_assignment(plan: ExchangePlan, num_layers: int, bits: int) -> Assignment:
    """Every message at the same width (reference ``assigner.py:95-106``;
    also the adaptive bootstrap, ``trainer.py:63-66``)."""
    lm = _lane_mask(plan)
    sm = _slot_mask(plan)
    fwd = [np.where(lm, bits, 0).astype(np.int32) for _ in range(num_layers)]
    bwd = [np.where(sm, bits, 0).astype(np.int32) for _ in range(num_layers)]
    return Assignment(fwd, bwd)


def random_assignment(
    plan: ExchangePlan, num_layers: int, seed: int = 0, bits_set: Sequence[int] = BITS_SET
) -> Assignment:
    """Uniform-probability random widths per message (reference
    ``assigner.py:108-120``)."""
    rng = np.random.default_rng(seed)
    lm = _lane_mask(plan)
    sm = _slot_mask(plan)
    bits_arr = np.asarray(bits_set, np.int32)
    fwd = [
        np.where(lm, bits_arr[rng.integers(0, len(bits_arr), lm.shape)], 0)
        for _ in range(num_layers)
    ]
    bwd = [
        np.where(sm, bits_arr[rng.integers(0, len(bits_arr), sm.shape)], 0)
        for _ in range(num_layers)
    ]
    return Assignment(fwd, bwd)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m if x else 0


def buckets_from_assignment(
    plan: ExchangePlan,
    assignment: Assignment,
    l_max: int,
    cap_multiple: int = 8,
) -> List[Tuple[Tuple[int, ...], Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray], ...]]]:
    """Lower an Assignment to per-layer ``(bucket_bits, bucket_arrays)``
    for the padded dense wire.

    Each bucket is (send_idx, recv_slot, gather_slot, scatter_idx) int32
    [K, K, cap_b] (rank-major; see ``comm/exchange.py``), ``cap_b`` the
    largest lane count of the width over every channel and both
    directions, rounded up to ``cap_multiple``; widths no lane uses have no
    bucket. Padding lanes send row 0 and carry the drop sentinels
    ``recv_slot == gather_slot == r_pad`` and ``scatter_idx == l_max``.
    Both endpoints derive the same lane sets from the replicated
    assignment, so no layout travels (the reference exchanges layouts with
    ``all_gather_object``, ``buffer.py:219-231``).
    """
    k = plan.send_idx.shape[0]
    out = []
    for layer in range(assignment.num_layers):
        fwd_bits = assignment.fwd[layer]
        bwd_bits = assignment.bwd[layer]
        layer_bits: List[int] = []
        layer_arrays = []
        for b in BITS_SET:
            # ---- forward buckets: per (s, r), the lanes with bits == b ----
            lanes: Dict[Tuple[int, int], np.ndarray] = {}
            cap_f = 0
            for s in range(k):
                for r in range(k):
                    if s == r:
                        continue
                    idx = np.where(fwd_bits[s, r] == b)[0]
                    lanes[(s, r)] = idx
                    cap_f = max(cap_f, len(idx))
            # ---- backward buckets: per (r -> s), the slots with bits == b
            # in slot order; the owner's scatter rows come from the plan
            # lane of each slot ----
            bslots: Dict[Tuple[int, int], np.ndarray] = {}
            cap_b = 0
            for r in range(k):
                offset = 0
                for s in range(k):
                    if s == r:
                        continue
                    c = int(plan.counts[s, r])
                    slots = np.arange(offset, offset + c)
                    sel = slots[bwd_bits[r, slots] == b]
                    bslots[(r, s)] = sel
                    cap_b = max(cap_b, len(sel))
                    offset += c
            cap = _round_up(max(cap_f, cap_b), cap_multiple)
            if cap == 0:
                continue
            send_idx = np.zeros((k, k, cap), np.int32)
            recv_slot = np.full((k, k, cap), plan.r_pad, np.int32)
            gather_slot = np.full((k, k, cap), plan.r_pad, np.int32)
            scatter_idx = np.full((k, k, cap), l_max, np.int32)
            for (s, r), idx in lanes.items():
                send_idx[s, r, : len(idx)] = plan.send_idx[s, r, idx]
                recv_slot[r, s, : len(idx)] = plan.recv_slot[r, s, idx]
            for (r, s), sel in bslots.items():
                gather_slot[r, s, : len(sel)] = sel
                # slots of (s -> r) follow the plan's lane order, after the
                # slots of the senders before s
                offset = sum(int(plan.counts[s2, r]) for s2 in range(s) if s2 != r)
                scatter_idx[s, r, : len(sel)] = plan.send_idx[s, r, sel - offset]
            layer_bits.append(b)
            layer_arrays.append((send_idx, recv_slot, gather_slot, scatter_idx))
        out.append((tuple(layer_bits), tuple(layer_arrays)))
    return out
