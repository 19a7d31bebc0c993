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

``comm/wire.py`` lowers an Assignment to the exact-size wire layouts. (The
JAX package's ``buckets_from_assignment`` serves its padded dense wire,
which the port does not run.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

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
