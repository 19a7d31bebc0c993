"""Loss and metric pieces (reference: ``AdaQP/trainer/trainer.py:157-158``,
``runtime_util.py:139-197``).

The reference pairs a SUM-reduction loss with division by the GLOBAL train
count (``runtime_util.py:102``) and then all-reduce-SUMS gradients without
dividing (``runtime_util.py:71-77``) — the pair is equivalent to a proper
global mean and must be preserved together (SURVEY.md §7.4). Here each
partition returns its local sum; the caller divides by the global count.
"""
from __future__ import annotations

import torch


def masked_loss_sum(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, multilabel: bool) -> torch.Tensor:
    """Sum of per-node losses over masked rows (one partition).

    single-label: cross entropy; multilabel: BCE-with-logits summed over all
    label dimensions (torch BCEWithLogitsLoss(reduction='sum') semantics).
    """
    if multilabel:
        per_elt = torch.clamp_min(logits, 0.0) - logits * labels + torch.log1p(
            torch.exp(-logits.abs())
        )
        per_node = per_elt.sum(dim=-1)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels[:, None].long())[:, 0]
        per_node = logz - picked
    return torch.where(mask, per_node, 0.0).sum()


def correct_count(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """# correctly classified masked nodes (single-label accuracy pieces,
    reference ``runtime_util.py:139-147``)."""
    pred = logits.argmax(dim=-1)
    return (mask & (pred == labels)).sum()


def f1_pieces(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """(TP, FP, FN) for micro-F1 over masked rows (multilabel, reference
    ``runtime_util.py:149-155``): prediction = logits > 0."""
    pred = logits > 0.0
    truth = labels > 0.5
    m = mask[:, None]
    tp = (pred & truth & m).sum()
    fp = (pred & ~truth & m).sum()
    fn = (~pred & truth & m).sum()
    return tp, fp, fn
