"""Device-side shard containers: PartitionLayout -> one rank's tensors.

The reference's ``GraphEngine`` singleton (``AdaQP/manager/graphEngine.py``)
becomes two explicit objects: :class:`ShardArrays`, one partition's tensors
(what the JAX package's ``ShardArrays.local()`` gives inside its
``shard_map``), and :class:`ShardStatic`, the run's hashable shape and
model configuration. One rank owns one partition; there is no mesh.

The per-partition edge lists of the segment-sum path are not carried: that
path is not ported yet, and the strip shards hold the edges.
"""
from __future__ import annotations

import dataclasses

import torch

from ..common.backend import DeviceLike
from ..common.types import AggregatorType, GNNType, Mode
from .layout import PartitionLayout


@dataclasses.dataclass
class ShardArrays:
    """One partition's node data and exchange maps."""

    feats: torch.Tensor  # f32 (bf16 under bf16 aggregation) [L, F]
    labels: torch.Tensor  # i64 [L] or f32 [L, C]
    train_mask: torch.Tensor  # bool [L]
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    deg_in: torch.Tensor  # f32 [L + R]
    deg_out: torch.Tensor
    send_idx: torch.Tensor  # i64 [K, S]  this rank's sends to each receiver
    recv_slot: torch.Tensor  # i64 [K, S]  slots of this rank's receives
    num_local: int

    def to(self, device: DeviceLike) -> "ShardArrays":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "num_local"
        })


@dataclasses.dataclass(frozen=True)
class ShardStatic:
    """Hashable static configuration for the compute graph."""

    k: int
    l_max: int
    r_pad: int
    s_pad: int
    f_pad: int
    num_classes: int
    multilabel: bool
    f_true: int = 0  # raw feature count before lane padding (0 = f_pad)
    model: GNNType = GNNType.GCN
    agg_type: AggregatorType = AggregatorType.MEAN
    mode: Mode = Mode.VANILLA
    num_layers: int = 3
    hidden: int = 256
    dropout: float = 0.5
    use_norm: bool = True
    spmm: str = "strip"
    agg_dtype: str = "float32"  # aggregation compute dtype ("bfloat16" on the card)


def shard_arrays_from_layout(layout: PartitionLayout, rank: int = 0) -> ShardArrays:
    """Partition ``rank``'s rows of the layout as CPU tensors."""
    labels = torch.as_tensor(layout.labels[rank])
    return ShardArrays(
        feats=torch.as_tensor(layout.feats[rank]),
        labels=labels if layout.multilabel else labels.long(),
        train_mask=torch.as_tensor(layout.train_mask[rank]),
        val_mask=torch.as_tensor(layout.val_mask[rank]),
        test_mask=torch.as_tensor(layout.test_mask[rank]),
        deg_in=torch.as_tensor(layout.deg_in_fwd[rank]),
        deg_out=torch.as_tensor(layout.deg_out_fwd[rank]),
        send_idx=torch.as_tensor(layout.plan_fwd.send_idx[rank]).long(),
        recv_slot=torch.as_tensor(layout.plan_fwd.recv_slot[rank]).long(),
        num_local=int(layout.num_local[rank]),
    )


def static_from_layout(layout: PartitionLayout, **overrides) -> ShardStatic:
    cfg = ShardStatic(
        k=layout.k,
        l_max=layout.l_max,
        r_pad=layout.plan_fwd.r_pad,
        s_pad=layout.plan_fwd.s_pad,
        f_pad=layout.num_feats,
        num_classes=layout.num_classes,
        multilabel=layout.multilabel,
        f_true=layout.f_true,
    )
    return dataclasses.replace(cfg, **overrides)


def agg_torch_dtype(cfg: ShardStatic) -> torch.dtype:
    """torch dtype of ``cfg.agg_dtype``."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.agg_dtype]
