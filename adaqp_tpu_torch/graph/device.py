"""Device-side shard containers: PartitionLayout -> one rank's tensors.

The reference's ``GraphEngine`` singleton (``AdaQP/manager/graphEngine.py``)
becomes two explicit objects: :class:`ShardArrays`, one partition's tensors
(what the JAX package's ``ShardArrays.local()`` gives inside its
``shard_map``), and :class:`ShardStatic`, the run's hashable shape and
model configuration. One rank owns one partition; there is no mesh.

The per-partition edge lists (``fl_src`` .. ``bh_dst``) feed only the
segment-sum aggregation (``spmm_impl=segment``); the tile paths hold their
edges in their shards, so :func:`shard_arrays_from_layout` fills the lists
only when asked (at the K=1 smoke's Reddit size they would take about 1 GB
of device memory).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..common.backend import DeviceLike
from ..common.types import AggregatorType, GNNType, Mode
from .layout import PartitionLayout


def _no_edges():
    return dataclasses.field(default_factory=lambda: torch.zeros(0, dtype=torch.int32))


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
    # segment-sum edge lists (i32 [E]; empty on the tile paths); padding
    # edges carry the sentinel dst (the output row count) and drop
    fl_src: torch.Tensor = _no_edges()  # forward local-src edges
    fl_dst: torch.Tensor = _no_edges()
    fh_src: torch.Tensor = _no_edges()  # forward halo-src (src = remote SLOT)
    fh_dst: torch.Tensor = _no_edges()
    bl_src: torch.Tensor = _no_edges()  # transposed local edges (backward)
    bl_dst: torch.Tensor = _no_edges()
    bh_src: torch.Tensor = _no_edges()  # transposed halo (src local, dst SLOT)
    bh_dst: torch.Tensor = _no_edges()

    def edges(self):
        """The eight edge lists in the order ``pair_seg_spmm`` takes them."""
        return (self.fl_src, self.fl_dst, self.fh_src, self.fh_dst,
                self.bl_src, self.bl_dst, self.bh_src, self.bh_dst)

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
    edge_chunk: Optional[int] = None  # segment sum: edges per chunk (None: all at once)
    agg_dtype: str = "float32"  # aggregation compute dtype ("bfloat16" on the card)


def shard_arrays_from_layout(layout: PartitionLayout, rank: int = 0,
                             edges: bool = False) -> ShardArrays:
    """Partition ``rank``'s rows of the layout as CPU tensors, with its
    segment-sum edge lists when ``edges`` (else empty)."""
    labels = torch.as_tensor(layout.labels[rank])
    lists = {}
    if edges:
        l_max = layout.l_max
        fh_src, fh_dst = layout.fwd_halo[0][rank], layout.fwd_halo[1][rank]
        # halo sources are stored as l_max + slot; padding edges read slot 0
        fh_src = np.where(fh_dst < l_max, fh_src - l_max, 0)
        for name, arr in (
            ("fl_src", layout.fwd_local[0][rank]), ("fl_dst", layout.fwd_local[1][rank]),
            ("fh_src", fh_src), ("fh_dst", fh_dst),
            ("bl_src", layout.bwd_local[0][rank]), ("bl_dst", layout.bwd_local[1][rank]),
            ("bh_src", layout.bwd_halo[0][rank]), ("bh_dst", layout.bwd_halo[1][rank]),
        ):
            lists[name] = torch.as_tensor(np.ascontiguousarray(arr, dtype=np.int32))
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
        **lists,
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
