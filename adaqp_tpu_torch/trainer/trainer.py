"""Trainer — the runtime that wires every subsystem together.

Reference: ``AdaQP/trainer/trainer.py`` + ``runtime_util.py``; the JAX
package's ``Trainer`` is the port's reference. Externally visible behaviour
(loss normalization, metric definitions, artifact formats) matches it.

This slice trains one partition (K=1) on one device: the strip bitmask
SpMM (``spmm_impl`` ``strip``, or ``auto``, which resolves to it) in mode
Vanilla or AdaQP-p, which run the same math when no messages cross
partitions. Everything else raises ``NotImplementedError`` naming its
ROADMAP item.

Numerics: float32 matrix products run in full f32 (TF32 is switched off
for both matmul and cuDNN), so an f32 run on the card can be compared with
the CPU. Under ``agg_dtype=bfloat16`` features are stored in bf16 and the
aggregation, the dense transforms and the activations run in bf16, with
f32 accumulation, LayerNorm statistics and logits.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..common.backend import DeviceLike, resolve_device
from ..common.types import AggregatorType, GNNType, Mode, Scheme
from ..graph import build_layout, partition_graph
from ..graph.device import shard_arrays_from_layout, static_from_layout
from ..graph.layout import load_layout, save_layout
from ..graph.strip_shards import build_strip_shards
from ..helper.dataset import GraphData, load_dataset
from ..model.gnn import apply_gnn, init_params, params_from_numpy
from ..model.loss import correct_count, f1_pieces, masked_loss_sum
from ..utils import Recorder, Timer
from .config import RunConfig

logger = logging.getLogger("adaqp_tpu_torch")

# the tile kernel's grid: rows padded to its 2048-row source windows,
# features to whole 16-byte vectors of 128 lanes
PAD_MULTIPLE, FEAT_MULTIPLE = 2048, 128


def setup_logger(level: str = "INFO", logfile: Optional[str] = "trainer.log"):
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(sh)
        if logfile:
            fh = logging.FileHandler(logfile)
            fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
            logger.addHandler(fh)


def _check_supported(cfg: RunConfig) -> RunConfig:
    """Reject what this slice does not run; resolve ``spmm_impl=auto``."""
    if cfg.num_parts != 1:
        raise NotImplementedError(
            f"num_parts={cfg.num_parts}: K>1 needs the boundary exchange "
            "(ROADMAP Queue 1, 'Exchange')"
        )
    if Mode.from_str(cfg.mode) not in (Mode.VANILLA, Mode.ADAQP_P):
        raise NotImplementedError(
            f"mode={cfg.mode}: quantized modes need the quantized wire and "
            "the assigner (ROADMAP Queue 1, 'Quantization', 'Exchange', "
            "'Assigner'; Queue 2, the quant kernels)"
        )
    if cfg.spmm_impl not in ("auto", "strip"):
        raise NotImplementedError(
            f"spmm_impl={cfg.spmm_impl}: only the strip kernel is ported "
            "(ROADMAP Queue 1, 'Segment SpMM' and 'Block and compact host "
            "sides'; Queue 2, the block and compact kernels)"
        )
    if cfg.ckpt_every or cfg.resume:
        raise NotImplementedError(
            "checkpointing is not ported (ROADMAP Queue 1, 'Trainer')"
        )
    return dataclasses.replace(cfg, spmm_impl="strip")


class Trainer:
    def __init__(self, cfg: RunConfig, graph: Optional[GraphData] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        setup_logger(cfg.logger_level)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cfg = _check_supported(cfg)
        self.mode = Mode.from_str(cfg.mode)
        self.scheme = Scheme.from_str(cfg.assign_scheme)
        self.model_type = GNNType.GCN if cfg.model_name == "gcn" else GNNType.SAGE
        self.timer = Timer()
        t0 = time.perf_counter()

        # ---- data + partition + layout ----
        self.graph = graph if graph is not None else load_dataset(
            cfg.dataset, cfg.raw_dir, **cfg.synth_kwargs
        )
        part_id = self._load_or_partition()
        lay_cache = os.path.join(
            cfg.partition_dir,
            f"{self.graph.name}_{cfg.num_parts}part_{cfg.partition_method}_"
            f"{self.model_type.value}_pm{PAD_MULTIPLE}_fm{FEAT_MULTIPLE}_layout",
        )
        self.layout = load_layout(lay_cache)
        if self.layout is None:
            self.layout = build_layout(
                self.graph, part_id, self.model_type,
                pad_multiple=PAD_MULTIPLE, feat_pad_multiple=FEAT_MULTIPLE,
            )
            save_layout(lay_cache, self.layout)
        else:
            logger.info("loaded layout cache %s", lay_cache)
        self.k = self.layout.k
        sh = shard_arrays_from_layout(self.layout, rank=0)
        if cfg.agg_dtype == "bfloat16":
            # features feed layer 0 in the aggregation dtype anyway; storing
            # them bf16 halves the largest resident
            sh = dataclasses.replace(sh, feats=sh.feats.to(torch.bfloat16))
        self.sh = sh.to(self.device)
        self.blocks = build_strip_shards(
            self.layout, min_edges=cfg.block_min_edges,
            # the JAX package caches its strip layouts under "_stp" in
            # another format
            cache_prefix=lay_cache + "_stc",
        ).to(self.device)
        self.static = static_from_layout(
            self.layout,
            model=self.model_type,
            agg_type=AggregatorType(cfg.aggregator_type),
            mode=self.mode,
            num_layers=cfg.num_layers,
            hidden=cfg.hidden_dim,
            dropout=cfg.dropout_rate,
            use_norm=cfg.use_norm,
            spmm=cfg.spmm_impl,
            agg_dtype=cfg.agg_dtype,
        )
        self.train_count = float(self.graph.train_mask.sum())
        self.val_count = float(self.graph.val_mask.sum())
        self.test_count = float(self.graph.test_mask.sum())

        # ---- model + optimizer ----
        self.params = init_params(
            torch.Generator().manual_seed(cfg.seed), self.static, self.device
        )
        # optax.chain(add_decayed_weights(wd), adam(lr)) adds wd * p to the
        # gradient before the moments: torch's Adam weight_decay, not AdamW
        self.opt = torch.optim.Adam(
            [p for layer in self.params for p in layer.values()],
            lr=cfg.learning_rate, weight_decay=cfg.weight_decay,
        )
        self.dropout_gen = torch.Generator(device=self.device)
        self.recorder = Recorder(cfg.num_epochs)
        self.overhead_s = time.perf_counter() - t0
        plan = self.layout.plan_fwd
        logger.info(
            "Trainer ready: %s %s mode=%s K=%d Lmax=%d R=%d S=%d on %s",
            cfg.dataset, cfg.model_name, self.mode.value, self.k,
            self.layout.l_max, plan.r_pad, plan.s_pad, self.device,
        )

    # ------------------------------------------------------------------
    def _load_or_partition(self) -> np.ndarray:
        cfg = self.cfg
        cache = os.path.join(
            cfg.partition_dir,
            f"{self.graph.name}_{cfg.num_parts}part_{cfg.partition_method}.npy",
        )
        if os.path.exists(cache):
            part = np.load(cache)
            if part.shape[0] == self.graph.num_nodes:
                logger.info("loaded partition cache %s", cache)
                return part
        part = partition_graph(self.graph, cfg.num_parts, cfg.partition_method, cfg.seed)
        os.makedirs(cfg.partition_dir, exist_ok=True)
        np.save(cache, part)
        return part

    def load_params(self, params) -> None:
        """Overwrite the parameters in place with numpy ones of the same
        structure (e.g. the JAX package's initial parameters)."""
        new = params_from_numpy(params, self.device)
        with torch.no_grad():
            for layer, src in zip(self.params, new, strict=True):
                if layer.keys() != src.keys():
                    raise ValueError(f"parameter names {sorted(src)} != {sorted(layer)}")
                for name, p in layer.items():
                    p.copy_(src[name])

    def _train_step(self, epoch: int) -> torch.Tensor:
        # dropout masks come from (seed, epoch), so a resumed run could draw
        # the same masks as an uninterrupted one
        self.dropout_gen.manual_seed(self.cfg.seed * 100_003 + epoch)
        self.opt.zero_grad(set_to_none=True)
        logits, _ = apply_gnn(
            self.params, self.sh, self.static, True, self.blocks, self.dropout_gen
        )
        s = self.sh
        loss = masked_loss_sum(logits, s.labels, s.train_mask, self.static.multilabel)
        loss = loss / self.train_count
        loss.backward()
        self.opt.step()
        return loss.detach()

    @torch.no_grad()
    def _eval_step(self):
        st, s = self.static, self.sh
        logits, _ = apply_gnn(self.params, s, st, False, self.blocks)
        masks = (s.train_mask, s.val_mask, s.test_mask)
        if st.multilabel:
            out = []
            for m in masks:
                tp, fp, fn = (x.float() for x in f1_pieces(logits, s.labels, m))
                out.append(2 * tp / torch.clamp_min(2 * tp + fp + fn, 1.0))
            return [float(x) for x in out]
        counts = (self.train_count, self.val_count, self.test_count)
        return [
            float(correct_count(logits, s.labels, m)) / c
            for m, c in zip(masks, counts)
        ]

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        t_train0 = time.perf_counter()
        losses = []
        for epoch in range(1, cfg.num_epochs + 1):
            t0 = time.perf_counter()
            # the host readback waits for the device, so the bracket holds
            # the whole step
            loss = float(self._train_step(epoch))
            self.timer.add_epoch(time.perf_counter() - t0)
            losses.append(loss)
            tr, va, te = self._eval_step()
            self.recorder.add(tr, va, te)
            if epoch % cfg.log_steps == 0:
                logger.info(
                    "epoch %04d | loss %.4f | %.3fs | train %.4f val %.4f test %.4f",
                    epoch, loss, self.timer.epoch_times[-1], tr, va, te,
                )
        total = time.perf_counter() - t_train0
        ep = np.asarray(self.timer.epoch_times)
        # median: robust to the first epoch's one-time costs (kernel build
        # and load, allocator warm-up)
        steady = float(np.median(ep)) if len(ep) else 0.0
        best = self.recorder.best()
        records = {
            "overhead": self.overhead_s,
            "total": total,
            "per_epoch": steady,
            "buckets": self.timer.epoch_traced_time(),
            "best": best,
            "val_curve": self.recorder.val_curve(),
            "loss_curve": np.asarray(losses),
        }
        logger.info(
            "done: best epoch %d train %.4f val %.4f test %.4f | %.3fs/epoch",
            *best, steady,
        )
        return records

    # ------------------------------------------------------------------
    def save(self, records: Dict[str, Any]):
        """Write reference-compatible artifacts (``trainer.py:203-238``):
        metrics txt, val-curve array, per-worker time CSV."""
        cfg = self.cfg
        base = os.path.join(
            cfg.exp_path, self.graph.name, f"{self.k}part", cfg.model_name
        )
        name = self.mode.value + (
            f"_{self.scheme.value}" if self.mode.quantized else ""
        )
        for sub in ("metrics", "val_curve", "time"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        e, tr, va, te = records["best"]
        with open(os.path.join(base, "metrics", f"{name}.txt"), "w") as f:
            f.write(
                f"best epoch: {e}\ntrain: {tr:.4f}\nval: {va:.4f}\ntest: {te:.4f}\n"
                f"per_epoch_s: {records['per_epoch']:.4f}\n"
                f"total_s: {records['total']:.4f}\noverhead_s: {records['overhead']:.4f}\n"
            )
        np.save(os.path.join(base, "val_curve", f"{name}.npy"), records["val_curve"])
        comm, quant_t, central, marginal, full = records["buckets"]
        rows = []
        for w in range(self.k):
            rows.append(
                [w, records["overhead"], records["total"], records["per_epoch"],
                 comm, quant_t, central, marginal, full]
            )
        header = "Worker,Overhead,Total,Per_epoch,Comm,Quant,Central,Marginal,Full"
        np.savetxt(
            os.path.join(base, "time", f"{name}.csv"),
            np.asarray(rows),
            delimiter=",",
            header=header,
            comments="",
            fmt="%.6f",
        )
        logger.info("artifacts written under %s", base)
