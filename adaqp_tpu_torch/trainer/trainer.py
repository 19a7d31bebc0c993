"""Trainer — the runtime that wires every subsystem together.

Reference: ``AdaQP/trainer/trainer.py`` + ``runtime_util.py``; the JAX
package's ``Trainer`` is the port's reference. Externally visible behaviour
(modes, schemes, loss normalization, metric definitions, the reassignment
cadence, artifact formats) matches it.

One process trains one partition. At K=1 there is no process group. At
K>1 every rank of a ``torch.distributed`` group of ``num_parts`` ranks
builds a Trainer (``comm/distributed.py::spawn`` or ``python -m
adaqp_tpu_torch`` start them):

- rank 0 partitions the graph and writes the partition, layout and tile
  layout caches; the other ranks load them after a barrier (the JAX package
  writes from process 0 only, ``trainer.py:340``). Each rank keeps its own
  shard's arrays and tile layouts on its device;
- parameters start identical on every rank (drawn on a CPU generator from
  ``seed``); each rank's loss is its masked sum over the GLOBAL train
  count, the gradients are all-reduced with SUM before ``Adam.step`` (the
  reference's ``average_gradients``), so parameters stay identical;
- boundary rows travel on the run's wire (``wire_impl``): the exact-size
  ragged wire (the fp wire in Vanilla and AdaQP-p and in every
  evaluation, the quantized wire of the current
  :class:`~adaqp_tpu_torch.assigner.Assignment` in AdaQP and AdaQP-q
  training) or the padded dense wire (the f32 exchange over the plan, or
  the assignment's per-width buckets in quantized training, on lane
  tables built once an assignment);
- schemes: ``uniform`` keeps ``assign_bits``; ``random`` draws new widths
  and ``adaptive`` solves the variance-vs-time MILP at every epoch with
  ``epoch % assign_cycle == 1`` except the first (``trainer.py:813-819``).
  For ``adaptive`` the ranks accumulate forward and backward variance
  traces, all-gather them to rank 0, which solves and broadcasts the
  assignment, so no two ranks can hold different plans; the cost model
  comes from timing the transport at start-up (``assigner/profile.py``);
- the breakdown probe (``measure_breakdown``, on by default) times the
  parts of a training epoch before the first one and fills the time CSV's
  Comm, Quant, Central and Marginal columns (:meth:`Trainer._breakdown_probe`);
- checkpoints (``ckpt_every``, ``resume``; ``utils/checkpoint.py``): after
  each ``ckpt_every``-th epoch's evaluation rank 0 writes one file with the
  parameters, the Adam state, the recorder, the assignment, the cost model
  and every rank's traces. A resumed run reads the latest one at
  construction, takes its cost model instead of profiling, and goes on
  from the next epoch; as every random stream below comes from the epoch
  index, it draws what the straight run draws (the JAX Trainer splits a
  key once an executed epoch, so its resumed runs draw other keys);
- recomputation (``remat``): the training step recomputes each layer in
  the backward pass instead of keeping its intermediates
  (``model/gnn.py::remat_layer``); the recompute reads the halo rows the
  layer's exchange delivered and ships nothing again, so the wire's
  launches and the traces are those of a run without it;
- the memory report (``log_hbm``): one line after the first training step
  with the bytes allocated before it, the step's peak above them and the
  gradients' bytes (:meth:`Trainer._log_step_memory`).

Random streams, all derived from ``seed`` with
``ops/quant_cuda.py::stream_key``, so that a run is reproducible and a
card run draws what a CPU run draws:

- dropout masks of epoch ``e`` on rank ``r``: a generator seeded with
  ``stream_key(seed, e, r, 0)``, which the layers draw from in turn (a
  recomputed layer draws its mask again from the state it first drew
  from);
- quantized bucket ``b`` of layer ``l`` in direction ``d`` (1 forward,
  2 backward), epoch ``e``, rank ``r``: the kernel's generator key
  ``stream_key(stream_key(seed, e, r, l, d), b)``.

Numerics: float32 matrix products run in full f32 (TF32 is switched off
for both matmul and cuDNN), so an f32 run on the card can be compared with
the CPU. Under ``agg_dtype=bfloat16`` features are stored in bf16 and the
aggregation, the dense transforms and the activations run in bf16, with
f32 accumulation, LayerNorm statistics, logits and wire rows.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..assigner import Assigner, AssignerConfig, Assignment, random_assignment
from ..assigner.profile import fit_cost_model, profile_cost_model
from ..assigner.assignment import buckets_from_assignment
from ..comm.distributed import resolve_backend
from ..comm.exchange import padded_all_to_all, padded_wire
from ..comm.ragged import ragged_all_to_all
from ..comm.wire import wire_cols, wire_fp, wire_from_assignment
from ..common.backend import DeviceLike, resolve_device
from ..common.types import BITS_SET, WIRE_BITS_SET, AggregatorType, GNNType, Mode, Scheme
from ..graph import build_layout, partition_graph
from ..graph.device import agg_torch_dtype, shard_arrays_from_layout, static_from_layout
from ..graph.layout import load_layout, save_layout
from ..helper.dataset import GraphData, load_dataset
from ..model.gnn import apply_gnn, init_params, params_from_numpy
from ..model.loss import correct_count, f1_pieces, masked_loss_sum
from ..ops.dist_ops import _seg, pick_block_kernel
from ..ops.quant import bytes_per_row, pad_features
from ..ops.quant_cuda import (dequant_frames, make_frames, quant_frames, quant_pack, stream_key,
                              unpack_dequant)
from ..utils import Recorder, Timer
from .config import RunConfig

logger = logging.getLogger("adaqp_tpu_torch")

# (row, feature) padding per aggregation, the JAX Trainer's: the tile
# kernels pad rows to their 2048-row source windows and features to 128
# lanes, compact features to 384 (its TPU kernel's lane chunk; kept so that
# the first weight has the JAX Trainer's shape), the segment sum to (8, 4)
PADDING = {"strip": (2048, 128), "block": (2048, 128), "compact": (2048, 384),
           "segment": (8, 4)}


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
    """Reject what the port does not run; resolve ``spmm_impl=auto``."""
    if cfg.spmm_impl not in ("auto", *PADDING):
        raise ValueError(f"unknown spmm_impl {cfg.spmm_impl!r}")
    if cfg.wire_impl not in ("ragged", "padded"):
        raise ValueError(f"unknown wire_impl {cfg.wire_impl!r} (ragged or padded)")
    if cfg.fp32_lanes and cfg.wire_impl != "ragged" and Mode.from_str(cfg.mode).quantized:
        raise ValueError(
            "fp32_lanes needs the ragged wire: the padded wire's buckets carry "
            "only quantized widths (2, 4, 8 bits)"
        )
    # auto is the strip kernel on every device (the JAX Trainer picks the
    # segment sum off the TPU; on the card the tile kernels are the point)
    return dataclasses.replace(
        cfg, spmm_impl="strip" if cfg.spmm_impl == "auto" else cfg.spmm_impl
    )


def _scalar_or_array(a: np.ndarray):
    """A saved cost-model term: a float for a 0-d array (one global fit)."""
    return float(a) if a.ndim == 0 else a


def _check_compact_gate(cfg: RunConfig, device: torch.device) -> None:
    """On the card the compact path needs the row gather; a failed probe
    raises (the JAX Trainer redirects compact to block, which would hide a
    failed kernel)."""
    if cfg.spmm_impl != "compact" or device.type != "cuda":
        return
    from ..ops.spmm_compact import dynamic_gather_supported

    if not dynamic_gather_supported():
        raise RuntimeError(
            "spmm_impl=compact on the card needs its row gather, and "
            "spmm_compact.dynamic_gather_supported() found none"
        )


def _process_group(cfg: RunConfig, device: torch.device) -> Tuple[int, int]:
    """(rank, world) of this Trainer; K>1 needs the process group."""
    if cfg.num_parts == 1:
        return 0, 1
    if not dist.is_initialized():
        raise RuntimeError(
            f"num_parts={cfg.num_parts} runs one torch.distributed rank per "
            "partition: start the ranks with `python -m adaqp_tpu_torch` or "
            "adaqp_tpu_torch.comm.distributed.spawn"
        )
    if dist.get_world_size() != cfg.num_parts:
        raise ValueError(
            f"num_parts={cfg.num_parts} but the process group has "
            f"{dist.get_world_size()} ranks"
        )
    local = int(os.environ.get("LOCAL_WORLD_SIZE", cfg.num_parts))
    if dist.get_backend() == "nccl" and resolve_backend(local, device) != "nccl":
        raise ValueError(
            f"an nccl process group needs one CUDA card per rank ({local} ranks "
            f"on this host, device {device}); ranks that share a card or run on "
            "the CPU join a gloo group"
        )
    return dist.get_rank(), dist.get_world_size()


class Trainer:
    def __init__(self, cfg: RunConfig, graph: Optional[GraphData] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        setup_logger(cfg.logger_level)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cfg = _check_supported(cfg)
        _check_compact_gate(cfg, self.device)
        self.rank, self.world = _process_group(cfg, self.device)
        # gloo carries CUDA tensors on the exchange's hot path; the small
        # control collectives (gradients, counts, traces) go through the CPU
        self._comm_dev = (self.device if self.world > 1 and dist.get_backend() == "nccl"
                          else torch.device("cpu"))
        self.mode = Mode.from_str(cfg.mode)
        self.scheme = Scheme.from_str(cfg.assign_scheme)
        self.model_type = GNNType.GCN if cfg.model_name == "gcn" else GNNType.SAGE
        self.timer = Timer()
        t0 = time.perf_counter()

        # ---- data + partition + layout: rank 0 builds, the others load ----
        self.graph = graph if graph is not None else load_dataset(
            cfg.dataset, cfg.raw_dir, **cfg.synth_kwargs
        )
        if self.rank != 0:
            dist.barrier()
        shards = self._host_setup()
        if self.world > 1 and self.rank == 0:
            dist.barrier()
        self.k = self.layout.k
        if self.k != self.world:
            raise ValueError(f"the layout has {self.k} partitions for {self.world} ranks")
        sh = shard_arrays_from_layout(
            self.layout, rank=self.rank, edges=cfg.spmm_impl == "segment")
        if cfg.agg_dtype == "bfloat16":
            # features feed layer 0 in the aggregation dtype anyway; storing
            # them bf16 halves the largest resident
            sh = dataclasses.replace(sh, feats=sh.feats.to(torch.bfloat16))
        self.sh = sh.to(self.device)
        self.blocks = None if shards is None else shards.select(self.rank).to(self.device)
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
            edge_chunk=cfg.edge_chunk,
            wire=cfg.wire_impl,
            remat=cfg.remat,
        )
        # global counts from the layout: every node lies in one partition
        lay = self.layout
        self.train_count = float(lay.train_mask.sum())
        self.val_count = float(lay.val_mask.sum())
        self.test_count = float(lay.test_mask.sum())

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

        # ---- wires: TRUE message widths per layer (features, then hidden)
        # drive the wire layouts and the assigner's byte model ----
        plan = lay.plan_fwd
        self.layer_dims = [lay.f_true] + [cfg.hidden_dim] * (cfg.num_layers - 1)
        # ragged: per-layer wire plans; padded: per-layer buckets of this
        # rank and their lane tables (quantized training), the f32 exchange
        # needs none
        self.wire_fp = self.wire_q = self.buckets = self.padded = None
        if self.k > 1 and cfg.wire_impl == "ragged":
            self.wire_fp = self._local_wires(wire_fp(plan, self.layer_dims, cfg.num_layers))

        # ---- checkpoint to resume from (read before the assigner: it holds
        # the cost model and the assignment) ----
        ckpt = self._read_checkpoint() if cfg.resume else None  # (epoch, arrays, path)
        saved = None if ckpt is None else ckpt[1]

        # ---- assigner (quantized modes; at K=1 nothing crosses) ----
        self.assignment: Optional[Assignment] = None
        self.assigner: Optional[Assigner] = None
        self.profile_s = 0.0
        self.assign_s: List[float] = []
        if self._has_assigner():
            acfg = AssignerConfig(
                group_size=cfg.group_size,
                coe_lambda=cfg.coe_lambda,
                assign_bits=cfg.assign_bits,
                wire_feats=lay.f_true,
                normal_mode=cfg.normal_mode,
                bits_options=self._bits_options(),
            )
            cost_model = (1.0, 0.1)
            if saved is not None:
                # the saved fit, not a new profile: the next reassignment
                # then solves what the straight run solves (the JAX Trainer
                # profiles again on resume)
                cost_model = tuple(_scalar_or_array(saved[f"cost.{x}"])
                                   for x in ("alpha", "beta"))
            elif self.scheme is Scheme.ADAPTIVE:
                tp = time.perf_counter()
                sizes, times = profile_cost_model(
                    max_bytes_per_pair=plan.s_pad * (self.static.f_pad + 4),
                    num_sizes=cfg.profile_data_length, mode=cfg.profile_mode,
                    device=self.device,
                )
                cost_model = fit_cost_model(sizes, times)
                self.profile_s = time.perf_counter() - tp
                a = np.asarray(cost_model[0])
                nz = a[a > 0]
                logger.info(
                    "profiled per-channel cost model in %.2fs: alpha %.4f-%.4f "
                    "ms/MB, beta mean %.4f ms", self.profile_s,
                    float(nz.min()) if nz.size else 0.0,
                    float(nz.max()) if nz.size else 0.0,
                    float(np.asarray(cost_model[1]).mean()),
                )
            self.assigner = Assigner(plan, cfg.num_layers, acfg, cost_model)
            # bootstrap: uniform assign_bits (reference trainer.py:63-66)
            if saved is not None:
                self.assignment = Assignment(
                    [saved[f"asg.fwd.{i}"] for i in range(cfg.num_layers)],
                    [saved[f"asg.bwd.{i}"] for i in range(cfg.num_layers)])
            elif self.scheme is Scheme.RANDOM:
                self.assignment = random_assignment(plan, cfg.num_layers, cfg.seed)
            else:
                self.assignment = self.assigner.bootstrap()
            self._lower_assignment()
        self._reset_traces()
        self.recorder = Recorder(cfg.num_epochs)
        # epochs already trained: training goes on from the next one
        self.start_epoch = 0 if ckpt is None else self._apply_checkpoint(*ckpt)
        self.overhead_s = time.perf_counter() - t0
        logger.info(
            "Trainer ready: %s %s mode=%s scheme=%s K=%d rank=%d Lmax=%d R=%d S=%d on %s",
            cfg.dataset, cfg.model_name, self.mode.value, self.scheme.value, self.k,
            self.rank, lay.l_max, plan.r_pad, plan.s_pad, self.device,
        )

    # ------------------------------------------------------------------
    def _host_setup(self):
        """Partition, layout and the aggregation's shards (None for the
        segment sum), each from its cache when one exists (rank 0 runs this
        first and writes them)."""
        cfg = self.cfg
        part_id = self._load_or_partition()
        pad_multiple, feat_multiple = PADDING[cfg.spmm_impl]
        lay_cache = os.path.join(
            cfg.partition_dir,
            f"{self.graph.name}_{cfg.num_parts}part_{cfg.partition_method}_"
            f"{self.model_type.value}_pm{pad_multiple}_fm{feat_multiple}_layout",
        )
        self.layout = load_layout(lay_cache)
        if self.layout is None:
            self.layout = build_layout(
                self.graph, part_id, self.model_type,
                pad_multiple=pad_multiple, feat_pad_multiple=feat_multiple,
            )
            save_layout(lay_cache, self.layout)
        else:
            logger.info("loaded layout cache %s", lay_cache)
        if cfg.spmm_impl == "strip":
            from ..graph.strip_shards import build_strip_shards

            # the JAX package caches its strip layouts under "_stp" in
            # another format
            return build_strip_shards(
                self.layout, min_edges=cfg.block_min_edges, cache_prefix=lay_cache + "_stc")
        if cfg.spmm_impl == "block":
            from ..graph.block_shards import build_block_shards

            return build_block_shards(
                self.layout, min_edges=cfg.block_min_edges, cache_prefix=lay_cache + "_blk")
        if cfg.spmm_impl == "compact":
            from ..graph.compact_shards import build_compact_shards

            return build_compact_shards(
                self.layout, me_ell=cfg.compact_me_ell, full_cols=cfg.compact_full_cols,
                cache_prefix=lay_cache + "_cmp")
        return None

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

    def _bits_options(self):
        """Widths the assigner may choose and the wire carries (with
        ``fp32_lanes``, raw f32 lanes too)."""
        return WIRE_BITS_SET if self.cfg.fp32_lanes else BITS_SET

    def _local_wires(self, plans):
        """All-rank wire plans -> this rank's (fwd, bwd) LocalWires."""
        st = self.layout
        return [
            (f.local(self.rank, st.plan_fwd.r_pad, self.device),
             None if b is None else b.local(self.rank, st.l_max, self.device))
            for f, b in plans
        ]

    def _lower_assignment(self):
        """Assignment -> this rank's quantized wire plans, or padded buckets
        and their lane tables (the reference's train-buffer regeneration,
        ``buffer.py:176-248``)."""
        if self.cfg.wire_impl == "padded":
            st = self.static
            dims = [st.f_pad] + [st.hidden] * (st.num_layers - 1)
            f_true = [st.f_true or st.f_pad] + dims[1:]  # as apply_gnn exchanges them
            self.buckets = [
                (bits, tuple(tuple(torch.as_tensor(a[self.rank]).long().to(self.device)
                                   for a in quad) for quad in arrays))
                for bits, arrays in buckets_from_assignment(
                    self.layout.plan_fwd, self.assignment, self.layout.l_max)
            ]
            self.padded = [padded_wire(b, ft, d) for b, ft, d in zip(self.buckets, f_true, dims)]
            return
        self.wire_q = self._local_wires(wire_from_assignment(
            self.layout.plan_fwd, self.assignment, self.layer_dims,
            bits_set=self._bits_options(),
        ))

    def _reset_traces(self):
        plan = self.layout.plan_fwd
        L = self.cfg.num_layers
        self.trace_fwd = torch.zeros((L, self.k, plan.s_pad), device=self.device)
        self.trace_bwd = torch.zeros((L, plan.r_pad), device=self.device)

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

    # ------------------------------------------------------------------
    def _has_assigner(self) -> bool:
        """Quantized modes at K>1 assign widths (at K=1 nothing crosses)."""
        return self.mode.quantized and self.k > 1

    def _named_params(self):
        return [(f"{i}.{name}", p) for i, layer in enumerate(self.params)
                for name, p in layer.items()]

    def _ckpt_path(self, epoch: int) -> str:
        """The JAX Trainer's path: ``ckpt_dir/{graph}/{K}part_{model}/ckpt_{epoch}``."""
        return os.path.join(self.cfg.ckpt_dir, self.graph.name,
                            f"{self.k}part_{self.cfg.model_name}", f"ckpt_{epoch}")

    def _ckpt_shapes(self) -> Dict[str, Optional[Tuple[int, ...]]]:
        """Name -> shape of every array a checkpoint of this run holds (None:
        any shape). One file for all ranks: parameters and Adam state are
        the same on every rank, the traces are stacked over ranks."""
        L, plan = self.cfg.num_layers, self.layout.plan_fwd
        shapes: Dict[str, Optional[Tuple[int, ...]]] = {"recorder": None}
        for key, p in self._named_params():
            shapes[f"params.{key}"] = tuple(p.shape)
            shapes[f"opt.{key}.step"] = ()
            shapes[f"opt.{key}.exp_avg"] = shapes[f"opt.{key}.exp_avg_sq"] = tuple(p.shape)
        shapes["trace.fwd"] = (self.world, L, self.k, plan.s_pad)
        shapes["trace.bwd"] = (self.world, L, plan.r_pad)
        if self._has_assigner():
            shapes["cost.alpha"] = shapes["cost.beta"] = None  # scalars or [K, K]
            for i in range(L):
                shapes[f"asg.fwd.{i}"] = tuple(plan.send_idx.shape)
                shapes[f"asg.bwd.{i}"] = (self.k, plan.r_pad)
        return shapes

    def _read_checkpoint(self):
        """``(step, state, path)`` of the latest checkpoint of this run, or
        None when there is none (the run then starts fresh)."""
        from ..utils.checkpoint import latest_checkpoint, load_checkpoint

        t0 = time.perf_counter()
        d = os.path.dirname(self._ckpt_path(0))
        path = latest_checkpoint(d)
        if path is None:
            logger.info("resume requested but no checkpoint under %s: starting fresh", d)
            return None
        step, state, _ = load_checkpoint(path, self._ckpt_shapes())
        self.timer.add("ckpt_load", time.perf_counter() - t0)
        return step, state, path

    def _apply_checkpoint(self, step: int, state, path: str) -> int:
        """Parameters, Adam state, this rank's traces and the recorder from
        a checkpoint; returns its epoch."""
        with torch.no_grad():
            for key, p in self._named_params():
                p.copy_(torch.from_numpy(state[f"params.{key}"]))
        sd = self.opt.state_dict()
        sd["state"] = {i: {f: torch.from_numpy(state[f"opt.{key}.{f}"])
                           for f in ("step", "exp_avg", "exp_avg_sq")}
                       for i, (key, _) in enumerate(self._named_params())}
        self.opt.load_state_dict(sd)
        self.trace_fwd.copy_(torch.from_numpy(state["trace.fwd"][self.rank]))
        self.trace_bwd.copy_(torch.from_numpy(state["trace.bwd"][self.rank]))
        # into the fresh matrix: the resumed run may end at another epoch
        loaded = state["recorder"]
        n = min(len(loaded), len(self.recorder.metrics))
        self.recorder.metrics[:n] = loaded[:n]
        self.recorder._cursor = min(step, n)
        logger.info("resumed from %s at epoch %d", path, step)
        return step

    def _ckpt_state(self, trace_fwd: torch.Tensor, trace_bwd: torch.Tensor
                    ) -> Dict[str, np.ndarray]:
        """The arrays of :meth:`_ckpt_shapes`, with the traces of every rank."""
        state = {"recorder": self.recorder.metrics,
                 "trace.fwd": trace_fwd.cpu().numpy(), "trace.bwd": trace_bwd.cpu().numpy()}
        for key, p in self._named_params():
            state[f"params.{key}"] = p.detach().cpu().numpy()
            for f, v in self.opt.state[p].items():
                state[f"opt.{key}.{f}"] = v.detach().cpu().numpy()
        if self._has_assigner():
            state["cost.alpha"] = np.asarray(self.assigner.alpha)
            state["cost.beta"] = np.asarray(self.assigner.beta)
            for d, arrays in (("fwd", self.assignment.fwd), ("bwd", self.assignment.bwd)):
                for i, a in enumerate(arrays):
                    state[f"asg.{d}.{i}"] = np.asarray(a)
        return state

    def _save_checkpoint(self, epoch: int) -> None:
        """Rank 0 writes one checkpoint with every rank's traces; a
        collective at K>1 that ends in a barrier, so no rank runs ahead of
        a half-written file."""
        from ..utils.checkpoint import save_checkpoint

        t0 = time.perf_counter()
        if self.world > 1:
            tf, tb = self._all_gather(self.trace_fwd), self._all_gather(self.trace_bwd)
        else:
            tf, tb = self.trace_fwd[None], self.trace_bwd[None]
        if self.rank == 0:
            meta = {"mode": self.mode.value, "scheme": self.scheme.value,
                    "num_epochs": self.cfg.num_epochs}
            save_checkpoint(self._ckpt_path(epoch), epoch, self._ckpt_state(tf, tb), meta)
        if self.world > 1:
            dist.barrier()
        self.timer.add("ckpt_save", time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over ranks (a no-op at K=1), on the control device."""
        if self.world == 1:
            return t
        x = t.to(self._comm_dev)
        dist.all_reduce(x)
        return x.to(t.device)

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[world, *t.shape] on every rank."""
        x = t.to(self._comm_dev).contiguous()
        out = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(out, x)
        return torch.stack(out).to(t.device)

    def _adaptive(self) -> bool:
        return self.assigner is not None and self.scheme is Scheme.ADAPTIVE

    def _train_step(self, epoch: int) -> torch.Tensor:
        cfg, st = self.cfg, self.static
        self.dropout_gen.manual_seed(stream_key(cfg.seed, epoch, self.rank, 0))
        self.opt.zero_grad(set_to_none=True)
        sinks = None
        if self._adaptive():
            # layer 0 has no backward exchange, so no trace and no sink
            sinks = [None] + [
                torch.zeros(st.r_pad, device=self.device, requires_grad=True)
                for _ in range(st.num_layers - 1)
            ]
        keys = [(stream_key(cfg.seed, epoch, self.rank, i, 1),
                 stream_key(cfg.seed, epoch, self.rank, i, 2))
                for i in range(st.num_layers)]
        logits, traces = apply_gnn(
            self.params, self.sh, st, True, self.blocks, self.dropout_gen,
            wires=self.wire_q if self.mode.quantized else self.wire_fp,
            keys=keys, sinks=sinks,
            padded=self.padded if self.mode.quantized else None,
        )
        s = self.sh
        loss = masked_loss_sum(logits, s.labels, s.train_mask, st.multilabel)
        loss = loss / self.train_count
        loss.backward()
        loss = loss.detach()
        if self.world > 1:
            loss = self._sync_grads(loss)
        self.opt.step()
        if sinks is not None:
            self.trace_fwd += traces
            for i in range(1, st.num_layers):
                self.trace_bwd[i] += sinks[i].grad
        return loss

    def _sync_grads(self, loss: torch.Tensor) -> torch.Tensor:
        """All-reduce every gradient (SUM) and the loss in one buffer;
        returns the global loss."""
        ps = [p for layer in self.params for p in layer.values()]
        for p in ps:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = self._all_reduce(torch.cat([p.grad.reshape(-1) for p in ps] + [loss.reshape(1)]))
        o = 0
        for p in ps:
            p.grad.copy_(flat[o:o + p.numel()].view_as(p))
            o += p.numel()
        return flat[o]

    @torch.no_grad()
    def _eval_step(self):
        st, s = self.static, self.sh
        logits, _ = apply_gnn(self.params, s, st, False, self.blocks, wires=self.wire_fp)
        masks = (s.train_mask, s.val_mask, s.test_mask)
        if st.multilabel:
            pieces = torch.stack([x.float() for m in masks for x in f1_pieces(logits, s.labels, m)])
            tp, fp, fn = self._all_reduce(pieces).view(3, 3).T
            return [float(x) for x in 2 * tp / torch.clamp_min(2 * tp + fp + fn, 1.0)]
        correct = torch.stack([correct_count(logits, s.labels, m).float() for m in masks])
        correct = self._all_reduce(correct).tolist()
        counts = (self.train_count, self.val_count, self.test_count)
        return [c / n for c, n in zip(correct, counts)]

    # ------------------------------------------------------------------
    def _reassign(self, epoch: int):
        """Periodic bit-width reassignment (reference
        ``runtime_util.py:86-93``)."""
        t0 = time.perf_counter()
        plan, L = self.layout.plan_fwd, self.cfg.num_layers
        if self.scheme is Scheme.RANDOM:
            # numpy from a shared seed: every rank draws the same widths
            self.assignment = random_assignment(plan, L, self.cfg.seed + epoch)
        else:
            tf = self._all_gather(self.trace_fwd).transpose(0, 1)  # [L, K, K, S]
            tb = self._all_gather(self.trace_bwd).transpose(0, 1)  # [L, K, R]
            asg = None
            if self.rank == 0:
                asg = self.assigner.assign(
                    tf.cpu().numpy(), tb.cpu().numpy(), layer_dims=self.layer_dims
                )
            self.assignment = self._broadcast_assignment(asg)
            self._reset_traces()
        t_assign = time.perf_counter() - t0
        self._lower_assignment()
        dt = time.perf_counter() - t0
        self.assign_s.append(dt)
        self.timer.add("assignment_overhead", dt)
        logger.info(
            "epoch %d: reassignment done in %.2fs (solve %.2fs, lower %.2fs)",
            epoch, dt, t_assign, dt - t_assign,
        )

    def _broadcast_assignment(self, asg: Optional[Assignment]) -> Assignment:
        """Rank 0's assignment on every rank."""
        plan, L = self.layout.plan_fwd, self.cfg.num_layers
        shapes = [plan.send_idx.shape] * L + [(self.k, plan.r_pad)] * L
        if self.rank == 0:
            flat = torch.as_tensor(np.concatenate(
                [np.asarray(a, np.int32).reshape(-1) for a in asg.fwd + asg.bwd]))
        else:
            flat = torch.empty(sum(int(np.prod(s)) for s in shapes), dtype=torch.int32)
        flat = flat.to(self._comm_dev)
        dist.broadcast(flat, src=0)
        flat = flat.cpu().numpy()
        arrays, o = [], 0
        for s in shapes:
            n = int(np.prod(s))
            arrays.append(flat[o:o + n].reshape(s))
            o += n
        return Assignment(arrays[:L], arrays[L:])

    def planned_quant_launches(self) -> Tuple[int, int]:
        """Launches of the wire's (quantize, dequantize) kernel pair one
        epoch makes on this rank with the current wires. The ragged wire:
        (quant_pack, unpack_dequant), one each per direction of an exchange
        that sends or receives any lane, 32-bit lanes included: the
        training step's exchanges (quantized or full-precision, layer 0
        has no backward) and the evaluation's forward ones. The padded
        wire: (quant_rows, dequant_rows), one pair per direction of a
        quantized training step's exchange that carries any lane (layer 0
        has no backward). Recomputation (``remat``) adds none: the
        recompute reads the halo rows the exchange delivered."""
        if self.padded is not None:
            n = sum(int(w.fwd.n > 0) + (int(w.bwd.n > 0) if i else 0)
                    for i, w in enumerate(self.padded))
            return n, n
        if self.wire_fp is None:
            return 0, 0
        train = self.wire_q if self.mode.quantized else self.wire_fp
        wires = [w for pair in train for w in pair] + [wf for wf, _ in self.wire_fp]
        pack = unpack = 0
        for w in wires:
            if w is not None:
                p, u = w.quant_launches()
                pack, unpack = pack + p, unpack + u
        return pack, unpack

    def _step_tile_launches(self, remat: bool) -> int:
        """Tile launches of one training step: the forward aggregates twice
        a layer (local and halo), the backward once a layer after the first
        (layer 0's input carries no gradient), twice at K>1 (the halo rows
        carry one through the exchange); with ``remat`` the backward
        recomputes each layer's forward, twice a layer more."""
        layers = self.cfg.num_layers
        fwd = 2 * layers
        return fwd + (layers - 1) * (1 if self.k == 1 else 2) + (fwd if remat else 0)

    def tile_launches_per_epoch(self) -> int:
        """Launches of the run's tile kernel one epoch (a training step and
        an evaluation, which aggregates twice a layer) makes on this rank;
        0 for the segment sum."""
        if self.blocks is None:
            return 0
        return self._step_tile_launches(self.static.remat) + 2 * self.cfg.num_layers

    def _probe_aggregation(self):
        """part -> fn(rows) running the run's aggregation of that part:
        "fl"/"fh" the forward local/halo sums, "bl"/"bh" their transposes
        (the backward's)."""
        st, dt = self.static, agg_torch_dtype(self.static)
        if self.blocks is None:
            s, l, r = self.sh, st.l_max, st.r_pad
            lists = {"fl": (s.fl_src, s.fl_dst, l), "bl": (s.bl_src, s.bl_dst, l),
                     "fh": (s.fh_src, s.fh_dst, l), "bh": (s.bh_src, s.bh_dst, r)}
            return {part: (lambda x, e=e: _seg(e[0], e[1], x, e[2], st.edge_chunk))
                    for part, e in lists.items()}
        lays = dict(zip(("fl", "bl", "fh", "bh"), self.blocks.devices()))
        kernel = pick_block_kernel(lays["fl"])
        return {part: (lambda x, lay=lay: kernel(lay, x.to(dt), None))
                for part, lay in lays.items()}

    def probe_launches(self, reps: int = 5) -> Dict[str, int]:
        """Kernel launches :meth:`_breakdown_probe` makes on this rank
        (kernel name -> count): each timed call runs once to warm up and
        ``reps`` times. The aggregation: what a training step runs (the
        local and halo parts forward, their transposes after layer 0, the
        halo's only at K>1). The quant pair of the wire, once a layer, in
        quantized modes at K>1."""
        layers, calls = self.cfg.num_layers, reps + 1
        out = {}
        if self.blocks is not None:
            name = {"strip": "strip_spmm", "block": "block_spmm",
                    "compact": "compact_spmm"}[self.cfg.spmm_impl]
            # a training step's, without recomputation
            out[name] = calls * self._step_tile_launches(remat=False)
        if self.assigner is not None:
            pair = (("quant_rows", "dequant_rows") if self.cfg.wire_impl == "padded"
                    else ("quant_pack", "unpack_dequant"))
            out.update({name: calls * layers for name in pair})
        return out

    @torch.no_grad()
    def _breakdown_probe(self, reps: int = 5):
        """Per-epoch time buckets [comm, quant, central, marginal], from
        timing each part of a training step alone at the run's shapes (the
        reference brackets the regions of the step itself with stream-sync
        fences, ``AdaQP/util/timer.py:18-27``; the JAX package times the
        parts alone, ``trainer.py:626-744``). Host clock around a
        ``torch.cuda.synchronize()`` on the card; each part runs once to
        warm up, then ``reps`` times.

        - Comm: the transfers of the exchange this mode's training runs, at
          their sizes (forward, and backward after layer 0): the fp or the
          quantized wire, ragged or padded. (The JAX probe times the fp
          exchange in every mode.) A collective: at K>1 every rank runs
          the probe in step.
        - Quant: the wire's quantize and dequantize kernels at
          ``assign_bits`` on ``[K * s_pad, d]`` rows, once per direction
          (quantized modes at K>1).
        - Central / Marginal: the run's aggregation on the local / halo
          layout, forward and (after layer 0) backward.

        Nothing here is caught: a failing probe fails the run (the JAX
        Trainer logs and goes on, ``trainer.py:800-803``)."""
        cfg, st, dev = self.cfg, self.static, self.device
        layers = cfg.num_layers
        dims = [st.f_pad] + [st.hidden] * (layers - 1)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

        def timeit(fn):
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            return (time.perf_counter() - t0) / reps

        agg = self._probe_aggregation()
        adt = agg_torch_dtype(st)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        bits, padded = cfg.assign_bits, cfg.wire_impl == "padded"
        for layer, d in enumerate(dims):
            back = layer > 0  # layer 0's input carries no gradient
            ft = self.layer_dims[layer] if layer == 0 else d
            local = torch.zeros((st.l_max, d), dtype=adt, device=dev)
            halo = torch.zeros((st.r_pad, d), dtype=adt, device=dev)
            central = timeit(lambda: agg["fl"](local))
            marginal = timeit(lambda: agg["fh"](halo))
            if back:
                central += timeit(lambda: agg["bl"](local))
                if self.k > 1:
                    marginal += timeit(lambda: agg["bh"](local))
            self.timer.add("central", central)
            self.timer.add("marginal", marginal)
            if self.k == 1:
                continue
            self.timer.add("communication", sum(
                timeit(fn) for fn in self._probe_transfers(layer, d, ft, back)))
            if self.assigner is None:
                continue
            flat = torch.randn((self.k * st.s_pad, d), generator=gen, device=dev).to(adt)
            if padded:  # the lane kernels on identity tables: a lane a row
                ident = torch.arange(flat.shape[0], device=dev)
                fr = make_frames((bits,), [ident], [ident], ft)
                out = torch.empty((flat.shape[0], d), dtype=torch.float32, device=dev)

                def quant():
                    return dequant_frames(quant_frames(flat, fr, (1,))[0], fr, out)
            else:
                fw = wire_cols(ft, bits)

                def quant():
                    return unpack_dequant(*quant_pack(flat, bits, ft, fw, 1), bits, ft, fw, d)
            self.timer.add("quantization", timeit(quant) * (2 if back else 1))

    def _probe_transfers(self, layer: int, d: int, f_true: int, back: bool):
        """The all-to-alls of one layer's exchange in this mode's training
        (forward, then backward when ``back``), each as a function that
        ships zeros of the wire's sizes."""
        st, dev, padded = self.static, self.device, self.cfg.wire_impl == "padded"
        widths = [f_true] + ([d] if back else [])  # true columns, forward then backward
        if not padded:
            wf, wb = (self.wire_q if self.mode.quantized else self.wire_fp)[layer]
            return [
                (lambda w=w: ragged_all_to_all(
                    torch.zeros(sum(w.send_splits), dtype=torch.int32, device=dev),
                    w.send_splits, w.recv_splits))
                for w in ([wf, wb] if back else [wf])
            ]
        if not self.mode.quantized:
            buf = torch.zeros((self.k, st.s_pad, d), dtype=torch.float32, device=dev)
            return [lambda: padded_all_to_all(buf) for _ in widths]
        bits, arrays = self.buckets[layer]
        fns = []
        for ft in widths:
            for b, quad in zip(bits, arrays):
                n = bytes_per_row(pad_features(ft), b) + 4  # codes, bf16 pair
                buf = torch.zeros((self.k, quad[0].shape[1], n), dtype=torch.uint8, device=dev)
                fns.append(lambda buf=buf: padded_all_to_all(buf))
        return fns

    def _memory_mark(self) -> Optional[Tuple[int, int]]:
        """(bytes allocated, the peak counter) on the card; None elsewhere."""
        if self.device.type != "cuda":
            return None
        torch.cuda.synchronize(self.device)
        return (torch.cuda.memory_allocated(self.device),
                torch.cuda.max_memory_allocated(self.device))

    def _log_step_memory(self, mark: Optional[Tuple[int, int]]) -> Optional[Dict[str, Any]]:
        """The ``log_hbm`` line of the first training step, ``mark`` taken
        just before it, in the JAX Trainer's form (``trainer.py:527-534``):

        - args: the bytes allocated before the step (parameters, graph and
          layouts; torch's Adam creates its moments within the first step,
          so their bytes fall in temps);
        - temps: the step's peak above args (a later step can peak higher
          by what the first one allocates after its peak and keeps: Adam's
          moments, a cuBLAS workspace of the backward's thread);
        - output: the gradients' bytes.

        It comes after the first step, not before: the JAX Trainer reads
        XLA's analysis of the compiled step, and eager PyTorch knows a
        step's memory only once it has run. The peak counter is read and
        never reset, so a caller's own reading of it stays whole; where an
        earlier peak of the process exceeds the step's, temps is given as
        at most that. Off the card, as where XLA has no analysis, the line
        says it is unavailable. Returns the bytes, or None."""
        if mark is None:
            logger.info("hbm analysis unavailable on this backend")
            return None
        args, peak_before = mark
        torch.cuda.synchronize(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        exact = peak > peak_before
        temps = (peak if exact else peak_before) - args
        output = sum(p.grad.numel() * p.grad.element_size()
                     for layer in self.params for p in layer.values() if p.grad is not None)
        gib = 2.0 ** 30
        logger.info(
            "train-step HBM: temps %s%.2f GiB | args %.2f GiB | output %.2f GiB "
            "(after the first step; bytes: temps %d, args %d, output %d)",
            "" if exact else "at most ", temps / gib, args / gib, output / gib,
            temps, args, output,
        )
        return {"args": args, "temps": temps, "output": output, "temps_exact": exact}

    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.measure_breakdown:
            self._breakdown_probe()
        t_train0 = time.perf_counter()
        losses = []
        planned = np.zeros(2, np.int64)
        hbm = None
        for epoch in range(self.start_epoch + 1, cfg.num_epochs + 1):
            if (
                self.assigner is not None
                and self.scheme in (Scheme.ADAPTIVE, Scheme.RANDOM)
                and epoch % cfg.assign_cycle == 1
                and epoch != 1
            ):
                self._reassign(epoch)
            planned += self.planned_quant_launches()
            first = cfg.log_hbm and epoch == self.start_epoch + 1
            mark = self._memory_mark() if first else None
            t0 = time.perf_counter()
            # the host readback waits for the device, so the bracket holds
            # the whole step
            loss = float(self._train_step(epoch))
            self.timer.add_epoch(time.perf_counter() - t0)
            if first:
                hbm = self._log_step_memory(mark)
            losses.append(loss)
            tr, va, te = self._eval_step()
            self.recorder.add(tr, va, te)
            if epoch % cfg.log_steps == 0:
                logger.info(
                    "epoch %04d | loss %.4f | %.3fs | train %.4f val %.4f test %.4f",
                    epoch, loss, self.timer.epoch_times[-1], tr, va, te,
                )
            if cfg.ckpt_every and epoch % cfg.ckpt_every == 0:
                self._save_checkpoint(epoch)
        total = time.perf_counter() - t_train0
        ep = np.asarray(self.timer.epoch_times)
        # median: robust to the first epoch's one-time costs (kernel build
        # and load, allocator warm-up) and the reassignment epochs
        steady = float(np.median(ep)) if len(ep) else 0.0
        best = self.recorder.best()
        records = {
            "overhead": self.overhead_s + self.timer.totals().get("assignment_overhead", 0.0),
            "total": total,
            "per_epoch": steady,
            "buckets": self.timer.epoch_traced_time(),
            "best": best,
            "val_curve": self.recorder.val_curve(),
            "loss_curve": np.asarray(losses),
            "planned_quant_launches": tuple(int(x) for x in planned),
            "planned_tile_launches": (cfg.num_epochs - self.start_epoch)
            * self.tile_launches_per_epoch(),
            "probe_launches": self.probe_launches() if cfg.measure_breakdown else {},
            "hbm": hbm,
        }
        logger.info(
            "done: best epoch %d train %.4f val %.4f test %.4f | %.3fs/epoch",
            *best, steady,
        )
        return records

    # ------------------------------------------------------------------
    def save(self, records: Dict[str, Any]):
        """Write reference-compatible artifacts (``trainer.py:203-238``):
        metrics txt, val-curve array, and the time CSV with one row per
        rank. Collective at K>1 (every rank's row goes to rank 0, which
        writes)."""
        cfg = self.cfg
        row = torch.tensor(
            [records["overhead"], records["total"], records["per_epoch"],
             *records["buckets"]], dtype=torch.float64,
        )
        rows = self._all_gather(row) if self.world > 1 else row[None]
        if self.rank != 0:
            return
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
        table = np.concatenate([np.arange(self.k)[:, None], rows.numpy()], axis=1)
        header = "Worker,Overhead,Total,Per_epoch,Comm,Quant,Central,Marginal,Full"
        np.savetxt(
            os.path.join(base, "time", f"{name}.csv"), table,
            delimiter=",", header=header, comments="", fmt="%.6f",
        )
        logger.info("artifacts written under %s", base)


def train_worker(rank, world, device, cfg: RunConfig, graph_fn=None):
    """One rank's run (the launcher's worker): build the Trainer, train,
    write the artifacts. Returns the loss curve and the median epoch
    seconds."""
    trainer = Trainer(cfg, graph=None if graph_fn is None else graph_fn(), device=device)
    records = trainer.train()
    trainer.save(records)
    return {"loss_curve": records["loss_curve"], "per_epoch": records["per_epoch"]}
