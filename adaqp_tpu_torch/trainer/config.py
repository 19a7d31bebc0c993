"""Two-level configuration: per-dataset YAML overridden by CLI flags
(reference: ``AdaQP/trainer/trainer.py:33-39``, flags ``main.py:6-15``).

YAML sections mirror the reference (``AdaQP/config/*.yaml``):
``data`` / ``model`` / ``runtime`` / ``assignment``. The field set is the
JAX package's, so one config describes a run of either package. Of the
fields for paths this port does not run yet, the Trainer rejects the ones
that change the result (``wire_impl=padded``, checkpointing). Fields that
tune the JAX package's compiler or TPU memory have no effect here:
``static_wire`` (PyTorch runs eagerly, so exact wire shapes cost no
recompile), ``remat``, ``log_hbm``, and ``measure_breakdown`` (the
breakdown probe is not ported).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "config")


@dataclass
class RunConfig:
    # data
    dataset: str = "sbm"
    raw_dir: str = "data/dataset"
    partition_dir: str = "data/part_data"
    num_feats: int = 0  # 0 -> from data
    num_classes: int = 0
    is_multilabel: bool = False
    # model
    model_name: str = "gcn"  # gcn | sage
    num_layers: int = 3
    hidden_dim: int = 256
    dropout_rate: float = 0.5
    use_norm: bool = True
    aggregator_type: str = "mean"
    # runtime
    num_parts: int = 4
    partition_method: str = "ldg"
    learning_rate: float = 0.01
    weight_decay: float = 0.0
    num_epochs: int = 100
    mode: str = "AdaQP"
    assign_scheme: str = "adaptive"
    exp_path: str = "exp"
    logger_level: str = "INFO"
    log_steps: int = 10
    seed: int = 42
    # segment sum: edges per chunk (None: all edges at once)
    edge_chunk: Optional[int] = None
    # time comm/quant/central/marginal probes (the reference always records
    # these buckets, AdaQP/util/timer.py:29-51)
    measure_breakdown: bool = True
    # "auto" | "segment" | "block" | "strip" | "compact": the aggregation
    # implementation ("auto" is "strip" in the port)
    spmm_impl: str = "auto"
    # strip/block tile-vs-ELL split: tiles with fewer edges go to the ELL
    # straggler path
    block_min_edges: int = 192
    # compact tiering: regions under compact_me_ell edges go to the ELL
    # tail, regions with more than compact_full_cols occupied source columns
    # stay full bitmask tiles, the rest become compact subtiles
    compact_me_ell: int = 64
    compact_full_cols: int = 1024
    # boundary-exchange wire: "ragged" = exact per-pair sizes; "padded" =
    # dense all-to-all at worst-channel capacity
    wire_impl: str = "ragged"
    # pow2-bracket wire capacities (JAX jit caches); no effect in the port
    static_wire: Optional[bool] = None
    agg_dtype: str = "float32"  # aggregation compute dtype
    # rematerialize GNN layers in backward
    remat: bool = False
    # log the train step's device-memory footprint before the first step
    log_hbm: bool = False
    # checkpoint / resume (capability absent in the reference, SURVEY.md §5)
    ckpt_every: int = 0  # epochs between checkpoints; 0 = off
    ckpt_dir: str = "checkpoints"
    resume: bool = False
    # assignment
    assign_cycle: int = 50
    profile_data_length: int = 8  # #payload sizes for cost-model profiling
    # channel resolution of the alpha-beta probes: "pair" | "offset" | "auto"
    profile_mode: str = "auto"
    group_size: int = 100
    coe_lambda: float = 0.5
    assign_bits: int = 8
    # bi-objective normalization: "nadir_utopia" (reference effective
    # default, AdaQP/assigner/assigner.py:312) or "magnitude"
    normal_mode: str = "nadir_utopia"
    # let the adaptive MILP assign raw fp32 (no quantize/pack) per channel
    # group. Ragged wire only.
    fp32_lanes: bool = False
    # synthetic dataset knobs
    synth_kwargs: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_yaml(dataset: str, overrides: Optional[Dict[str, Any]] = None) -> "RunConfig":
        cfg = RunConfig(dataset=dataset)
        path = os.path.join(CONFIG_DIR, f"{dataset}.yaml")
        if os.path.exists(path):
            # PyYAML is optional: only a YAML-backed config needs it
            import yaml

            with open(path) as f:
                doc = yaml.safe_load(f) or {}
            flat: Dict[str, Any] = {}
            for section in ("data", "model", "runtime", "assignment"):
                flat.update(doc.get(section) or {})
            _KEYMAP = {
                "name": "dataset",
                "dataset_path": "raw_dir",
                "partition_path": "partition_dir",
                "num_epoches": "num_epochs",
            }
            for k, v in flat.items():
                k = _KEYMAP.get(k, k)
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
        for k, v in (overrides or {}).items():
            if v is None:
                continue
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config key {k!r}")
            setattr(cfg, k, v)
        return cfg
