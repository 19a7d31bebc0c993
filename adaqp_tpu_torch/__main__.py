"""Training entry point: ``python -m adaqp_tpu_torch`` (the JAX package's
``main.py``, with the flags the port runs).

    python -m adaqp_tpu_torch --dataset reddit --num_parts 4 --mode AdaQP \\
        --assign_scheme adaptive
    python -m adaqp_tpu_torch --dataset sbm --num_parts 2 --mode AdaQP --device cpu
    python -m adaqp_tpu_torch --dataset sbm --num_parts 1 --spmm_impl compact --device cpu

``--num_parts K`` > 1 starts K ranks on this machine (one per partition;
over nccl when there is a card for each rank, else over gloo). Under
``torchrun`` (``RANK``/``WORLD_SIZE`` set) this process is one rank and
starts nothing. Runs on the CUDA card unless ``--device cpu`` is given;
with no card and no ``--device cpu`` it stops with an error.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="adaqp_tpu_torch trainer")
    p.add_argument("--dataset", type=str, default="sbm")
    p.add_argument("--num_parts", type=int, default=None)
    p.add_argument("--partition_method", type=str, default=None,
                   choices=["ldg", "metis", "random"])
    p.add_argument("--model_name", type=str, default=None, choices=["gcn", "sage"])
    p.add_argument("--mode", type=str, default=None,
                   choices=["Vanilla", "AdaQP", "AdaQP-q", "AdaQP-p"])
    p.add_argument("--assign_scheme", type=str, default=None,
                   choices=["uniform", "random", "adaptive"])
    p.add_argument("--assign_bits", type=int, default=None, choices=[2, 4, 8])
    p.add_argument("--assign_cycle", type=int, default=None)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--hidden_dim", type=int, default=None)
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--logger_level", type=str, default=None)
    p.add_argument("--exp_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--spmm_impl", type=str, default=None,
                   choices=["auto", "segment", "block", "compact", "strip"])
    p.add_argument("--agg_dtype", type=str, default=None, choices=["float32", "bfloat16"])
    p.add_argument("--block_min_edges", type=int, default=None,
                   help="tile/ELL split threshold of the strip and block layouts")
    p.add_argument("--compact_me_ell", type=int, default=None,
                   help="compact impl: regions below this edge count ride "
                        "the ELL tail")
    p.add_argument("--compact_full_cols", type=int, default=None,
                   help="compact impl: regions above this occupied-column "
                        "count stay full-bitmask")
    p.add_argument("--fp32_lanes", action="store_true", default=None,
                   help="let the adaptive MILP assign raw fp32 lanes per "
                        "channel group")
    p.add_argument("--profile_mode", type=str, default=None,
                   choices=["auto", "offset", "pair"],
                   help="cost-model probe resolution (pair: each ordered pair "
                        "alone; offset: one collective per ring offset)")
    p.add_argument("--normal_mode", type=str, default=None,
                   choices=["nadir_utopia", "magnitude"],
                   help="bi-objective normalization of the bit assigner")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where every rank runs (default: the CUDA card)")
    return p.parse_args(argv)


def config_from_args(args):
    from .trainer import RunConfig

    overrides = {k: v for k, v in vars(args).items() if k not in ("dataset", "device")}
    return RunConfig.from_yaml(args.dataset, overrides)


def main(argv=None):
    args = parse_args(argv)
    cfg = config_from_args(args)
    from .comm.distributed import run_from_env, spawn
    from .trainer.trainer import train_worker

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        run_from_env(train_worker, args.device, args=(cfg,))
    elif cfg.num_parts == 1:
        train_worker(0, 1, args.device, cfg)
    else:
        spawn(train_worker, cfg.num_parts, args.device, args=(cfg,))


if __name__ == "__main__":
    main()
