"""Offline graph partitioning: ``python -m adaqp_tpu_torch.graph_partition``
(the repository's ``graph_partition.py``, with the same flags and output).

    python -m adaqp_tpu_torch.graph_partition --dataset sbm --partition_size 4
    python -m adaqp_tpu_torch.graph_partition --dataset reddit --partition_size 4 --method ldg

Partitions a dataset and writes the membership vector as
``{partition_dir}/{name}_{K}part_{method}.npy``, the cache the Trainer
reads before it would partition itself; then prints the part sizes and the
edge cut. Runs on the host only.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="adaqp_tpu_torch graph partitioner")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--raw_dir", type=str, default="data/dataset")
    p.add_argument("--partition_dir", type=str, default="data/part_data")
    p.add_argument("--partition_size", type=int, required=True)
    p.add_argument("--method", type=str, default="ldg", choices=["ldg", "metis", "random"])
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Partition, write the file and print the summary; returns the file's path."""
    from .graph import partition_graph
    from .helper.dataset import load_dataset
    from .trainer.trainer import setup_logger

    args = parse_args(argv)
    setup_logger(logfile=None)  # the partitioner logs which LDG path ran
    g = load_dataset(args.dataset, args.raw_dir)
    part = partition_graph(g, args.partition_size, args.method)
    os.makedirs(args.partition_dir, exist_ok=True)
    out = f"{args.partition_dir}/{g.name}_{args.partition_size}part_{args.method}.npy"
    np.save(out, part)
    sizes = np.bincount(part, minlength=args.partition_size)
    cut = int((part[g.src] != part[g.dst]).sum())
    print(f"saved {out}; part sizes {sizes.tolist()}; edge cut {cut}/{g.num_edges}")
    return out


if __name__ == "__main__":
    main()
