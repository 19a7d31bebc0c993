"""Accuracy parity: each quantized mode and scheme against Vanilla fp32.

The port's counterpart of ``scripts/accuracy_parity.py``, with its
experiment: the same graph (``SYNTH``, or ``SCALE`` under ``--scale``), the
same per-run overrides and the same eight configurations in order, each
reported as its test accuracy at its best validation epoch and the
difference to Vanilla's.

    python -m adaqp_tpu_torch.scripts.accuracy_parity                   # on the card
    python -m adaqp_tpu_torch.scripts.accuracy_parity --device cpu --epochs 20
    python -m adaqp_tpu_torch.scripts.accuracy_parity --scale           # 131K-node R-MAT, K=8

Unlike the script, one launch of K ranks (``comm/distributed.py::spawn``)
trains all eight configurations in turn, so the partition and layout
caches written by the first serve the rest; its files go under
``--workdir``. After the table it prints one JSON line of the rows, each
with its launches of the strip and ragged-wire kernels (summed over the
ranks, the breakdown probe and training; 0 on the CPU, where the plain
versions run) beside what the Trainers planned. ``ADAQP_DUMP_TRACES=path``
writes the adaptive run's per-lane variance traces there, in the
script's shapes: ``tf`` [L, K, K, S], ``tb`` [L, K, R], ``counts`` and
``num_remote``. On a machine without ``pymetis``, ``--scale``'s METIS
partition falls back to LDG, with a warning.
"""
from __future__ import annotations

import argparse
import json
import os
import time

SYNTH = {"n": 2000, "blocks": 8, "num_feats": 32, "p_in": 0.02, "p_out": 0.002, "seed": 7}
EPOCHS = 60

# --scale: a products-shaped workload, R-MAT 131K nodes / ~4M directed
# edges with structured (learnable) labels, 8 partitions, feature and
# hidden widths 128; homophily=0.3 rewires 30% of raw edges to same-label
# targets so that fp32 reaches a Reddit-like operating point
SCALE = {
    "dataset": "rmat",
    "synth_kwargs": {"n": 1 << 17, "avg_degree": 16, "num_feats": 128,
                     "num_classes": 32, "seed": 7, "structured": True,
                     "hint": 2.5, "homophily": 0.3},
    "num_parts": 8, "hidden_dim": 128, "num_epochs": 30, "assign_cycle": 10,
    "learning_rate": 0.03, "dropout_rate": 0.2,
    # the accuracy question is partition-independent; METIS cuts this
    # power-law graph's halo where LDG leaves it large
    "partition_method": "metis", "profile_data_length": 2,
}

# every run's overrides (besides mode, scheme, bits, epochs and paths)
RUN = {"num_parts": 4, "hidden_dim": 64, "assign_cycle": 20, "log_steps": 1000, "seed": 42}

# (name, mode, assign_scheme, assign_bits), in the script's order
CONFIGS = (
    ("Vanilla fp32", "Vanilla", "uniform", 8),
    ("AdaQP-q uniform 8-bit", "AdaQP-q", "uniform", 8),
    ("AdaQP-q uniform 4-bit", "AdaQP-q", "uniform", 4),
    ("AdaQP-q uniform 2-bit", "AdaQP-q", "uniform", 2),
    ("AdaQP adaptive", "AdaQP", "adaptive", 8),
    ("AdaQP adaptive+fp32lanes", "AdaQP", "adaptive", 8),
    ("AdaQP random", "AdaQP", "random", 8),
    ("AdaQP-p (overlap only)", "AdaQP-p", "uniform", 8),
)
DUMPED = "AdaQP adaptive"  # the run whose traces ADAQP_DUMP_TRACES receives


def run_overrides(mode: str, scheme: str, bits: int, workdir: str, scale: bool = False,
                  epochs=None, nodes=None):
    """``(dataset, overrides)`` of one configuration's run."""
    over = {**RUN, "num_epochs": EPOCHS, "mode": mode, "assign_scheme": scheme,
            "assign_bits": bits, "synth_kwargs": dict(SYNTH),
            "partition_dir": os.path.join(workdir, "parts"),
            "exp_path": os.path.join(workdir, "exp"),
            # eight runs of K ranks: the per-run INFO lines would bury the table
            "logger_level": "WARNING"}
    dataset = "sbm"
    if scale:
        over.update({k: v for k, v in SCALE.items() if k != "dataset"})
        over["synth_kwargs"] = dict(SCALE["synth_kwargs"])
        dataset = SCALE["dataset"]
    if epochs:
        over["num_epochs"] = epochs
    if nodes:
        over["synth_kwargs"]["n"] = nodes
    return dataset, over


def _counters():
    from ..ops import quant_cuda as qc
    from ..ops import spmm_strip as ss

    return {"strip_spmm": ss.strip_spmm, "quant_pack": qc.quant_pack,
            "unpack_dequant": qc.unpack_dequant}


def _dump_traces(t, path: str) -> None:
    """The run's traces since its last reassignment, every rank's, in the
    script's shapes (a collective: rank 0 writes)."""
    import numpy as np

    tf = t._all_gather(t.trace_fwd).transpose(0, 1).cpu().numpy()  # [L, K, K, S]
    tb = t._all_gather(t.trace_bwd).transpose(0, 1).cpu().numpy()  # [L, K, R]
    if t.rank == 0:
        plan = t.layout.plan_fwd
        np.savez_compressed(path, tf=tf, tb=tb, counts=np.asarray(plan.counts),
                            num_remote=np.asarray(plan.num_remote))
        print(f"[traces -> {path}] tf{tf.shape} tb{tb.shape}", flush=True)


def _worker(rank, world, device, dataset, runs, dump):
    """One rank: every configuration in turn on one graph; returns, for
    each, its best epoch's accuracies, seconds and launches."""
    from ..helper.dataset import load_dataset
    from ..trainer import RunConfig, Trainer

    graph = None
    counters = _counters()
    out = []
    for name, over in runs:
        cfg = RunConfig.from_yaml(dataset, over)
        if graph is None:
            graph = load_dataset(cfg.dataset, cfg.raw_dir, **cfg.synth_kwargs)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        t = Trainer(cfg, graph=graph, device=device)
        rec = t.train()
        launches = {k: c.launches for k, c in counters.items()}
        if dump and name == DUMPED:
            _dump_traces(t, dump)
        probe = rec["probe_launches"]
        q, u = rec["planned_quant_launches"]
        planned = {"strip_spmm": rec["planned_tile_launches"], "quant_pack": q,
                   "unpack_dequant": u}
        _, tr, va, te = rec["best"]
        out.append({
            "config": name, "train": tr, "val": va, "test": te,
            "seconds": time.perf_counter() - t0, "launches": launches,
            "planned": {k: v + probe.get(k, 0) for k, v in planned.items()},
        })
    return out


def main(argv=None):
    """Train the eight configurations, print the table and the JSON line;
    returns the rows."""
    from ..comm.distributed import spawn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", action="store_true",
                    help="products-shaped workload: 131K-node structured R-MAT, 8 parts, "
                         "F/hidden 128")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="where every rank runs (default: the CUDA card)")
    ap.add_argument("--epochs", type=int, default=None,
                    help=f"epochs of every run (default {EPOCHS}; {SCALE['num_epochs']} "
                         "under --scale)")
    ap.add_argument("--nodes", type=int, default=None, help="nodes of the graph (a smaller run)")
    ap.add_argument("--workdir", type=str, default=os.path.join("build", "accuracy_parity"),
                    help="partitions, layouts, artifacts and the launch's files")
    args = ap.parse_args(argv)
    runs = []
    for name, mode, scheme, bits in CONFIGS:
        dataset, over = run_overrides(mode, scheme, bits, args.workdir, args.scale,
                                      args.epochs, args.nodes)
        if name.endswith("fp32lanes"):
            over["fp32_lanes"] = True
        runs.append((name, over))
    world = runs[0][1]["num_parts"]
    t0 = time.perf_counter()
    res = spawn(_worker, world, args.device,
                args=(dataset, runs, os.environ.get("ADAQP_DUMP_TRACES")),
                workdir=os.path.join(args.workdir, "launch"))
    rows = res[0]
    base = rows[0]["test"]
    for i, r in enumerate(rows):
        r["delta"] = r["test"] - base
        for key in ("launches", "planned"):
            r[key] = {k: sum(x[i][key][k] for x in res) for k in r[key]}
    print(f"[{len(rows)} configurations, K={world}, {runs[0][1]['num_epochs']} epochs each, "
          f"on {args.device}: {time.perf_counter() - t0:.1f} s]")
    print(f"\n{'config':28s} {'test acc':>9s} {'delta':>8s}")
    for r in rows:
        print(f"{r['config']:28s} {r['test']:9.4f} {r['delta']:+8.4f}")
    print(json.dumps({"accuracy_parity": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
