"""One run of one cell: set-up, the measured window, the traced stretch and
the comparison with the reference.

The cell names a configuration (``configs/<name>.json``: the model, the
training settings, the graph generator and its data seed) and a traffic
mix (``traffic/<name>.json``: ranks, warm-up, the traced epochs, and
settings of the run that it overrides). The limits of the comparison are
``limits/<cell>.json``; the per-layer metrics are ``metrics/<name>.py``,
each with a ``read(record)`` that returns a number or None.

Set-up builds the program's ``Trainer`` once, loads the parameters the
benchmark drew from ``--seed``, and drives it through its first epochs by
the window's own call, ``Trainer._train_step``; those are the checked
steps. The window goes on with the same object from the epoch warm-up
reached, reassigning bit widths where ``Trainer.train`` would. After it,
with ``--trace 1``, a few more epochs run under ``torch.profiler``.
Then the program is freed and the reference repeats the checked steps.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from benchmark import check, counts, graphs, trace
from benchmark.reference.gnn import Reference, init_params

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
# a collective that waits longer fails the run: rank 0 builds the layouts
# of a checkout's first run while the others wait
COLLECTIVE_TIMEOUT_S = 600
ROW_BLOCK = 1 << 16  # rows a block when the program's rows are held against the graph


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def load_cell(name: str) -> dict:
    """The cell's entry in BENCHMARK.json with its configuration, traffic
    mix, limits and the per-layer metrics it reports."""
    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = dict(cells[name])
    cfg = next(c for c in man["configs"] if c["name"] == cell["config"])
    cell["configuration"] = _json(ROOT, cfg["file"])
    cell["mix"] = _json(HERE, "traffic", f"{cell['traffic']}.json")
    cell["limits"] = _json(HERE, "limits", f"{name}.json")
    cell["per_layer"] = [m for m in man["per_layer"] if name in m.get("workloads", [name])]
    cell["end_to_end"] = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    return cell


def read_metric(name: str, record: dict) -> Optional[float]:
    """``metrics/<name>.py``'s reading of a run's record."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def layer_dims(conf: dict) -> List[tuple]:
    f, h, c, layers = conf["num_feats"], conf["hidden_dim"], conf["num_classes"], conf["num_layers"]
    return [(f, h)] + [(h, h)] * (layers - 2) + [(h, c)]


def reference(conf: dict, g: graphs.Graph, device) -> Reference:
    """The plain reference of a configuration, on its graph."""
    m = conf["model"]
    return Reference(g, m["model_name"], layer_dims(conf), m["dropout_rate"], m["use_norm"],
                     m["learning_rate"], m["weight_decay"], device)


def run_config(cell: dict, seed: int):
    """The program's RunConfig for this cell and seed."""
    from adaqp_tpu_torch.trainer import RunConfig

    conf, mix = cell["configuration"], cell["mix"]
    fields = {**conf["model"], **conf["run"], **mix.get("run", {})}
    return RunConfig(
        dataset=conf["name"], num_layers=conf["num_layers"], hidden_dim=conf["hidden_dim"],
        num_feats=conf["num_feats"], num_classes=conf["num_classes"],
        num_parts=mix["ranks"], seed=seed, num_epochs=10 ** 9, log_steps=10 ** 9,
        logger_level="WARNING", measure_breakdown=False,
        partition_dir=os.path.join(CACHE, "parts"), exp_path=os.path.join(CACHE, "exp"),
        ckpt_dir=os.path.join(CACHE, "ckpt"), **fields)


def program_graph(g: graphs.Graph, name: str):
    """The generated graph as the program's GraphData; its name keys the
    program's partition and layout caches."""
    from adaqp_tpu_torch.helper.dataset import GraphData

    return GraphData(g.num_nodes, g.src, g.dst, g.feats, g.labels, g.train_mask, g.val_mask,
                     g.test_mask, g.num_classes, g.multilabel,
                     f"bench-{name}-n{g.num_nodes}-e{g.num_edges}-{g.digest[:16]}")


def _leaves(params) -> Dict[str, torch.Tensor]:
    return {f"{i}.{k}": p for i, layer in enumerate(params) for k, p in layer.items()}


def _load(trainer, params0: Dict[str, torch.Tensor]) -> None:
    """The benchmark's parameters into the program's, zero-padded where the
    program holds a leaf wider (layer 0's rows past the features)."""
    new = []
    for i, layer in enumerate(trainer.params):
        d = {}
        for k, p in layer.items():
            src = params0[f"{i}.{k}"].detach().cpu().numpy()
            out = np.zeros(tuple(p.shape), np.float32)
            out[tuple(slice(0, s) for s in src.shape)] = src
            d[k] = out
        new.append(d)
    trainer.load_params(new)


def _first_gradient(trainer) -> Dict[str, torch.Tensor]:
    """Each leaf's first gradient as Adam holds it after one step: its first
    moment over (1 - beta1); zero where Adam holds no state."""
    beta1 = trainer.opt.defaults["betas"][0]
    out = {}
    for k, p in _leaves(trainer.params).items():
        st = trainer.opt.state.get(p, {})
        m = st.get("exp_avg")
        out[k] = torch.zeros_like(p).cpu() if m is None else (m / (1.0 - beta1)).detach().cpu()
    return out


def _reassigns(trainer, epoch: int) -> bool:
    """Whether ``Trainer.train`` reassigns bit widths before ``epoch``."""
    return (trainer.assigner is not None
            and trainer.cfg.assign_scheme in ("adaptive", "random")
            and epoch % trainer.cfg.assign_cycle == 1 and epoch != 1)


def _epoch(trainer, epoch: int) -> float:
    if _reassigns(trainer, epoch):
        trainer._reassign(epoch)
    return float(trainer._train_step(epoch))


def _traced(trainer, epoch: int, epochs: int, sync):
    """``epochs`` more epochs under the profiler, with the benchmark's spans;
    the strip kernel's calls (layout, width, element bytes) recorded."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import adaqp_tpu_torch.model.gnn as gnn
    import adaqp_tpu_torch.ops.spmm_strip as strip

    calls = []

    def recording(fn):
        def call(layout, h):
            key = (layout.masks.data_ptr(), layout.tile_src.data_ptr(), layout.blk_ptr.data_ptr())
            calls.append((key, layout, h.shape[1], h.element_size()))
            return fn(layout, h)
        return call

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with trace.wrapped(gnn, "dist_aggregate", trace.spanned("bench.agg")), \
            trace.wrapped(strip, "strip_spmm", recording), \
            trace.wrapped(type(trainer), "_reassign", trace.spanned("bench.assign")):
        sync()
        with profile(activities=acts) as prof:
            with record_function("bench.stretch"):
                for _ in range(epochs):
                    epoch += 1
                    with record_function("bench.step"):
                        _epoch(trainer, epoch)
                sync()
    tr = trace.reduce_profile(prof)
    layouts = {}
    for key, lay, _, _ in calls:
        if key not in layouts:
            tiles = int(lay.blk_ptr[-1])
            edges, rows = counts.tile_work(lay.masks, lay.tile_src, tiles, lay.n_src_pad)
            layouts[key] = {"edges": edges, "src_rows": rows, "out_rows": lay.n_pad}
    tr["strip_calls"] = [(layouts[key], width, elt) for key, _, width, elt in calls]
    tr["epochs"] = epochs
    return tr, epoch


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _rows_hold(trainer, g: graphs.Graph, rank: int) -> bool:
    """Whether each of the rank's rows holds the node that ``local_ids``
    names there, by what the benchmark made: its features (in the dtype the
    program stores them), its labels and its training flag; and whether the
    rows past the rank's nodes train nothing. The reference places the
    dropout masks by that row order."""
    lay, sh = trainer.layout, trainer.sh
    n = int(lay.num_local[rank])
    ids = np.asarray(lay.local_ids[rank][:n])
    if n == 0 or ids.min() < 0 or ids.max() >= g.num_nodes:
        return False
    if bool(sh.train_mask[n:].any()):
        return False
    f, dev = g.feats.shape[1], sh.feats.device
    for lo in range(0, n, ROW_BLOCK):
        idx = ids[lo:lo + ROW_BLOCK]
        rows = slice(lo, lo + len(idx))
        feats = torch.as_tensor(g.feats[idx], device=dev).to(sh.feats.dtype)
        labels = torch.as_tensor(g.labels[idx], device=dev).to(sh.labels.dtype)
        train = torch.as_tensor(g.train_mask[idx], device=dev)
        if not (torch.equal(sh.feats[rows, :f], feats) and torch.equal(sh.labels[rows], labels)
                and torch.equal(sh.train_mask[rows].bool(), train.bool())):
            return False
    return True


def run_rank(cell: dict, seed: int, seconds: float, traced: bool, device: str,
             started: float, rank: int = 0, world: int = 1) -> dict:
    """One rank's run (K=1: the whole run). ``started``: the process's start
    on ``time.perf_counter``'s clock. At K>1 rank 0 decides when the window
    closes and runs the reference."""
    from adaqp_tpu_torch.trainer import Trainer

    conf, mix = cell["configuration"], cell["mix"]
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    start_s = t0 - started
    g = graphs.make(conf, dev)
    graph_s = time.perf_counter() - t0
    cfg = run_config(cell, seed)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, graph=program_graph(g, conf["name"]), device=dev)
    trainer_init_s = time.perf_counter() - t0
    model = conf["model"]["model_name"]
    params0 = init_params(seed, model, layer_dims(conf), conf["model"]["use_norm"], dev)
    _load(trainer, params0)

    # set-up: the first epochs, by the window's own call; the first
    # `checked` are compared with the reference
    checked, losses, grad1, after = mix["checked_steps"], [], None, None
    epoch = 0
    t0 = time.perf_counter()
    for _ in range(max(mix["warmup_epochs"], checked)):
        epoch += 1
        losses.append(_epoch(trainer, epoch))
        if epoch == 1:
            grad1 = _first_gradient(trainer)
        if epoch == checked:
            after = {k: p.detach().cpu().clone() for k, p in _leaves(trainer.params).items()}
    sync()
    warmup_s = time.perf_counter() - t0
    if world > 1:
        dist.barrier()
    setup_s = time.perf_counter() - started

    attempted = failed = 0
    t0 = time.perf_counter()
    while True:
        epoch += 1
        try:
            ok = math.isfinite(_epoch(trainer, epoch))
        except RuntimeError:
            ok = False
        attempted += 1
        failed += not ok
        done = time.perf_counter() - t0 >= seconds
        if world > 1:  # rank 0's clock closes the window on every rank
            flag = torch.tensor([int(done)], device=trainer._comm_dev)
            dist.broadcast(flag, 0)
            done = bool(flag.item())
        if done:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = {"rank": rank, "start_s": start_s, "graph_s": graph_s, "warmup_s": warmup_s,
           "trainer_init_s": trainer_init_s,
           "setup_s": setup_s, "attempted": attempted, "failed": failed, "window_s": window_s,
           "peak_bytes": peak, "nodes": g.num_nodes, "edges": g.num_edges}
    if traced:
        rec["trace"], epoch = _traced(trainer, epoch, mix["trace_epochs"], sync)

    prog = {"losses": losses[:checked], "grad1": grad1,
            "delta": {k: after[k] - _padded(params0[k], after[k]) for k in after}}
    lay = trainer.layout
    # the rows a rank's dropout draws are the rows it holds
    rows = int(trainer.sh.feats.shape[0])
    placement = [(rank, rows, lay.local_ids[rank][:lay.num_local[rank]])]
    held = _rows_hold(trainer, g, rank)
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, (placement[0], held))
        placement = [p for p, _ in every]
        held = all(h for _, h in every)
    rec["order_ok"] = held and _is_permutation(placement, g.num_nodes)
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if world > 1:
        dist.barrier()
        if rank != 0:
            return rec
    ref = reference(conf, g, dev)
    t0 = time.perf_counter()
    want = ref.train(params0, seed, checked, placement)
    rec["reference_s"] = time.perf_counter() - t0
    want = check.on_cpu(want)
    rec["numbers"] = check.numbers(prog, want)
    rec["grad_leaves"] = check.leaf_deviations(prog["grad1"], want["grad1"])
    rec["losses"] = {"program": prog["losses"], "reference": want["losses"]}
    return rec


def rank_worker(rank: int, world: int, device, cell: dict, seed: int, seconds: float,
                traced: bool, started: float) -> dict:
    """One rank of a K>1 run, as the program's launcher starts it."""
    return run_rank(cell, seed, seconds, traced, str(device), started, rank, world)


def _padded(p0: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``p0`` on the CPU, zero-padded to ``like``'s shape."""
    out = torch.zeros_like(like)
    out[tuple(slice(0, s) for s in p0.shape)] = p0.detach().cpu()
    return out


def _is_permutation(placement, n: int) -> bool:
    """The ranks' rows together hold every node once."""
    nodes = np.concatenate([np.asarray(p[2]) for p in placement])
    return len(nodes) == n and bool((np.sort(nodes) == np.arange(n)).all())


def run(cell: dict, seed: int, seconds: float, traced: bool, device: str,
        started: float, worker=None):
    """The run's result line (without ``device``'s card fields) and rank 0's
    record. At K>1 the ranks run in the program's launcher, ``worker``
    (default :func:`rank_worker`) in each."""
    world = cell["mix"]["ranks"]
    if world == 1:
        ranks = [run_rank(cell, seed, seconds, traced, device, started)]
    else:
        from adaqp_tpu_torch.comm.distributed import spawn

        ranks = spawn(worker or rank_worker, world, device,
                      args=(cell, seed, seconds, traced, started),
                      workdir=os.path.join(CACHE, "launch"), timeout_s=COLLECTIVE_TIMEOUT_S)
    rec = ranks[0]
    conf = cell["configuration"]
    chips = cell["chips"]
    epoch_s = rec["window_s"] / rec["attempted"]
    record = {"chips": chips, "epoch_s": epoch_s, "ranks": ranks,
              "trainer_init_s": max(r["trainer_init_s"] for r in ranks),
              "flops_per_epoch": counts.epoch_flops(
                  rec["nodes"], rec["edges"],
                  layer_dims(conf), 2 if conf["model"]["model_name"] == "sage" else 1)}
    peak = max(r["peak_bytes"] for r in ranks)
    e2e = {"epoch_ms": epoch_s * 1e3, "peak_mem_gib": peak / 2 ** 30,
           "setup_s": max(r["setup_s"] for r in ranks)}
    if traced:
        metrics = {}
        for m in cell["per_layer"]:
            v = read_metric(m["name"], record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    ok, rows = check.judge(rec["numbers"], cell["limits"])
    rows.append({"name": "row_order", "value": int(rec["order_ok"]), "limit": 1})
    ok = ok and rec["order_ok"]
    out = {"correct": bool(ok), "attempted": rec["attempted"],
           "failed": max(r["failed"] for r in ranks), "metrics": metrics,
           "device": {"count": chips, "memory_peak_bytes": peak}}
    if traced:
        tr = rec["trace"]
        out["device"]["busy_s"] = float(np.mean([trace.busy_us(r["trace"]) for r in ranks])) * 1e-6
        out["device"]["window_s"] = (tr["window"][1] - tr["window"][0]) * 1e-6
        out["breakdown"] = {"device_ops": trace.device_ops(tr), "idle_gaps": trace.idle_gaps(tr)}
    out["check"] = rows
    return out, rec
