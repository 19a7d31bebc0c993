#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``adaqp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # banded Reddit-degree graph, 65,536 nodes
    python3 chip_smoke.py --full     # Reddit's 232,965 nodes / 114,615,892 edges

It builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version on the card, trains a Reddit-width GCN
(602 -> 256 -> 256 -> 41, 3 layers, bf16 aggregation, LayerNorm, dropout
0.5, Adam lr 0.01) at K=1 through the port's ``Trainer``, checks that the
training ran through the kernel, and times the kernel beside its bound, its
plain version and ``torch.sparse.mm``. Phases: env, build, setup, kernel,
e2e (a small run on the card against the same run on the CPU), train,
time (and, with ``--profile``, a device-time breakdown of a few training
steps). Any failing phase exits nonzero and prints no result. The last line
of standard output is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel numbers, and the one before that the card's name and
power limit. Everything it writes goes under ``build/`` in this checkout.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "smoke")

# published peaks of one H100 SXM (NVIDIA data sheet, at a 700 W limit); the
# kernel's inputs are 0/1 masks and bf16 rows summed in f32, whose peak is
# the tensor cores' dense bf16 rate with f32 accumulation
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
SEED = 0
# |kernel - plain| <= ATOL + RTOL * |plain| for bf16: both sum in f32 and
# round once to bf16, in another order: one bf16 step (2^-7 of the value)
# plus f32 reordering error next to zero
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -7


class Failed(Exception):
    pass


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def phase_env(torch):
    check(torch.cuda.is_available(), "no CUDA device visible to PyTorch")
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"[env] card: {card}")
    return card


def phase_build():
    from adaqp_tpu_torch.utils.cuda_build import build

    t0 = time.perf_counter()
    logs = build(["spmm_strip"])
    say(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                say(f"[build] {name}: {line.strip()}")


def cuda_ms(torch, fn, reps, warmup=2):
    """Mean milliseconds per call from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare(torch, got, want, atol, rtol):
    """(max |got - want|, worst ratio of the error to its tolerance)."""
    err = (got.float() - want.float()).abs()
    tol = atol + rtol * want.float().abs()
    return float(err.max()) if err.numel() else 0.0, float((err / tol).max()) if err.numel() else 0.0


def phase_setup(torch, args):
    from adaqp_tpu_torch.helper.dataset import REDDIT_C, REDDIT_E, REDDIT_F, REDDIT_N, synth_reddit
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    n = REDDIT_N if args.full else args.nodes
    e = REDDIT_E if args.full else n * round(REDDIT_E / REDDIT_N)
    t0 = time.perf_counter()
    # drawn on the card: the generator's 50M-key sorts take minutes on a host
    g = synth_reddit(n, e, REDDIT_F, REDDIT_C, seed=SEED, device="cuda")
    t1 = time.perf_counter()
    cfg = RunConfig.from_yaml("reddit", {
        "num_parts": 1, "mode": "Vanilla", "num_epochs": args.epochs,
        "spmm_impl": "auto", "agg_dtype": "bfloat16", "log_steps": 1,
        "partition_dir": os.path.join(WORK, "parts"),
        "exp_path": os.path.join(WORK, "exp"), "seed": SEED,
    })
    check((cfg.num_layers, cfg.hidden_dim, cfg.dropout_rate, cfg.use_norm,
           cfg.learning_rate) == (3, 256, 0.5, True, 0.01),
          "reddit.yaml no longer holds the Reddit GCN settings")
    t = Trainer(cfg, graph=g)
    t2 = time.perf_counter()
    say(f"[setup] graph n={g.num_nodes} e={g.num_edges} f={g.num_feats} "
        f"classes={g.num_classes}: {t1 - t0:.1f} s; layouts + upload {t2 - t1:.1f} s")
    for name, (tiles, ell) in zip(("fwd_local", "bwd_local", "fwd_halo", "bwd_halo"),
                                  t.blocks.counts):
        say(f"[setup] {name}: dense tiles {tiles}, ELL edges {ell}")
    check(t.blocks.counts[0][0] > 0, "no dense tile in the forward layout")
    say(f"[setup] l_max={t.layout.l_max} r_pad={t.layout.plan_fwd.r_pad} "
        f"f_pad={t.static.f_pad} hidden={t.static.hidden} classes={t.static.num_classes}")
    return t


def phase_kernel(torch, trainer, seed):
    """Every layout and width the main path gives the kernel, plus a
    rectangular halo-shaped layout, an empty one and a backward."""
    import numpy as np

    from adaqp_tpu_torch.ops import spmm_strip as ss

    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    fl, bl, fh, bh = trainer.blocks.devices()
    worst = 0.0
    err_main = None

    def run(tag, lay, f, main=False):
        nonlocal worst, err_main
        h = torch.randn(lay.n_src_pad, f, generator=gen, device=dev).to(torch.bfloat16)
        got = ss.strip_spmm(lay, h)
        torch.cuda.synchronize()
        want = ss._run_strip_torch(lay, h)
        err, ratio = compare(torch, got, want, BF16_ATOL, BF16_RTOL)
        worst = max(worst, ratio)
        if main:
            err_main = err
        say(f"[kernel] {tag} F={f}: max |kernel - plain| {err:.3g}, "
            f"{ratio:.3f} of the tolerance ({BF16_ATOL} + 2^-7 |plain|)")
        check(ratio <= 1.0, f"{tag} F={f}: kernel disagrees with the plain version")
        return got

    for f in (640, 256):
        run("fwd_local", fl, f, main=(f == 640))
        run("bwd_local (reverse)", bl, f)
        for tag, lay in (("fwd_halo (empty at K=1)", fh), ("bwd_halo (empty at K=1)", bh)):
            check(int(lay.blk_ptr[-1]) == 0, f"{tag}: expected no tiles")
            out = run(tag, lay, f)
            check(not out.any(), f"{tag}: the empty layout did not give zeros")

    rng = np.random.default_rng(seed)
    n, n_src, e = 8192, 6144, 600_000
    src = rng.integers(0, n_src, e).astype(np.int32)
    dst = ((src + rng.integers(-400, 400, e)) % n).astype(np.int32)
    rect = ss.strip_layout(src, dst, n, min_edges=64, n_src=n_src).to_device(dev)
    check(int(rect.blk_ptr[-1]) > 0, "rectangular layout has no dense tile")
    run(f"rectangular {rect.n_pad}x{rect.n_src_pad}", rect, 640)

    # backward: SpmmStrip (kernel on the reverse layout) against autograd
    # through the plain version; dense tiles only, summed in f32 by both
    fwd = ss.strip_layout(src % n, dst, n, min_edges=1).to_device(dev)
    rev = ss.strip_layout(dst, src % n, n, min_edges=1).to_device(dev)
    check(fwd.straggler is None and rev.straggler is None, "backward layouts have ELL edges")
    h0 = torch.randn(fwd.n_src_pad, 256, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(fwd.n_pad, 256, generator=gen, device=dev)
    hk = h0.clone().requires_grad_()
    (ss.spmm_strip(fwd, hk, rev).float() * g).sum().backward()
    hp = h0.clone().requires_grad_()
    (ss._run_strip_torch(fwd, hp.float()).to(torch.bfloat16).float() * g).sum().backward()
    torch.cuda.synchronize()
    err, ratio = compare(torch, hk.grad, hp.grad, BF16_ATOL, BF16_RTOL)
    worst = max(worst, ratio)
    say(f"[kernel] backward F=256: max |SpmmStrip grad - plain autograd grad| "
        f"{err:.3g}, {ratio:.3f} of the tolerance")
    check(hk.grad.dtype == torch.bfloat16, "backward did not return the primal dtype")
    check(ratio <= 1.0, "SpmmStrip backward disagrees with the plain version's autograd")
    return err_main


def phase_e2e(torch, seed):
    """A small f32 run through the Trainer on the card against the same run
    on the CPU (plain version): the losses must agree."""
    import numpy as np

    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    curves = []
    for device in ("cuda", "cpu"):
        cfg = RunConfig.from_yaml("sbm", {
            "num_parts": 1, "mode": "Vanilla", "num_epochs": 6, "hidden_dim": 32,
            "dropout_rate": 0.0, "log_steps": 100, "block_min_edges": 2000,
            "synth_kwargs": {"n": 600, "blocks": 4, "num_feats": 16, "seed": seed},
            "partition_dir": os.path.join(WORK, f"e2e_parts_{device}"),
            "exp_path": os.path.join(WORK, "e2e_exp"),
        })
        curves.append(Trainer(cfg, device=device).train()["loss_curve"])
    rel = float(np.max(np.abs(curves[0] - curves[1]) / np.abs(curves[1])))
    say(f"[e2e] f32 SBM-600 losses, card {np.round(curves[0], 5).tolist()}")
    say(f"[e2e] max relative difference to the CPU run {rel:.2e} (limit 1e-3)")
    check(np.isfinite(curves[0]).all() and rel <= 1e-3, "card and CPU runs disagree")


def phase_train(torch, trainer):
    import numpy as np

    from adaqp_tpu_torch.ops import spmm_strip as ss

    cfg = trainer.cfg
    # per epoch: forward 2 launches a layer (local + halo); backward one per
    # layer after the first (layer 0's input and every halo input carry no
    # gradient); the eval pass 2 a layer again
    per_epoch = 2 * cfg.num_layers + (cfg.num_layers - 1) + 2 * cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss.strip_spmm.launches = 0
    rec = trainer.train()
    launches = ss.strip_spmm.launches
    torch.cuda.synchronize()
    losses = rec["loss_curve"]
    for i, (loss, sec) in enumerate(zip(losses, trainer.timer.epoch_times), 1):
        say(f"[train] epoch {i}: loss {loss:.5f} ({sec * 1e3:.1f} ms)")
    say(f"[train] median epoch {rec['per_epoch'] * 1e3:.1f} ms; best {rec['best']}")
    say(f"[train] peak torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"[train] strip kernel launches {launches}, expected {per_epoch} x "
        f"{cfg.num_epochs} epochs = {per_epoch * cfg.num_epochs}")
    check(np.isfinite(losses).all(), "non-finite loss")
    check(losses[-1] < losses[0], "loss did not fall")
    check(launches == per_epoch * cfg.num_epochs, "the kernel launch count is off")
    return launches


def phase_profile(torch, trainer, steps=3):
    """``--profile``: device time by kernel over a few training steps
    (``torch.profiler``), and the device's busy share of that window."""
    from torch.profiler import ProfilerActivity, profile

    from adaqp_tpu_torch.ops import spmm_strip as ss

    saved = ss.strip_spmm.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            trainer._train_step(1000 + i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ss.strip_spmm.launches = saved  # not the main path's launches
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = {}
    for e in kernels:
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(busy.values())
    check(total > 0, "the profiler saw no device time")
    say(f"[profile] {steps} training steps: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{total / 1e3:.1f} ms ({100 * total / wall_us:.1f}%), {len(kernels)} device events")
    for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:10]:
        say(f"[profile] {us / 1e3:9.3f} ms {100 * us / total:5.1f}%  {name[:100]}")


def tile_csr(torch, lay, dtype):
    """The layout's dense-tile edges as a CSR matrix (library yardstick)."""
    dev = lay.masks.device
    blk = lay.blk_ptr.long()
    t = int(blk[-1])
    tile_dst = torch.repeat_interleave(torch.arange(blk.numel() - 1, device=dev), blk.diff())
    shifts = torch.arange(16, dtype=torch.int32, device=dev)
    rows, cols = [], []
    for s in range(0, t, 64):
        e = min(s + 64, t)
        words = lay.masks[s:e].int() & 0xFFFF
        bits = ((words[..., None] >> shifts) & 1).transpose(2, 3).reshape(e - s, 256, 2048)
        ti, r, j = bits.nonzero(as_tuple=True)
        rows.append(tile_dst[s + ti] * 256 + r)
        cols.append(lay.tile_src[s + ti].long() + j)
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    vals = torch.ones(idx.shape[1], dtype=dtype, device=dev)
    coo = torch.sparse_coo_tensor(idx, vals, (lay.n_pad, lay.n_src_pad)).coalesce()
    return coo.to_sparse_csr(), idx.shape[1]


def phase_time(torch, trainer, card):
    from adaqp_tpu_torch.ops import spmm_strip as ss

    dev = trainer.device
    fl = trainer.blocks.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    t = int(fl.blk_ptr[-1])
    rows = {}
    for f in (640, 256):
        h = torch.randn(fl.n_src_pad, f, generator=gen, device=dev).to(torch.bfloat16)
        saved = ss.strip_spmm.launches
        ms = cuda_ms(torch, lambda: ss.strip_spmm(fl, h), reps=10)
        ss.strip_spmm.launches = saved  # timing launches are not the main path's
        plain_ms = cuda_ms(torch, lambda: ss._run_strip_torch(fl, h), reps=2, warmup=1)
        # the library yardstick on the same edges; the port never calls it
        csr, nnz = tile_csr(torch, fl, torch.bfloat16)
        lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, h), reps=10)
        del csr
        nbytes = (t * 256 * 128 * 2 + t * 4 + fl.blk_ptr.numel() * 4
                  + fl.n_src_pad * f * 2 + fl.n_pad * f * 2)
        flops = 2.0 * nnz * f
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOP_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        say(f"[time] {card} | fwd_local F={f}: tiles {t}, tile edges {nnz}")
        say(f"[time] {card} | kernel {ms:.3f} ms; bound {bound_ms:.3f} ms by {bound_by} "
            f"({nbytes / 1e9:.3f} GB, {flops / 1e12:.4f} TFLOP bf16); plain {plain_ms:.2f} ms; "
            f"torch.sparse.mm {lib_ms:.3f} ms (bf16 CSR)")
        rows[f] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="the full Reddit-size graph (232,965 nodes, 114.6M edges)")
    p.add_argument("--nodes", type=int, default=65_536,
                   help="nodes of the default graph (edges keep Reddit's mean degree)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--profile", action="store_true",
                   help="also trace a few training steps with torch.profiler")
    args = p.parse_args()
    try:
        import torch
    except ImportError as exc:
        raise Failed(f"PyTorch missing: {exc}")
    card = phase_env(torch)
    sys.path.insert(0, HERE)
    try:
        import adaqp_tpu_torch  # noqa: F401
    except ImportError as exc:
        raise Failed(f"the port's package is not beside this script: {exc}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    phase_build()
    trainer = phase_setup(torch, args)
    err = phase_kernel(torch, trainer, SEED)
    phase_e2e(torch, SEED)
    launches = phase_train(torch, trainer)
    if args.profile:
        phase_profile(torch, trainer)
    times = phase_time(torch, trainer, card)
    main_row = times[640]
    say(card)
    say(json.dumps({"kernels": [{
        "name": "strip_spmm", "route": "cuda",
        "source": "adaqp_tpu_torch/csrc/spmm_strip.cu",
        "replaces": "adaqp_tpu/ops/spmm_strip.py:277",
        "launches": launches, "max_abs_err": err, **main_row,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except Failed as exc:
        print(f"FAIL: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
