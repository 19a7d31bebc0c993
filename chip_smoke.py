#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``adaqp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # banded Reddit-degree graphs (K=1: 65,536 nodes)
    python3 chip_smoke.py --full     # K=1 at Reddit's 232,965 nodes / 114,615,892 edges

It builds the port's CUDA kernels from this checkout (one ``nvcc`` per
source, all at once), holds each against its plain PyTorch version on the
card, and trains a Reddit-width GCN (602 -> 256 -> 256 -> 41, 3 layers,
bf16 aggregation, LayerNorm, dropout 0.5, Adam lr 0.01) twice through the
port's entry points: at K=1 through ``Trainer``, and at K=4 in mode AdaQP
with the adaptive scheme through the launcher of ``python -m
adaqp_tpu_torch`` (four ranks sharing the one card over gloo). It checks
that each training ran through the kernels (their launch counts), and
times every kernel beside its bound, its plain version and a library call
where one exists. Phases: env, build, setup, kernel (strip SpMM), quant
(quant_pack and unpack_dequant), e2e (a small K=1 run on the card against
the same run on the CPU), e2e_k (the same at K=2, Vanilla and AdaQP),
train (K=1), train_k (K=4), time (and, with ``--profile``, a device-time
breakdown of a few K=1 training steps). Each phase prints its seconds. Any
failing phase exits nonzero and prints no result. The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
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
    logs = build(["spmm_strip", "quant_pack"])
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


def phase_quant(torch, seed):
    """quant_pack and unpack_dequant against their plain versions on the
    card at the main path's shapes: words, scale, rmin and dequantized rows
    bit for bit; every round-trip error within one step; no bias."""
    from adaqp_tpu_torch.comm.wire import wire_cols
    from adaqp_tpu_torch.ops import quant_cuda as qc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst_err = 0.0  # unpack_dequant: max |kernel rows - plain rows|
    worst_pack = 0.0  # quant_pack: max |difference| of words, scale and rmin
    cases = 0
    for bits in (2, 4, 8):
        for f, ft in ((640, 602), (256, 256)):
            fw = wire_cols(ft, bits)
            for dtype in (torch.float32, torch.bfloat16):
                for n in (0, 1, 33, 25_700):
                    x = torch.randn(n, f, generator=gen, device="cuda")
                    x = (x * torch.rand(n, 1, generator=gen, device="cuda") * 4).to(dtype)
                    x[:, ft:] = 0
                    if n > 1:
                        x[1, :] = 0.5  # a constant row: all codes 0
                    key = qc.stream_key(seed, bits, f, n)
                    saved = (qc.quant_pack.launches, qc.unpack_dequant.launches)
                    w, sc, rm = qc.quant_pack(x, bits, ft, fw, key)
                    y = qc.unpack_dequant(w, sc, rm, bits, ft, fw, f)
                    torch.cuda.synchronize()
                    launched = (qc.quant_pack.launches - saved[0],
                                qc.unpack_dequant.launches - saved[1])
                    qc.quant_pack.launches, qc.unpack_dequant.launches = saved
                    check(launched == ((0, 0) if n == 0 else (1, 1)),
                          f"launches {launched} for N={n}")
                    w0, sc0, rm0 = qc._quant_pack_torch(x, bits, ft, fw, key)
                    y0 = qc.dequantize_words(w0, sc0, rm0, bits, ft, fw, f)
                    tag = f"bits={bits} F={f} f_true={ft} {str(dtype)[6:]} N={n}"
                    if n:
                        worst_pack = max(worst_pack,
                                         float((w.long() - w0.long()).abs().max()),
                                         float((sc - sc0).abs().max()),
                                         float((rm - rm0).abs().max()))
                    check(w.shape == (n, fw * bits // 32) and y.shape == (n, f), f"{tag}: shapes")
                    check(torch.equal(w, w0), f"{tag}: words differ from the plain version")
                    check(torch.equal(sc, sc0) and torch.equal(rm, rm0), f"{tag}: scale/rmin differ")
                    check(torch.equal(y, y0), f"{tag}: dequantized rows differ")
                    if n > 1:
                        check(not w[1].any() and bool((y[1, :ft] == 0.5).all()),
                              f"{tag}: the constant row did not round-trip")
                    if n:
                        # one step of the f32 scale, with f32 rounding slack
                        # (y = (x - rmin) * scale reaches 255 at 8 bits)
                        err = (y[:, :ft] - x[:, :ft].float()).abs()
                        step = (1.0 / sc)[:, None]
                        check(bool((err <= step * (1 + 1e-3) + 1e-6).all()),
                              f"{tag}: a round-trip error exceeds one step")
                        check(not y[:, ft:].any(), f"{tag}: padding columns not zero")
                        worst_err = max(worst_err, float((y - y0).abs().max()))
                    cases += 1
    say(f"[quant] {cases} cases (bits 2/4/8, F 640/256, f32/bf16, N 0/1/33/25,700, "
        f"a constant row): kernels equal the plain versions bit for bit (max |difference| "
        f"quant_pack {worst_pack:g}, unpack_dequant {worst_err:g}); round trip within one step")
    # unbiased: the mean over 64 keys of the dequantized rows
    n, f, ft = 1024, 640, 602
    x = torch.randn(n, f, generator=gen, device="cuda")
    x[:, ft:] = 0
    for bits in (2, 4, 8):
        fw = wire_cols(ft, bits)
        acc = torch.zeros(n, f, device="cuda", dtype=torch.float64)
        saved = (qc.quant_pack.launches, qc.unpack_dequant.launches)
        for r in range(64):
            w, sc, rm = qc.quant_pack(x, bits, ft, fw, qc.stream_key(seed, 77, r))
            acc += qc.unpack_dequant(w, sc, rm, bits, ft, fw, f).double()
        qc.quant_pack.launches, qc.unpack_dequant.launches = saved
        step = (1.0 / sc).double()[:, None]
        z = ((acc / 64 - x.double())[:, :ft] / step)
        # each draw's error is within one step, so its sd is <= 1/2 step
        sigma = 0.5 / (64 * n * ft) ** 0.5
        mean = float(z.mean())
        say(f"[quant] bias at {bits} bits: mean error {mean:.2e} steps, 4 sigma {4 * sigma:.2e}")
        check(abs(mean) <= 4 * sigma, f"{bits}-bit codes are biased")
    return worst_pack, worst_err


def _e2e_worker(rank, world, device, configs):
    """One rank of the K=2 card-vs-CPU check: each config trains in turn."""
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    out = []
    for over in configs:
        t = Trainer(RunConfig.from_yaml("sbm", over), device=device)
        out.append(t.train()["loss_curve"])
    check("jax" not in sys.modules, "a rank imported jax")
    return out


def phase_e2e_k(torch, seed):
    """K=2 on the SBM, f32: two ranks on the card over gloo against the
    same ranks on the CPU, in Vanilla and in AdaQP (uniform 8 bits). The
    plain generator equals the kernel's, so both draw the same codes."""
    import numpy as np

    from adaqp_tpu_torch.comm.distributed import spawn

    runs = {}
    for device in ("cuda", "cpu"):
        configs = [{
            "num_parts": 2, "mode": mode, "assign_scheme": "uniform", "assign_bits": 8,
            "num_epochs": 6, "hidden_dim": 32, "dropout_rate": 0.0, "log_steps": 100,
            "block_min_edges": 1, "logger_level": "WARNING",
            "synth_kwargs": {"n": 1200, "blocks": 4, "num_feats": 16, "seed": seed},
            "partition_dir": os.path.join(WORK, f"e2ek_parts_{device}"),
            "exp_path": os.path.join(WORK, "e2ek_exp"),
        } for mode in ("Vanilla", "AdaQP")]
        # a collective that waits 180 s fails the phase instead of hanging
        res = spawn(_e2e_worker, 2, device, args=(configs,),
                    workdir=os.path.join(WORK, "launch"), timeout_s=180)
        for i, mode in enumerate(("Vanilla", "AdaQP")):
            curves = [np.asarray(r[i]) for r in res]
            check(np.array_equal(curves[0], curves[1]), f"{device} {mode}: ranks disagree on the loss")
            runs[(device, mode)] = curves[0]
    # both modes read under 1e-6 on the H100 (1.7e-7 Vanilla, 6.5e-7 AdaQP):
    # the same codes, f32 sums in another order; 1e-5 leaves room for that
    # order and none for a wrong code or parameter word
    tol = 1e-5
    for mode in ("Vanilla", "AdaQP"):
        card, cpu = runs[("cuda", mode)], runs[("cpu", mode)]
        rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        say(f"[e2e_k] K=2 f32 SBM-1200 {mode}: card losses {np.round(card, 5).tolist()}")
        say(f"[e2e_k] {mode}: max relative difference to the CPU run {rel:.2e} (limit {tol:g})")
        check(np.isfinite(card).all() and rel <= tol, f"{mode}: card and CPU K=2 runs disagree")


def _profile_steps(torch, t, rank, steps=3):
    """Rank 0's view of a few more training steps (every rank takes them):
    wall time, its device time by kernel, its host time by operator."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from adaqp_tpu_torch.ops import quant_cuda as qc
    from adaqp_tpu_torch.ops import spmm_strip as ss

    saved = (ss.strip_spmm.launches, qc.quant_pack.launches, qc.unpack_dequant.launches)
    torch.cuda.synchronize()
    dist.barrier()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if rank == 0:
        prof.__enter__()
    t0 = time.perf_counter()
    for i in range(steps):
        float(t._train_step(1000 + i))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ss.strip_spmm.launches, qc.quant_pack.launches, qc.unpack_dequant.launches = saved
    if rank != 0:
        return None
    prof.__exit__(None, None, None)
    dev, host = {}, {}
    # device time from the device's own events (kernels, copies), not from
    # the operators that launched them
    for e in prof.events():
        if e.device_type.name == "CUDA":
            dev[e.name] = dev.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    for e in prof.key_averages():
        if e.self_cpu_time_total > 0:
            host[e.key] = e.self_cpu_time_total / 1e3 / steps
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": sum(dev.values()), "device": top(dev),
            "host": top(host)}


def _train_k_worker(rank, world, device, cfg, graph_fn, profile):
    """One rank of the K=4 Reddit-width run: train, then report counts,
    memory and a checksum of the parameters that every rank must share."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from adaqp_tpu_torch.ops import quant_cuda as qc
    from adaqp_tpu_torch.ops import spmm_strip as ss
    from adaqp_tpu_torch.trainer import Trainer

    t = Trainer(cfg, graph=graph_fn(), device=device)
    hist = []
    reassign = t._reassign

    def recording_reassign(epoch):
        reassign(epoch)
        hist.append((epoch, [
            {b: int(((a == b) & (a > 0)).sum()) for b in (2, 4, 8)}
            for a in t.assignment.fwd + t.assignment.bwd[1:]
        ]))

    t._reassign = recording_reassign
    fh = t.blocks.devices()[2]
    halo = (int(fh.blk_ptr[-1]), 0 if fh.straggler is None else
            sum(int((r < fh.n).sum()) for _, r, _, _ in fh.straggler.buckets))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss.strip_spmm.launches = qc.quant_pack.launches = qc.unpack_dequant.launches = 0
    rec = t.train()
    launches = (ss.strip_spmm.launches, qc.quant_pack.launches, qc.unpack_dequant.launches)
    torch.cuda.synchronize()
    flat = torch.cat([p.detach().reshape(-1) for layer in t.params for p in layer.values()]).cpu()
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat)
    check(all(torch.equal(x.view(torch.int32), flat.view(torch.int32)) for x in every),
          f"rank {rank}: parameters differ across ranks")
    split = _profile_steps(torch, t, rank) if profile else None
    plan = t.layout.plan_fwd
    return {
        "split": split,
        "loss_curve": rec["loss_curve"], "epoch_times": list(t.timer.epoch_times),
        "per_epoch": rec["per_epoch"], "planned": rec["planned_quant_launches"],
        "launches": launches, "checksum": float(flat.double().sum()),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profile_s": t.profile_s, "assign_s": t.assign_s, "hist": hist,
        "halo": halo, "lanes": int(plan.counts[rank].sum()),
        "layout": (t.layout.l_max, plan.r_pad, plan.s_pad,
                   [int(x) for x in t.layout.num_local]),
        "epochs": cfg.num_epochs, "layers": cfg.num_layers,
    }


def phase_train_k(torch, args):
    """The Reddit-width GCN at K=4 on one card (four ranks over gloo) in
    mode AdaQP with the adaptive scheme, then Vanilla on the same graph."""
    import functools

    import numpy as np

    from adaqp_tpu_torch.__main__ import config_from_args, parse_args
    from adaqp_tpu_torch.comm.distributed import spawn
    from adaqp_tpu_torch.helper.dataset import REDDIT_C, REDDIT_E, REDDIT_F, REDDIT_N, synth_reddit

    n = args.nodes_k
    e = n * round(REDDIT_E / REDDIT_N)
    graph_fn = functools.partial(synth_reddit, n, e, REDDIT_F, REDDIT_C, seed=SEED, device="cuda")
    out = {}
    for mode, epochs in (("AdaQP", args.epochs_k), ("Vanilla", 6)):
        cfg = config_from_args(parse_args([
            "--dataset", "reddit", "--num_parts", "4", "--mode", mode,
            "--assign_scheme", "adaptive", "--num_epochs", str(epochs),
            "--agg_dtype", "bfloat16", "--seed", str(SEED),
            "--exp_path", os.path.join(WORK, "k4_exp"),
        ]))
        cfg.assign_cycle, cfg.log_steps = 5, 1
        cfg.partition_dir = os.path.join(WORK, "k4_parts")
        check((cfg.num_layers, cfg.hidden_dim, cfg.dropout_rate, cfg.use_norm,
               cfg.learning_rate, cfg.partition_method) == (3, 256, 0.5, True, 0.01, "ldg"),
              "reddit.yaml no longer holds the Reddit GCN settings")
        t0 = time.perf_counter()
        res = spawn(_train_k_worker, 4, "cuda", args=(cfg, graph_fn, mode == "AdaQP"),
                    workdir=os.path.join(WORK, "launch"), timeout_s=480)
        wall = time.perf_counter() - t0
        r0 = res[0]
        l_max, r_pad, s_pad, nloc = r0["layout"]
        say(f"[train_k] {mode}: {n} nodes, {e} edges, K=4 on one card over gloo; "
            f"partitions {nloc}, l_max {l_max}, r_pad {r_pad}, s_pad {s_pad}; "
            f"launch + set-up + {epochs} epochs {wall:.1f} s")
        losses = np.asarray(r0["loss_curve"])
        for i, loss in enumerate(losses, 1):
            ms = [r["epoch_times"][i - 1] * 1e3 for r in res]
            say(f"[train_k] {mode} epoch {i}: loss {loss:.5f} (step {min(ms):.0f}-{max(ms):.0f} ms over ranks)")
        for r in res[1:]:
            check(np.array_equal(np.asarray(r["loss_curve"]), losses), f"{mode}: ranks disagree on the loss")
        check(np.isfinite(losses).all() and losses[-1] < losses[0], f"{mode}: the loss did not fall")
        per_epoch_strip = 6 * r0["layers"] - 2  # 2L forward, 2(L-1) backward, 2L eval
        for rank, r in enumerate(res):
            strip, qp, ud = r["launches"]
            say(f"[train_k] {mode} rank {rank}: {r['lanes']} send lanes; halo layout "
                f"{r['halo'][0]} dense tiles, {r['halo'][1]} ELL segments; launches strip {strip} "
                f"(expected {per_epoch_strip * epochs}), quant_pack {qp}, unpack_dequant {ud} "
                f"(the plans imply {r['planned'][0]}, {r['planned'][1]}); peak "
                f"max_memory_allocated {r['peak_gib']:.2f} GiB; median step {r['per_epoch'] * 1e3:.1f} ms")
            check(sum(r["halo"]) > 0, f"rank {rank}: the halo layout is empty")
            check(strip == per_epoch_strip * epochs, f"rank {rank}: strip launch count is off")
            check((qp, ud) == tuple(r["planned"]), f"rank {rank}: quant launch counts differ from the plans")
            if mode == "AdaQP":
                check(qp > 0 and ud > 0, f"rank {rank}: no quant kernel launched")
        say(f"[train_k] {mode}: parameters bit-identical across ranks (all-gathered; "
            f"sum {r0['checksum']!r})")
        if mode == "AdaQP":
            say(f"[train_k] profiling {r0['profile_s']:.2f} s; reassignments (MILP + lowering) "
                f"{[round(x, 2) for x in r0['assign_s']]} s")
            check(len(r0["hist"]) >= 1, "no reassignment ran")
            for epoch, h in r0["hist"]:
                say(f"[train_k] assignment at epoch {epoch}, lanes per width "
                    f"(fwd layers 0-2, bwd layers 1-2): {h}")
            sp = r0["split"]
            # the four ranks time-share the card: a kernel's span on the
            # device clock may include slices that ran other ranks' work
            say(f"[train_k] profile, rank 0 of 4 over 3 more steps: {sp['wall_ms']:.1f} ms a step; "
                f"its kernels span {sp['device_ms']:.1f} ms of device time a step")
            for name, ms in sp["device"]:
                say(f"[train_k]   device {ms:8.3f} ms  {name[:90]}")
            for name, ms in sp["host"]:
                say(f"[train_k]   host   {ms:8.3f} ms  {name[:90]}")
        out[mode] = res
    say(f"[train_k] median step AdaQP {out['AdaQP'][0]['per_epoch'] * 1e3:.1f} ms, "
        f"Vanilla {out['Vanilla'][0]['per_epoch'] * 1e3:.1f} ms "
        "(four ranks time-sharing one card over a host-staged transport)")
    return out


def phase_time_quant(torch, card, lanes):
    """Both quant kernels at the main path's shapes (8 bits, bf16 rows,
    ``lanes`` rows: one rank's send lanes at layer 0 and in a hidden
    layer)."""
    from adaqp_tpu_torch.comm.wire import wire_cols
    from adaqp_tpu_torch.ops import quant_cuda as qc

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for f, ft in ((640, 602), (256, 256)):
        bits, fw = 8, wire_cols(ft, 8)
        wpr = fw * bits // 32
        x = torch.randn(lanes, f, generator=gen, device="cuda").to(torch.bfloat16)
        saved = (qc.quant_pack.launches, qc.unpack_dequant.launches)
        ms_q = cuda_ms(torch, lambda: qc.quant_pack(x, bits, ft, fw, 5), reps=20)
        w, sc, rm = qc.quant_pack(x, bits, ft, fw, 5)
        ms_u = cuda_ms(torch, lambda: qc.unpack_dequant(w, sc, rm, bits, ft, fw, f), reps=20)
        qc.quant_pack.launches, qc.unpack_dequant.launches = saved
        plain_q = cuda_ms(torch, lambda: qc._quant_pack_torch(x, bits, ft, fw, 5), reps=3, warmup=1)
        plain_u = cuda_ms(torch, lambda: qc.dequantize_words(w, sc, rm, bits, ft, fw, f),
                          reps=3, warmup=1)
        # quant_pack reads only the first fw columns of each row
        bytes_q = lanes * fw * 2 + lanes * wpr * 4 + 8 * lanes
        bytes_u = lanes * wpr * 4 + 8 * lanes + lanes * f * 4
        bq, bu = bytes_q / PEAK_BYTES_S * 1e3, bytes_u / PEAK_BYTES_S * 1e3
        say(f"[time] {card} | quant_pack N={lanes} F={f} f_true={ft} 8 bits bf16: kernel {ms_q:.4f} ms; "
            f"bound {bq:.4f} ms by bytes ({bytes_q / 1e6:.1f} MB); plain {plain_q:.3f} ms; library none")
        say(f"[time] {card} | unpack_dequant N={lanes} F={f}: kernel {ms_u:.4f} ms; bound {bu:.4f} ms "
            f"by bytes ({bytes_u / 1e6:.1f} MB); plain {plain_u:.3f} ms; library none")
        rows[f] = (dict(ms=ms_q, plain_ms=plain_q, bound_ms=bq, bound_by="bytes", library_ms=None),
                   dict(ms=ms_u, plain_ms=plain_u, bound_ms=bu, bound_by="bytes", library_ms=None))
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="K=1 on the full Reddit-size graph (232,965 nodes, 114.6M edges)")
    p.add_argument("--nodes", type=int, default=65_536,
                   help="nodes of the K=1 graph (edges keep Reddit's mean degree)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--nodes_k", type=int, default=32_768, help="nodes of the K=4 graph")
    p.add_argument("--epochs_k", type=int, default=12,
                   help="AdaQP epochs at K=4 (reassignment at 6 and 11 with a cycle of 5)")
    p.add_argument("--only", type=str, default=None,
                   help="comma-separated phases to run (quant, e2e, e2e_k, k1, train_k); "
                        "build always runs, and the result lines print only for a full run")
    p.add_argument("--profile", action="store_true",
                   help="also trace a few K=1 training steps with torch.profiler")
    args = p.parse_args()
    only = None if args.only is None else set(args.only.split(","))
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

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        say(f"[{name}] phase {time.perf_counter() - t0:.1f} s")
        return out

    def want(name):
        return only is None or name in only

    run("build", phase_build)
    pack_err, quant_err = run("quant", phase_quant, torch, SEED) if want("quant") else (None, None)
    if want("e2e"):
        run("e2e", phase_e2e, torch, SEED)
    if want("e2e_k"):
        run("e2e_k", phase_e2e_k, torch, SEED)
    if want("k1"):
        trainer = run("setup", phase_setup, torch, args)
        err = run("kernel", phase_kernel, torch, trainer, SEED)
        launches = run("train", phase_train, torch, trainer)
        if args.profile:
            run("profile", phase_profile, torch, trainer)
        times = run("time", phase_time, torch, trainer, card)
        del trainer
        torch.cuda.empty_cache()
    if want("train_k"):
        k4 = run("train_k", phase_train_k, torch, args)
        lanes = k4["AdaQP"][0]["lanes"]
        qtimes = run("time", phase_time_quant, torch, card, lanes)
    if only is not None:
        say("[done] partial run (--only): no result lines")
        return
    k4_strip = sum(r["launches"][0] for r in k4["AdaQP"])
    k4_q = sum(r["launches"][1] for r in k4["AdaQP"])
    k4_u = sum(r["launches"][2] for r in k4["AdaQP"])
    say(f"[result] strip_spmm launches: K=1 train {launches}, K=4 AdaQP train {k4_strip} (all ranks)")
    say(card)
    say(json.dumps({"kernels": [
        {"name": "strip_spmm", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/spmm_strip.cu",
         "replaces": "adaqp_tpu/ops/spmm_strip.py:277",
         "launches": launches + k4_strip, "max_abs_err": err, **times[640]},
        {"name": "quant_pack", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/quant_pack.cu",
         "replaces": "adaqp_tpu/ops/quant_pallas.py:103",
         "launches": k4_q, "max_abs_err": pack_err, **qtimes[640][0]},
        {"name": "unpack_dequant", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/quant_pack.cu",
         "replaces": "adaqp_tpu/ops/quant_pallas.py:202",
         "launches": k4_u, "max_abs_err": quant_err, **qtimes[640][1]},
    ]}))
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
