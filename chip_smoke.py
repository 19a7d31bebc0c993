#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``adaqp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # banded graphs (Reddit K=1: 65,536 nodes; products: 131,072)
    python3 chip_smoke.py --full     # K=1 at Reddit's 232,965 nodes / 114,615,892 edges

It builds the port's CUDA kernels from this checkout (one ``nvcc`` per
source, all at once), holds each against its plain PyTorch version on the
card, and trains a Reddit-width GCN (602 -> 256 -> 256 -> 41, 3 layers,
bf16 aggregation, LayerNorm, dropout 0.5, Adam lr 0.01) twice through the
port's entry points: at K=1 through ``Trainer``, and at K=4 in mode AdaQP
with the adaptive scheme through the launcher of ``python -m
adaqp_tpu_torch`` (four ranks sharing the one card over gloo), on the
ragged wire and, with the breakdown probe on, on the padded dense wire
(``wire_impl=padded``); then an ogbn-products-width GCN (100 -> 256 -> 256
-> 47) at K=1 through each aggregation (``spmm_impl`` strip, block,
compact, segment). It checks that each training ran through the kernels
(their launch counts), and times every kernel beside its bound, its plain
version and a library call where one exists. It also drives the probes of
``adaqp_tpu_torch.scripts`` (``microbench_dma_gather``, ``microbench_gather``,
``microbench_expand``, ``probe_r5``) through their mains, and runs the
card-only pytest cases. Phases: env, build, agg
(block_spmm, compact_spmm and gather_rows), pad (quant_rows and
dequant_rows), quant (quant_pack and unpack_dequant in their contiguous
form and over the lane tables of synthetic K=4 wires), gather (ring_gather,
window_gather and compact_item against their plain versions, the two
mains with their launches checked, then each kernel timed with its
per-iteration slope, ring_gather also with L2 flushed, one block over the
stream and many), expand (expand_spmm's four variants against their plain
versions, its main on a Reddit-degree layout of 32,768 nodes, 2,048 dense
tiles (``--full``: Reddit's size), then each variant timed beside
block_spmm, torch.sparse.mm and its bound), r5 (transpose_u32 bit for bit
and timed, then the probe's main with its scatter and plane lines),
gpu_tests (``pytest -m gpu tests/test_torch_gpu.py`` in a subprocess,
every case passed and none skipped), setup, kernel
(strip SpMM), e2e (a small K=1 run on the card against the same run on
the CPU), e2e_k (the same at K=2, Vanilla and AdaQP), e2e_pad (e2e_k on
the padded wire), train (K=1), train_k (K=4), train_pad (K=4 AdaQP on the
padded wire, with the probe), e2e_agg (K=2 card against CPU for block,
compact and segment), train_agg (the products GCN through the four
aggregations), time (after k1, train_k, train_pad and train_agg; after
train_pad it first holds quant_rows and dequant_rows against their plain
versions at every shape that run gave them; with ``--profile``, also a
device-time breakdown of a few training steps of the K=1 Reddit run and of
each train_agg run; train_k and train_pad always profile three more steps
of rank 0, and train_k times rank 0's send and receive sides of each
exchange of one more step, holding them against the plain versions). The
quant kernels' bounds count the operations of their hot loops in the SASS
of the built library (``cuobjdump``) beside their bytes. The runs that check exact
launch counts of training alone turn the probe off; train_pad counts the
probe's launches as a planned term. Each phase prints its seconds. Any
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
# f32: both sum in f32 in another order (the plain versions through
# torch.bmm at full f32 precision); readings on the H100 up to 2.7e-5 where
# rows sum hundreds of N(0, 1) values, hence the absolute floor
F32_ATOL, F32_RTOL = 1e-4, 1e-5
# the products GCN's evaluation loss before a step, one set of parameters,
# across the four aggregations: bf16 sums in other orders (f32 for the
# segment sum); 3.4e-6 read on the H100
AGG_LOSS0_RTOL = 1e-4


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


def sm_clock_mhz():
    """(current, maximum) SM clock in MHz as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    cur, top = smi.stdout.strip().splitlines()[0].split(",")
    return float(cur), float(top)


def strip_floor(lay, f, nnz, clock_mhz):
    """The strip kernel design's own floor for bf16 h: the shared-memory
    bytes it moves (every tile edge reads its row's 32-byte column slice,
    every window step's slice is written once by TMA, per column slice)
    over 132 SMs at 128 bytes a clock. Returns (ms, bytes)."""
    from adaqp_tpu_torch.ops import spmm_strip as ss

    slices = -(-f * 2 // ss.SLICE_BYTES)
    nbytes = slices * (nnz * ss.SLICE_BYTES + lay.walk.step_win.numel() * ss.BS * ss.SLICE_BYTES)
    return nbytes / (132 * 128 * clock_mhz * 1e6) * 1e3, nbytes


# SASS opcodes by the pipe that issues them on Hopper, with its rate a clock
# per SM: the integer pipe (64), the conversion and special-function units
# (16), the f32 pipe (128). Anything else (loads, stores, branches, moves)
# counts in no term, so the operation bound is a lower bound.
SASS_PIPES = {
    "integer": (64, {"IMAD", "IMUL", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
                     "ISETP", "IMNMX", "VIMNMX", "LEA", "SEL", "PRMT", "IABS", "BMSK",
                     "SGXT", "POPC", "FLO", "BREV", "I2FP", "VIADD", "IDP"}),
    "conversion": (16, {"F2I", "I2F", "FRND", "F2F", "MUFU"}),
    "f32": (128, {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL"}),
}


def sass_per_element(lib, func, marker, per_marker=1):
    """Operations an element, by pipe, in the hot loop of the kernel whose
    mangled name contains ``func`` in ``build/kernels/lib<lib>.so``
    (``cuobjdump -sass``): of the innermost loops (a backward branch with
    no other loop inside), the one with the most instructions whose opcode
    starts with ``marker``, each of which stands for ``per_marker``
    elements. Returns ({pipe: operations an element}, elements an
    iteration, instructions in the loop)."""
    import re

    from adaqp_tpu_torch.utils.cuda_build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    so = os.path.join(HERE, "build", "kernels", f"lib{lib}.so")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    body = [chunk for chunk in out.stdout.split("Function : ")[1:] if func in chunk.split()[0]]
    check(len(body) == 1, f"{func}: {len(body)} functions in lib{lib}.so")
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body[0])]
    loops = []
    for a, t in ins:
        m = re.search(r"\bBRA (?:!?U?P\w+, )?0x([0-9a-f]+)", t)
        if m and int(m.group(1), 16) <= a:
            loops.append((int(m.group(1), 16), a))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]

    def ops(lp):
        return [t.split()[1 if t.startswith("@") else 0] for a, t in ins if lp[0] <= a <= lp[1]]

    best = max(inner, key=lambda lp: sum(o.startswith(marker) for o in ops(lp)), default=None)
    check(best is not None, f"{func}: no loop in the SASS")
    codes = ops(best)
    elems = sum(o.startswith(marker) for o in codes) * per_marker
    check(elems > 0, f"{func}: no {marker} in its innermost loops")
    counts = {pipe: sum(o.split(".")[0] in names for o in codes) / elems
              for pipe, (_, names) in SASS_PIPES.items()}
    return counts, elems, len(codes)


def ops_ms(counts, elements, clock_mhz):
    """The least time of ``elements`` elements at ``counts`` operations an
    element on each pipe, 132 SMs at ``clock_mhz``: (ms, the pipe)."""
    t = {pipe: elements * n / (SASS_PIPES[pipe][0] * 132 * clock_mhz * 1e6) * 1e3
         for pipe, n in counts.items()}
    pipe = max(t, key=t.get)
    return t[pipe], pipe


def phase_build():
    from adaqp_tpu_torch.utils.cuda_build import build

    t0 = time.perf_counter()
    logs = build(["spmm_strip", "quant_pack", "quant_rows", "spmm_block", "spmm_compact",
                  "ring_gather", "window_gather", "compact_item", "expand_tile",
                  "transpose_u32"])
    say(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                say(f"[build] {name}: {line.strip()}")


def cuda_ms(torch, fn, reps, warmup=2, backlog=False, spin=20_000_000):
    """Mean milliseconds per call from CUDA events around ``reps`` calls.
    ``backlog``: queue them behind a spin of ``spin`` clock cycles on the
    card (the default some 10 ms), so that calls shorter than their host
    time run back to back and the events read the card's time, not the
    host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if backlog:
        torch.cuda._sleep(spin)
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
        "measure_breakdown": False, "partition_dir": os.path.join(WORK, "parts"),
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
    from adaqp_tpu_torch.ops import spmm_strip as ss

    for name, lay in zip(("fwd_local", "bwd_local", "fwd_halo", "bwd_halo"), t.blocks.devices()):
        w = lay.walk
        check(w is not None, f"{name}: the layout carries no walk arrays")
        groups = w.cols.numel() * 2 + (w.grp_ptr.numel() + w.grp_len.numel()) * 4
        say(f"[setup] {name} walk arrays (built on the card with torch ops): column batches "
            f"{w.cols.numel() * 2 / 1e6:.1f} MB ({w.cols.numel()} slots) + group pointers "
            f"{(groups - w.cols.numel() * 2) / 1e6:.1f} MB + schedule "
            f"{(w.nbytes - groups) / 1e3:.1f} kB ({w.step_win.numel()} window steps) = "
            f"{w.nbytes / 1e6:.1f} MB, beside {lay.masks.numel() * 2 / 1e6:.1f} MB of masks")
    fl = t.blocks.devices()[0]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    again = ss.strip_walk(fl.masks, fl.tile_src, fl.blk_ptr)
    torch.cuda.synchronize()
    say(f"[setup] fwd_local walk arrays rebuilt in {time.perf_counter() - t3:.2f} s")
    check(all(torch.equal(a, b) for a, b in zip(again.tensors(), fl.walk.tensors())),
          "the walk arrays differ from one build to the next")
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

    # the same launch twice: bit for bit the same (one thread a sum, fixed order)
    h = torch.randn(fl.n_src_pad, 640, generator=gen, device=dev).to(torch.bfloat16)
    first, second = ss.strip_spmm(fl, h), ss.strip_spmm(fl, h)
    torch.cuda.synchronize()
    say(f"[kernel] fwd_local F=640 launched twice: bit for bit the same {torch.equal(first, second)}")
    check(torch.equal(first, second), "two launches of strip_spmm differ")

    rng = np.random.default_rng(seed)
    n, n_src, e = 8192, 6144, 600_000
    src = rng.integers(0, n_src, e).astype(np.int32)
    dst = ((src + rng.integers(-400, 400, e)) % n).astype(np.int32)
    rect = ss.strip_layout(src, dst, n, min_edges=64, n_src=n_src).to_device(dev)
    check(int(rect.blk_ptr[-1]) > 0, "rectangular layout has no dense tile")
    run(f"rectangular {rect.n_pad}x{rect.n_src_pad}", rect, 640)
    # a tile row with all 2,048 columns set, beside the rectangular edges
    full = ss.strip_layout(np.concatenate([np.arange(2048, dtype=np.int32), src % 4096]),
                           np.concatenate([np.full(2048, 300, np.int32), dst % 4096]),
                           4096, min_edges=1).to_device(dev)
    check(int(full.walk.grp_len.max()) == 2048, "no full tile row in the full-row layout")
    run("full row (2,048 set columns)", full, 640)

    # backward: spmm_strip (kernel on the reverse layout) against autograd
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
    say(f"[kernel] backward F=256: max |spmm_strip grad - plain autograd grad| "
        f"{err:.3g}, {ratio:.3f} of the tolerance")
    check(hk.grad.dtype == torch.bfloat16, "backward did not return the primal dtype")
    check(ratio <= 1.0, "spmm_strip backward disagrees with the plain version's autograd")
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


def phase_profile(torch, trainer, steps=3, tag="profile"):
    """``--profile``: device time by kernel over a few training steps
    (``torch.profiler``), the device's busy share of that window, and the
    host's self time by operator. The steps' launches are not counted."""
    from torch.profiler import ProfilerActivity, profile

    wrappers = _wrappers()
    saved = {k: w.launches for k, w in wrappers.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            trainer._train_step(1000 + i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for k, w in wrappers.items():
        w.launches = saved[k]
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = {}
    for e in kernels:
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(busy.values())
    check(total > 0, "the profiler saw no device time")
    say(f"[{tag}] {steps} training steps: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{total / 1e3:.1f} ms ({100 * total / wall_us:.1f}%), {len(kernels)} device events")
    for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:10]:
        say(f"[{tag}] device {us / 1e3:9.3f} ms {100 * us / total:5.1f}%  {name[:100]}")
    host = {e.key: e.self_cpu_time_total for e in prof.key_averages() if e.self_cpu_time_total > 0}
    for name, us in sorted(host.items(), key=lambda kv: -kv[1])[:5]:
        say(f"[{tag}] host   {us / 1e3:9.3f} ms  {name[:100]}")


def tile_csr(torch, lay, dtype):
    """The edges a tile layout's kernel part covers, as a CSR matrix of ones
    (the library yardstick), and their count."""
    dst, src = _layout_coo(torch, lay)
    vals = torch.ones(dst.numel(), dtype=dtype, device=dst.device)
    coo = torch.sparse_coo_tensor(torch.stack([dst, src]), vals, (lay.n_pad, lay.n_src_pad))
    return coo.coalesce().to_sparse_csr(), dst.numel()


def phase_time(torch, trainer, card):
    from adaqp_tpu_torch.ops import spmm_strip as ss

    dev = trainer.device
    fl = trainer.blocks.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    t = int(fl.blk_ptr[-1])
    rows = {}
    clock = sm_clock_mhz()
    info = ss.strip_kernel_info(torch.bfloat16)
    say(f"[time] {card} | strip_spmm form: a CTA a (strip, slice of {info['columns']} bf16 columns), "
        f"{info['registers']} registers a thread, {info['spill_bytes']} spill bytes, shared memory "
        f"{info['dynamic_smem']} B dynamic + {info['static_smem']} B static; SM clock "
        f"{clock[0]:g} MHz now, {clock[1]:g} MHz max (the floor uses the max)")
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
        floor_ms, floor_bytes = strip_floor(fl, f, nnz, clock[1])
        say(f"[time] {card} | fwd_local F={f}: tiles {t}, tile edges {nnz}")
        say(f"[time] {card} | kernel {ms:.3f} ms; bound {bound_ms:.3f} ms by {bound_by} "
            f"({nbytes / 1e9:.3f} GB, {flops / 1e12:.4f} TFLOP bf16); plain {plain_ms:.2f} ms; "
            f"torch.sparse.mm {lib_ms:.3f} ms (bf16 CSR)")
        say(f"[time] {card} | the design's shared-memory floor {floor_ms:.3f} ms "
            f"({floor_bytes / 1e9:.2f} GB at 132 x 128 B a clock; the warps walk "
            f"{fl.walk.cols.numel() / nnz:.2f} column slots an edge)")
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
    lane_pack, lane_unpack = _hold_lanes(torch, seed)
    worst_pack, worst_err = max(worst_pack, lane_pack), max(worst_err, lane_unpack)
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


def _hold_lanes(torch, seed):
    """The lane kernels (pack_lanes, unpack_lanes) against their plain
    versions on the card, on random K=4 wires of the port's wire lowering
    (``tests/torch_helpers.py``) with all four widths: each
    rank's send buffer and ranges, and each rank's received rows, forward
    (placed through the inverse map) and backward (a row a lane), bit for
    bit; the backward's sums (added into the destinations with atomics)
    within 1e-6 * sum |terms| of index_add_'s (another order where three
    peers return a row). Returns the largest differences (pack, unpack)."""
    import numpy as np

    from adaqp_tpu_torch.comm.exchange_ragged import unpack_dir
    from adaqp_tpu_torch.ops import quant_cuda as qc

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_helpers import random_wire, received

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    saved = (qc.quant_pack.launches, qc.unpack_dequant.launches)
    worst_p = worst_u = worst_sum = 0.0
    cases = []
    for forward, f, ft, dtype in ((True, 640, 602, torch.bfloat16), (False, 256, 256, torch.float32),
                                  (True, 256, 256, torch.bfloat16), (False, 333, 301, torch.float32)):
        out_len = 30_000 if forward else 10_240
        wd = random_wire(rng, 4, ft, (2, 4, 8, 32), True, out_len, 10_240, forward,
                         lanes=(4_000, 8_000))
        wires = [wd.local(r, out_len, "cuda") for r in range(4)]
        bufs = []
        for r, w in enumerate(wires):
            x = torch.randn(10_240, f, generator=gen, device="cuda").to(dtype)
            keys = [qc.stream_key(seed, r, bi) for bi in range(len(w.bits))]
            n_words = sum(w.send_splits)
            got, rng_k = qc.pack_lanes(x, w.send_lanes, w.bits, w.wpr, keys, ft, n_words, True)
            want, rng_p = qc._pack_lanes_torch(x, w.send_lanes, w.bits, w.wpr, keys, ft, n_words,
                                               True)
            worst_p = max(worst_p, float((got.long() - want.long()).abs().max()),
                          float((rng_k - rng_p).abs().max()))
            check(torch.equal(got, want) and torch.equal(rng_k, rng_p),
                  f"pack_lanes differs from its plain version (rank {r}, F={f}, {dtype})")
            bufs.append(got)
        for r, w in enumerate(wires):
            recv = received(bufs, wires, r)
            inv = w.d_inv if forward else None
            got = qc.unpack_lanes(recv, w.recv_lanes, w.bits, w.wpr, ft, f, inv)
            want = qc._unpack_lanes_torch(recv, w.recv_lanes, w.bits, w.wpr, ft, f, inv)
            worst_u = max(worst_u, float((got - want).abs().max()))
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"unpack_lanes differs from its plain version (rank {r}, F={f})")
            if not forward:
                dst = w.recv_lanes.row
                total = unpack_dir(w, recv, True, ft, f)
                ref = torch.zeros_like(total).index_add_(0, dst, want)
                scale = torch.zeros_like(total).index_add_(0, dst, want.abs())
                worst_sum = max(worst_sum, float(((total - ref).abs() / (scale + 1e-30)).max()))
                check(bool(((total - ref).abs() <= 1e-6 * scale).all()),
                      f"the backward sums differ beyond 1e-6 * sum |terms| (rank {r})")
        lanes = [w.send_lanes.n for w in wires]
        cases.append(f"{'fwd' if forward else 'bwd'} F={f} f_true={ft} {str(dtype)[6:]} "
                     f"lanes {lanes}")
    qc.quant_pack.launches, qc.unpack_dequant.launches = saved
    say(f"[quant] lane kernels on K=4 wires of 2/4/8/32-bit lanes ({'; '.join(cases)}): "
        f"send buffers, ranges and received rows equal the plain versions bit for bit; "
        f"backward sums within {worst_sum:.2e} of sum |terms| (limit 1e-6)")
    return worst_p, worst_u


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

    counters = (ss.strip_spmm, qc.quant_pack, qc.unpack_dequant, qc.quant_rows, qc.dequant_rows)
    saved = [c.launches for c in counters]
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
    for c, n in zip(counters, saved):
        c.launches = n
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


def _wire_volume(t):
    """One training step's quantized wire on this rank: (collectives, bytes
    sent to the other ranks), forward and backward over all layers; None
    without a quantized wire."""
    from adaqp_tpu_torch.ops.quant import bytes_per_row, pad_features

    if t.buckets is not None:
        n = sent = 0
        for i, (bits, arrays) in enumerate(t.buckets):
            for ft in [t.layer_dims[i]] + ([t.layer_dims[i]] if i else []):
                for b, quad in zip(bits, arrays):
                    k, cap = quad[0].shape  # the chunk to itself is padding
                    n, sent = n + 1, sent + (k - 1) * cap * (bytes_per_row(pad_features(ft), b) + 4)
        return n, sent
    if t.wire_q is None:
        return None
    ws = [w for pair in t.wire_q for w in pair if w is not None]
    return len(ws), sum(4 * sum(w.send_splits) for w in ws)


def _pad_cases(t, probe=False):
    """The (bits, rows, F, f_true, dtype) of every quant_rows launch one
    padded training step makes with the current buckets: the forward rows
    in the activations' dtype, the backward's gradient rows in f32. With
    ``probe``, also the breakdown probe's: ``assign_bits`` on ``K * s_pad``
    rows a layer."""
    st = t.static
    dims = [st.f_pad] + [st.hidden] * (st.num_layers - 1)
    fwd = "bfloat16" if st.agg_dtype == "bfloat16" else "float32"
    cases = set()
    if probe and t.buckets is not None:
        cases.update((t.cfg.assign_bits, t.k * st.s_pad, d, ft, fwd)
                     for d, ft in zip(dims, t.layer_dims))
    for i, (bits, arrays) in enumerate(t.buckets or ()):
        for b, quad in zip(bits, arrays):
            n = int(quad[0].numel())
            cases.add((b, n, dims[i], t.layer_dims[i], fwd))
            if i:
                cases.add((b, n, dims[i], dims[i], "float32"))
    return cases


def _exchange_sides(torch, t, rank, reps=20):
    """Rank 0's send side (``pack_dir``) and receive side (``unpack_dir``)
    of every exchange of one more training step (every rank takes it), each
    timed alone as a function on the card: the step's own wires, source
    rows and received buffers, ``reps`` calls between CUDA events behind a
    backlog of some 100 ms. Returns a dict a call on rank 0, else None."""
    import torch.distributed as dist

    from adaqp_tpu_torch.comm import exchange_ragged as er
    from adaqp_tpu_torch.ops import quant_cuda as qc

    calls, start = [], er._start

    def recording(w, src, key, f_true, async_op, trace=False):
        p, tr = start(w, src, key, f_true, async_op, trace)
        if p.work is not None:
            p.work.wait()
            p.work = None
        # the forward starts without waiting, the backward waits
        calls.append((w, src.clone(), key, f_true, trace, p.recvbuf, not async_op, p.f_pad))
        return p, tr

    er._start = recording
    try:
        float(t._train_step(2000))
    finally:
        er._start = start
    torch.cuda.synchronize()
    if rank != 0:
        dist.barrier()
        return None
    saved = (qc.quant_pack.launches, qc.unpack_dequant.launches)
    out = []
    for w, src, key, ft, trace, recv, back, f_pad in calls:
        layer = next(i for i, pair in enumerate(t.wire_q) if any(x is w for x in pair))
        # the kernels against their plain versions on this real wire
        keys = [qc.stream_key(key, bi) for bi in range(len(w.bits))]
        got = er.pack_dir(w, src, key, ft, trace)
        want = qc._pack_lanes_torch(src, w.send_lanes, w.bits, w.wpr, keys, ft,
                                    sum(w.send_splits), trace)
        check(torch.equal(got[0], want[0]), f"layer {layer}: the send buffer differs from the "
              "plain version's")
        inv = None if back else w.d_inv
        rows = qc.unpack_lanes(recv, w.recv_lanes, w.bits, w.wpr, ft, f_pad, inv)
        check(torch.equal(rows, qc._unpack_lanes_torch(recv, w.recv_lanes, w.bits, w.wpr, ft,
                                                       f_pad, inv)),
              f"layer {layer}: the received rows differ from the plain version's")
        ms_p = cuda_ms(torch, lambda: er.pack_dir(w, src, key, ft, trace), reps,
                       backlog=True, spin=200_000_000)
        ms_u = cuda_ms(torch, lambda: er.unpack_dir(w, recv, back, ft, f_pad), reps,
                       backlog=True, spin=200_000_000)
        out.append({"layer": layer, "dir": "bwd" if back else "fwd", "F": int(src.shape[1]),
                    "f_true": ft, "dtype": str(src.dtype)[6:],
                    "send_lanes": sum(sum(c) for c in w.send_cnt),
                    "recv_lanes": sum(sum(c) for c in w.recv_cnt),
                    "pack_ms": ms_p, "unpack_ms": ms_u})
    qc.quant_pack.launches, qc.unpack_dequant.launches = saved
    dist.barrier()
    return out


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
        volume.append((epoch, _wire_volume(t)))
        pad_cases.update(_pad_cases(t))

    volume, pad_cases = [(1, _wire_volume(t))], _pad_cases(t, cfg.measure_breakdown)
    t._reassign = recording_reassign
    fh = t.blocks.devices()[2]
    halo = (int(fh.blk_ptr[-1]), 0 if fh.straggler is None else
            sum(int((r < fh.n).sum()) for _, r, _, _ in fh.straggler.buckets))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss.strip_spmm.launches = qc.quant_pack.launches = qc.unpack_dequant.launches = 0
    qc.quant_rows.launches = qc.dequant_rows.launches = 0
    rec = t.train()
    launches = (ss.strip_spmm.launches, qc.quant_pack.launches, qc.unpack_dequant.launches)
    pad_launches = (qc.quant_rows.launches, qc.dequant_rows.launches)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    t.save(rec)  # the time CSV: a row per rank, written by rank 0
    csv = os.path.join(cfg.exp_path, t.graph.name, f"{t.k}part", cfg.model_name, "time",
                       t.mode.value + (f"_{t.scheme.value}.csv" if t.mode.quantized else ".csv"))
    flat = torch.cat([p.detach().reshape(-1) for layer in t.params for p in layer.values()]).cpu()
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat)
    check(all(torch.equal(x.view(torch.int32), flat.view(torch.int32)) for x in every),
          f"rank {rank}: parameters differ across ranks")
    split = _profile_steps(torch, t, rank) if profile else None
    sides = _exchange_sides(torch, t, rank) if profile else None
    plan = t.layout.plan_fwd
    return {
        "split": split, "sides": sides,
        "loss_curve": rec["loss_curve"], "epoch_times": list(t.timer.epoch_times),
        "per_epoch": rec["per_epoch"], "planned": rec["planned_quant_launches"],
        "launches": launches, "checksum": float(flat.double().sum()),
        "pad_launches": pad_launches, "probe": rec["probe_launches"], "csv": csv,
        "buckets": t.timer.epoch_traced_time()[:4],
        # layer 0's padded buckets: (bits, K * cap) each
        "pad_shapes": None if t.buckets is None else [
            (b, int(q[0].numel())) for b, q in zip(*t.buckets[0])],
        "pad_cases": sorted(pad_cases), "volume": volume,
        "peak_gib": peak_gib,
        "profile_s": t.profile_s, "assign_s": t.assign_s, "hist": hist,
        "halo": halo, "lanes": int(plan.counts[rank].sum()),
        "layout": (t.layout.l_max, plan.r_pad, plan.s_pad,
                   [int(x) for x in t.layout.num_local]),
        "epochs": cfg.num_epochs, "layers": cfg.num_layers,
    }


def _say_volume(tag, r0):
    """Rank 0's quantized wire per training step under each assignment,
    and the median step of the epochs each assignment ran."""
    import numpy as np

    ep = np.asarray(r0["epoch_times"]) * 1e3
    starts = [e for e, _ in r0["volume"]] + [len(ep) + 1]
    for (epoch, (n, sent)), end in zip(r0["volume"], starts[1:]):
        # epoch 1 carries the one-time costs (kernel build and load)
        steps = ep[max(epoch, 2) - 1:end - 1]
        say(f"[{tag}] rank 0 wire from epoch {epoch}: {n} all-to-alls, {sent / 1e6:.2f} MB to "
            f"the other ranks a step; median step of epochs {max(epoch, 2)}-{end - 1} "
            f"{np.median(steps):.1f} ms")


def _say_split(tag, sp):
    # the four ranks time-share the card: a kernel's span on the device
    # clock may include slices that ran other ranks' work
    say(f"[{tag}] profile, rank 0 of 4 over 3 more steps: {sp['wall_ms']:.1f} ms a step; "
        f"its kernels span {sp['device_ms']:.1f} ms of device time a step")
    for name, ms in sp["device"]:
        say(f"[{tag}]   device {ms:8.3f} ms  {name[:90]}")
    for name, ms in sp["host"]:
        say(f"[{tag}]   host   {ms:8.3f} ms  {name[:90]}")


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
        cfg.assign_cycle, cfg.log_steps, cfg.measure_breakdown = 5, 1, False
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
            check(r["pad_launches"] == (0, 0), f"rank {rank}: the ragged run launched a padded-wire kernel")
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
            _say_volume("train_k", r0)
            _say_split("train_k", r0["split"])
            for x in r0["sides"]:
                say(f"[train_k] rank 0 exchange, layer {x['layer']} {x['dir']} F={x['F']} "
                    f"f_true={x['f_true']} {x['dtype']}: {x['send_lanes']} lanes out, "
                    f"{x['recv_lanes']} in; send side (pack_dir) {x['pack_ms']:.4f} ms, receive "
                    f"side (unpack_dir) {x['unpack_ms']:.4f} ms, sum "
                    f"{x['pack_ms'] + x['unpack_ms']:.4f} ms (CUDA events behind a backlog)")
        out[mode] = res
    say(f"[train_k] median step AdaQP {out['AdaQP'][0]['per_epoch'] * 1e3:.1f} ms, "
        f"Vanilla {out['Vanilla'][0]['per_epoch'] * 1e3:.1f} ms "
        "(four ranks time-sharing one card over a host-staged transport)")
    return out


def phase_time_quant(torch, card, lanes):
    """Both quant kernels at the main path's shapes (8 bits, bf16 rows,
    ``lanes`` rows: one rank's send lanes at layer 0 and in a hidden layer),
    each call queued behind a backlog so that the events read the card.
    The bound is the larger of the bytes and the operations of the kernel's
    hot loop (counted in its SASS) at the card's highest SM clock."""
    from adaqp_tpu_torch.comm.wire import wire_cols
    from adaqp_tpu_torch.ops import quant_cuda as qc

    gen = torch.Generator(device="cuda").manual_seed(2)
    clock = sm_clock_mhz()
    # bf16 rows; the forward's 16-byte stores (no atomics)
    sass = {"pack": sass_per_element("quant_pack", "17pack_lanes_kernelILb1", "I2F"),
            "unpack": sass_per_element("quant_pack", "19unpack_lanes_kernelILb1ELb0", "I2F")}
    for name, (counts, elems, n) in sass.items():
        say(f"[time] {card} | SASS of the {name} hot loop: {n} instructions for {elems} elements; "
            "an element: " + ", ".join(f"{v:.2f} {k}" for k, v in counts.items()))
    rows = {}
    for f, ft in ((640, 602), (256, 256)):
        bits, fw = 8, wire_cols(ft, 8)
        wpr = fw * bits // 32
        x = torch.randn(lanes, f, generator=gen, device="cuda").to(torch.bfloat16)
        saved = (qc.quant_pack.launches, qc.unpack_dequant.launches)
        ms_q = cuda_ms(torch, lambda: qc.quant_pack(x, bits, ft, fw, 5), reps=20, backlog=True)
        w, sc, rm = qc.quant_pack(x, bits, ft, fw, 5)
        ms_u = cuda_ms(torch, lambda: qc.unpack_dequant(w, sc, rm, bits, ft, fw, f), reps=20,
                       backlog=True)
        qc.quant_pack.launches, qc.unpack_dequant.launches = saved
        clock_now = sm_clock_mhz()[0]
        plain_q = cuda_ms(torch, lambda: qc._quant_pack_torch(x, bits, ft, fw, 5), reps=3, warmup=1)
        plain_u = cuda_ms(torch, lambda: qc.dequantize_words(w, sc, rm, bits, ft, fw, f),
                          reps=3, warmup=1)
        # quant_pack reads only the first fw columns of each row
        bytes_q = lanes * fw * 2 + lanes * wpr * 4 + 8 * lanes
        bytes_u = lanes * wpr * 4 + 8 * lanes + lanes * f * 4
        bounds = []
        # elements: quant_pack codes the wire's fw columns, unpack_dequant
        # dequantizes the f_true true ones
        for nbytes, counts, elems in (
                (bytes_q, sass["pack"][0], lanes * fw),
                (bytes_u, sass["unpack"][0], lanes * ft)):
            b_ms = nbytes / PEAK_BYTES_S * 1e3
            o_ms, pipe = ops_ms(counts, elems, clock[1])
            bounds.append((max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", b_ms,
                           o_ms, pipe))
        (bq, byq, bqb, bqo, pq), (bu, byu, bub, buo, pu) = bounds
        say(f"[time] {card} | quant_pack N={lanes} F={f} f_true={ft} 8 bits bf16: kernel {ms_q:.4f} ms; "
            f"bound {bq:.4f} ms by {byq} (bytes {bqb:.4f} ms, {bytes_q / 1e6:.1f} MB; operations "
            f"{bqo:.4f} ms on the {pq} pipe, {lanes * fw} elements at {clock[1]:g} MHz; SM clock "
            f"{clock_now:g} MHz after the runs); plain {plain_q:.3f} ms; library none")
        say(f"[time] {card} | unpack_dequant N={lanes} F={f}: kernel {ms_u:.4f} ms; bound "
            f"{bu:.4f} ms by {byu} "
            f"(bytes {bub:.4f} ms, {bytes_u / 1e6:.1f} MB; operations {buo:.4f} ms on the {pu} "
            f"pipe); plain {plain_u:.3f} ms; library none")
        rows[f] = (dict(ms=ms_q, plain_ms=plain_q, bound_ms=bq, bound_by=byq, library_ms=None),
                   dict(ms=ms_u, plain_ms=plain_u, bound_ms=bu, bound_by=byu, library_ms=None))
    return rows


# ---------------------------------------------------------------------------
# the padded dense wire (wire_impl=padded) and the breakdown probe
# ---------------------------------------------------------------------------


def phase_pad(torch, seed):
    """quant_rows and dequant_rows against their plain versions on the card,
    bit for bit: bits 2/4/8, f32 and bf16 rows, row counts that are no
    multiple of the TPU kernel's 256, f_true < F, a constant row, no rows;
    and the round trip within one step."""
    from adaqp_tpu_torch.ops import quant_cuda as qc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst_q = worst_d = 0.0  # max |kernel - plain|: codes, scale, rmin; rows
    cases = 0
    for bits in (2, 4, 8):
        for f, ft in ((640, 602), (256, 256), (18, 17)):
            for dtype in (torch.float32, torch.bfloat16):
                for n in (0, 1, 33, 25_700):
                    x = torch.randn(n, f, generator=gen, device="cuda")
                    x = (x * torch.rand(n, 1, generator=gen, device="cuda") * 4).to(dtype)
                    x[:, ft:] = 0
                    if n > 1:
                        x[1, :] = 0.5  # a constant row: all codes 0
                    key = qc.stream_key(seed, bits, f, n, 7)
                    saved = (qc.quant_rows.launches, qc.dequant_rows.launches)
                    q, sc, rm = qc.quant_rows(x, bits, ft, key)
                    y = qc.dequant_rows(q, sc, rm)
                    torch.cuda.synchronize()
                    launched = (qc.quant_rows.launches - saved[0],
                                qc.dequant_rows.launches - saved[1])
                    qc.quant_rows.launches, qc.dequant_rows.launches = saved
                    check(launched == ((0, 0) if n == 0 else (1, 1)), f"launches {launched} for N={n}")
                    q0, sc0, rm0 = qc._quant_rows_torch(x, bits, ft, key)
                    y0 = qc._dequant_rows_torch(q0, sc0, rm0)
                    tag = f"bits={bits} F={f} f_true={ft} {str(dtype)[6:]} N={n}"
                    check(q.shape == (n, f) and q.dtype == torch.uint8 and y.shape == (n, f),
                          f"{tag}: shapes")
                    if n:
                        worst_q = max(worst_q, float((q.int() - q0.int()).abs().max()),
                                      float((sc - sc0).abs().max()), float((rm - rm0).abs().max()))
                        worst_d = max(worst_d, float((y - y0).abs().max()))
                    check(torch.equal(q, q0), f"{tag}: codes differ from the plain version")
                    check(torch.equal(sc, sc0) and torch.equal(rm, rm0), f"{tag}: scale/rmin differ")
                    check(torch.equal(y, y0), f"{tag}: dequantized rows differ")
                    if n > 1:
                        check(not q[1].any() and bool((y[1, :ft] == 0.5).all()),
                              f"{tag}: the constant row did not round-trip")
                    if n:
                        err = (y[:, :ft] - x[:, :ft].float()).abs()
                        step = (1.0 / sc)[:, None]
                        check(bool((err <= step * (1 + 1e-3) + 1e-6).all()),
                              f"{tag}: a round-trip error exceeds one step")
                    cases += 1
    say(f"[pad] {cases} cases (bits 2/4/8, F 640/256/18, f32/bf16, N 0/1/33/25,700, a constant "
        f"row): kernels equal the plain versions bit for bit (max |difference| quant_rows "
        f"{worst_q:g}, dequant_rows {worst_d:g}); round trip within one step")
    return worst_q, worst_d


def phase_e2e_pad(torch, seed):
    """e2e_k on the padded wire: K=2 SBM, f32, two ranks on the card over
    gloo against the same ranks on the CPU, Vanilla and AdaQP (uniform 8
    bits), the breakdown probe on. The counter generator draws the same
    codes on both devices."""
    import numpy as np

    from adaqp_tpu_torch.comm.distributed import spawn

    runs = {}
    for device in ("cuda", "cpu"):
        configs = [{
            "num_parts": 2, "mode": mode, "assign_scheme": "uniform", "assign_bits": 8,
            "wire_impl": "padded", "num_epochs": 6, "hidden_dim": 32, "dropout_rate": 0.0,
            "log_steps": 100, "block_min_edges": 1, "logger_level": "WARNING",
            "synth_kwargs": {"n": 1200, "blocks": 4, "num_feats": 16, "seed": seed},
            "partition_dir": os.path.join(WORK, f"e2ek_parts_{device}"),
            "exp_path": os.path.join(WORK, "e2epad_exp"),
        } for mode in ("Vanilla", "AdaQP")]
        res = spawn(_e2e_worker, 2, device, args=(configs,),
                    workdir=os.path.join(WORK, "launch"), timeout_s=180)
        for i, mode in enumerate(("Vanilla", "AdaQP")):
            curves = [np.asarray(r[i]) for r in res]
            check(np.array_equal(curves[0], curves[1]), f"{device} {mode}: ranks disagree on the loss")
            runs[(device, mode)] = curves[0]
    tol = 1e-5  # the e2e_k limit: the same codes, f32 sums in another order
    for mode in ("Vanilla", "AdaQP"):
        card, cpu = runs[("cuda", mode)], runs[("cpu", mode)]
        rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        say(f"[e2e_pad] K=2 f32 SBM-1200 {mode} wire_impl=padded: card losses "
            f"{np.round(card, 5).tolist()}")
        say(f"[e2e_pad] {mode}: max relative difference to the CPU run {rel:.2e} (limit {tol:g})")
        check(np.isfinite(card).all() and card[-1] < card[0], f"{mode}: the loss did not fall")
        check(rel <= tol, f"{mode}: card and CPU K=2 padded runs disagree")


def phase_train_pad(torch, args, k4):
    """The Reddit-width GCN at K=4 on one card (four ranks over gloo) in
    mode AdaQP with the adaptive scheme on the padded wire, the breakdown
    probe on: its launches are planned on top of training's."""
    import functools

    import numpy as np

    from adaqp_tpu_torch.__main__ import config_from_args, parse_args
    from adaqp_tpu_torch.comm.distributed import spawn
    from adaqp_tpu_torch.helper.dataset import REDDIT_C, REDDIT_E, REDDIT_F, REDDIT_N, synth_reddit

    n = args.nodes_k
    e = n * round(REDDIT_E / REDDIT_N)
    epochs = args.epochs_pad
    graph_fn = functools.partial(synth_reddit, n, e, REDDIT_F, REDDIT_C, seed=SEED, device="cuda")
    cfg = config_from_args(parse_args([
        "--dataset", "reddit", "--num_parts", "4", "--mode", "AdaQP",
        "--assign_scheme", "adaptive", "--num_epochs", str(epochs), "--wire_impl", "padded",
        "--agg_dtype", "bfloat16", "--seed", str(SEED),
        "--exp_path", os.path.join(WORK, "k4pad_exp"),
    ]))
    cfg.assign_cycle, cfg.log_steps = 5, 1
    cfg.partition_dir = os.path.join(WORK, "k4_parts")  # train_k's caches, when it ran
    check((cfg.num_layers, cfg.hidden_dim, cfg.dropout_rate, cfg.use_norm, cfg.learning_rate,
           cfg.measure_breakdown) == (3, 256, 0.5, True, 0.01, True),
          "reddit.yaml no longer holds the Reddit GCN settings, or the probe is off")
    t0 = time.perf_counter()
    res = spawn(_train_k_worker, 4, "cuda", args=(cfg, graph_fn, True),
                workdir=os.path.join(WORK, "launch"), timeout_s=480)
    wall = time.perf_counter() - t0
    r0 = res[0]
    l_max, r_pad, s_pad, nloc = r0["layout"]
    say(f"[train_pad] AdaQP adaptive, wire_impl=padded: {n} nodes, {e} edges, K=4 on one card "
        f"over gloo; partitions {nloc}, l_max {l_max}, r_pad {r_pad}, s_pad {s_pad}; "
        f"launch + set-up + probe + {epochs} epochs {wall:.1f} s")
    losses = np.asarray(r0["loss_curve"])
    for i, loss in enumerate(losses, 1):
        ms = [r["epoch_times"][i - 1] * 1e3 for r in res]
        say(f"[train_pad] epoch {i}: loss {loss:.5f} (step {min(ms):.0f}-{max(ms):.0f} ms over ranks)")
    for r in res[1:]:
        check(np.array_equal(np.asarray(r["loss_curve"]), losses), "ranks disagree on the loss")
    check(np.isfinite(losses).all() and losses[-1] < losses[0], "the loss did not fall")
    per_epoch_strip = 6 * r0["layers"] - 2
    for rank, r in enumerate(res):
        strip, qp, ud = r["launches"]
        qr, dr = r["pad_launches"]
        probe = r["probe"]
        want_strip = per_epoch_strip * epochs + probe["strip_spmm"]
        want_q = r["planned"][0] + probe["quant_rows"]
        want_d = r["planned"][1] + probe["dequant_rows"]
        say(f"[train_pad] rank {rank}: launches strip {strip} (training {per_epoch_strip * epochs} "
            f"+ probe {probe['strip_spmm']}), quant_rows {qr} and dequant_rows {dr} (the buckets "
            f"imply {r['planned'][0]} and {r['planned'][1]}, + probe {probe['quant_rows']} and "
            f"{probe['dequant_rows']}); peak max_memory_allocated {r['peak_gib']:.2f} GiB; median "
            f"step {r['per_epoch'] * 1e3:.1f} ms")
        check(strip == want_strip, f"rank {rank}: strip launch count is off")
        check(qr > 0 and (qr, dr) == (want_q, want_d),
              f"rank {rank}: quant_rows/dequant_rows launches differ from the plan + probe")
        check((qp, ud) == (0, 0), f"rank {rank}: the padded run launched a ragged-wire kernel")
    say(f"[train_pad] parameters bit-identical across ranks (all-gathered; sum {r0['checksum']!r})")
    want = [ep for ep in range(2, epochs + 1) if ep % cfg.assign_cycle == 1]
    check(want and [h[0] for h in r0["hist"]] == want,
          f"reassignments at epochs {[h[0] for h in r0['hist']]}, expected {want}")
    for epoch, h in r0["hist"]:
        say(f"[train_pad] assignment at epoch {epoch}, lanes per width (fwd layers 0-2, bwd "
            f"layers 1-2): {h}")
    say(f"[train_pad] layer-0 buckets after the last assignment (bits, K*cap lanes): {r0['pad_shapes']}")
    _say_volume("train_pad", r0)
    _say_split("train_pad", r0["split"])
    csv = np.genfromtxt(r0["csv"], delimiter=",", names=True)
    check(list(csv["Worker"]) == [0, 1, 2, 3], "the time CSV lacks a rank's row")
    for b in ("Comm", "Quant", "Central", "Marginal"):
        say(f"[train_pad] breakdown {b} per rank (s): {[float(x) for x in csv[b]]}")
        check(bool((csv[b] > 0).all()), f"the time CSV's {b} bucket is zero")
    steps = f"padded AdaQP {r0['per_epoch'] * 1e3:.1f} ms"
    if k4 is not None:
        steps += (f"; ragged AdaQP {k4['AdaQP'][0]['per_epoch'] * 1e3:.1f} ms, ragged Vanilla "
                  f"{k4['Vanilla'][0]['per_epoch'] * 1e3:.1f} ms (train_k)")
    say(f"[train_pad] median step (rank 0): {steps}")
    return res


def phase_time_pad(torch, card, res):
    """quant_rows and dequant_rows at every shape train_pad gave them (each
    rank's buckets under each assignment, forward and backward, and the
    probe's), held against their plain versions bit for bit; then timed at
    the largest layer-0 bucket: bf16 rows of 640 columns with 602 true, and
    the codes of the wire's 604 columns back. Returns the two kernels' time
    rows and their max |kernel - plain| (codes, scale, rmin; rows)."""
    from adaqp_tpu_torch.ops import quant_cuda as qc
    from adaqp_tpu_torch.ops.quant import pad_features

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = sorted({tuple(c) for r in res for c in r["pad_cases"]})
    saved = (qc.quant_rows.launches, qc.dequant_rows.launches)
    worst_q = worst_d = 0.0
    inputs = {}  # the forward's bf16 rows at each (bits, N, F)
    for bits, n, f, ft, dt in cases:
        x = torch.randn(n, f, generator=gen, device="cuda").to(getattr(torch, dt))
        fw = pad_features(ft)
        q, sc, rm = qc.quant_rows(x, bits, ft, 5)
        q0, sc0, rm0 = qc._quant_rows_torch(x, bits, ft, 5)
        # the receiver's form: the wire's columns, the pair through bf16
        p = torch.stack([sc, rm], dim=-1).to(torch.bfloat16).float()
        qw, pscale, prmin = q[:, :fw].contiguous(), p[:, 0].contiguous(), p[:, 1].contiguous()
        y, y0 = qc.dequant_rows(qw, pscale, prmin), qc._dequant_rows_torch(qw, pscale, prmin)
        tag = f"bits={bits} N={n} F={f} f_true={ft} {dt}"
        worst_q = max(worst_q, float((q.int() - q0.int()).abs().max()),
                      float((sc - sc0).abs().max()), float((rm - rm0).abs().max()))
        worst_d = max(worst_d, float((y - y0).abs().max()))
        check(torch.equal(q, q0) and torch.equal(sc, sc0) and torch.equal(rm, rm0),
              f"{tag}: quant_rows differs from the plain version")
        check(torch.equal(y, y0), f"{tag}: dequant_rows differs from the plain version")
        if dt == "bfloat16":
            inputs[(bits, n, f)] = (x, qw, pscale, prmin)
    say(f"[time] quant_rows and dequant_rows equal their plain versions bit for bit at all "
        f"{len(cases)} shapes train_pad gave them (bits, K*cap or K*s_pad rows, F, f_true, dtype): "
        f"{cases}")
    # the largest layer-0 bucket of training (the probe's rows aside)
    bits, n = max(res[0]["pad_shapes"], key=lambda s: s[1])
    f, ft, fw = 640, 602, pad_features(602)
    x, qw, sc, rm = inputs[(bits, n, f)]
    ms_q = cuda_ms(torch, lambda: qc.quant_rows(x, bits, ft, 5), reps=20, backlog=True)
    ms_d = cuda_ms(torch, lambda: qc.dequant_rows(qw, sc, rm), reps=20, backlog=True)
    qc.quant_rows.launches, qc.dequant_rows.launches = saved
    plain_q = cuda_ms(torch, lambda: qc._quant_rows_torch(x, bits, ft, 5), reps=3, warmup=1)
    plain_d = cuda_ms(torch, lambda: qc._dequant_rows_torch(qw, sc, rm), reps=3, warmup=1)
    # one library call computes rmin + q / scale (the port never calls it)
    lib_d = cuda_ms(torch, lambda: torch.addcdiv(rm[:, None], qw, sc[:, None]), reps=20,
                    backlog=True)
    lib_err = float((torch.addcdiv(rm[:, None], qw, sc[:, None])
                     - qc._dequant_rows_torch(qw, sc, rm)).abs().max())
    bytes_q = n * f * 2 + n * f + 8 * n
    bytes_d = n * fw + 8 * n + 4 * n * fw
    bq, bd = bytes_q / PEAK_BYTES_S * 1e3, bytes_d / PEAK_BYTES_S * 1e3
    say(f"[time] {card} | quant_rows N={n} F={f} f_true={ft} {bits} bits bf16: kernel {ms_q:.4f} ms; "
        f"bound {bq:.4f} ms by bytes ({bytes_q / 1e6:.1f} MB); plain {plain_q:.3f} ms; library none")
    say(f"[time] {card} | dequant_rows N={n} F={fw}: kernel {ms_d:.4f} ms; bound {bd:.4f} ms by "
        f"bytes ({bytes_d / 1e6:.1f} MB); plain {plain_d:.3f} ms; torch.addcdiv {lib_d:.4f} ms "
        f"(max |addcdiv - plain| {lib_err:g})")
    return ((dict(ms=ms_q, plain_ms=plain_q, bound_ms=bq, bound_by="bytes", library_ms=None),
             dict(ms=ms_d, plain_ms=plain_d, bound_ms=bd, bound_by="bytes", library_ms=lib_d)),
            (worst_q, worst_d))


# ---------------------------------------------------------------------------
# the block, compact and segment aggregations (spmm_impl=block|compact|segment)
# ---------------------------------------------------------------------------

# ogbn-products (OGB): 2,449,029 nodes, 123,718,280 directed edges with
# self-loops, 100 features, 47 classes
PRODUCTS_N, PRODUCTS_E, PRODUCTS_F, PRODUCTS_C = 2_449_029, 123_718_280, 100, 47
TILE_KERNELS = ("strip_spmm", "block_spmm", "compact_spmm")
# each impl's first-layer width (its feature padding of the 100 features)
LAYER0_F = {"strip": 128, "block": 128, "compact": 384, "segment": 100}


def _wrappers():
    """name -> kernel wrapper of every aggregation kernel."""
    from adaqp_tpu_torch.ops import spmm_block as sb
    from adaqp_tpu_torch.ops import spmm_compact as sc
    from adaqp_tpu_torch.ops import spmm_strip as ss

    return {"strip_spmm": ss.strip_spmm, "block_spmm": sb.block_spmm,
            "compact_spmm": sc.compact_spmm, "gather_rows": sc.gather_rows}


def _tile_kernels():
    """spmm_impl -> (kernel name, wrapper, plain version) of each tile path."""
    from adaqp_tpu_torch.ops import spmm_block as sb
    from adaqp_tpu_torch.ops import spmm_compact as sc
    from adaqp_tpu_torch.ops import spmm_strip as ss

    return {"strip": ("strip_spmm", ss.strip_spmm, ss._run_strip_torch),
            "block": ("block_spmm", sb.block_spmm, sb._run_block_torch),
            "compact": ("compact_spmm", sc.compact_spmm, sc._run_compact_torch)}


def _tiered_edges(rng, n, n_src, e):
    """Edges that give a compact layout all three tiers: dense regions on
    the diagonal windows of the first half of the rows (full tiles), a hot
    set of 1,500 source columns there too (compact subtiles, several to a
    region), and a sprinkle over the second half (the ELL tail)."""
    import numpy as np

    d1 = rng.integers(0, n // 2, e)
    s1 = np.minimum((d1 // 2048) * 2048 + rng.integers(0, 2048, e), n_src - 1)
    d2 = rng.integers(0, n // 2, e // 2)
    hot = rng.integers(0, n_src, 1500)
    s2 = hot[rng.integers(0, 1500, e // 2)]
    d3 = rng.integers(n // 2, n, e // 40)
    s3 = rng.integers(0, n_src, e // 40)
    return (np.concatenate([s1, s2, s3]).astype(np.int32),
            np.concatenate([d1, d2, d3]).astype(np.int32))


def _tolerance(torch, dtype):
    return (BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16 else (F32_ATOL, F32_RTOL)


def _hold(torch, gen, tag, wrapper, plain, lay, f, dtype, phase):
    """Run ``wrapper`` (one launch, not counted) and ``plain`` on the same
    random ``h``; fail unless they agree within the dtype's tolerance."""
    h = torch.randn(lay.n_src_pad, f, generator=gen, device="cuda").to(dtype)
    saved = wrapper.launches
    got = wrapper(lay, h)
    torch.cuda.synchronize()
    check(wrapper.launches == saved + 1, f"{tag}: the kernel did not launch")
    wrapper.launches = saved
    want = plain(lay, h)
    atol, rtol = _tolerance(torch, dtype)
    err, ratio = compare(torch, got, want, atol, rtol)
    say(f"[{phase}] {tag} F={f} {str(dtype)[6:]}: max |kernel - plain| {err:.3g}, "
        f"{ratio:.3f} of the tolerance ({atol:g} + {rtol:g} |plain|)")
    check(got.dtype == dtype and got.shape == want.shape, f"{tag}: dtype or shape")
    check(ratio <= 1.0, f"{tag} F={f}: kernel disagrees with the plain version")
    return got, err


def _hold_backward(torch, gen, tag, spmm, plain, fwd, rev, f, phase):
    """The autograd function (kernel forward and, on the reverse layout,
    kernel backward) against autograd through the plain version; bf16."""
    h0 = torch.randn(fwd.n_src_pad, f, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(fwd.n_pad, f, generator=gen, device="cuda")
    hk = h0.clone().requires_grad_()
    (spmm(fwd, hk, rev).float() * g).sum().backward()
    hp = h0.clone().requires_grad_()
    (plain(fwd, hp.float()).to(torch.bfloat16).float() * g).sum().backward()
    torch.cuda.synchronize()
    err, ratio = compare(torch, hk.grad, hp.grad, BF16_ATOL, BF16_RTOL)
    say(f"[{phase}] {tag} backward F={f}: max |grad - plain autograd grad| {err:.3g}, "
        f"{ratio:.3f} of the tolerance")
    check(hk.grad.dtype == torch.bfloat16, f"{tag}: backward did not return the primal dtype")
    check(ratio <= 1.0, f"{tag}: backward disagrees with the plain version's autograd")


def phase_agg(torch, seed):
    """block_spmm, compact_spmm and gather_rows against their plain versions
    on small layouts of every shape the paths give them: square forward and
    reverse, rectangular (halo-shaped), empty; a compact layout with full
    tiles, subtile groups and an ELL tail, and one of groups only; bf16 and
    f32; and each through its autograd backward."""
    import numpy as np

    from adaqp_tpu_torch.ops import spmm_block as sb
    from adaqp_tpu_torch.ops import spmm_compact as sc

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, n_src = 8192, 6144
    src, dst = _tiered_edges(rng, n, n, 150_000)
    rs, rd = _tiered_edges(rng, 4096, n_src, 60_000)
    e0 = np.zeros(0, np.int32)
    errs = {"block_spmm": 0.0, "compact_spmm": 0.0, "gather_rows": 0.0}

    def cases(name, wrapper, plain, lays):
        for tag, lay in lays:
            for dtype in (torch.bfloat16, torch.float32):
                for f in (128, 384):
                    out, err = _hold(torch, gen, f"{name} {tag}", wrapper, plain, lay, f,
                                     dtype, "agg")
                    errs[name] = max(errs[name], err)
                    if tag.startswith("empty"):
                        check(not out.any(), f"{name} {tag}: the empty layout did not give zeros")

    block = [
        ("forward", sb.block_layout(src, dst, n, min_edges=64)),
        ("reverse", sb.block_layout(dst, src, n, min_edges=64)),
        (f"rectangular 4096x{n_src}", sb.block_layout(rs, rd, 4096, min_edges=64, n_src=n_src)),
        ("empty 2048x4096", sb.block_layout(e0, e0, 2048, n_src=4096)),
    ]
    check(block[2][1].masks.any(), "the rectangular block layout has no set bit")
    cases("block_spmm", sb.block_spmm, sb._run_block_torch,
          [(t, lay.to_device("cuda")) for t, lay in block])

    tiers = sc.compact_layout(src, dst, n)
    kinds = np.bincount(tiers.kind[tiers.masks.reshape(len(tiers.kind), -1).any(1)], minlength=2)
    say(f"[agg] compact three-tier layout: {kinds[0]} full items, {kinds[1]} groups, "
        f"ELL tail {tiers.straggler is not None}; subtile slots used "
        f"{np.bincount(tiers.nsub[tiers.kind == 1], minlength=9)[1:].tolist()}")
    check(kinds[0] > 0 and kinds[1] > 0 and tiers.straggler is not None,
          "the compact layout lacks a tier")
    shared = sum(len(set(d[:k])) < k for d, k in zip(tiers.dst_off[tiers.kind == 1],
                                                      tiers.nsub[tiers.kind == 1]))
    check(shared > 0, "no compact group holds two subtiles with one target")
    groups = sc.compact_layout(src, dst, n, full_cols=2048)
    check(not groups.masks[groups.kind == 0].any(), "the all-groups layout holds a full tile")
    rect = sc.compact_layout(rs, rd, 4096, n_src=n_src)
    check((rect.kind == 1).any(), "the rectangular compact layout holds no group")
    cases("compact_spmm", sc.compact_spmm, sc._run_compact_torch, [
        ("three-tier", tiers.to_device("cuda")),
        ("all groups (full_cols 2048)", groups.to_device("cuda")),
        (f"rectangular 4096x{n_src}", rect.to_device("cuda")),
        ("empty 2048x4096", sc.compact_layout(e0, e0, 2048, n_src=4096).to_device("cuda")),
    ])

    # backward: the tile parts only (no ELL edges), summed in f32 by both
    fwd = sb.block_layout(src, dst, n, min_edges=1).to_device("cuda")
    rev = sb.block_layout(dst, src, n, min_edges=1).to_device("cuda")
    check(fwd.straggler is None and rev.straggler is None, "backward layouts have ELL edges")
    _hold_backward(torch, gen, "spmm_block", sb.spmm_block, sb._run_block_torch, fwd, rev, 256,
                   "agg")
    fwd = sc.compact_layout(src, dst, n, me_ell=1).to_device("cuda")
    rev = sc.compact_layout(dst, src, n, me_ell=1).to_device("cuda")
    check(fwd.straggler is None and rev.straggler is None, "backward layouts have ELL edges")
    _hold_backward(torch, gen, "spmm_compact", sc.spmm_compact, sc._run_compact_torch, fwd, rev,
                   256, "agg")

    # the row gather, bit for bit, at the probe's shape and a ragged one
    for r, c in ((2048, 128), (1000, 37)):
        x = torch.randn(r, c, generator=gen, device="cuda")
        idx = torch.randint(0, r, (r, c), generator=gen, device="cuda", dtype=torch.int32)
        saved = sc.gather_rows.launches
        got = sc.gather_rows(x, idx)
        torch.cuda.synchronize()
        check(sc.gather_rows.launches == saved + 1, "gather_rows did not launch")
        sc.gather_rows.launches = saved
        want = torch.take_along_dim(x, idx.long(), dim=0)
        errs["gather_rows"] = max(errs["gather_rows"], float((got - want).abs().max()))
        say(f"[agg] gather_rows [{r}, {c}]: max |kernel - take_along_dim| "
            f"{float((got - want).abs().max()):g}")
        check(torch.equal(got, want), "gather_rows differs from torch.take_along_dim")
    return errs


def phase_e2e_agg(torch, seed):
    """K=2 on the SBM, f32, Vanilla, for block, compact and segment: two
    ranks on the card over gloo against the same ranks on the CPU."""
    import numpy as np

    from adaqp_tpu_torch.comm.distributed import spawn

    impls = ("block", "compact", "segment")
    runs = {}
    for device in ("cuda", "cpu"):
        configs = [{
            "num_parts": 2, "mode": "Vanilla", "spmm_impl": impl, "num_epochs": 6,
            "hidden_dim": 32, "dropout_rate": 0.0, "log_steps": 100, "block_min_edges": 64,
            "compact_me_ell": 16, "logger_level": "WARNING",
            "synth_kwargs": {"n": 1200, "blocks": 4, "num_feats": 16, "seed": seed},
            "partition_dir": os.path.join(WORK, f"e2eagg_parts_{device}"),
            "exp_path": os.path.join(WORK, "e2eagg_exp"),
        } for impl in impls]
        res = spawn(_e2e_worker, 2, device, args=(configs,),
                    workdir=os.path.join(WORK, "launch"), timeout_s=240)
        for i, impl in enumerate(impls):
            curves = [np.asarray(r[i]) for r in res]
            check(np.array_equal(curves[0], curves[1]), f"{device} {impl}: ranks disagree on the loss")
            runs[(device, impl)] = curves[0]
    tol = 1e-5  # the e2e_k limit: f32 sums in another order, nothing more
    for impl in impls:
        card, cpu = runs[("cuda", impl)], runs[("cpu", impl)]
        rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        say(f"[e2e_agg] K=2 f32 SBM-1200 Vanilla spmm_impl={impl}: card losses "
            f"{np.round(card, 5).tolist()}")
        say(f"[e2e_agg] {impl}: max relative difference to the CPU run {rel:.2e} (limit {tol:g})")
        check(np.isfinite(card).all() and card[-1] < card[0], f"{impl}: the loss did not fall")
        check(rel <= tol, f"{impl}: card and CPU K=2 runs disagree")


def _eval_loss(torch, t):
    """The training loss of the current parameters in evaluation mode (no
    dropout), without a step."""
    from adaqp_tpu_torch.model.gnn import apply_gnn
    from adaqp_tpu_torch.model.loss import masked_loss_sum

    with torch.no_grad():
        logits, _ = apply_gnn(t.params, t.sh, t.static, False, t.blocks)
        loss = masked_loss_sum(logits, t.sh.labels, t.sh.train_mask, t.static.multilabel)
    return float(loss) / t.train_count


def _ell_edges(lay):
    if lay.straggler is None:
        return 0
    return sum(int(lens[rows < lay.straggler.n].sum()) for _, rows, _, lens in lay.straggler.buckets)


def phase_train_agg(torch, args):
    """The ogbn-products-width GCN (100 -> 256 -> 256 -> 47, 3 layers, bf16
    aggregation, LayerNorm, dropout 0.5, Adam lr 0.01) at K=1 through each
    aggregation in turn, from the same initial parameters: strip, block,
    compact, segment. Each run is the Trainer's construction and training;
    the launch counts of that window must be what the path implies. After
    each run its kernel is held against its plain version on the run's own
    layouts at the path's widths."""
    import dataclasses

    import numpy as np

    from adaqp_tpu_torch.helper.dataset import synth_reddit
    from adaqp_tpu_torch.ops import spmm_compact as sc
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    n = args.nodes_agg
    e = round(n * PRODUCTS_E / PRODUCTS_N)
    t0 = time.perf_counter()
    g = synth_reddit(n, e, PRODUCTS_F, PRODUCTS_C, seed=SEED, device="cuda")
    say(f"[train_agg] products-degree banded graph: {n} nodes, {e} unique directed edges "
        f"(mean degree {e / n:.2f}), {PRODUCTS_F} features, {PRODUCTS_C} classes: "
        f"{time.perf_counter() - t0:.1f} s")
    base = RunConfig.from_yaml("ogbn-products", {
        "num_parts": 1, "mode": "Vanilla", "num_epochs": args.epochs_agg, "log_steps": 1,
        "partition_dir": os.path.join(WORK, "agg_parts"), "exp_path": os.path.join(WORK, "agg_exp"),
        "seed": SEED, "logger_level": "WARNING", "measure_breakdown": False,
    })
    check((base.num_layers, base.hidden_dim, base.dropout_rate, base.use_norm,
           base.learning_rate, base.agg_dtype) == (3, 256, 0.5, True, 0.01, "bfloat16"),
          "ogbn-products.yaml no longer holds the products GCN settings")
    wrappers = _wrappers()
    tiles = _tile_kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    init, out = None, {}
    for impl in ("strip", "block", "compact", "segment"):
        cfg = dataclasses.replace(base, spmm_impl=impl)
        # the main path: the Trainer's construction (the compact gate probes
        # the row gather once a process) and its training
        sc.dynamic_gather_supported.cache_clear()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        t = Trainer(cfg, graph=g)
        setup_s = time.perf_counter() - t0
        params = [{k: v.detach().cpu().numpy().copy() for k, v in layer.items()}
                  for layer in t.params]
        if init is None:
            init = params
        # one set of initial parameters: the first weight's rows past the
        # 100 features are zero-padded or cut to this run's f_pad
        w0 = np.zeros_like(params[0]["w"])
        rows = min(len(w0), len(init[0]["w"]))
        w0[:rows] = init[0]["w"][:rows]
        t.load_params([{**init[0], "w": w0}] + init[1:])
        saved = {k: w.launches for k, w in wrappers.items()}
        loss0 = _eval_loss(torch, t)
        for k, w in wrappers.items():
            w.launches = saved[k]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = t.train()
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        losses = rec["loss_curve"]
        fl = t.blocks.devices()[0] if t.blocks is not None else None
        ell = _ell_edges(fl) if fl is not None else 0
        say(f"[train_agg] {impl}: set-up {setup_s:.1f} s, f_pad {t.static.f_pad}, eval loss "
            f"before a step {loss0:.6f}; losses {np.round(losses, 4).tolist()}")
        say(f"[train_agg] {impl}: median step {rec['per_epoch'] * 1e3:.2f} ms; peak "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {launches} (planned tile launches {rec['planned_tile_launches']})")
        if fl is not None:
            units = t.blocks.counts[0][0]
            say(f"[train_agg] {impl}: forward local layout {units} "
                f"{'items' if impl == 'compact' else 'tiles'}, ELL edges {ell} "
                f"({100 * ell / e:.2f}% of the edges)")
        check(np.isfinite(losses).all() and losses[-1] < losses[0], f"{impl}: the loss did not fall")
        for k in TILE_KERNELS:
            want = rec["planned_tile_launches"] if impl in tiles and k == tiles[impl][0] else 0
            check(launches[k] == want, f"{impl}: {k} launched {launches[k]} times, expected {want}")
        check(impl == "segment" or rec["planned_tile_launches"] > 0, f"{impl}: no tile launch planned")
        check(launches["gather_rows"] == (1 if impl == "compact" else 0),
              f"{impl}: gather_rows launched {launches['gather_rows']} times")
        if args.profile:
            phase_profile(torch, t, tag=f"train_agg {impl} profile")
        res = {"loss0": loss0, "launches": launches, "step_ms": rec["per_epoch"] * 1e3}
        if impl == "compact":
            t_items = int(fl.item_ptr[-1])
            kinds = torch.bincount(fl.kind[:t_items].long(), minlength=2).tolist()
            say(f"[train_agg] compact forward local: {kinds[0]} full items, {kinds[1]} groups "
                f"(fill {float(fl.nsub[:t_items][fl.kind[:t_items] == 1].float().mean()):.2f} "
                f"of 8 slots)")
            check(kinds[0] > 0 and kinds[1] > 0 and ell > 0,
                  "the products compact layout lacks a tier")
        if fl is not None:
            # the kernel against its plain version on this run's layouts
            bl = t.blocks.devices()[1]
            name, wrapper, plain = tiles[impl]
            _, res["err"] = _hold(torch, gen, f"{name} forward local", wrapper, plain, fl,
                                  LAYER0_F[impl], torch.bfloat16, "train_agg")
            _hold(torch, gen, f"{name} forward local", wrapper, plain, fl, 256,
                  torch.bfloat16, "train_agg")
            _hold(torch, gen, f"{name} reverse local", wrapper, plain, bl, 256,
                  torch.bfloat16, "train_agg")
            res["layout"] = fl
        out[impl] = res
        del t
        torch.cuda.empty_cache()
    l0 = {k: v["loss0"] for k, v in out.items()}
    rel = max(abs(v - l0["strip"]) / abs(l0["strip"]) for v in l0.values())
    say(f"[train_agg] eval loss before a step, same parameters: {l0}; largest relative "
        f"difference to strip {rel:.2e} (limit {AGG_LOSS0_RTOL:g})")
    check(rel <= AGG_LOSS0_RTOL, "the aggregations disagree on the same parameters")
    return out


def _layout_coo(torch, lay):
    """(dst, src) of the edges a tile layout's kernel part covers."""
    from adaqp_tpu_torch.ops import spmm_block as sb
    from adaqp_tpu_torch.ops import spmm_compact as sc

    dev = lay.masks.device
    if isinstance(lay, sc.CompactDevice):
        ptr = lay.item_ptr.long()
        starts = lay.src_start
    else:
        ptr = lay.blk_ptr.long()
        starts = lay.tile_src if hasattr(lay, "tile_src") else lay.src_start
    owner = torch.repeat_interleave(torch.arange(ptr.numel() - 1, device=dev), ptr.diff())
    rows, cols = [], []
    for s in range(0, owner.numel(), 64):
        e = min(s + 64, owner.numel())
        ti, r, v = sb.expand_masks(lay.masks[s:e]).nonzero(as_tuple=True)
        it = s + ti
        if isinstance(lay, sc.CompactDevice):
            grp = lay.kind[it] == 1
            col = torch.where(grp, lay.col_idx[it, v].long(), v)
            slot = torch.where(grp, v // sc.CSUB, 0)
            rows.append(owner[it] * sc.STRIP + lay.dst_off[it, slot].long() + r)
        else:
            col = v
            rows.append(owner[it] * sb.BD + r)
        cols.append(starts[it].long() + col)
    return torch.cat(rows), torch.cat(cols)


def phase_time_agg(torch, card, runs):
    """The three tile kernels on the products forward local layout at F=256
    and at each one's layer-0 width, and gather_rows at the probe's shape,
    each beside its bound, its plain version and a library call."""
    from adaqp_tpu_torch.ops import spmm_compact as sc

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    clock = sm_clock_mhz()
    for impl, (name, w, plain) in _tile_kernels().items():
        lay = runs[impl]["layout"]
        csr, nnz = tile_csr(torch, lay, torch.bfloat16)
        h_rows = int(torch.unique(csr.col_indices()).numel())
        for f in sorted({256, LAYER0_F[impl]}):
            h = torch.randn(lay.n_src_pad, f, generator=gen, device="cuda").to(torch.bfloat16)
            saved = w.launches
            ms = cuda_ms(torch, lambda: w(lay, h), reps=20)
            w.launches = saved
            plain_ms = cuda_ms(torch, lambda: plain(lay, h), reps=2, warmup=1)
            lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, h), reps=20)
            # each input once (masks, index arrays, the h rows the edges
            # read), the output once
            ptr = lay.item_ptr if impl == "compact" else lay.blk_ptr
            units = int(ptr[-1])
            idx_bytes = units * 4 + ptr.numel() * 4  # src_start, pointers
            if impl == "compact":  # kind, nsub, dst_off; col_idx of the groups
                groups = int((lay.kind[:units] == 1).sum())
                idx_bytes += units * (2 * 4 + 8 * 4) + groups * 2048 * 4
            nbytes = units * 256 * 128 * 2 + idx_bytes + h_rows * f * 2 + lay.n_pad * f * 2
            flops = 2.0 * nnz * f
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOP_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            say(f"[time] {card} | {name} products forward local F={f} bf16: {units} "
                f"{'items' if impl == 'compact' else 'tiles'}, {nnz} covered edges, "
                f"{h_rows} source rows read")
            say(f"[time] {card} | {name} F={f}: kernel {ms:.4f} ms; bound {bound_ms:.4f} ms by "
                f"{bound_by} ({nbytes / 1e9:.4f} GB, {flops / 1e12:.5f} TFLOP); plain "
                f"{plain_ms:.2f} ms; torch.sparse.mm {lib_ms:.4f} ms (bf16 CSR of the covered edges)")
            if impl == "strip":
                floor_ms, floor_bytes = strip_floor(lay, f, nnz, clock[1])
                say(f"[time] {card} | {name} F={f}: the design's shared-memory floor "
                    f"{floor_ms:.4f} ms ({floor_bytes / 1e9:.3f} GB at 132 x 128 B a clock, "
                    f"{clock[1]:g} MHz)")
            rows[(name, f)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=lib_ms)
        del csr
    x = torch.randn(2048, 128, generator=gen, device="cuda")
    i = torch.randint(0, 2048, (2048, 128), generator=gen, device="cuda", dtype=torch.int32)
    il = i.long()
    saved = sc.gather_rows.launches
    # the launch alone: the wrapper's index range check reads idx back
    ms = cuda_ms(torch, lambda: sc._launch_gather_rows(x, i), reps=20)
    sc.gather_rows.launches = saved
    plain_ms = cuda_ms(torch, lambda: torch.take_along_dim(x, il, dim=0), reps=20)
    nbytes = 3 * x.numel() * 4
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    say(f"[time] {card} | gather_rows [2048, 128] f32: kernel {ms:.4f} ms; bound {bound_ms:.5f} ms by bytes ({nbytes / 1e6:.2f} MB); "
        f"torch.take_along_dim {plain_ms:.4f} ms (the plain version and the library call)")
    rows[("gather_rows", 128)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by="bytes", library_ms=plain_ms)
    return rows


# ---------------------------------------------------------------------------
# the gather micro-benchmarks (scripts/microbench_dma_gather.py and
# scripts/microbench_gather.py)
# ---------------------------------------------------------------------------

# the f32 rate outside the tensor cores (window_gather's adds)
PEAK_F32_FLOP_S = 67e12


def _gather_wrappers():
    from adaqp_tpu_torch.scripts import microbench_dma_gather as dg
    from adaqp_tpu_torch.scripts import microbench_gather as gb

    return {"ring_gather": dg.ring_gather, "window_gather": gb.window_gather,
            "compact_item": gb.compact_item}


def _item_inputs(torch, rng, gen, fc):
    """mask int16 [256, 128] and col int32 [2048] drawn from ``rng`` as the
    script draws them, and bf16 win [2048, fc] from ``gen``, on the card."""
    import numpy as np

    from adaqp_tpu_torch.ops.spmm_compact import BD, BS, WORDS

    mask = torch.from_numpy(rng.integers(0, 1 << 16, (BD, WORDS)).astype(np.uint16).view(np.int16))
    col = torch.from_numpy(rng.integers(0, BS, BS).astype(np.int32))
    win = torch.randn(BS, fc, generator=gen, device="cuda").to(torch.bfloat16)
    return mask.cuda(), col.cuda(), win


def phase_gather(torch, seed):
    """The gather probes' kernels against their plain versions on the card:
    ring_gather bit for bit with h[idx] at every depth 1/4/8/16/32/64, in
    the many-block form and as one block over the stream, idx
    uniform, sorted, banded and rows 0 and N-1 alternating, bf16 and f32, F
    256 and 640, chunk 8 and 4,096, one to three passes, and an empty idx;
    window_gather bit for bit with its torch.gather loop over axis 0 and 1,
    full and 1-D index, f32 and bf16, a gather axis of 8 to 4,096, F 256
    and 640, 1/3/200 iterations; compact_item within 2^-7 |plain| + 1e-6
    at kind 0 and 1, fc 256/384/136, 1 and 200 iterations (kind 0's rows
    past 256 zero). Then both scripts' mains at their default sizes, with
    each kernel's launches checked against the plan. Returns each kernel's
    max |kernel - plain| and the mains' launches."""
    import numpy as np

    from adaqp_tpu_torch.scripts import microbench_dma_gather as dg
    from adaqp_tpu_torch.scripts import microbench_gather as gb

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: compact_item's plain version needs full f32 products")
    wrappers = _gather_wrappers()
    saved = {k: w.launches for k, w in wrappers.items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    errs = dict.fromkeys(wrappers, 0.0)

    def worst(name, got, want):
        errs[name] = max(errs[name], float((got.float() - want.float()).abs().max()))

    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for f in (256, 640):
            h = torch.randn(dg.N, f, generator=gen, device="cuda").to(dtype)
            for chunk in (8, dg.CHUNK):
                variants = dg.idx_variants(rng, dg.N, chunk)
                variants["ends"] = np.resize(np.array([0, dg.N - 1], np.int32), chunk)
                for vname, vi in variants.items():
                    i = torch.from_numpy(vi).cuda()
                    want = dg._ring_gather_torch(h, i)
                    for depth in (1, 4, 8, 16, 32, 64):
                        iters = 1 + depth % 3  # 1 to 3 passes: the ring wraps across them
                        for many in (True, False):  # many blocks; one over the stream
                            got = dg.ring_gather(h, i, iters, depth, many)
                            worst("ring_gather", got, want)
                            check(torch.equal(got, want), f"ring_gather {str(dtype)[6:]} F={f} "
                                  f"chunk={chunk} {vname} depth={depth} many_blocks={many}: "
                                  "differs from h[idx]")
                            cases += 1
    before = dg.ring_gather.launches
    got = dg.ring_gather(h, torch.empty(0, dtype=torch.int32, device="cuda"), 1, 4)
    check(got.shape == (0, h.shape[1]) and dg.ring_gather.launches == before,
          "ring_gather launched for an empty idx")
    say(f"[gather] ring_gather: {cases} cases equal h[idx] bit for bit; an empty idx launches "
        "nothing")

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for length in (8, 256, 1024, 2048, 4096):
            for f in (256, 640):
                for axis in (0, 1):
                    shape = (length, f) if axis == 0 else (f, length)
                    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                    full = torch.randint(0, length, shape, generator=gen, device="cuda",
                                         dtype=torch.int32)
                    col = torch.randint(0, length, (1, length), generator=gen, device="cuda",
                                        dtype=torch.int32)
                    for form, ii in (("full", full), ("1-D", col)):
                        for iters in (1, 3, 200):
                            got = gb.window_gather(x, ii, iters, axis)
                            want = gb._window_gather_torch(x, ii, iters, axis)
                            worst("window_gather", got, want)
                            check(torch.equal(got, want),
                                  f"window_gather {str(dtype)[6:]} {tuple(shape)} axis={axis} "
                                  f"{form} iters={iters}: differs from the torch.gather loop")
                            cases += 1
    say(f"[gather] window_gather: {cases} cases equal the torch.gather loop bit for bit")

    cases, ratio = 0, 0.0
    for fc in (256, 384, 136):
        mask, col, win = _item_inputs(torch, rng, gen, fc)
        for kind in (0, 1):
            for iters in (1, 200):
                got = gb.compact_item(mask, col, win, kind, iters)
                want = gb._compact_item_torch(mask, col, win, kind, iters)
                err, r = compare(torch, got, want, gb.ITEM_ATOL, gb.ITEM_RTOL)
                errs["compact_item"], ratio = max(errs["compact_item"], err), max(ratio, r)
                check(r <= 1, f"compact_item fc={fc} kind={kind} iters={iters}: |kernel - "
                      f"plain| {err:g} exceeds 2^-7 |plain| + 1e-6 ({r:.3f} of it)")
                check(kind == 1 or not got[256:].any(), f"compact_item fc={fc}: kind 0 wrote "
                      "rows past 256")
                cases += 1
    torch.cuda.synchronize()
    say(f"[gather] compact_item: {cases} cases within 2^-7 |plain| + 1e-6 (worst {ratio:.3f} of "
        f"it, max |difference| {errs['compact_item']:g})")
    for k, w in wrappers.items():
        w.launches = saved[k]

    # the main path: both probes at their default sizes, through their mains
    for w in wrappers.values():
        w.launches = 0
    said = {**dg.main([]), **gb.main([])}
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    # dma: one dtype x two idx x five depths, one block over the stream (the
    # main's default, the reference's form); gather: sections of 2 + 3 and
    # 8 windows, 4 items; each a timed call, its warm-up and a check
    plan = {"ring_gather": 30, "microbench_gather.py:72": 15,
            "microbench_gather.py:130": 24, "microbench_gather.py:212": 12}
    check(said == plan, f"the mains' launches {said}, planned {plan}")
    check(launches == {"ring_gather": 30, "window_gather": 39, "compact_item": 12},
          f"launch counts {launches} disagree with the mains' plan")
    say(f"[gather] mains launched {launches} as planned")
    return errs, said


def _cold_ms(torch, fn, reps=20):
    """Mean milliseconds of ``fn`` with L2 flushed before each call (a 256 MB
    write evicts the 50 MB cache); CUDA events around the call alone."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def _bound(nbytes, ops, rate):
    """(bound ms, what bounds it) for ``nbytes`` moved and ``ops`` done at
    ``rate`` operations a second."""
    b_ms, o_ms = nbytes / PEAK_BYTES_S * 1e3, ops / rate * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def phase_time_gather(torch, card, seed):
    """Each gather kernel at its script's shapes with CUDA events: its time
    at one iteration (one pass) beside its bound, its plain version and the
    library call; its time at the script's I iterations and at 2I, and the
    per-iteration slope (t(2I) - t(I)) / I, which must be nonzero (work
    hoisted out of the loop would make it vanish). ring_gather warm (I =
    50 passes over the same 4,096 rows, L2-resident) and cold (one pass,
    L2 flushed) at every depth and index locality, as one block over the
    stream (the reference's form, depths 4-64) and as many blocks of 4
    rows, each time beside the copies in flight for the stream."""
    import numpy as np

    from adaqp_tpu_torch.ops.spmm_block import expand_masks
    from adaqp_tpu_torch.ops.spmm_compact import BD, BS, CSUB, GROUP
    from adaqp_tpu_torch.scripts import microbench_dma_gather as dg
    from adaqp_tpu_torch.scripts import microbench_gather as gb

    wrappers = _gather_wrappers()
    saved = {k: w.launches for k, w in wrappers.items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    rows = {}

    # ring_gather: bf16 h [233,472, 256], 4,096 rows a pass
    f, chunk = 256, dg.CHUNK
    h = torch.randn(dg.N, f, generator=gen, device="cuda").to(torch.bfloat16)
    row_b = f * 2
    bound_ms, bound_by = _bound(chunk * (2 * row_b + 4), 0, 1)
    say(f"[time] {card} | ring_gather bf16 [{chunk}, {f}] of [{dg.N}]: bound {bound_ms:.5f} ms a "
        f"pass by bytes ({bound_ms * 1e6 / chunk:.3f} ns/row)")
    sms = dg.sm_count(h.device)
    cold = {}
    for vname, vi in dg.idx_variants(rng, dg.N, chunk).items():
        i = torch.from_numpy(vi).cuda()
        lib = _cold_ms(torch, lambda: torch.index_select(h, 0, i))
        warm_lib = cuda_ms(torch, lambda: dg.library_gather(h, i, 50), reps=5) / (50 * chunk)
        say(f"[time] {card} | ring_gather {vname:8s} torch.index_select (plain and library) cold "
            f"{lib:.5f} ms a pass; the script's library loop warm {warm_lib * 1e6:.3f} ns/row")
        cold[(vname, "index_select")] = lib
        # the reference's form (one block keeps `depth` copies in flight for
        # the stream) at its depths, then the many-block form (4 rows a block)
        for many, depths in ((False, (4, 8, 16, 32, 64)), (True, (1, 4, 8, 16, 32, 64))):
            for depth in depths:
                c = _cold_ms(torch, lambda: dg.ring_gather(h, i, 1, depth, many))
                cold[(vname, many, depth)] = c
                grid, _, flight = dg.ring_plan(chunk, 1, depth, many, sms)
                line = (f"[time] {card} | ring_gather {vname:8s} blocks={grid:4d} "
                        f"depth={depth:2d}: cold {c:.5f} ms a pass, {flight} in flight")
                if depth > 1:
                    # a many-block call of 0.05-0.1 ms is as short as its
                    # host time: queued behind a spin, the calls run back to
                    # back and a slow host call does not swamp the slope
                    reps = 20 if many else 3
                    t1 = cuda_ms(torch, lambda: dg.ring_gather(h, i, 50, depth, many),
                                 reps=reps, backlog=True)
                    t2 = cuda_ms(torch, lambda: dg.ring_gather(h, i, 100, depth, many),
                                 reps=reps, backlog=True)
                    slope = (t2 - t1) / 50
                    check(slope > 0.05 * t1 / 50, f"ring_gather blocks={grid} depth={depth}: "
                          f"the slope {slope:g} ms a pass is near zero: work left the loop")
                    flight50 = dg.ring_plan(chunk, 50, depth, many, sms)[2]
                    line += (f"; warm {t1 / (50 * chunk) * 1e6:.3f} ns/row at 50 passes "
                             f"({t1:.4f} ms, {flight50} in flight), 100 passes {t2:.4f} ms, "
                             f"slope {slope * 1e3:.3f} us a pass")
                say(line)
    # the kernels line: uniform idx in the main's form, one block over the
    # stream, at its deepest ring
    lib = cold[("uniform", "index_select")]
    rows["ring_gather"] = dict(ms=cold[("uniform", False, 64)], plain_ms=lib, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=lib)

    def window_case(tag, x, ii, axis, iters_i=200):
        """Times one window_gather case; returns its row at one iteration."""
        full = gb.full_index(x, ii, axis)
        t1 = cuda_ms(torch, lambda: gb.window_gather(x, ii, 1, axis), reps=20)
        ti = cuda_ms(torch, lambda: gb.window_gather(x, ii, iters_i, axis), reps=5)
        t2 = cuda_ms(torch, lambda: gb.window_gather(x, ii, 2 * iters_i, axis), reps=5)
        slope = (t2 - ti) / iters_i
        check(slope > 0.05 * ti / iters_i, f"window_gather {tag}: the slope {slope:g} ms an "
              "iteration is near zero: work left the loop")
        plain = cuda_ms(torch, lambda: gb._window_gather_torch(x, ii, 1, axis), reps=20)
        plain_i = cuda_ms(torch, lambda: gb._window_gather_torch(x, ii, iters_i, axis), reps=2,
                          warmup=1)
        lib = cuda_ms(torch, lambda: torch.gather(x, axis, full), reps=20)
        nbytes = x.numel() * x.element_size() * 2 + ii.numel() * 4
        b1, by1 = _bound(nbytes, x.numel(), PEAK_F32_FLOP_S)
        bi, byi = _bound(nbytes, x.numel() * iters_i, PEAK_F32_FLOP_S)
        say(f"[time] {card} | window_gather {tag}: 1 iteration {t1:.5f} ms (bound {b1:.5f} by "
            f"{by1}; plain {plain:.5f}; torch.gather {lib:.5f}); {iters_i} iterations {ti:.4f} ms "
            f"(bound {bi:.5f} by {byi}; plain {plain_i:.3f}), {2 * iters_i} {t2:.4f} ms, slope "
            f"{slope * 1e3:.4f} us an iteration")
        return dict(ms=t1, plain_ms=plain, bound_ms=b1, bound_by=by1, library_ms=lib)

    # the element gather (:72) at [4096, 256], full index (rows broadcast),
    # axis 0; the square window (:130) at D = 2048, F 256 and 640
    idx_rows = torch.from_numpy(rng.integers(0, 4096, 4096).astype(np.int32)).cuda()
    x = torch.randn(4096, 256, generator=gen, device="cuda")
    ii = idx_rows[:, None].expand(4096, 256).contiguous()
    rows["window_gather"] = window_case("[4096, 256] f32 full idx axis 0", x, ii, 0)
    window_case("[4096, 256] bf16 full idx axis 0", x.to(torch.bfloat16), ii, 0)
    for ff in (256, 640):
        for axis in (0, 1):
            shape = (2048, ff) if axis == 0 else (ff, 2048)
            x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            col = torch.randint(0, 2048, (1, 2048), generator=gen, device="cuda",
                                dtype=torch.int32)
            fi = (col.reshape(-1, 1) if axis == 0 else col).expand(shape).contiguous()
            for form, ii in (("full", fi), ("1-D", col)):
                row = window_case(f"{list(shape)} bf16 {form} idx axis {axis}", x, ii, axis)
                if (ff, axis, form) == (256, 0, "1-D"):
                    rows["window_gather_square"] = row

    # compact_item at fc 256 and 384, kinds 0 and 1
    for fc in (256, 384):
        mask, col, win = _item_inputs(torch, rng, gen, fc)
        a = expand_masks(mask[None])[0].to(torch.bfloat16)
        g = win[col.long()]
        a_sub = a.reshape(BD, GROUP, CSUB).transpose(0, 1).contiguous()
        g_sub = g.reshape(GROUP, CSUB, fc)
        for kind, name in ((0, "full"), (1, "group")):
            t1 = cuda_ms(torch, lambda: gb.compact_item(mask, col, win, kind, 1), reps=20)
            ti = cuda_ms(torch, lambda: gb.compact_item(mask, col, win, kind, 200), reps=3)
            t2 = cuda_ms(torch, lambda: gb.compact_item(mask, col, win, kind, 400), reps=3)
            slope = (t2 - ti) / 200
            check(slope > 0.05 * ti / 200, f"compact_item {name} fc={fc}: the slope {slope:g} "
                  "ms an iteration is near zero: work left the loop")
            plain = cuda_ms(torch, lambda: gb._compact_item_torch(mask, col, win, kind, 1),
                            reps=5, warmup=1)
            yard = cuda_ms(torch, (lambda: a @ win) if kind == 0 else
                           (lambda: torch.bmm(a_sub, g_sub)), reps=20)
            nbytes = mask.numel() * 2 + kind * col.numel() * 4 + 2 * win.numel() * 2
            flops = 2.0 * BD * BS * fc
            b1, by1 = _bound(nbytes, flops, PEAK_BF16_FLOP_S)
            bi, byi = _bound(nbytes, flops * 200, PEAK_BF16_FLOP_S)
            say(f"[time] {card} | compact_item {name} fc={fc}: 1 iteration {t1:.5f} ms (bound "
                f"{b1:.5f} by {by1}; plain {plain:.4f}; library none); 200 iterations "
                f"{ti:.4f} ms (bound {bi:.4f} by {byi}), 400 {t2:.4f} ms, slope "
                f"{slope * 1e3:.3f} us an iteration; torch.matmul on the pre-expanded bf16 A "
                f"(the products alone) {yard:.5f} ms")
            if (fc, kind) == (384, 1):
                rows["compact_item"] = dict(ms=t1, plain_ms=plain, bound_ms=b1, bound_by=by1,
                                            library_ms=None)
    for k, w in wrappers.items():
        w.launches = saved[k]
    return rows


# the Reddit-degree layout of the expand probe's timing: 32,768 nodes at
# Reddit's mean degree (2,048 dense tiles); --full: Reddit's own size
EXPAND_N = 32_768
EXPAND_ITERS = 5  # the script's --iters


def _hold_expand(torch, me, lay, h, variant, tag):
    """expand_spmm (one launch, not counted) against its plain version, both
    bf16: within F32_ATOL + 2^-7 |plain| + F32_RTOL times the sum of the
    terms' magnitudes (exact products summed in f32 in another order, the
    tensor cores', then each sum rounded once to bf16; v3's products reach
    3e4 |h| and cancel). Returns max |kernel - plain|."""
    saved = me.expand_spmm.launches
    got = me.expand_spmm(lay, h, variant)
    torch.cuda.synchronize()
    check(me.expand_spmm.launches == saved + 1, f"expand_spmm {tag}: the kernel did not launch")
    me.expand_spmm.launches = saved
    want = me._run_expand_torch(lay, h, variant).float()
    err = (got.float() - want).abs()
    tol = F32_ATOL + BF16_RTOL * want.abs() + F32_RTOL * me.term_magnitudes(lay, h, variant)
    ratio = float((err / tol).max())
    check(ratio <= 1.0, f"expand_spmm {tag}: disagrees with the plain version "
          f"({ratio:.3f} of the limit)")
    say(f"[expand] {tag}: max |kernel - plain| {float(err.max()):.3g}, {ratio:.3f} of "
        "F32_ATOL + 2^-7 |plain| + F32_RTOL sum|terms|")
    return float(err.max())


def phase_expand(torch, args):
    """expand_spmm's four variants against their plain versions, one pass
    each: on a small layout (a random 5,000-node graph, F=128 and 640, with
    and without the all-zero tiles that cover destination blocks with no
    dense tile, so a block with no tiles must give zeros) and on the
    Reddit-degree layout at F=640 (the main's shapes; built here and kept
    for the timing); then the script's main at that size, with its
    launches checked against the plan. Returns (max |kernel - plain|, the
    main's launches, the device layout, host seconds of its build)."""
    import numpy as np

    from adaqp_tpu_torch.ops import spmm_block as sb
    from adaqp_tpu_torch.scripts import microbench_expand as me

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = dict.fromkeys(me.VARIANTS, 0.0)  # max |kernel - plain| a variant
    n = 5000
    src = rng.integers(0, n, 200_000).astype(np.int32)
    dst = np.where(rng.random(200_000) < 0.7, (src + rng.integers(-300, 300, 200_000)) % n,
                   rng.integers(0, n, 200_000)).astype(np.int32)
    lay = sb.block_layout(src, dst, n, min_edges=64).to_device("cuda")
    keep = lay.masks.flatten(1).any(dim=1)
    t = int(lay.blk_ptr[-1])
    keep[t:] = False
    dst_blk = lay.dst_blk[keep]
    holed = sb.BlockDevice(lay.n, lay.n_pad, lay.n_src_pad, lay.masks[keep].contiguous(),
                           lay.src_start[keep].contiguous(), dst_blk.contiguous(),
                           torch.as_tensor(sb.block_pointers(dst_blk.cpu().numpy(), lay.n_pad),
                                           device="cuda"), None)
    empty = (holed.blk_ptr[1:] == holed.blk_ptr[:-1]).nonzero().flatten()
    check(empty.numel() > 0 and int(holed.blk_ptr[-1]) > lay.n_pad // sb.BD,
          "the holed layout has no empty destination block, or too few tiles")
    for f in (128, 640):
        h = torch.randn(lay.n_pad, f, generator=gen, device="cuda").to(torch.bfloat16)
        for variant in me.VARIANTS:
            worst[variant] = max(worst[variant], _hold_expand(
                torch, me, lay, h, variant, f"{variant} {t} tiles F={f}"))
            worst[variant] = max(worst[variant], _hold_expand(
                torch, me, holed, h, variant, f"{variant} {int(holed.blk_ptr[-1])} tiles, "
                f"{empty.numel()} empty blocks, F={f}"))
        rows = (empty[:, None] * sb.BD + torch.arange(sb.BD, device="cuda")).flatten()
        check(not me.expand_spmm(holed, h, "v0")[rows].any(),
              "expand_spmm: a destination block without tiles is not zero")

    from adaqp_tpu_torch.helper.dataset import REDDIT_E, REDDIT_N

    n_e = REDDIT_N if args.full else EXPAND_N
    e_e = REDDIT_E if args.full else n_e * round(REDDIT_E / REDDIT_N)
    cache = os.path.join(WORK, "expand_cache")
    host, secs, hit = me.reddit_layout(n_e, e_e, SEED, torch.device("cuda"), cache)
    check(not hit, "the expand layout came from an old cache")
    say(f"[expand] layout n={n_e} e={e_e}: {host.masks.shape[0]} tiles, built on the host in "
        f"{secs:.1f} s (synth_reddit on the card, block_layout in numpy); cached for the main")
    dev = host.to_device("cuda")
    # one pass of every variant at the main's shapes: this layout, F=640
    h = torch.randn(dev.n_pad, 640, generator=gen, device="cuda").to(torch.bfloat16)
    for variant in me.VARIANTS:
        worst[variant] = max(worst[variant], _hold_expand(
            torch, me, dev, h, variant, f"{variant} Reddit-degree layout F=640"))
    del h
    say("[expand] max |kernel - plain| a variant over these comparisons: "
        + ", ".join(f"{v} {e:.3g}" for v, e in worst.items()))

    # the main path: the script's main at the Reddit-degree size
    me.expand_spmm.launches = 0
    said = me.main(["--n", str(n_e), "--e", str(e_e), "--f", "640",
                    "--iters", str(EXPAND_ITERS), "--cache_dir", cache])
    torch.cuda.synchronize()
    launches = me.expand_spmm.launches
    plan = 4 * 2 * EXPAND_ITERS  # four variants, a warm-up and a timed chain each
    check(said == {"expand_spmm": plan} and launches == plan,
          f"the main launched expand_spmm {launches} times ({said}), planned {plan}")
    say(f"[expand] main launched expand_spmm {launches} times as planned")
    return worst, launches, dev, secs


def phase_time_expand(torch, card, dev, host_s):
    """Each variant at F=640 on the Reddit-degree layout: one pass (CUDA
    events) beside the bound of the function A^T h (the masks, index
    arrays, the h rows the edges read and out once at the memory rate, or
    the edges' products at the bf16 rate, as for block_spmm), the dense
    tiles' tensor-core time (every tile's 256 x 2048 x F product at the
    bf16 rate: the floor of this design, not of the function), the plain
    version, block_spmm (the set-bit walk) and torch.sparse.mm of the
    tiles' edges; and the per-pass slope of chains of I and 2I passes,
    which must be nonzero."""
    from adaqp_tpu_torch.ops import spmm_block as sb
    from adaqp_tpu_torch.scripts import microbench_expand as me

    saved = (me.expand_spmm.launches, sb.block_spmm.launches)
    f = 640
    t = int(dev.blk_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = torch.randn(dev.n_pad, f, generator=gen, device="cuda").to(torch.bfloat16)
    csr, nnz = tile_csr(torch, dev, torch.bfloat16)
    h_rows = int(torch.unique(csr.col_indices()).numel())
    nbytes = (t * sb.BD * sb.WORDS * 2 + t * 4 + dev.blk_ptr.numel() * 4
              + h_rows * f * 2 + dev.n_pad * f * 2)
    bound_ms, bound_by = _bound(nbytes, 2.0 * nnz * f, PEAK_BF16_FLOP_S)
    dense_flops = 2.0 * sb.BD * sb.BS * f * t
    dense_ms = dense_flops / PEAK_BF16_FLOP_S * 1e3
    walk = cuda_ms(torch, lambda: sb.block_spmm(dev, h), reps=10)
    lib = cuda_ms(torch, lambda: torch.sparse.mm(csr, h), reps=10)
    del csr
    say(f"[time] {card} | expand layout n_pad={dev.n_pad}: {t} tiles, {nnz} tile edges "
        f"({nnz / (t * sb.BD * sb.BS):.4%} dense), {h_rows} source rows read, host build "
        f"{host_s:.1f} s; F={f}: bound of A^T h {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e9:.3f} GB, {2.0 * nnz * f / 1e12:.4f} TFLOP); dense tiles on the tensor "
        f"cores {dense_ms:.4f} ms ({dense_flops / 1e12:.3f} TFLOP); block_spmm (set-bit walk) "
        f"{walk:.4f} ms; torch.sparse.mm {lib:.4f} ms")
    rows = {}

    def chain(variant, passes):
        cur = h
        for _ in range(passes):
            cur = me.expand_spmm(dev, cur, variant)
        return cur

    for variant in me.VARIANTS:
        ms = cuda_ms(torch, lambda: me.expand_spmm(dev, h, variant), reps=10)
        ti = cuda_ms(torch, lambda: chain(variant, EXPAND_ITERS), reps=3)
        t2 = cuda_ms(torch, lambda: chain(variant, 2 * EXPAND_ITERS), reps=3)
        slope = (t2 - ti) / EXPAND_ITERS
        check(slope > 0.05 * ti / EXPAND_ITERS, f"expand_spmm {variant}: the slope {slope:g} ms "
              "a pass is near zero: work left the loop")
        plain = cuda_ms(torch, lambda: me._run_expand_torch(dev, h, variant), reps=2, warmup=1)
        say(f"[time] {card} | expand_spmm {variant} F={f}: {ms:.4f} ms a pass "
            f"({ms / t * 1e3:.3f} us a tile; {bound_ms / ms:.2%} of the bound of A^T h, "
            f"{dense_ms / ms:.1%} of the dense tiles' tensor-core time, "
            f"{walk / ms:.2f}x block_spmm's speed); chains of {EXPAND_ITERS} / "
            f"{2 * EXPAND_ITERS} passes {ti:.3f} / {t2:.3f} ms, slope {slope:.4f} ms a pass; "
            f"plain {plain:.2f} ms")
        rows[variant] = dict(ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib)
    me.expand_spmm.launches, sb.block_spmm.launches = saved
    return rows


# the transpose's shapes: the probe's, odd ones, and the wire's (the plane
# probe's k1 * cnt rows of wpr = 25 words)
TRANSPOSE_SHAPES = ((4096, 25), (1, 1), (33, 31), (1000, 7), (7, 1000), (4097, 65),
                    (100_003, 25), (1_856_512, 25))


def phase_r5(torch, card):
    """transpose_u32 bit for bit with x.t().contiguous() at the probe's
    shape, odd shapes and the wire's; its time at the probe's and the
    wire's shapes beside its byte bound and the plain (and library) call;
    then the script's main at its own sizes (the scatter and plane lines),
    with its launches checked."""
    from adaqp_tpu_torch.scripts import probe_r5 as pr

    saved = pr.transpose_u32.launches
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xs, err = {}, 0.0
    for shape in TRANSPOSE_SHAPES:
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device="cuda",
                          dtype=torch.int32)
        before = pr.transpose_u32.launches
        got = pr.transpose_u32(x)
        torch.cuda.synchronize()
        check(pr.transpose_u32.launches == before + 1, f"transpose_u32 {shape}: no launch")
        want = pr._transpose_torch(x)
        if got.numel():
            err = max(err, float((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"transpose_u32 {list(shape)}: differs from "
              "x.t().contiguous()")
        xs[shape] = x
    say(f"[r5] transpose_u32: {len(TRANSPOSE_SHAPES)} shapes equal x.t().contiguous() bit for bit "
        f"({', '.join(str(list(s)) for s in TRANSPOSE_SHAPES)})")
    rows = {}
    for shape in ((4096, 25), (1_856_512, 25)):
        x = xs[shape]
        ms = cuda_ms(torch, lambda: pr.transpose_u32(x), reps=20)
        plain = cuda_ms(torch, lambda: pr._transpose_torch(x), reps=20)
        bound_ms, bound_by = _bound(2 * x.numel() * 4, 0, 1)
        say(f"[time] {card} | transpose_u32 {list(shape)} u32: {ms:.5f} ms (bound {bound_ms:.5f} "
            f"by {bound_by}, {bound_ms / ms:.1%} of it); x.t().contiguous() (plain and library) "
            f"{plain:.5f} ms")
        rows[shape] = dict(ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=plain)
    pr.transpose_u32.launches = saved
    del xs

    # the main path: the script's main at its own sizes
    pr.transpose_u32.launches = 0
    said = pr.main([])
    torch.cuda.synchronize()
    launches = pr.transpose_u32.launches
    check(said == {"transpose_u32": 1} and launches == 1,
          f"the main launched transpose_u32 {launches} times ({said}), planned 1")
    say("[r5] main launched transpose_u32 once, as planned")
    return launches, err, rows[(1_856_512, 25)]


def phase_gpu_tests():
    """The card-only pytest cases (tests/test_torch_gpu.py; no JAX, no
    conftest) in a subprocess: fails on a nonzero exit, on any skip, or on
    fewer passes than the file's collected cases."""
    import re

    base = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-m", "gpu"]
    test = os.path.join("tests", "test_torch_gpu.py")
    # pytest.ini's -q already makes --collect-only print one line a case
    col = subprocess.run(base + ["--collect-only", test], cwd=HERE, capture_output=True,
                         text=True, timeout=300)
    cases = [x for x in col.stdout.splitlines() if x.startswith(test + "::")]
    check(col.returncode == 0 and cases, f"collecting {test} failed:\n{col.stdout[-3000:]}"
          f"{col.stderr[-2000:]}")
    run = subprocess.run(base + ["-rs", test], cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
    passed = int(m.group(1)) if (m := re.search(r"(\d+) passed", tail)) else 0
    skipped = re.search(r"(\d+) skipped", tail)
    say(f"[gpu_tests] {passed} passed of {len(cases)} cases ({tail})")
    check(run.returncode == 0 and skipped is None and passed >= len(cases),
          f"the gpu tests did not all pass (exit {run.returncode}):\n{run.stdout[-6000:]}"
          f"{run.stderr[-2000:]}")
    return passed


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="K=1 and the expand probe on the full Reddit-size graph (232,965 "
                        "nodes, 114.6M edges)")
    p.add_argument("--nodes", type=int, default=65_536,
                   help="nodes of the K=1 graph (edges keep Reddit's mean degree)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--nodes_k", type=int, default=32_768, help="nodes of the K=4 graph")
    p.add_argument("--epochs_k", type=int, default=12,
                   help="AdaQP epochs at K=4 (reassignment at 6 and 11 with a cycle of 5)")
    p.add_argument("--epochs_pad", type=int, default=8,
                   help="AdaQP epochs of train_pad (reassignment at 6 with a cycle of 5)")
    p.add_argument("--nodes_agg", type=int, default=131_072,
                   help="nodes of the products-degree graph of train_agg")
    p.add_argument("--epochs_agg", type=int, default=8, help="epochs of each train_agg run")
    p.add_argument("--only", type=str, default=None,
                   help="comma-separated phases to run (agg, pad, quant, gather, expand, r5, "
                        "gpu_tests, e2e, e2e_k, e2e_pad, k1, train_k, train_pad, e2e_agg, "
                        "train_agg); build always runs, and the result lines print only for a "
                        "full run")
    p.add_argument("--profile", action="store_true",
                   help="also trace a few K=1 training steps with torch.profiler (the "
                        "Reddit run and each train_agg run)")
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
    agg_errs = run("agg", phase_agg, torch, SEED) if want("agg") else None
    pad_q_err, pad_d_err = run("pad", phase_pad, torch, SEED) if want("pad") else (None, None)
    pack_err, quant_err = run("quant", phase_quant, torch, SEED) if want("quant") else (None, None)
    if want("gather"):
        gather_errs, gather_l = run("gather", phase_gather, torch, SEED)
        gtimes = run("time", phase_time_gather, torch, card, SEED)
    if want("expand"):
        expand_err, expand_l, expand_lay, expand_host = run("expand", phase_expand, torch, args)
        etimes = run("time", phase_time_expand, torch, card, expand_lay, expand_host)
        del expand_lay
        torch.cuda.empty_cache()
    if want("r5"):
        r5_l, r5_err, r5_time = run("r5", phase_r5, torch, card)
        torch.cuda.empty_cache()
    if want("gpu_tests"):
        run("gpu_tests", phase_gpu_tests)
    if want("e2e"):
        run("e2e", phase_e2e, torch, SEED)
    if want("e2e_k"):
        run("e2e_k", phase_e2e_k, torch, SEED)
    if want("e2e_pad"):
        run("e2e_pad", phase_e2e_pad, torch, SEED)
    if want("k1"):
        trainer = run("setup", phase_setup, torch, args)
        err = run("kernel", phase_kernel, torch, trainer, SEED)
        launches = run("train", phase_train, torch, trainer)
        if args.profile:
            run("profile", phase_profile, torch, trainer)
        times = run("time", phase_time, torch, trainer, card)
        del trainer
        torch.cuda.empty_cache()
    k4 = None
    if want("train_k"):
        k4 = run("train_k", phase_train_k, torch, args)
        lanes = k4["AdaQP"][0]["lanes"]
        qtimes = run("time", phase_time_quant, torch, card, lanes)
    if want("train_pad"):
        kpad = run("train_pad", phase_train_pad, torch, args, k4)
        ptimes, pad_path_err = run("time", phase_time_pad, torch, card, kpad)
    if want("e2e_agg"):
        run("e2e_agg", phase_e2e_agg, torch, SEED)
    if want("train_agg"):
        agg = run("train_agg", phase_train_agg, torch, args)
        atimes = run("time", phase_time_agg, torch, card, agg)
    if only is not None:
        say("[done] partial run (--only): no result lines")
        return
    k4_strip = sum(r["launches"][0] for r in k4["AdaQP"])
    k4_q = sum(r["launches"][1] for r in k4["AdaQP"])
    k4_u = sum(r["launches"][2] for r in k4["AdaQP"])
    agg_l = {k: sum(r["launches"][k] for r in agg.values()) for k in _wrappers()}
    pad_q = sum(r["pad_launches"][0] for r in kpad)
    pad_d = sum(r["pad_launches"][1] for r in kpad)
    say(f"[result] strip_spmm launches: K=1 train {launches}, K=4 AdaQP train {k4_strip} "
        f"(all ranks), products train {agg_l['strip_spmm']}")
    say(card)
    say(json.dumps({"kernels": [
        {"name": "strip_spmm", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/spmm_strip.cu",
         "replaces": "adaqp_tpu/ops/spmm_strip.py:277",
         "launches": launches + k4_strip + agg_l["strip_spmm"], "max_abs_err": err,
         **times[640]},
        {"name": "quant_pack", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/quant_pack.cu",
         "replaces": "adaqp_tpu/ops/quant_pallas.py:103",
         "launches": k4_q, "max_abs_err": pack_err, **qtimes[640][0]},
        {"name": "unpack_dequant", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/quant_pack.cu",
         "replaces": "adaqp_tpu/ops/quant_pallas.py:202",
         "launches": k4_u, "max_abs_err": quant_err, **qtimes[640][1]},
        {"name": "block_spmm", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/spmm_block.cu",
         "replaces": "adaqp_tpu/ops/spmm_block.py:248",
         "launches": agg_l["block_spmm"], "max_abs_err": agg["block"]["err"],
         **atimes[("block_spmm", 256)]},
        {"name": "compact_spmm", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/spmm_compact.cu",
         "replaces": "adaqp_tpu/ops/spmm_compact.py:413",
         "launches": agg_l["compact_spmm"], "max_abs_err": agg["compact"]["err"],
         **atimes[("compact_spmm", 256)]},
        {"name": "gather_rows", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/spmm_compact.cu",
         "replaces": "adaqp_tpu/ops/spmm_compact.py:93",
         "launches": agg_l["gather_rows"], "max_abs_err": agg_errs["gather_rows"],
         **atimes[("gather_rows", 128)]},
        {"name": "quant_rows", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/quant_rows.cu",
         "replaces": "adaqp_tpu/ops/quant_pallas.py:33",
         "launches": pad_q, "max_abs_err": max(pad_q_err, pad_path_err[0]), **ptimes[0]},
        {"name": "dequant_rows", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/quant_rows.cu",
         "replaces": "adaqp_tpu/ops/quant_pallas.py:271",
         "launches": pad_d, "max_abs_err": max(pad_d_err, pad_path_err[1]), **ptimes[1]},
        {"name": "ring_gather", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/ring_gather.cu",
         "replaces": "scripts/microbench_dma_gather.py:72",
         "launches": gather_l["ring_gather"], "max_abs_err": gather_errs["ring_gather"],
         **gtimes["ring_gather"]},
        {"name": "window_gather", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/window_gather.cu",
         "replaces": "scripts/microbench_gather.py:72",
         "launches": gather_l["microbench_gather.py:72"],
         "max_abs_err": gather_errs["window_gather"], **gtimes["window_gather"]},
        {"name": "window_gather_square", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/window_gather.cu",
         "replaces": "scripts/microbench_gather.py:130",
         "launches": gather_l["microbench_gather.py:130"],
         "max_abs_err": gather_errs["window_gather"], **gtimes["window_gather_square"]},
        {"name": "compact_item", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/compact_item.cu",
         "replaces": "scripts/microbench_gather.py:212",
         "launches": gather_l["microbench_gather.py:212"],
         "max_abs_err": gather_errs["compact_item"], **gtimes["compact_item"]},
        {"name": "expand_spmm", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/expand_tile.cu",
         "replaces": "scripts/microbench_expand.py:48",
         "launches": expand_l, "max_abs_err": expand_err["v0"], **etimes["v0"]},
        {"name": "transpose_u32", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/transpose_u32.cu",
         "replaces": "scripts/probe_r5.py:63",
         "launches": r5_l, "max_abs_err": r5_err, **r5_time},
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
