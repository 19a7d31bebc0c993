#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``adaqp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # banded graphs (Reddit K=1: 32,768 nodes; products: 131,072)
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
compact, segment); and GraphSAGE with the multilabel loss at Yelp's
widths (``config/yelp.yaml``, 300 -> 256 -> 256 -> 100) on GraphSAINT raw
files, at K=1 and K=4. It checks that each training ran through the kernels
(their launch counts), and times every kernel beside its bound, its plain
version and a library call where one exists. It also drives the probes of
``adaqp_tpu_torch.scripts`` (``microbench_dma_gather``, ``microbench_gather``,
``microbench_expand``, ``probe_r5``) through their mains, and runs the
card-only pytest cases. Phases: env, build, agg
(block_spmm, compact_spmm and gather_rows), pad (quant_rows and
dequant_rows in their contiguous form and on the lane tables of synthetic
K=4 padded wires), quant (quant_pack and unpack_dequant in their contiguous
form and over the lane tables of synthetic K=4 wires), gather (ring_gather,
window_gather and compact_item against their plain versions, the two
mains with their launches checked, then each kernel timed with its
per-iteration slope, ring_gather also with L2 flushed, one block an SM,
one over the stream and many), expand (the SASS of expand_spmm's kernels:
wgmma, TMA, no mma.sync, no register cap; its four variants against
their plain versions at F=128, 384 and 640, on a hub layout too; its
main on a Reddit-degree layout of 32,768 nodes, 2,048 dense
tiles (``--full``: Reddit's size), then each variant timed beside
block_spmm, torch.sparse.mm and its bound), r5 (transpose_u32 bit for bit
and timed paced by the host, on the card's clock and as host time a call,
then the probe's main with its scatter and plane lines; with
``--parent_probes DIR`` the expand and r5 timing also time an older tree's
expand_tile.cu and transpose_u32.cu on the same inputs),
gpu_tests (``pytest -m gpu tests/test_torch_gpu.py`` in a subprocess,
every case passed and none skipped), setup, kernel
(strip SpMM), e2e (a small K=1 run on the card against the same run on
the CPU), e2e_k (the same at K=2, Vanilla and AdaQP), e2e_pad (e2e_k on
the padded wire), train (K=1), train_k (K=4; its AdaQP run checkpoints
after epoch 8), ckpt (four new ranks resume that run from its checkpoint:
the loaded state bit for bit, the reassignment at epoch 11 without a new
profile, launches as planned, losses within one bf16 step of the straight
run's), partition (the native LDG against the numpy one on train_k's
graph, then ``python -m adaqp_tpu_torch.graph_partition``), parity
(``adaqp_tpu_torch.scripts.accuracy_parity``'s eight configurations at K=4,
``--epochs_parity`` epochs each), train_pad (K=4 AdaQP on the
padded wire, with the probe), e2e_agg (K=2 card against CPU for block,
compact and segment), train_agg (the products GCN through the four
aggregations), remat (the products GCN with layer recomputation, and
train_k's checkpoint resumed with it), sage (K=2 SAGE-mean and SAGE-gcn
on a multilabel SBM, card against CPU; a Yelp-shaped R-MAT graph of
``--nodes_sage`` nodes written as GraphSAINT raw files and trained
through ``RunConfig.from_yaml("yelp")`` at K=1 and at K=4 in AdaQP
adaptive, launches against the plans; strip_spmm at F=384 and 256 and the
quant pair at f_true 300 against their plain versions, strip_spmm timed
at F=384), time (after k1, train_k, train_pad and train_agg; after
train_pad it first holds quant_rows and dequant_rows against their plain
versions on lane tables of every shape that run gave them; with
``--profile``, also a device-time breakdown of a few training steps of the
K=1 Reddit run and of each train_agg run; train_k and train_pad always
profile three more steps of rank 0 and time rank 0's send and receive
sides of each exchange of one more step, holding them against the plain
versions; train_pad also times the per-bucket composition its exchange
ran before on the same inputs). The
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
import math
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
# train_k's AdaQP run checkpoints after this epoch; phase ckpt resumes there
CKPT_EPOCH = 8
# the resumed run's losses against the straight run's: the card adds in no
# fixed order (the ELL tail's index_add_, the receive side's atomics in
# the backward), so not bit for bit; one bf16 step
CKPT_RTOL = 2.0 ** -7
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
    """The window-stationary kernel design's own floor for bf16 h (any tile
    layout's walk): the shared-memory bytes it moves (every tile edge reads
    its row's 32-byte column slice, every window step's slice is written
    once by TMA, per column slice) over 132 SMs at 128 bytes a clock.
    Returns (ms, bytes)."""
    from adaqp_tpu_torch.ops import spmm_walk as sw

    slices = -(-f * 2 // sw.SLICE_BYTES)
    nbytes = slices * (nnz * sw.SLICE_BYTES + lay.walk.step_win.numel() * sw.BS * sw.SLICE_BYTES)
    return nbytes / (132 * 128 * clock_mhz * 1e6) * 1e3, nbytes


def walk_bound(lay, f, nnz, h_rows):
    """The bound of the window-stationary kernel on a tile layout's walk
    and bf16 h [., f]: the bytes it must move (the walk arrays, the
    ``h_rows`` source rows its ``nnz`` edges read, the output once) over the
    memory rate, or its 2 nnz f operations over the bf16 rate, whichever is
    longer. Returns (ms, what bounds it, bytes, operations)."""
    nbytes = lay.walk.nbytes + h_rows * f * 2 + lay.n_pad * f * 2
    flops = 2.0 * nnz * f
    return (*_bound(nbytes, flops, PEAK_BF16_FLOP_S), nbytes, flops)


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


def sass_per_element(lib, func, marker, per_marker=1, cheapest=False):
    """Operations an element, by pipe, in the hot loop of the kernel whose
    mangled name contains ``func`` in ``build/kernels/lib<lib>.so``
    (``cuobjdump -sass``): of the innermost loops (a backward branch with
    no other loop inside), the one with the most instructions whose opcode
    starts with ``marker``, each of which stands for ``per_marker``
    elements; with ``cheapest``, of those that hold any, the one whose
    busiest pipe takes the least time an element (a kernel with one loop a
    code width: a bound that holds for every width). Returns ({pipe:
    operations an element}, elements an iteration, instructions in the
    loop)."""
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

    def per_element(lp):
        codes = ops(lp)
        elems = sum(o.startswith(marker) for o in codes) * per_marker
        counts = {pipe: sum(o.split(".")[0] in names for o in codes) / max(elems, 1)
                  for pipe, (_, names) in SASS_PIPES.items()}
        return counts, elems, len(codes)

    found = [per_element(lp) for lp in inner]
    found = [x for x in found if x[1] > 0]
    check(found, f"{func}: no {marker} in its innermost loops")
    if cheapest:
        return min(found, key=lambda x: max(n / SASS_PIPES[p][0] for p, n in x[0].items()))
    return max(found, key=lambda x: x[1])


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
    logs = build(["spmm_strip", "quant_pack", "quant_rows", "spmm_compact",
                  "ring_gather", "window_gather", "compact_item", "expand_tile",
                  "transpose_u32"])
    say(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line or "warning" in line:
                say(f"[build] {name}: {line.strip()}")
    # ptxas serialises a kernel's wgmmas (C7512) when it cannot keep their
    # sums in registers (expand_tile's consumers lost their setmaxnreg
    # registers to a trap once): the redesigns' whole gain
    for name in ("expand_tile", "compact_item"):
        check("C7512" not in logs[name],
              f"ptxas serialised {name}'s wgmma (C7512): its sums left the registers")


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


def phase_time(torch, trainer, card, widths=(640, 256), tag="time"):
    """strip_spmm on the trainer's forward local layout at each width of
    ``widths``, bf16: CUDA-event ms beside its bound, the design's
    shared-memory floor, the plain version and torch.sparse.mm."""
    from adaqp_tpu_torch.ops import spmm_strip as ss
    from adaqp_tpu_torch.ops import spmm_walk as sw

    dev = trainer.device
    fl = trainer.blocks.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    t = int(fl.blk_ptr[-1])
    rows = {}
    clock = sm_clock_mhz()
    info = sw.walk_kernel_info(torch.bfloat16)
    say(f"[{tag}] {card} | strip_spmm form: a CTA a (strip, slice of {info['columns']} bf16 columns), "
        f"{info['registers']} registers a thread, {info['spill_bytes']} spill bytes, shared memory "
        f"{info['dynamic_smem']} B dynamic + {info['static_smem']} B static; SM clock "
        f"{clock[0]:g} MHz now, {clock[1]:g} MHz max (the floor uses the max)")
    for f in widths:
        h = torch.randn(fl.n_src_pad, f, generator=gen, device=dev).to(torch.bfloat16)
        saved = ss.strip_spmm.launches
        ms = cuda_ms(torch, lambda: ss.strip_spmm(fl, h), reps=10)
        ss.strip_spmm.launches = saved  # timing launches are not the main path's
        plain_ms = cuda_ms(torch, lambda: ss._run_strip_torch(fl, h), reps=2, warmup=1)
        # the library yardstick on the same edges; the port never calls it
        csr, nnz = tile_csr(torch, fl, torch.bfloat16)
        h_rows = int(torch.unique(csr.col_indices()).numel())
        lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, h), reps=10)
        del csr
        bound_ms, bound_by, nbytes, flops = walk_bound(fl, f, nnz, h_rows)
        floor_ms, floor_bytes = strip_floor(fl, f, nnz, clock[1])
        say(f"[{tag}] {card} | fwd_local F={f}: tiles {t}, tile edges {nnz}")
        say(f"[{tag}] {card} | kernel {ms:.3f} ms; bound {bound_ms:.3f} ms by {bound_by} "
            f"({nbytes / 1e9:.3f} GB, {flops / 1e12:.4f} TFLOP bf16); plain {plain_ms:.2f} ms; "
            f"torch.sparse.mm {lib_ms:.3f} ms (bf16 CSR)")
        say(f"[{tag}] {card} | the design's shared-memory floor {floor_ms:.3f} ms "
            f"({floor_bytes / 1e9:.2f} GB at 132 x 128 B a clock; the warps walk "
            f"{fl.walk.cols.numel() / nnz:.2f} column slots an edge)")
        rows[f] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
    return rows


def _hold_contiguous(torch, seed, shapes):
    """quant_pack and unpack_dequant in their contiguous form against their
    plain versions on the card, at each (F, f_true) of ``shapes``: bits
    2/4/8, f32 and bf16 rows, N 0/1/33/25,700 with a constant row; words,
    scale, rmin and dequantized rows bit for bit, every round-trip error
    within one step. Returns (max |difference| of quant_pack's outputs,
    of unpack_dequant's, the cases)."""
    from adaqp_tpu_torch.comm.wire import wire_cols
    from adaqp_tpu_torch.ops import quant_cuda as qc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst_err = 0.0  # unpack_dequant: max |kernel rows - plain rows|
    worst_pack = 0.0  # quant_pack: max |difference| of words, scale and rmin
    cases = 0
    for bits in (2, 4, 8):
        for f, ft in shapes:
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
    return worst_pack, worst_err, cases


def phase_quant(torch, seed):
    """quant_pack and unpack_dequant against their plain versions on the
    card at the main path's shapes: words, scale, rmin and dequantized rows
    bit for bit; every round-trip error within one step; no bias."""
    from adaqp_tpu_torch.comm.wire import wire_cols
    from adaqp_tpu_torch.ops import quant_cuda as qc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst_pack, worst_err, cases = _hold_contiguous(torch, seed, ((640, 602), (256, 256)))
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


# (forward, F, f_true, dtype name) of the lane kernels' holds: the Reddit
# GCN's layer 0 and hidden widths, and an odd width
LANE_CASES = ((True, 640, 602, "bfloat16"), (False, 256, 256, "float32"),
              (True, 256, 256, "bfloat16"), (False, 333, 301, "float32"))


def _hold_lanes(torch, seed, cases=LANE_CASES):
    """The lane kernels (pack_lanes, unpack_lanes) against their plain
    versions on the card, on random K=4 wires of the port's wire lowering
    (``tests/torch_helpers.py``) with all four widths, one for each of
    ``cases``: each
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
    held = []
    for forward, f, ft, dtype in cases:
        dtype = getattr(torch, dtype)
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
        held.append(f"{'fwd' if forward else 'bwd'} F={f} f_true={ft} {str(dtype)[6:]} "
                     f"lanes {lanes}")
    qc.quant_pack.launches, qc.unpack_dequant.launches = saved
    say(f"[quant] lane kernels on K=4 wires of 2/4/8/32-bit lanes ({'; '.join(held)}): "
        f"send buffers, ranges and received rows equal the plain versions bit for bit; "
        f"backward sums within {worst_sum:.2e} of sum |terms| (limit 1e-6)")
    return worst_p, worst_u


def _e2e_worker(rank, world, device, configs):
    """One rank of a K=2 card-against-CPU check: each config (overrides of
    ``sbm.yaml``) trains on the card, then on the CPU in the same rank."""
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    out = []
    for over in configs:
        out.append([Trainer(RunConfig.from_yaml("sbm", over), device=dev).train()["loss_curve"]
                    for dev in (device, "cpu")])
    check("jax" not in sys.modules, "a rank imported jax")
    return out


def _e2e_curves(res, tags):
    """Rank 0's (card, CPU) loss curves of each config of :func:`_e2e_worker`
    (``tags`` names them), every rank checked to agree."""
    import numpy as np

    out = {}
    for i, tag in enumerate(tags):
        for d, device in enumerate(("card", "CPU")):
            check(all(np.array_equal(r[i][d], res[0][i][d]) for r in res),
                  f"{tag} on the {device}: ranks disagree on the loss")
        out[tag] = tuple(np.asarray(c) for c in res[0][i])
    return out


def phase_e2e_k(torch, seed):
    """K=2 on the SBM, f32: two ranks on the card over gloo against the
    same ranks on the CPU, in Vanilla and in AdaQP (uniform 8 bits). The
    plain generator equals the kernel's, so both draw the same codes."""
    import numpy as np

    from adaqp_tpu_torch.comm.distributed import spawn

    modes = ("Vanilla", "AdaQP")
    configs = [{
        "num_parts": 2, "mode": mode, "assign_scheme": "uniform", "assign_bits": 8,
        "num_epochs": 6, "hidden_dim": 32, "dropout_rate": 0.0, "log_steps": 100,
        "block_min_edges": 1, "logger_level": "WARNING",
        "synth_kwargs": {"n": 1200, "blocks": 4, "num_feats": 16, "seed": seed},
        "partition_dir": os.path.join(WORK, "e2ek_parts"),
        "exp_path": os.path.join(WORK, "e2ek_exp"),
    } for mode in modes]
    # a collective that waits 180 s fails the phase instead of hanging
    runs = _e2e_curves(spawn(_e2e_worker, 2, "cuda", args=(configs,),
                             workdir=os.path.join(WORK, "launch"), timeout_s=180), modes)
    # both modes read under 1e-6 on the H100 (1.7e-7 Vanilla, 6.5e-7 AdaQP):
    # the same codes, f32 sums in another order; 1e-5 leaves room for that
    # order and none for a wrong code or parameter word
    tol = 1e-5
    for mode in modes:
        card, cpu = runs[mode]
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
    """The lane tables of every quant_rows and dequant_rows launch one
    padded training step makes with the current buckets, as shapes:
    (direction, bucket widths, lanes a bucket, F, f_true, source dtype,
    source rows, output rows); the forward's rows in the activations'
    dtype, the backward's gradient rows in f32. With ``probe``, also the
    breakdown probe's identity tables: ``assign_bits`` on ``K * s_pad``
    lanes a layer."""
    st = t.static
    dims = [st.f_pad] + [st.hidden] * (st.num_layers - 1)
    fwd = "bfloat16" if st.agg_dtype == "bfloat16" else "float32"
    cases = set()
    if probe and t.padded is not None:
        n = t.k * st.s_pad
        cases.update(("probe", (t.cfg.assign_bits,), (n,), d, ft, fwd, n, n)
                     for d, ft in zip(dims, [t.layer_dims[0]] + dims[1:]))
    for i, w in enumerate(t.padded or ()):
        cases.add(("fwd", w.fwd.bits, w.fwd.counts, dims[i], w.fwd.f_true, fwd, st.l_max,
                   st.r_pad))
        if i:
            cases.add(("bwd", w.bwd.bits, w.bwd.counts, dims[i], w.bwd.f_true, "float32",
                       st.r_pad, st.l_max))
    return cases


def _build_parent(csrc, names):
    """``{name: ctypes.CDLL}`` of the ``<name>.cu`` sources in ``csrc`` (an
    older tree's), built at once with the port's ``nvcc`` flags into
    ``lib<name>_parent.so`` under the work directory."""
    import ctypes

    from adaqp_tpu_torch.utils.cuda_build import NVCC_FLAGS, nvcc_path

    os.makedirs(WORK, exist_ok=True)
    so = {name: os.path.join(WORK, f"lib{name}_parent.so") for name in names}
    procs = {name: subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", so[name],
                                     os.path.join(csrc, f"{name}.cu")],
                                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for name in names}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        check(proc.returncode == 0, f"the older {name}.cu failed to build: {err[-2000:]}")
    return {name: ctypes.CDLL(so[name]) for name in names}


def _parent_rows(torch, csrc):
    """The contiguous ``quant_rows`` and ``dequant_rows`` kernels of the
    ``quant_rows.cu`` in ``csrc`` (an older tree's sources, from before one
    launch served a direction: codes a byte a column, one launch a bucket),
    built with the port's ``nvcc`` flags and wrapped with the port's
    contiguous signatures."""
    import ctypes

    lib = _build_parent(csrc, ["quant_rows"])["quant_rows"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.adaqp_quant_rows.argtypes = [vp, ci, ci, ci, ci, ci, ctypes.c_uint32, vp, vp, vp, ci, vp]
    lib.adaqp_dequant_rows.argtypes = [vp, vp, vp, ci, ci, vp, ci, vp]

    def quant_rows(x, bits, f_true, key):
        x = x.contiguous()
        (n, f), dev = x.shape, x.device
        q = torch.empty((n, f), dtype=torch.uint8, device=dev)
        scale, rmin = (torch.empty(n, device=dev) for _ in range(2))
        rc = lib.adaqp_quant_rows(x.data_ptr(), int(x.dtype == torch.bfloat16), n, f,
                                  min(f_true, f), bits, key & 0xFFFFFFFF, q.data_ptr(),
                                  scale.data_ptr(), rmin.data_ptr(), dev.index,
                                  torch.cuda.current_stream(dev).cuda_stream) if n else 0
        check(rc == 0, f"the older quant_rows failed to launch ({rc})")
        return q, scale, rmin

    def dequant_rows(q, scale, rmin):
        (n, f), dev = q.shape, q.device
        out = torch.empty((n, f), device=dev)
        rc = lib.adaqp_dequant_rows(q.data_ptr(), scale.data_ptr(), rmin.data_ptr(), n, f,
                                    out.data_ptr(), dev.index,
                                    torch.cuda.current_stream(dev).cuda_stream) if n else 0
        check(rc == 0, f"the older dequant_rows failed to launch ({rc})")
        return out

    return quant_rows, dequant_rows


def _padded_sides(torch, t, rank, parent_rows=None, reps=20):
    """Rank 0's send side (``quant_frames``) and receive side (a zero
    buffer and ``dequant_frames``) of every exchange of one more padded
    training step (every rank takes it), each timed alone on the card on
    the step's own lane tables, source rows and received buffers, ``reps``
    calls between CUDA events behind a backlog of some 100 ms; beside each,
    the per-bucket composition the exchange ran before
    (``tests/torch_helpers.py``: ``frames_by_buckets``,
    ``unframe_by_buckets``) on the same inputs, around this tree's
    contiguous kernels (``old_*``) and, with ``parent_rows`` (a ``csrc``
    directory: :func:`_parent_rows`), around that tree's (``parent_*``).
    The kernels are held against their plain versions and against each
    composition. Returns a dict a call on rank 0, else None."""
    import torch.distributed as dist

    from adaqp_tpu_torch.comm import exchange as ex
    from adaqp_tpu_torch.ops import quant_cuda as qc

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_helpers import abs_sums, frames_by_buckets, unframe_by_buckets

    sends, recvs = [], []
    quant_frames, dequant_frames = ex.quant_frames, ex.dequant_frames

    def recording_quant(x, fr, keys, with_range=False):
        sends.append((x.clone(), fr, list(keys), with_range))
        return quant_frames(x, fr, keys, with_range)

    def recording_dequant(buf, fr, out, add=False):
        recvs.append((buf.clone(), fr, tuple(out.shape), add))
        return dequant_frames(buf, fr, out, add)

    ex.quant_frames, ex.dequant_frames = recording_quant, recording_dequant
    try:
        float(t._train_step(2000))
    finally:
        ex.quant_frames, ex.dequant_frames = quant_frames, dequant_frames
    torch.cuda.synchronize()
    if rank != 0:
        dist.barrier()
        return None
    kernels = {"old": (qc.quant_rows, qc.dequant_rows)}
    if parent_rows:
        kernels["parent"] = _parent_rows(torch, parent_rows)
    saved = (qc.quant_rows.launches, qc.dequant_rows.launches)
    out, spin = [], 200_000_000
    for x, fr, keys, trace in sends:
        buf, (n_out, f), add = next((b, o, a) for b, g, o, a in recvs if g is fr)
        layer = next(i for i, w in enumerate(t.padded) if fr is w.fwd or fr is w.bwd)
        tag = f"layer {layer} {'bwd' if add else 'fwd'}"
        # the kernels against their plain versions on this real wire
        got, rng = qc.quant_frames(x, fr, keys, trace)
        want, rng0 = qc._quant_frames_torch(x, fr, keys, trace)
        check(torch.equal(got, want) and (rng is None or torch.equal(rng, rng0)),
              f"{tag}: the send buffer differs from the plain version's")
        zeros = torch.zeros(n_out, f, device="cuda")
        rows = qc.dequant_frames(buf, fr, zeros.clone(), add)
        rows0 = qc._dequant_frames_torch(buf, fr, zeros.clone(), add)
        tol = 1e-6 * abs_sums(buf, fr, n_out, f) if add else 0.0
        check(bool(((rows - rows0).abs() <= tol).all()),
              f"{tag}: the received rows differ from the plain version's")
        ms_s = cuda_ms(torch, lambda: qc.quant_frames(x, fr, keys, trace), reps, backlog=True,
                       spin=spin)
        ms_r = cuda_ms(torch, lambda: qc.dequant_frames(
            buf, fr, torch.zeros(n_out, f, device="cuda"), add), reps, backlog=True, spin=spin)
        res = {"layer": layer, "dir": "bwd" if add else "fwd", "F": f, "f_true": fr.f_true,
               "dtype": str(x.dtype)[6:], "lanes": fr.n,
               "buckets": list(zip(fr.bits, fr.counts)), "send_ms": ms_s, "recv_ms": ms_r}
        # the per-bucket composition of before on the same inputs
        buckets, ft = t.buckets[layer], fr.f_true
        for name, (quant_rows, dequant_rows) in kernels.items():
            def send():
                into = torch.zeros(x.shape[0] + 1, device="cuda") if trace else None
                return frames_by_buckets(x, buckets, keys, ft, add, into, quant_rows)

            old = send()
            check(torch.equal(torch.cat([o.reshape(-1) for o in old]), got),
                  f"{tag}: the send buffer differs from the per-bucket frames ({name})")
            frames = [v.reshape(o.shape) for v, o in zip(fr.views(buf), old)]

            def recv():
                return unframe_by_buckets(frames, buckets, f, ft, n_out, add, dequant_rows)

            check(bool(((recv() - rows).abs() <= tol).all()),
                  f"{tag}: the received rows differ from the per-bucket composition's ({name})")
            res[f"{name}_send_ms"] = cuda_ms(torch, send, reps, backlog=True, spin=spin)
            res[f"{name}_recv_ms"] = cuda_ms(torch, recv, reps, backlog=True, spin=spin)
        out.append(res)
    qc.quant_rows.launches, qc.dequant_rows.launches = saved
    dist.barrier()
    return out


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


def _train_k_worker(rank, world, device, cfg, graph_fn, profile, parent_rows=None):
    """One rank of the K=4 Reddit-width run: train, then report counts,
    memory and a checksum of the parameters that every rank must share
    (``parent_rows``: :func:`_padded_sides`)."""
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
        before[epoch] = _trace_sum(t)
        reassign(epoch)
        hist.append((epoch, [
            {b: int(((a == b) & (a > 0)).sum()) for b in (2, 4, 8)}
            for a in t.assignment.fwd + t.assignment.bwd[1:]
        ]))
        volume.append((epoch, _wire_volume(t)))
        pad_cases.update(_pad_cases(t))

    volume, pad_cases = [(1, _wire_volume(t))], _pad_cases(t, cfg.measure_breakdown)
    t._reassign = recording_reassign
    digests, before, save = {}, {}, t._save_checkpoint

    def recording_save(epoch):
        digests[epoch] = _state_digest(t)
        save(epoch)

    t._save_checkpoint = recording_save
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
    sides = None
    if profile:
        sides = (_exchange_sides(torch, t, rank) if t.padded is None
                 else _padded_sides(torch, t, rank, parent_rows))
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
        "digests": digests, "trace_before": before,
        "ckpt_save_s": t.timer.totals().get("ckpt_save", 0.0),
        "assignment": None if t.assignment is None else [
            np.asarray(a) for a in t.assignment.fwd + t.assignment.bwd],
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
        if mode == "AdaQP":  # the one checkpoint, which phase ckpt resumes
            cfg.ckpt_every, cfg.ckpt_dir = CKPT_EPOCH, os.path.join(WORK, "k4_ckpt")
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


def _state_digest(t):
    """SHA-256 of a Trainer's parameters, Adam state and this rank's traces."""
    import hashlib

    h = hashlib.sha256()
    for _, p in t._named_params():
        h.update(p.detach().cpu().numpy().tobytes())
        for f in ("step", "exp_avg", "exp_avg_sq"):
            h.update(t.opt.state[p][f].detach().cpu().numpy().tobytes())
    for x in (t.trace_fwd, t.trace_bwd):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def _trace_sum(t):
    """This rank's accumulated traces, summed in f64."""
    return float(t.trace_fwd.double().sum() + t.trace_bwd.double().sum())


def _ckpt_worker(rank, world, device, cfg, graph_fn):
    """One rank of the resumed K=4 run: the state it loaded, then its
    epochs after the checkpoint, with the kernels' launches."""
    import numpy as np
    import torch

    from adaqp_tpu_torch.ops import quant_cuda as qc
    from adaqp_tpu_torch.ops import spmm_strip as ss
    from adaqp_tpu_torch.trainer import Trainer

    t = Trainer(cfg, graph=graph_fn(), device=device)
    digest = _state_digest(t)
    reassigned, before, reassign = [], {}, t._reassign

    def recording_reassign(epoch):
        before[epoch] = _trace_sum(t)
        reassigned.append(epoch)
        reassign(epoch)

    t._reassign = recording_reassign
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss.strip_spmm.launches = qc.quant_pack.launches = qc.unpack_dequant.launches = 0
    rec = t.train()
    launches = (ss.strip_spmm.launches, qc.quant_pack.launches, qc.unpack_dequant.launches)
    torch.cuda.synchronize()
    return {
        "peak": torch.cuda.max_memory_allocated(), "per_epoch": rec["per_epoch"],
        "start": t.start_epoch, "digest": digest, "profile_s": t.profile_s,
        "load_s": t.timer.totals().get("ckpt_load", 0.0), "reassigned": reassigned,
        "trace_before": before, "loss_curve": rec["loss_curve"], "launches": launches,
        "planned": (rec["planned_tile_launches"], *rec["planned_quant_launches"]),
        "assignment": [np.asarray(a) for a in t.assignment.fwd + t.assignment.bwd],
    }


def _resume_k4(args, k4, tag, remat=False):
    """Four new ranks resume train_k's AdaQP run from its epoch-8
    checkpoint (with ``remat``: recomputing their layers); each rank's
    :func:`_ckpt_worker` result, the launch's seconds and the checkpoint's
    bytes."""
    import functools

    from adaqp_tpu_torch.__main__ import config_from_args, parse_args
    from adaqp_tpu_torch.comm.distributed import spawn
    from adaqp_tpu_torch.helper.dataset import REDDIT_C, REDDIT_E, REDDIT_F, REDDIT_N, synth_reddit

    epochs = k4["AdaQP"][0]["epochs"]
    check(epochs > CKPT_EPOCH + 2, f"{tag} needs train_k past epoch {CKPT_EPOCH + 2} "
          f"(--epochs_k {epochs})")
    n = args.nodes_k
    graph_fn = functools.partial(synth_reddit, n, n * round(REDDIT_E / REDDIT_N), REDDIT_F,
                                 REDDIT_C, seed=SEED, device="cuda")
    ckpt_dir = os.path.join(WORK, "k4_ckpt")
    cfg = config_from_args(parse_args([
        "--dataset", "reddit", "--num_parts", "4", "--mode", "AdaQP",
        "--assign_scheme", "adaptive", "--num_epochs", str(epochs),
        "--agg_dtype", "bfloat16", "--seed", str(SEED), "--resume", "--ckpt_dir", ckpt_dir,
        "--exp_path", os.path.join(WORK, "k4_exp"), "--remat", str(int(remat)),
    ]))
    cfg.assign_cycle, cfg.log_steps, cfg.measure_breakdown = 5, 1, False
    cfg.partition_dir = os.path.join(WORK, "k4_parts")
    graphs = os.listdir(ckpt_dir)  # ckpt_dir/{graph}/4part_gcn/
    check(len(graphs) == 1, f"train_k checkpointed {graphs}")
    run_dir = os.path.join(ckpt_dir, graphs[0], "4part_gcn")
    files = sorted(os.listdir(run_dir))
    check(files == [f"ckpt_{CKPT_EPOCH}.json", f"ckpt_{CKPT_EPOCH}.npz"],
          f"train_k left other checkpoint files: {files}")
    nbytes = sum(os.path.getsize(os.path.join(run_dir, f)) for f in files)
    t0 = time.perf_counter()
    res = spawn(_ckpt_worker, 4, "cuda", args=(cfg, graph_fn),
                workdir=os.path.join(WORK, "launch"), timeout_s=480)
    return res, time.perf_counter() - t0, nbytes, cfg


def _check_resumed(tag, res, straight, tile_epoch):
    """Every rank of a resumed run: loaded at the save's state, no profile,
    the straight run's reassignments on the straight run's traces, its
    launches as planned; returns the losses of rank 0, which the other ranks
    share, and their largest relative difference to the straight run's."""
    import numpy as np

    epochs = straight[0]["epochs"]
    for rank, (r, s) in enumerate(zip(res, straight)):
        strip, qp, ud = r["launches"]
        say(f"[{tag}] rank {rank}: resumed at epoch {r['start']}; state digest "
            f"{r['digest'][:16]} (at the save {s['digests'].get(CKPT_EPOCH, 'none')[:16]}); "
            f"profiling {r['profile_s']:.2f} s; reassigned at {r['reassigned']}; launches strip "
            f"{strip}, quant_pack {qp}, unpack_dequant {ud} (planned {r['planned']}); peak "
            f"max_memory_allocated {r['peak'] / 2**30:.3f} GiB; median step "
            f"{r['per_epoch'] * 1e3:.1f} ms")
        check(r["start"] == CKPT_EPOCH, f"rank {rank} resumed at epoch {r['start']}")
        check(r["digest"] == s["digests"].get(CKPT_EPOCH),
              f"rank {rank}: the loaded state differs from the state at the save")
        check(r["profile_s"] == 0, f"rank {rank} profiled the transport again")
        check(r["reassigned"] == [e for e, _ in s["hist"] if e > CKPT_EPOCH],
              f"rank {rank}: reassignments {r['reassigned']} against the straight run's "
              f"{[e for e, _ in s['hist']]}")
        check(strip == r["planned"][0] == tile_epoch * (epochs - CKPT_EPOCH)
              and (qp, ud) == r["planned"][1:] and qp > 0,
              f"rank {rank}: launches differ from the plans")
        for e in r["reassigned"]:
            got, want = r["trace_before"][e], s["trace_before"][e]
            rel = abs(got - want) / abs(want)
            say(f"[{tag}] rank {rank} traces before the reassignment at epoch {e}: sum "
                f"{got!r}, straight run {want!r} (relative {rel:.2e}, limit {CKPT_RTOL:.2e})")
            check(rel <= CKPT_RTOL, f"rank {rank}: the traces at epoch {e} are not the "
                  "loaded ones plus the new epochs'")
    losses = np.asarray(res[0]["loss_curve"])
    want = np.asarray(straight[0]["loss_curve"])[CKPT_EPOCH:]
    for r in res[1:]:
        check(np.array_equal(np.asarray(r["loss_curve"]), losses), "ranks disagree on the loss")
    rel = float(np.max(np.abs(losses - want) / np.abs(want)))
    say(f"[{tag}] losses of epochs {CKPT_EPOCH + 1}-{epochs}: resumed "
        f"{np.round(losses, 5).tolist()}, straight {np.round(want, 5).tolist()}; max relative "
        f"difference {rel:.2e} (limit {CKPT_RTOL:.2e})")
    check(len(losses) == len(want) and np.isfinite(losses).all() and rel <= CKPT_RTOL,
          "the resumed losses left the straight run's")
    differ = sum(int(((a != b) & ((a > 0) | (b > 0))).sum())
                 for a, b in zip(res[0]["assignment"], straight[0]["assignment"]))
    lanes = sum(int((a > 0).sum()) for a in straight[0]["assignment"])
    say(f"[{tag}] rank 0's assignment after epoch {res[0]['reassigned'][-1]}: {differ} of "
        f"{lanes} lane widths differ from the straight run's (not gated: the card's sums "
        "reorder; the CPU test holds it exactly)")
    return losses, rel


def phase_ckpt(torch, args, k4):
    """Resume train_k's AdaQP run from its epoch-8 checkpoint on four new
    ranks: the loaded state equals each rank's state at the save bit for
    bit, the reassignment at epoch 11 runs on the loaded traces plus the
    new epochs' without profiling again, the kernels launch as planned,
    and the losses follow the straight run's."""
    straight = k4["AdaQP"]
    epochs = straight[0]["epochs"]
    res, wall, nbytes, cfg = _resume_k4(args, k4, "ckpt")
    _check_resumed("ckpt", res, straight, 6 * cfg.num_layers - 2)
    say(f"[ckpt] checkpoint {nbytes} bytes; save {straight[0]['ckpt_save_s']:.3f} s (rank 0, "
        f"gather + write + barrier), load {max(r['load_s'] for r in res):.3f} s (slowest rank); "
        f"launch + set-up + {epochs - CKPT_EPOCH} epochs {wall:.1f} s")
    return [r["launches"] for r in res]


def phase_partition(torch, args):
    """The native LDG against the numpy one on train_k's graph (and, with
    --full, the native one on Reddit's size), then the partitioning CLI."""
    import logging

    import numpy as np

    from adaqp_tpu_torch.graph.partition import partition_ldg
    from adaqp_tpu_torch.helper.dataset import REDDIT_C, REDDIT_E, REDDIT_F, REDDIT_N, synth_reddit

    seen = []

    class Paths(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    log = logging.getLogger("adaqp_tpu_torch")
    handler, level = Paths(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        for n in [args.nodes_k] + ([REDDIT_N] if args.full else []):
            e = REDDIT_E if n == REDDIT_N else n * round(REDDIT_E / REDDIT_N)
            g = synth_reddit(n, e, REDDIT_F, REDDIT_C, seed=SEED, device="cuda")
            keep = g.src != g.dst
            src, dst, name = g.src[keep], g.dst[keep], g.name
            del g
            seen.clear()
            t0 = time.perf_counter()
            part = partition_ldg(src, dst, n, 4)
            native_s = time.perf_counter() - t0
            check(any("native path" in m for m in seen), f"the native LDG did not run: {seen}")
            sizes = np.bincount(part, minlength=4).tolist()
            cut = int((part[src] != part[dst]).sum())
            line = (f"[partition] {n} nodes, {len(src)} edges without self-loops, K=4: native "
                    f"{native_s:.2f} s; part sizes {sizes}; edge cut {cut}")
            if n == args.nodes_k:
                t0 = time.perf_counter()
                plain = partition_ldg(src, dst, n, 4, native=False)
                numpy_s = time.perf_counter() - t0
                check(np.array_equal(part, plain), "the native and numpy LDG partitions differ")
                line += f"; numpy {numpy_s:.2f} s ({numpy_s / native_s:.0f}x), the same partition"
                cache = os.path.join(WORK, "k4_parts", f"{name}_4part_ldg.npy")
                if os.path.exists(cache):  # train_k's Trainer partitioned this graph
                    check(np.array_equal(np.load(cache), part), "train_k's partition differs")
                    line += ", as train_k's"
            else:  # the numpy path would take minutes at Reddit's size
                line += "; numpy not run"
            say(line)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    cli = subprocess.run(
        [sys.executable, "-m", "adaqp_tpu_torch.graph_partition", "--dataset", "sbm",
         "--partition_size", "4", "--partition_dir", os.path.join(WORK, "cli_parts")],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    said = cli.stdout.strip().splitlines()
    check(cli.returncode == 0 and said and said[-1].startswith("saved ")
          and "native path" in cli.stderr,
          f"the partitioning CLI failed (exit {cli.returncode}):\n{cli.stdout[-2000:]}"
          f"{cli.stderr[-2000:]}")
    say(f"[partition] python -m adaqp_tpu_torch.graph_partition --dataset sbm "
        f"--partition_size 4: {said[-1]}")


def phase_parity(torch, args):
    """The accuracy-parity experiment on the card (K=4 over gloo): every
    row finite and at least twice chance, every row's kernels launched as
    planned."""
    import math

    from adaqp_tpu_torch.scripts import accuracy_parity as ap

    rows = ap.main(["--epochs", str(args.epochs_parity),
                    "--workdir", os.path.join(WORK, "parity")])
    chance = 1.0 / ap.SYNTH["blocks"]
    for r in rows:
        say(f"[parity] {r['config']}: test {r['test']:.4f} (train {r['train']:.4f}, val "
            f"{r['val']:.4f}) in {r['seconds']:.1f} s; launches {r['launches']} (planned "
            f"{r['planned']})")
        check(math.isfinite(r["test"]) and r["test"] >= 2 * chance,
              f"{r['config']}: test accuracy {r['test']} below twice chance ({2 * chance})")
        check(r["launches"] == r["planned"] and r["launches"]["quant_pack"] > 0
              and r["launches"]["unpack_dequant"] > 0,
              f"{r['config']}: launches {r['launches']} against the plans {r['planned']}")
    return {k: sum(r["launches"][k] for r in rows)
            for k in ("strip_spmm", "quant_pack", "unpack_dequant")}


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
    in their contiguous forms bit for bit: bits 2/4/8, f32 and bf16 rows,
    row counts that are no multiple of the TPU kernel's 256, f_true < F, a
    constant row, no rows; and the round trip within one step. Then their
    lane forms on mixed-bucket tables (:func:`_hold_frames`)."""
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
    lane_q, lane_d = _hold_frames(torch, seed)
    return max(worst_q, lane_q), max(worst_d, lane_d)


def _hold_frames(torch, seed):
    """The lane forms (quant_frames, dequant_frames) against their plain
    versions on the card, on the lane tables of random K=4 plans with 2-,
    4- and 8-bit buckets (``tests/torch_helpers.py``): each rank's send
    buffer and ranges bit for bit; each rank's received rows stored at their
    destinations bit for bit (forward), or added there within 1e-6 * sum
    |terms| of index_add_'s (backward: the atomics' order; row 0 comes back
    from every peer); the sentinels of both directions dropped. Returns the
    largest differences (send bytes and ranges, received rows)."""
    import numpy as np

    from adaqp_tpu_torch.assigner.assignment import buckets_from_assignment, random_assignment
    from adaqp_tpu_torch.comm.exchange import padded_wire
    from adaqp_tpu_torch.ops import quant_cuda as qc

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_helpers import abs_sums, random_plan, rank_buckets, received_frames

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    saved = (qc.quant_rows.launches, qc.dequant_rows.launches)
    worst_q = worst_d = worst_sum = 0.0
    cases = []
    n_rows = 10_240
    for forward, f, ft, dtype in ((True, 640, 602, torch.bfloat16), (False, 256, 256, torch.float32),
                                  (True, 256, 256, torch.bfloat16), (False, 18, 18, torch.float32),
                                  (True, 18, 17, torch.float32)):
        plan = random_plan(rng, 4, n_rows, lanes=(1_000, 3_000))
        lowered = buckets_from_assignment(plan, random_assignment(plan, 1, seed), n_rows)[0]
        check(len(lowered[0]) == 3, "the random plan lacks a width")
        n_src, out_len = (n_rows, plan.r_pad) if forward else (plan.r_pad, n_rows)
        frames = [getattr(padded_wire(rank_buckets(lowered, r, "cuda"), ft, f),
                          "fwd" if forward else "bwd") for r in range(4)]
        bufs = []
        for r, fr in enumerate(frames):
            x = torch.randn(n_src, f, generator=gen, device="cuda").to(dtype)
            keys = [qc.stream_key(seed, r, i) for i in range(len(fr.bits))]
            got, rng_k = qc.quant_frames(x, fr, keys, with_range=True)
            want, rng_p = qc._quant_frames_torch(x, fr, keys, with_range=True)
            worst_q = max(worst_q, float((got.int() - want.int()).abs().max()),
                          float((rng_k - rng_p).abs().max()))
            check(torch.equal(got, want) and torch.equal(rng_k, rng_p),
                  f"quant_frames differs from its plain version (rank {r}, F={f}, {dtype})")
            bufs.append(got)
        for r, fr in enumerate(frames):
            recv = received_frames(bufs, frames, r)
            zeros = torch.zeros(out_len, f, device="cuda")
            got = qc.dequant_frames(recv, fr, zeros.clone(), add=not forward)
            want = qc._dequant_frames_torch(recv, fr, zeros.clone(), add=not forward)
            worst_d = max(worst_d, float((got - want).abs().max()))
            if forward:
                check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                      f"dequant_frames differs from its plain version (rank {r}, F={f})")
                continue
            scale = abs_sums(recv, fr, out_len, f)
            worst_sum = max(worst_sum, float(((got - want).abs() / (scale + 1e-30)).max()))
            check(bool(((got - want).abs() <= 1e-6 * scale).all()),
                  f"the backward sums differ beyond 1e-6 * sum |terms| (rank {r}, F={f})")
        cases.append(f"{'fwd' if forward else 'bwd'} F={f} f_true={ft} {str(dtype)[6:]} lanes "
                     f"{[fr.n for fr in frames]}")
    qc.quant_rows.launches, qc.dequant_rows.launches = saved
    say(f"[pad] lane forms on K=4 tables of 2/4/8-bit buckets ({'; '.join(cases)}): send "
        f"buffers, ranges and stored rows equal the plain versions bit for bit; backward sums "
        f"within {worst_sum:.2e} of sum |terms| (limit 1e-6)")
    return worst_q, worst_d


def phase_e2e_pad(torch, seed):
    """e2e_k on the padded wire: K=2 SBM, f32, two ranks on the card over
    gloo against the same ranks on the CPU, Vanilla and AdaQP (uniform 8
    bits), the breakdown probe on. The counter generator draws the same
    codes on both devices."""
    import numpy as np

    from adaqp_tpu_torch.comm.distributed import spawn

    modes = ("Vanilla", "AdaQP")
    configs = [{
        "num_parts": 2, "mode": mode, "assign_scheme": "uniform", "assign_bits": 8,
        "wire_impl": "padded", "num_epochs": 6, "hidden_dim": 32, "dropout_rate": 0.0,
        "log_steps": 100, "block_min_edges": 1, "logger_level": "WARNING",
        "synth_kwargs": {"n": 1200, "blocks": 4, "num_feats": 16, "seed": seed},
        "partition_dir": os.path.join(WORK, "e2ek_parts"),
        "exp_path": os.path.join(WORK, "e2epad_exp"),
    } for mode in modes]
    runs = _e2e_curves(spawn(_e2e_worker, 2, "cuda", args=(configs,),
                             workdir=os.path.join(WORK, "launch"), timeout_s=180), modes)
    tol = 1e-5  # the e2e_k limit: the same codes, f32 sums in another order
    for mode in modes:
        card, cpu = runs[mode]
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
    res = spawn(_train_k_worker, 4, "cuda", args=(cfg, graph_fn, True, args.parent_rows),
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
    check(r0["sides"], "no padded exchange was recorded")
    before = {"old": "this tree's contiguous kernels"}
    if args.parent_rows:
        before["parent"] = f"the contiguous kernels of {args.parent_rows}"
    tot = dict.fromkeys(["send_ms", "recv_ms"] + [f"{k}_{d}_ms" for k in before
                                                   for d in ("send", "recv")], 0.0)
    for x in r0["sides"]:
        say(f"[train_pad] rank 0 exchange, layer {x['layer']} {x['dir']} F={x['F']} "
            f"f_true={x['f_true']} {x['dtype']}: {x['lanes']} lanes, (bits, lanes) "
            f"{x['buckets']}; send side (quant_frames) {x['send_ms']:.4f} ms, receive side "
            f"(dequant_frames) {x['recv_ms']:.4f} ms; the per-bucket composition before, "
            + "; ".join(f"on {what}: send {x[k + '_send_ms']:.4f} ms, receive "
                        f"{x[k + '_recv_ms']:.4f} ms" for k, what in before.items())
            + " (CUDA events behind a backlog)")
        for k in tot:
            tot[k] += x[k]
    say(f"[train_pad] rank 0, the {len(r0['sides'])} exchanges of one step: send + receive "
        f"{tot['send_ms'] + tot['recv_ms']:.4f} ms on the lane tables (send "
        f"{tot['send_ms']:.4f}, receive {tot['recv_ms']:.4f}); per bucket before, "
        + "; ".join(f"on {what}: {tot[k + '_send_ms'] + tot[k + '_recv_ms']:.4f} ms (send "
                    f"{tot[k + '_send_ms']:.4f}, receive {tot[k + '_recv_ms']:.4f})"
                    for k, what in before.items()))
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


def _case_frames(torch, gen, case):
    """Lane tables of one shape of :func:`_pad_cases` on the card: the
    probe's identity tables, or source and destination rows drawn within
    the shape's ranges, about one lane in eight a sentinel (a source past
    the rows backward, a destination past the output), destinations unique
    forward and repeated backward."""
    from adaqp_tpu_torch.ops import quant_cuda as qc

    kind, bits, counts, f, ft, dt, n_src, n_out = case
    n = sum(counts)
    dev = "cuda"
    if kind == "probe":
        src = dst = torch.arange(n, device=dev)
    else:
        src = torch.randint(0, n_src, (n,), generator=gen, device=dev)
        if kind == "bwd":
            dst = torch.randint(0, n_out, (n,), generator=gen, device=dev)
            src[torch.rand(n, generator=gen, device=dev) < 0.125] = n_src
        else:
            dst = torch.randperm(n_out + n, generator=gen, device=dev)[:n]
        dst[torch.rand(n, generator=gen, device=dev) < 0.125] = n_out
        dst = dst.clamp(max=n_out)
    cuts = torch.tensor(counts).cumsum(0)[:-1].tolist()
    return qc.make_frames(bits, list(torch.tensor_split(src, cuts)),
                          list(torch.tensor_split(dst, cuts)), ft)


def phase_time_pad(torch, card, res):
    """quant_rows and dequant_rows in their lane forms on tables of every
    shape train_pad gave them (each rank's directions under each
    assignment, and the probe's identity tables; :func:`_case_frames`), held
    against their plain versions: send buffers and stored rows bit for bit,
    backward sums within 1e-6 * sum |terms|. Then both timed at the largest
    layer-0 bucket on identity tables (bf16 rows of 640 columns, 602 true),
    beside their bounds (bytes, and the operations of their hot loops'
    SASS), their plain versions, torch.addcdiv for the receive arithmetic,
    and their contiguous forms at the same rows. Returns the two kernels'
    time rows and their max |kernel - plain| (send bytes and ranges;
    rows)."""
    from adaqp_tpu_torch.ops import quant_cuda as qc
    from adaqp_tpu_torch.ops.quant import pad_features

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_helpers import abs_sums

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = sorted({c for r in res for c in r["pad_cases"]})
    saved = (qc.quant_rows.launches, qc.dequant_rows.launches)
    worst_q = worst_d = 0.0
    for case in cases:
        kind, bits, counts, f, ft, dt, n_src, n_out = case
        fr = _case_frames(torch, gen, case)
        x = torch.randn(n_src, f, generator=gen, device="cuda").to(getattr(torch, dt))
        keys = [qc.stream_key(5, i) for i in range(len(bits))]
        add = kind == "bwd"
        got, rng = qc.quant_frames(x, fr, keys, with_range=add)
        want, rng0 = qc._quant_frames_torch(x, fr, keys, with_range=add)
        tag = f"{kind} bits {bits} lanes {counts} F={f} f_true={ft} {dt}"
        worst_q = max(worst_q, float((got.int() - want.int()).abs().max()),
                      float((rng - rng0).abs().max()) if add else 0.0)
        check(torch.equal(got, want) and (not add or torch.equal(rng, rng0)),
              f"{tag}: quant_frames differs from the plain version")
        zeros = torch.zeros(n_out, f, device="cuda")
        y = qc.dequant_frames(got, fr, zeros.clone(), add)
        y0 = qc._dequant_frames_torch(got, fr, zeros.clone(), add)
        worst_d = max(worst_d, float((y - y0).abs().max()))
        tol = 1e-6 * abs_sums(got, fr, n_out, f) if add else 0.0
        check(bool(((y - y0).abs() <= tol).all()), f"{tag}: dequant_frames differs from the "
              "plain version")
    say(f"[time] quant_rows and dequant_rows (lane forms) equal their plain versions at all "
        f"{len(cases)} shapes train_pad gave them (direction, bits, lanes a bucket, F, f_true, "
        f"dtype, source rows, output rows): {cases}")
    clock = sm_clock_mhz()
    sass = {"quant": sass_per_element("quant_rows", "17quant_rows_kernelILb1ELb1E", "I2F",
                                      cheapest=True),
            "dequant": sass_per_element("quant_rows", "19dequant_rows_kernelILb1ELb1ELb0E", "I2F",
                                        cheapest=True)}
    for name, (counts, elems, n_ins) in sass.items():
        say(f"[time] {card} | SASS of the {name}_rows lane form's cheapest coding loop: {n_ins} "
            f"instructions for {elems} elements; an element: "
            + ", ".join(f"{v:.2f} {k}" for k, v in counts.items()))
    # the largest layer-0 bucket of training (the probe's rows aside)
    bits, n = max(res[0]["pad_shapes"], key=lambda s: s[1])
    f, ft = 640, 602
    fw = pad_features(ft)
    x = torch.randn(n, f, generator=gen, device="cuda").to(torch.bfloat16)
    ident = torch.arange(n, device="cuda")
    fr = qc.make_frames((bits,), [ident], [ident], ft)
    buf = qc.quant_frames(x, fr, (5,))[0]
    out = torch.empty(n, f, device="cuda")
    ms_q = cuda_ms(torch, lambda: qc.quant_frames(x, fr, (5,)), reps=20, backlog=True)
    ms_d = cuda_ms(torch, lambda: qc.dequant_frames(buf, fr, out), reps=20, backlog=True)
    # the contiguous forms at the same rows: the codes of the wire's columns
    # back, with the pair through bf16
    q, sc, rm = qc.quant_rows(x, bits, ft, 5)
    p = torch.stack([sc, rm], dim=-1).to(torch.bfloat16).float()
    qw, ps, pr = q[:, :fw].contiguous(), p[:, 0].contiguous(), p[:, 1].contiguous()
    ms_qc = cuda_ms(torch, lambda: qc.quant_rows(x, bits, ft, 5), reps=20, backlog=True)
    ms_dc = cuda_ms(torch, lambda: qc.dequant_rows(qw, ps, pr), reps=20, backlog=True)
    qc.quant_rows.launches, qc.dequant_rows.launches = saved
    clock_now = sm_clock_mhz()[0]
    plain_q = cuda_ms(torch, lambda: qc._quant_frames_torch(x, fr, (5,)), reps=3, warmup=1)
    plain_d = cuda_ms(torch, lambda: qc._dequant_frames_torch(buf, fr, out), reps=3, warmup=1)
    # one library call computes rmin + q / scale (the port never calls it)
    lib_d = cuda_ms(torch, lambda: torch.addcdiv(pr[:, None], qw, ps[:, None]), reps=20,
                    backlog=True)
    lib_err = float((torch.addcdiv(pr[:, None], qw, ps[:, None])
                     - qc._dequant_rows_torch(qw, ps, pr)).abs().max())
    # the columns a frame codes read once (min(F, F_wire) of each row),
    # frames written once, the four lane tables read; then frames and three
    # tables read, rows written once
    bytes_q = n * min(f, fw) * 2 + fr.nbytes + 4 * 8 * n
    bytes_d = fr.nbytes + 3 * 8 * n + n * f * 4
    bounds = []
    for nbytes, (counts, _, _), elems in ((bytes_q, sass["quant"], n * fw),
                                          (bytes_d, sass["dequant"], n * ft)):
        b_ms = nbytes / PEAK_BYTES_S * 1e3
        o_ms, pipe = ops_ms(counts, elems, clock[1])
        bounds.append((max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", b_ms, o_ms,
                       pipe))
    (bq, byq, bqb, bqo, pq), (bd, byd, bdb, bdo, pd) = bounds
    say(f"[time] {card} | quant_rows (quant_frames) N={n} F={f} f_true={ft} {bits} bits bf16, "
        f"identity tables: kernel {ms_q:.4f} ms; bound {bq:.4f} ms by {byq} (bytes {bqb:.4f} ms, "
        f"{bytes_q / 1e6:.1f} MB; operations {bqo:.4f} ms on the {pq} pipe, {n * fw} elements "
        f"at {clock[1]:g} MHz; SM clock {clock_now:g} MHz after the runs); plain {plain_q:.3f} "
        f"ms; library none; contiguous form quant_rows {ms_qc:.4f} ms")
    say(f"[time] {card} | dequant_rows (dequant_frames) N={n} F={f} f_true={ft}: kernel "
        f"{ms_d:.4f} ms; bound {bd:.4f} ms by {byd} (bytes {bdb:.4f} ms, {bytes_d / 1e6:.1f} MB; "
        f"operations {bdo:.4f} ms on the {pd} pipe, {n * ft} elements); plain {plain_d:.3f} ms; "
        f"torch.addcdiv {lib_d:.4f} ms on the {fw} wire columns (max |addcdiv - plain| "
        f"{lib_err:g}); contiguous form dequant_rows {ms_dc:.4f} ms")
    return ((dict(ms=ms_q, plain_ms=plain_q, bound_ms=bq, bound_by=byq, library_ms=None),
             dict(ms=ms_d, plain_ms=plain_d, bound_ms=bd, bound_by=byd, library_ms=lib_d)),
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
    reverse, rectangular (halo-shaped), a rectangular block layout whose
    rows are padded to 256 only (its last strip part-filled), empty; a
    compact layout with full tiles, subtile groups and an ELL tail, and one
    of groups only whose targets take subtiles from two items; bf16 and
    f32 at F=128, 256, 384 and 640; and each through its autograd
    backward."""
    import numpy as np

    from adaqp_tpu_torch.ops import spmm_block as sb
    from adaqp_tpu_torch.ops import spmm_compact as sc

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_helpers import merged_targets

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, n_src = 8192, 6144
    src, dst = _tiered_edges(rng, n, n, 150_000)
    rs, rd = _tiered_edges(rng, 4096, n_src, 60_000)
    ps, pd = _tiered_edges(rng, 4352, n_src, 60_000)
    ms, md = _tiered_edges(rng, n, n, 60_000)
    e0 = np.zeros(0, np.int32)
    errs = {"block_spmm": 0.0, "compact_spmm": 0.0, "gather_rows": 0.0}

    def cases(name, wrapper, plain, lays):
        for tag, lay in lays:
            for dtype in (torch.bfloat16, torch.float32):
                for f in (128, 256, 384, 640):
                    out, err = _hold(torch, gen, f"{name} {tag}", wrapper, plain, lay, f,
                                     dtype, "agg")
                    errs[name] = max(errs[name], err)
                    if tag.startswith("empty"):
                        check(not out.any(), f"{name} {tag}: the empty layout did not give zeros")

    block = [
        ("forward", sb.block_layout(src, dst, n, min_edges=64)),
        ("reverse", sb.block_layout(dst, src, n, min_edges=64)),
        (f"rectangular 4096x{n_src}", sb.block_layout(rs, rd, 4096, min_edges=64, n_src=n_src)),
        (f"rectangular 4352x{n_src} (part-filled strip)",
         sb.block_layout(ps, pd, 4352, min_edges=16, n_src=n_src)),
        ("empty 2048x4096", sb.block_layout(e0, e0, 2048, n_src=4096)),
    ]
    check(block[2][1].masks.any(), "the rectangular block layout has no set bit")
    part = block[3][1]
    check(part.n_pad % 2048 and part.masks[part.dst_blk >= part.n_pad // 2048 * 8].any(),
          "the part-filled block layout has no dense tile in its last strip")
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
    spill = sc.compact_layout(ms, md, n, full_cols=2048)
    merged = merged_targets(spill)
    say(f"[agg] compact groups-only layout of {len(ms)} edges: {merged} targets take subtiles "
        "from more than one item (one walk tile each)")
    check(merged > 0, "no compact target takes subtiles from two items")
    rect = sc.compact_layout(rs, rd, 4096, n_src=n_src)
    check((rect.kind == 1).any(), "the rectangular compact layout holds no group")
    cases("compact_spmm", sc.compact_spmm, sc._run_compact_torch, [
        ("three-tier", tiers.to_device("cuda")),
        ("all groups (full_cols 2048)", groups.to_device("cuda")),
        ("merged subtiles (full_cols 2048)", spill.to_device("cuda")),
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

    # the row gather, bit for bit, at the probe's shape, ragged ones and an
    # idx that starts 4 bytes past 16 (the scalar path)
    for r, c, skew in ((2048, 128, 0), (1000, 37, 0), (2048, 1, 0), (1000, 128, 1)):
        x = torch.randn(r, c, generator=gen, device="cuda")
        idx = torch.empty(r * c + skew, device="cuda", dtype=torch.int32)[skew:].view(r, c)
        idx.copy_(torch.randint(0, r, (r, c), generator=gen, device="cuda", dtype=torch.int32))
        saved = sc.gather_rows.launches
        got = sc.gather_rows(x, idx)
        torch.cuda.synchronize()
        check(sc.gather_rows.launches == saved + 1, "gather_rows did not launch")
        sc.gather_rows.launches = saved
        want = torch.take_along_dim(x, idx.long(), dim=0)
        errs["gather_rows"] = max(errs["gather_rows"], float((got - want).abs().max()))
        say(f"[agg] gather_rows [{r}, {c}] idx at +{4 * skew} bytes: max |kernel - "
            f"take_along_dim| {float((got - want).abs().max()):g}")
        check(torch.equal(got, want), "gather_rows differs from torch.take_along_dim")
    return errs


def phase_e2e_agg(torch, seed):
    """K=2 on the SBM, f32, Vanilla, for block, compact and segment: two
    ranks on the card over gloo against the same ranks on the CPU."""
    import numpy as np

    from adaqp_tpu_torch.comm.distributed import spawn

    impls = ("block", "compact", "segment")
    configs = [{
        "num_parts": 2, "mode": "Vanilla", "spmm_impl": impl, "num_epochs": 6,
        "hidden_dim": 32, "dropout_rate": 0.0, "log_steps": 100, "block_min_edges": 64,
        "compact_me_ell": 16, "logger_level": "WARNING",
        "synth_kwargs": {"n": 1200, "blocks": 4, "num_feats": 16, "seed": seed},
        "partition_dir": os.path.join(WORK, "e2eagg_parts"),
        "exp_path": os.path.join(WORK, "e2eagg_exp"),
    } for impl in impls]
    runs = _e2e_curves(spawn(_e2e_worker, 2, "cuda", args=(configs,),
                             workdir=os.path.join(WORK, "launch"), timeout_s=240), impls)
    tol = 1e-5  # the e2e_k limit: f32 sums in another order, nothing more
    for impl in impls:
        card, cpu = runs[impl]
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
    return out, g


class _LineCatcher:
    """Collects the port's log lines that contain ``marker``."""

    def __init__(self, marker):
        import logging

        self.lines, self.log = [], logging.getLogger("adaqp_tpu_torch")
        catcher = self

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if marker in msg:
                    catcher.lines.append(msg)

        self.handler = Handler()
        self.log.addHandler(self.handler)

    def close(self):
        self.log.removeHandler(self.handler)


def phase_remat(torch, args, agg_graph, k4, ckpt_l):
    """Layer recomputation (``remat``) on the card. (a) The products GCN at
    K=1 through strip, on train_agg's graph and cached layout (or, with
    another ``--nodes_remat``, a graph of its own), twice from one set of
    initial parameters: remat off, then on, each with ``log_hbm``. The
    losses agree within one bf16 step, the recompute's strip launches are
    the plan's, the remat run's peak is the lower, and each run's
    ``log_hbm`` line agrees with the phase's own readings. (b) Four new
    ranks resume train_k's epoch-8 checkpoint with remat on: as phase ckpt,
    the straight run's losses within one bf16 step, its reassignment at 11,
    the launches as planned (the recompute ships nothing again, so the
    quant kernels launch as without it). Returns each run's launches."""
    import numpy as np

    from adaqp_tpu_torch.helper.dataset import synth_reddit
    from adaqp_tpu_torch.ops import spmm_strip as ss
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    n = args.nodes_remat
    parts = os.path.join(WORK, "agg_parts")
    if agg_graph is None or n != args.nodes_agg:
        e = round(n * PRODUCTS_E / PRODUCTS_N)
        t0 = time.perf_counter()
        agg_graph = synth_reddit(n, e, PRODUCTS_F, PRODUCTS_C, seed=SEED, device="cuda")
        parts = os.path.join(WORK, f"remat_parts_{n}")
        say(f"[remat] products-degree banded graph: {n} nodes, {e} unique directed edges: "
            f"{time.perf_counter() - t0:.1f} s")
    runs, init = {}, None
    for remat in (False, True):
        cfg = RunConfig.from_yaml("ogbn-products", {
            "num_parts": 1, "mode": "Vanilla", "num_epochs": args.epochs_agg,
            "log_steps": 10 ** 6, "partition_dir": parts,
            "exp_path": os.path.join(WORK, "agg_exp"), "seed": SEED, "logger_level": "INFO",
            "measure_breakdown": False, "spmm_impl": "strip", "remat": remat, "log_hbm": True,
        })
        t0 = time.perf_counter()
        t = Trainer(cfg, graph=agg_graph)
        setup_s = time.perf_counter() - t0
        if init is None:
            init = [{k: v.detach().cpu().numpy().copy() for k, v in layer.items()}
                    for layer in t.params]
        t.load_params(init)
        catcher = _LineCatcher("train-step HBM")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        ss.strip_spmm.launches = 0
        try:
            rec = t.train()
        finally:
            catcher.close()
        torch.cuda.synchronize()
        peak, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        launches = ss.strip_spmm.launches
        tag = "remat" if remat else "plain"
        adam = 2 * sum(p.numel() * p.element_size() for layer in t.params for p in layer.values())
        hbm = rec["hbm"]
        say(f"[remat] {tag}: {n} nodes, set-up {setup_s:.1f} s; losses "
            f"{np.round(rec['loss_curve'], 5).tolist()}; median step "
            f"{rec['per_epoch'] * 1e3:.2f} ms; peak max_memory_allocated {peak} bytes "
            f"({peak / 2**30:.3f} GiB), {before} before train(); strip launches {launches} "
            f"(planned {rec['planned_tile_launches']})")
        for line in catcher.lines:
            say(f"[remat] {tag} log_hbm: {line}")
        check(len(catcher.lines) == 1 and hbm is not None and hbm["temps_exact"],
              f"{tag}: no log_hbm line with the step's own peak ({catcher.lines})")
        # the run's peak above args is the first step's plus what that step
        # allocated after its peak and kept, less the gradients (freed at
        # each step's start): Adam's moments, and in a fresh process the
        # backward thread's cuBLAS workspace
        extra, kept = (peak - before) - hbm["temps"], after - before - hbm["output"]
        say(f"[remat] {tag}: log_hbm args {hbm['args']} (phase {before}), temps {hbm['temps']} "
            f"(the run's peak above args {peak - before}, {extra} more; kept after the run "
            f"besides the gradients {kept}, Adam's moments {adam} of it), output {hbm['output']}")
        check(hbm["args"] == before and 0 <= extra <= kept + 2 ** 20,
              f"{tag}: the log_hbm line disagrees with the phase's readings")
        check(hbm["output"] == adam // 2, f"{tag}: output {hbm['output']} is not the gradients'")
        check(launches == rec["planned_tile_launches"], f"{tag}: strip launched {launches} "
              f"times, planned {rec['planned_tile_launches']}")
        check(np.isfinite(rec["loss_curve"]).all(), f"{tag}: a loss is not finite")
        runs[tag] = {"losses": np.asarray(rec["loss_curve"]), "peak": peak,
                     "step_ms": rec["per_epoch"] * 1e3, "launches": launches,
                     "planned": rec["planned_tile_launches"], "temps": hbm["temps"]}
        del t
        torch.cuda.empty_cache()
    plain, remat = runs["plain"], runs["remat"]
    layers, epochs = 3, args.epochs_agg
    rel = float(np.max(np.abs(remat["losses"] - plain["losses"]) / np.abs(plain["losses"])))
    say(f"[remat] {n} nodes: losses max relative difference {rel:.2e} (limit {CKPT_RTOL:.2e}); "
        f"peak {plain['peak'] / 2**30:.3f} -> {remat['peak'] / 2**30:.3f} GiB "
        f"({(plain['peak'] - remat['peak']) / 2**30:.3f} GiB less); median step "
        f"{plain['step_ms']:.2f} -> {remat['step_ms']:.2f} ms")
    check(rel <= CKPT_RTOL, "the remat run's losses left the plain run's")
    check(remat["planned"] == plain["planned"] + 2 * layers * epochs,
          "the remat plan is not the plain plan plus two forward aggregations a layer a step")
    check(remat["peak"] < plain["peak"], "remat did not lower the peak")
    out = {"strip": plain["launches"] + remat["launches"], "quant_pack": 0, "unpack_dequant": 0}
    if k4 is None:
        return out
    # (b) the K=4 run resumed from train_k's checkpoint, recomputing its layers
    res, wall, _, cfg = _resume_k4(args, k4, "remat", remat=True)
    check(cfg.remat, "the resumed ranks' config lost --remat")
    _check_resumed("remat", res, k4["AdaQP"], 6 * cfg.num_layers - 2 + 2 * cfg.num_layers)
    if ckpt_l is not None:
        # against the same run without remat: the same wire launches
        check([r["launches"][1:] for r in res] == [l[1:] for l in ckpt_l],
              "the remat run's quant launches differ from the run without it")
    say(f"[remat] K=4 resumed with remat: launch + set-up + "
        f"{k4['AdaQP'][0]['epochs'] - CKPT_EPOCH} epochs {wall:.1f} s")
    for i, name in enumerate(("strip", "quant_pack", "unpack_dequant")):
        out[name] += sum(r["launches"][i] for r in res)
    return out


# GraphSAINT's Yelp (the source of config/yelp.yaml): nodes, undirected
# edges (mean degree 2 x 6,977,410 / 716,847 = 19.47), feature width and
# classes of its multilabel task
YELP_N, YELP_E, YELP_F, YELP_C = 716_847, 6_977_410, 300, 100
# R-MAT draws this many edges a node; after symmetrizing and dropping
# repeats the mean degree comes to about Yelp's (20.0 at 131,072 nodes)
SAGE_RMAT_DEGREE = 11
# the Yelp-width runs' epochs, and the K=4 run's cycle: one reassignment, at 6
SAGE_EPOCHS, SAGE_CYCLE = 8, 5
# the K=2 card-against-CPU runs: (aggregator, mode)
SAGE_E2E = (("mean", "Vanilla"), ("mean", "AdaQP"), ("gcn", "Vanilla"))


def _yelp_raw(n, out):
    """A graph of Yelp's shape in GraphSAINT's raw format under ``out``
    (``adj_full.npz`` without self-loops, ``feats.npy``, ``class_map.json``,
    ``role.json``): the port's structured R-MAT at ``n`` nodes, 300
    features and 100 classes, with the feature hint and homophily of
    ``accuracy_parity --scale``; each node's labels its community and one
    class drawn at random (as ``sbm_graph``'s multilabel labels).
    Returns (directed edges without self-loops, seconds)."""
    import numpy as np
    import scipy.sparse as sp

    from adaqp_tpu_torch.helper.dataset import rmat_graph

    t0 = time.perf_counter()
    g = rmat_graph(n=n, avg_degree=SAGE_RMAT_DEGREE, num_feats=YELP_F, num_classes=YELP_C,
                   seed=SEED, structured=True, hint=2.5, homophily=0.3)
    labels = np.zeros((n, YELP_C), np.int8)
    labels[np.arange(n), g.labels] = 1
    labels[np.arange(n), np.random.default_rng(SEED).integers(0, YELP_C, n)] = 1
    off = g.src != g.dst
    adj = sp.csr_matrix((np.ones(int(off.sum()), np.float32), (g.src[off], g.dst[off])),
                        shape=(n, n))
    os.makedirs(out, exist_ok=True)
    sp.save_npz(os.path.join(out, "adj_full.npz"), adj, compressed=False)
    np.save(os.path.join(out, "feats.npy"), g.feats)
    with open(os.path.join(out, "class_map.json"), "w") as f:
        json.dump({str(i): row for i, row in enumerate(labels.tolist())}, f)
    with open(os.path.join(out, "role.json"), "w") as f:
        json.dump({role: np.flatnonzero(m).tolist() for role, m in
                   (("tr", g.train_mask), ("va", g.val_mask), ("te", g.test_mask))}, f)
    return int(off.sum()), time.perf_counter() - t0


def _yelp_cfg(raw, k):
    """``config/yelp.yaml`` on the raw files ``raw`` at ``k`` partitions."""
    from adaqp_tpu_torch.trainer import RunConfig

    cfg = RunConfig.from_yaml("yelp", {
        "raw_dir": raw, "num_parts": k, "num_epochs": SAGE_EPOCHS, "assign_cycle": SAGE_CYCLE,
        "log_steps": 10 ** 6, "measure_breakdown": False, "seed": SEED,
        "logger_level": "WARNING", "partition_dir": os.path.join(WORK, "sage_parts"),
        "exp_path": os.path.join(WORK, "sage_exp"),
    })
    check((cfg.model_name, cfg.aggregator_type, cfg.num_layers, cfg.hidden_dim,
           cfg.dropout_rate, cfg.use_norm, cfg.learning_rate, cfg.agg_dtype, cfg.spmm_impl,
           cfg.mode, cfg.assign_scheme, cfg.wire_impl) ==
          ("sage", "mean", 3, 256, 0.5, True, 0.01, "bfloat16", "auto", "AdaQP", "adaptive",
           "ragged"), "yelp.yaml no longer holds Yelp's SAGE settings")
    return cfg


def _sage_run(torch, t):
    """Train ``t`` with the launch counters set to 0 just before and read
    just after: its record, the (strip, quant_pack, unpack_dequant)
    launches, its reassignment epochs and its peak memory in bytes."""
    from adaqp_tpu_torch.ops import quant_cuda as qc
    from adaqp_tpu_torch.ops import spmm_strip as ss

    reassigned, reassign = [], t._reassign
    t._reassign = lambda epoch: (reassigned.append(epoch), reassign(epoch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss.strip_spmm.launches = qc.quant_pack.launches = qc.unpack_dequant.launches = 0
    rec = t.train()
    launches = (ss.strip_spmm.launches, qc.quant_pack.launches, qc.unpack_dequant.launches)
    torch.cuda.synchronize()
    return rec, launches, reassigned, torch.cuda.max_memory_allocated()


def _sage_k_worker(rank, world, device, cfg, go):
    """One rank of the K=4 Yelp-width run: set up from the raw files, wait
    for the file ``go``, train, and report what the phase prints and
    checks."""
    import torch
    import torch.distributed as dist

    from adaqp_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    t = Trainer(cfg, device=device)
    setup_s = time.perf_counter() - t0
    with open(f"{go}.ready{rank}", "w"):
        pass
    while not os.path.exists(go):  # the phase's K=1 run has the card until then
        time.sleep(0.05)
    t0 = time.perf_counter()
    rec, launches, reassigned, peak = _sage_run(torch, t)
    train_s = time.perf_counter() - t0
    flat = torch.cat([p.detach().reshape(-1) for layer in t.params for p in layer.values()]).cpu()
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat)
    check(all(torch.equal(x.view(torch.int32), flat.view(torch.int32)) for x in every),
          f"rank {rank}: parameters differ across ranks")
    check("jax" not in sys.modules, "a rank imported jax")
    lay = t.layout
    return {"setup_s": setup_s, "train_s": train_s, "losses": rec["loss_curve"], "step_ms": rec["per_epoch"] * 1e3,
            "best": rec["best"], "launches": launches, "reassigned": reassigned, "peak": peak,
            "planned": (rec["planned_tile_launches"], *rec["planned_quant_launches"]),
            "profile_s": t.profile_s, "l_max": lay.l_max, "r_pad": lay.plan_fwd.r_pad,
            "num_local": int(lay.num_local[rank]), "lanes": int(lay.plan_fwd.counts[rank].sum()),
            "f": (t.static.f_pad, lay.f_true), "checksum": float(flat.double().sum())}


def _say_sage(tag, rec, launches, reassigned, peak, planned):
    import numpy as np

    say(f"[sage] {tag}: losses {[round(float(x), 5) for x in rec['loss_curve']]}; median step "
        f"{rec['per_epoch'] * 1e3:.2f} ms; peak max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.3f} GiB); best (epoch, train, val, test micro-F1) {rec['best']}; "
        f"launches strip / quant_pack / unpack_dequant {launches}, planned {planned}; "
        f"reassigned at {reassigned}")
    check(np.isfinite(rec["loss_curve"]).all(), f"{tag}: a loss is not finite")
    check(tuple(launches) == tuple(planned), f"{tag}: launches {launches} differ from the "
          f"plans {planned}")


def _hold_sage_strip(torch, t):
    """strip_spmm against its plain version on the Yelp layout's forward
    and backward local parts: layer 0's rows (the raw features, 300 of 384
    columns) and random rows at the hidden width 256. Returns the largest
    |kernel - plain|."""
    from adaqp_tpu_torch.ops import spmm_strip as ss

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feats = t.sh.feats
    saved, worst = ss.strip_spmm.launches, 0.0
    for name, lay in zip(("fwd_local", "bwd_local"), t.blocks.devices()[:2]):
        for f in (feats.shape[1], 256):
            h = torch.randn(lay.n_src_pad, f, generator=gen, device="cuda").to(torch.bfloat16)
            if f == feats.shape[1]:
                h.zero_()[:feats.shape[0]] = feats
            got = ss.strip_spmm(lay, h)
            want = ss._run_strip_torch(lay, h)
            err, ratio = compare(torch, got, want, BF16_ATOL, BF16_RTOL)
            worst = max(worst, err)
            say(f"[sage] strip_spmm {name} F={f}: max |kernel - plain| {err:.3g}, {ratio:.3f} "
                f"of the tolerance ({BF16_ATOL} + 2^-7 |plain|)")
            check(ratio <= 1.0, f"strip_spmm {name} F={f} disagrees with its plain version")
    ss.strip_spmm.launches = saved
    return worst


def _beside(worker, world, args, timeout_s):
    """``spawn(worker, world, "cuda", args)`` in a thread of its own: returns
    the thread and a dict that gets the ranks' results ("res") or what
    they raised ("exc"), and the seconds ("s")."""
    import threading

    from adaqp_tpu_torch.comm.distributed import spawn

    out, t0 = {}, time.perf_counter()

    def launch():
        try:
            out["res"] = spawn(worker, world, "cuda", args=args,
                               workdir=os.path.join(WORK, "launch"), timeout_s=timeout_s)
        except BaseException as exc:  # raised by _joined
            out["exc"] = exc
        out["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=launch)
    thread.start()
    return thread, out


def _joined(thread, out):
    thread.join()
    if "exc" in out:
        raise out["exc"]
    return out["res"], out["s"]


def phase_sage(torch, args, card):
    """GraphSAGE and the multilabel task on the card. (a) K=2 on a
    multilabel SBM-1200, f32: SAGE-mean in Vanilla and AdaQP (uniform 8
    bits) and SAGE-gcn in Vanilla, each on the card and on the CPU in the
    same two ranks; the losses within 1e-5 relative. (b) Yelp's published
    configuration (``config/yelp.yaml``: SAGE-mean 300 -> 256 -> 256 -> 100,
    bf16 aggregation) on a graph of Yelp's shape written as GraphSAINT raw
    files and loaded by ``load_yelp``, through ``RunConfig.from_yaml``: at
    K=1, then at K=4 (four ranks over gloo on the card, AdaQP adaptive on the
    ragged wire, a reassignment at epoch 6); each run's launches equal to
    the Trainer's plans. Between them, the kernels at the SAGE shapes
    against their plain versions (strip_spmm at F=384 and 256, the quant
    pair at f_true 300 within 384, bit for bit) and strip_spmm timed at
    F=384. (a) runs while this process writes the raw files and sets up
    the K=1 run, and the K=4 ranks set up beside the K=1 run and train only
    after it: each timed run has the card to itself. Returns the launches
    of (b) and the holds' errors."""
    import numpy as np

    from adaqp_tpu_torch.trainer import Trainer

    configs = [{
        "num_parts": 2, "model_name": "sage", "aggregator_type": agg, "mode": mode,
        "assign_scheme": "uniform", "assign_bits": 8, "num_epochs": 4, "hidden_dim": 32,
        "dropout_rate": 0.0, "log_steps": 100, "block_min_edges": 1, "logger_level": "WARNING",
        "synth_kwargs": {"n": 1200, "blocks": 4, "num_feats": 16, "seed": SEED,
                         "multilabel": True},
        "partition_dir": os.path.join(WORK, "sage_e2e_parts"),
        "exp_path": os.path.join(WORK, "sage_e2e_exp"),
    } for agg, mode in SAGE_E2E]
    n = args.nodes_sage
    raw = os.path.join(WORK, f"yelp_raw_{n}")
    go = os.path.join(WORK, "sage_k4_go")
    if os.path.exists(go):
        os.remove(go)
    e2e, k4_job = _beside(_e2e_worker, 2, (configs,), 180), None
    try:
        edges, write_s = _yelp_raw(n, raw)
        k4_job = _beside(_sage_k_worker, 4, (_yelp_cfg(raw, 4), go), 600)
        t0 = time.perf_counter()
        t = Trainer(_yelp_cfg(raw, 1))
        setup_s = time.perf_counter() - t0

        # (a) the card against the CPU
        res, e2e_s = _joined(*e2e)
        curves = _e2e_curves(res, SAGE_E2E)
        for agg, mode in SAGE_E2E:
            card_l, cpu_l = curves[agg, mode]
            rel = float(np.max(np.abs(card_l - cpu_l) / np.abs(cpu_l)))
            say(f"[sage] K=2 f32 multilabel SBM-1200 SAGE-{agg} {mode}: card losses "
                f"{np.round(card_l, 5).tolist()}; max relative difference to the CPU run "
                f"{rel:.2e} (limit 1e-5)")
            check(np.isfinite(card_l).all() and rel <= 1e-5,
                  f"SAGE-{agg} {mode}: card and CPU K=2 runs disagree")
        say(f"[sage] card against CPU: {e2e_s:.1f} s")

        # (b) Yelp's configuration on GraphSAINT raw files, K=1
        degree = edges / n
        say(f"[sage] Yelp-shaped raw files: {n} nodes (GraphSAINT's Yelp {YELP_N}), {edges} "
            f"directed edges without self-loops, mean degree {degree:.2f} (Yelp "
            f"{2 * YELP_E / YELP_N:.2f}), {YELP_F} features, {YELP_C} classes: {write_s:.1f} s")
        check(abs(degree / (2 * YELP_E / YELP_N) - 1) <= 0.1,
              "the mean degree left Yelp's by 10%")
        check((t.graph.name, t.graph.multilabel, t.static.f_pad, t.layout.f_true,
               t.static.num_classes) == ("yelp", True, 384, YELP_F, YELP_C),
              "the K=1 run is not on the Yelp-format graph at Yelp's widths")
        # the K=4 ranks' set-up touches the card too: the K=1 run waits for it
        while k4_job[0].is_alive() and not all(os.path.exists(f"{go}.ready{r}")
                                                for r in range(4)):
            time.sleep(0.05)
        rec, k1, reassigned, peak = _sage_run(torch, t)
        say(f"[sage] K=1: load_yelp + layouts + upload {setup_s:.1f} s (beside the K=4 "
            f"ranks' set-up); fwd_local {t.blocks.counts[0][0]} dense tiles, "
            f"{t.blocks.counts[0][1]} ELL edges")
        _say_sage("K=1", rec, k1, reassigned, peak,
                  (rec["planned_tile_launches"], *rec["planned_quant_launches"]))
        check(k1[0] > 0 and rec["loss_curve"][-1] < rec["loss_curve"][0],
              "K=1: no strip launch, or the loss did not fall")
        if args.profile:
            phase_profile(torch, t, tag="sage")
        strip_err = _hold_sage_strip(torch, t)
        time384 = phase_time(torch, t, card, widths=(384,), tag="sage")[384]
        del t
        torch.cuda.empty_cache()
        pack_err, unpack_err, cases = _hold_contiguous(torch, SEED, ((384, 300), (256, 256)))
        lane_pack, lane_unpack = _hold_lanes(torch, SEED, ((True, 384, 300, "bfloat16"),
                                                           (False, 256, 256, "float32")))
        say(f"[sage] quant_pack / unpack_dequant at f_true 300 within 384 and at 256: {cases} "
            f"contiguous cases and the lane form on K=4 wires bit for bit (max |difference| "
            f"{max(pack_err, lane_pack):g} / {max(unpack_err, lane_unpack):g})")
    finally:
        with open(go, "w"):  # the K=4 ranks train now, and every rank ends
            pass
        for job in (e2e, k4_job):
            if job is not None:
                job[0].join()

    # (b) K=4
    res, _ = _joined(*k4_job)
    r0 = res[0]
    say(f"[sage] K=4 over gloo on one card: l_max {r0['l_max']}, r_pad {r0['r_pad']}, layer 0 "
        f"F {r0['f'][0]} (f_true {r0['f'][1]}); {SAGE_EPOCHS} epochs {r0['train_s']:.1f} s")
    k4 = [0, 0, 0]
    for rank, r in enumerate(res):
        say(f"[sage] K=4 rank {rank}: {r['num_local']} nodes, {r['lanes']} send lanes, set-up "
            f"{r['setup_s']:.1f} s (profiling {r['profile_s']:.1f} s of it)")
        _say_sage(f"K=4 rank {rank}", {"loss_curve": r["losses"], "per_epoch": r["step_ms"] / 1e3,
                                       "best": r["best"]},
                  r["launches"], r["reassigned"], r["peak"], r["planned"])
        check(np.array_equal(np.asarray(r["losses"]), np.asarray(r0["losses"])),
              f"K=4 rank {rank}: ranks disagree on the loss")
        check(r["reassigned"] == [SAGE_CYCLE + 1], f"K=4 rank {rank}: reassigned at "
              f"{r['reassigned']}, not at {SAGE_CYCLE + 1}")
        check(r["launches"][1] > 0 and r["launches"][2] > 0, f"K=4 rank {rank}: no quant launch")
        k4 = [a + b for a, b in zip(k4, r["launches"])]
    check(r0["losses"][-1] < r0["losses"][0], "K=4: the loss did not fall")
    say(f"[sage] K=4: parameters bit-identical across ranks (sum {r0['checksum']!r})")
    return {"strip": k1[0] + k4[0], "quant_pack": k4[1], "unpack_dequant": k4[2],
            "k1": k1, "k4": k4, "strip_err": strip_err, "time384": time384,
            "pack_err": max(pack_err, lane_pack), "unpack_err": max(unpack_err, lane_unpack)}


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


def phase_time_agg(torch, card, runs, parent=None):
    """The three tile kernels on the products forward local layout at F=256
    and at each one's layer-0 width, and gather_rows at the probe's shape
    (:func:`_time_gather_rows`; ``parent``: an older tree's kernels,
    :func:`_parent_gather`), each beside its bound, its plain version and a
    library call."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    clock = sm_clock_mhz()
    for impl, (name, w, plain) in _tile_kernels().items():
        lay = runs[impl]["layout"]
        csr, nnz = tile_csr(torch, lay, torch.bfloat16)
        h_rows = int(torch.unique(csr.col_indices()).numel())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walk = lay.build_walk()
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(walk.tensors(), lay.walk.tensors())),
              f"{name}: the walk differs from one build to the next")
        say(f"[time] {card} | {name} products forward local walk: rebuilt on the card in "
            f"{walk_s:.3f} s; {lay.walk.nbytes / 1e6:.1f} MB, {lay.walk.step_win.numel()} window "
            f"steps, {lay.walk.grp_len.numel() // 16} walk tiles, {lay.walk.cols.numel() / nnz:.2f} "
            "column slots an edge")
        del walk
        for f in sorted({256, LAYER0_F[impl]}):
            h = torch.randn(lay.n_src_pad, f, generator=gen, device="cuda").to(torch.bfloat16)
            saved = w.launches
            ms = cuda_ms(torch, lambda: w(lay, h), reps=20)
            w.launches = saved
            plain_ms = cuda_ms(torch, lambda: plain(lay, h), reps=2, warmup=1)
            lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, h), reps=20)
            units = int((lay.item_ptr if impl == "compact" else lay.blk_ptr)[-1])
            bound_ms, bound_by, nbytes, flops = walk_bound(lay, f, nnz, h_rows)
            say(f"[time] {card} | {name} products forward local F={f} bf16: {units} "
                f"{'items' if impl == 'compact' else 'tiles'}, {nnz} covered edges, "
                f"{h_rows} source rows read")
            say(f"[time] {card} | {name} F={f}: kernel {ms:.4f} ms; bound {bound_ms:.4f} ms by "
                f"{bound_by} ({nbytes / 1e9:.4f} GB, {flops / 1e12:.5f} TFLOP); plain "
                f"{plain_ms:.2f} ms; torch.sparse.mm {lib_ms:.4f} ms (bf16 CSR of the covered edges)")
            floor_ms, floor_bytes = strip_floor(lay, f, nnz, clock[1])
            say(f"[time] {card} | {name} F={f}: the design's shared-memory floor "
                f"{floor_ms:.4f} ms ({floor_bytes / 1e9:.3f} GB at 132 x 128 B a clock, "
                f"{clock[1]:g} MHz)")
            rows[(name, f)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=lib_ms)
        del csr
    rows[("gather_rows", 128)] = _time_gather_rows(torch, card, gen, parent)
    return rows


def _time_gather_rows(torch, card, gen, parent=None):
    """gather_rows at the probe's [2048, 128] f32 (random idx), through its
    launch (the wrapper's range check reads idx back), beside
    torch.take_along_dim on an int64 index made beforehand (the plain
    version and the library call) and, with ``parent``
    (:func:`_parent_gather`), the older kernel's launch: each read three
    ways (:func:`_three_ways`) in two rounds, the second in reverse order.
    Returns the kernels line's row: the first round, paced."""
    from adaqp_tpu_torch.ops import spmm_compact as sc

    x = torch.randn(2048, 128, generator=gen, device="cuda")
    i = torch.randint(0, 2048, (2048, 128), generator=gen, device="cuda", dtype=torch.int32)
    il = i.long()
    saved = sc.gather_rows.launches
    calls = {"gather_rows": lambda: sc._launch_gather_rows(x, i),
             "torch.take_along_dim": lambda: torch.take_along_dim(x, il, dim=0)}
    if parent is not None:
        check(torch.equal(parent[1](x, i), torch.take_along_dim(x, il, dim=0)),
              "the older gather_rows differs from torch.take_along_dim")
        calls["older kernel"] = lambda: parent[1](x, i)
    reads = {name: [] for name in calls}
    for names in (list(calls), list(calls)[::-1]):
        for name in names:
            reads[name].append(_three_ways(torch, calls[name]))
    sc.gather_rows.launches = saved
    nbytes = 3 * x.numel() * 4
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = sc.gather_plan(2048, 128, True, sms)

    def spread(name, k):
        lo, hi = sorted(r[k] for r in reads[name])
        return f"{lo:.5f}-{hi:.5f}"

    say(f"[time] {card} | gather_rows [2048, 128] f32 ({plan.width} columns a thread, blocks "
        f"{plan.block}, grid {plan.grid}), ms paced / on the card's clock / host a call (two "
        "rounds): " + "; ".join(f"{name} {spread(name, 0)} / {spread(name, 1)} / {spread(name, 2)}"
                                 for name in calls)
        + f"; bound {bound_ms:.5f} ms by bytes ({nbytes / 1e6:.2f} MB)")
    ms, plain_ms = reads["gather_rows"][0][0], reads["torch.take_along_dim"][0][0]
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=plain_ms)


# ---------------------------------------------------------------------------
# the gather micro-benchmarks (scripts/microbench_dma_gather.py and
# scripts/microbench_gather.py)
# ---------------------------------------------------------------------------

# the f32 rate outside the tensor cores (window_gather's adds)
PEAK_F32_FLOP_S = 67e12


# ring_gather's grids: 4 rows a block; one block an SM (the reference's
# form); one block over the whole stream (the form before, on one SM)
RING_FORMS = {"many": {"many_blocks": True}, "persistent": {}, "one block": {"blocks": 1}}


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
    the many-block form, as one block an SM (the reference's form) and as
    one block over the stream, idx
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
    _item_sass()
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
                        # many blocks; one an SM; one over the stream
                        for form in RING_FORMS.values():
                            got = dg.ring_gather(h, i, iters, depth, **form)
                            worst("ring_gather", got, want)
                            check(torch.equal(got, want), f"ring_gather {str(dtype)[6:]} F={f} "
                                  f"chunk={chunk} {vname} depth={depth} {form}: differs from "
                                  "h[idx]")
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
    # dma: one dtype x two idx x five depths, one block an SM (the main's
    # default, the reference's form); gather: sections of 2 + 3 and
    # 8 windows, 4 items; each a timed call, its warm-up and a check
    plan = {"ring_gather": 30, "microbench_gather.py:72": 15,
            "microbench_gather.py:130": 24, "microbench_gather.py:212": 12}
    check(said == plan, f"the mains' launches {said}, planned {plan}")
    check(launches == {"ring_gather": 30, "window_gather": 39, "compact_item": 12},
          f"launch counts {launches} disagree with the mains' plan")
    say(f"[gather] mains launched {launches} as planned")
    return errs, said


def _cold_ms(torch, fn, reps=50, spread=False):
    """Median milliseconds of ``fn`` over ``reps`` calls with L2 flushed
    before each (a 256 MB write evicts the 50 MB cache); CUDA events around
    the call alone. ``spread``: (median, fastest, slowest)."""
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
    ms = sorted(a.elapsed_time(b) for a, b in events)
    return (ms[reps // 2], ms[0], ms[-1]) if spread else ms[reps // 2]


def _host_ms(torch, fn, reps=100):
    """Mean milliseconds of host time a call of ``fn`` takes to return,
    over ``reps`` calls that the launch queue absorbs (none waits on the
    card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _bound(nbytes, ops, rate):
    """(bound ms, what bounds it) for ``nbytes`` moved and ``ops`` done at
    ``rate`` operations a second."""
    b_ms, o_ms = nbytes / PEAK_BYTES_S * 1e3, ops / rate * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _three_ways(torch, fn):
    """(paced by the host: 20 calls between two events; on the card's clock:
    the same calls queued behind a spin; host time a call), in ms."""
    return (cuda_ms(torch, fn, reps=20), cuda_ms(torch, fn, reps=20, backlog=True),
            _host_ms(torch, fn))


def _parent_gather(torch, csrc):
    """The ``compact_item`` and ``gather_rows`` kernels of the ``csrc``
    directory of an older tree (compact_item: mma.sync on A and B staged in
    shared memory, a block 64 rows x 64 columns, kind 0 on the first 256
    rows' blocks only; gather_rows: a thread an element), built with the
    port's ``nvcc`` flags and called through that tree's C signatures and
    wrappers, line for line but for the launch counts (so that a call costs
    the host what it cost there): ``item(mask, col, win, kind, iters)`` and
    ``rows(x, idx)`` (the launch alone, as its time was always read)."""
    import ctypes

    from adaqp_tpu_torch.scripts import microbench_gather as gb
    from adaqp_tpu_torch.utils.cuda_build import raise_on

    libs = _build_parent(csrc, ["compact_item", "spmm_compact"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    item_lib, rows_lib = libs["compact_item"], libs["spmm_compact"]
    item_lib.adaqp_compact_item.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    item_lib.adaqp_compact_item.restype = ci
    item_lib.adaqp_compact_item_error_string.argtypes = [ci]
    item_lib.adaqp_compact_item_error_string.restype = ctypes.c_char_p
    rows_lib.adaqp_gather_rows.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    rows_lib.adaqp_gather_rows.restype = ci
    rows_lib.adaqp_compact_error_string.argtypes = [ci]
    rows_lib.adaqp_compact_error_string.restype = ctypes.c_char_p

    def item(mask, col, win, kind, iters):
        gb._item_args(mask, col, win, kind, iters)
        mask, col, win = mask.contiguous(), col.contiguous().reshape(-1), win.contiguous()
        fc = win.shape[1]
        out = torch.empty((gb.SBK * gb.BD, fc), dtype=torch.bfloat16, device=win.device)
        if mask.data_ptr() % 16:
            raise ValueError("the older compact_item reads the mask 16 bytes at a time")
        rc = item_lib.adaqp_compact_item(
            mask.data_ptr(), col.data_ptr(), win.data_ptr(), out.data_ptr(), fc, kind, iters,
            win.device.index, torch.cuda.current_stream(win.device).cuda_stream,
        )
        raise_on(item_lib.adaqp_compact_item_error_string, rc, "the older compact_item")
        return out

    def rows(x, idx):
        out = torch.empty_like(x)
        rc = rows_lib.adaqp_gather_rows(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
        )
        raise_on(rows_lib.adaqp_compact_error_string, rc, "the older gather_rows")
        return out

    return item, rows


def phase_time_gather(torch, card, seed, parent=None):
    """Each gather kernel at its script's shapes with CUDA events: its time
    at one iteration (one pass) beside its bound, its plain version and the
    library call; its time at the script's I iterations and at 2I, and the
    per-iteration slope (t(2I) - t(I)) / I, which must be nonzero (work
    hoisted out of the loop would make it vanish). ring_gather warm (I =
    50 passes over the same 4,096 rows, L2-resident) and cold (one pass,
    L2 flushed) at every depth and index locality, as one block an SM (the
    reference's form, depths 4-64) and as many blocks of 4 rows, each time
    beside the copies in flight for the stream; then, uniform idx alone,
    one block over the stream at depth 64 (the grid before). A cold pass
    reads the median of 50, with the fastest and the slowest.
    window_gather at the script's windows, one iteration paced by the host
    (the kernels line) and on the card's clock. compact_item at fc 256 and
    384, both kinds: one iteration paced by the host (the kernels line), on
    the card's clock and as host time a call, and the slope beside the
    bound an iteration by operations. ``parent``: an older tree's
    compact_item (:func:`_parent_gather`), timed beside it on the same
    inputs."""
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

    def ring_case(vname, i, form, depth, warm=True):
        """One grid and depth: a cold pass, then 50 and 100 warm passes."""
        kw = RING_FORMS[form]
        c, lo, hi = _cold_ms(torch, lambda: dg.ring_gather(h, i, 1, depth, **kw), spread=True)
        grid, most, flight = dg.ring_plan(chunk, 1, depth, sms=sms, **kw)
        line = (f"[time] {card} | ring_gather {vname:8s} {form:10s} blocks={grid:4d} "
                f"issuers={dg.ring_issuers(depth, most):2d} depth={depth:2d}: cold {c:.5f} ms "
                f"a pass ({lo:.5f}-{hi:.5f}), {flight} in flight")
        if warm:
            # a call of 0.05-0.1 ms is as short as its host time: queued
            # behind a spin, the calls run back to back and a slow host call
            # does not swamp the slope
            reps = 3 if form == "one block" else 20
            t1 = cuda_ms(torch, lambda: dg.ring_gather(h, i, 50, depth, **kw), reps=reps,
                         backlog=True)
            t2 = cuda_ms(torch, lambda: dg.ring_gather(h, i, 100, depth, **kw), reps=reps,
                         backlog=True)
            slope = (t2 - t1) / 50
            check(slope > 0.05 * t1 / 50, f"ring_gather {form} depth={depth}: the slope "
                  f"{slope:g} ms a pass is near zero: work left the loop")
            flight50 = dg.ring_plan(chunk, 50, depth, sms=sms, **kw)[2]
            line += (f"; warm {t1 / (50 * chunk) * 1e6:.3f} ns/row at 50 passes ({t1:.4f} ms, "
                     f"{flight50} in flight), 100 passes {t2:.4f} ms, slope {slope * 1e3:.3f} "
                     "us a pass")
        say(line)
        return c

    for vname, vi in dg.idx_variants(rng, dg.N, chunk).items():
        i = torch.from_numpy(vi).cuda()
        lib, lo, hi = _cold_ms(torch, lambda: torch.index_select(h, 0, i), spread=True)
        warm_lib = cuda_ms(torch, lambda: dg.library_gather(h, i, 50), reps=5) / (50 * chunk)
        say(f"[time] {card} | ring_gather {vname:8s} torch.index_select (plain and library) cold "
            f"{lib:.5f} ms a pass ({lo:.5f}-{hi:.5f}); the script's library loop warm "
            f"{warm_lib * 1e6:.3f} ns/row")
        cold[(vname, "index_select")] = lib
        # the reference's form (one block an SM keeps `depth` copies in
        # flight over its share) at its depths, then the many-block form
        for form, depths in (("persistent", (4, 8, 16, 32, 64)), ("many", (1, 4, 8, 16, 32, 64))):
            for depth in depths:
                cold[(vname, form, depth)] = ring_case(vname, i, form, depth, warm=depth > 1)
        if vname == "uniform":
            # the grid before (the ring on one SM) beside the new
            ring_case(vname, i, "one block", 64)
    # the kernels line: uniform idx in the main's form, one block an SM, at
    # its deepest ring
    lib = cold[("uniform", "index_select")]
    rows["ring_gather"] = dict(ms=cold[("uniform", "persistent", 64)], plain_ms=lib,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib)

    def window_case(tag, x, ii, axis, iters_i=200):
        """Times one window_gather case; returns its row at one iteration. One
        iteration is timed paced by the host (20 calls between two events,
        as the probe was first timed: the kernels line's timer), and on the
        card's clock, the calls queued behind a spin (a call is shorter than
        its host time); I and 2I iterations on the card's clock, so that a slow
        host call does not swamp the slope."""
        full = gb.full_index(x, ii, axis)
        plan = gb.window_plan(*x.shape, axis, x.element_size(),
                              tuple(ii.shape) == tuple(x.shape), sms)
        paced = cuda_ms(torch, lambda: gb.window_gather(x, ii, 1, axis), reps=20)
        t1 = cuda_ms(torch, lambda: gb.window_gather(x, ii, 1, axis), reps=20, backlog=True)
        ti = cuda_ms(torch, lambda: gb.window_gather(x, ii, iters_i, axis), reps=5, backlog=True)
        t2 = cuda_ms(torch, lambda: gb.window_gather(x, ii, 2 * iters_i, axis), reps=5,
                     backlog=True)
        slope = (t2 - ti) / iters_i
        check(slope > 0.05 * ti / iters_i, f"window_gather {tag}: the slope {slope:g} ms an "
              "iteration is near zero: work left the loop")
        plain = cuda_ms(torch, lambda: gb._window_gather_torch(x, ii, 1, axis), reps=20)
        plain_card = cuda_ms(torch, lambda: gb._window_gather_torch(x, ii, 1, axis), reps=20,
                             backlog=True)
        plain_i = cuda_ms(torch, lambda: gb._window_gather_torch(x, ii, iters_i, axis), reps=2,
                          warmup=1)
        lib = cuda_ms(torch, lambda: torch.gather(x, axis, full), reps=20)
        lib_card = cuda_ms(torch, lambda: torch.gather(x, axis, full), reps=20, backlog=True)
        host = _host_ms(torch, lambda: gb.window_gather(x, ii, 1, axis))
        lib_host = _host_ms(torch, lambda: torch.gather(x, axis, full))
        nbytes = x.numel() * x.element_size() * 2 + ii.numel() * 4
        b1, by1 = _bound(nbytes, x.numel(), PEAK_F32_FLOP_S)
        bi, byi = _bound(nbytes, x.numel() * iters_i, PEAK_F32_FLOP_S)
        tag += f" ({plan.lines} lines a block, {plan.blocks} blocks, {plan.unit}-byte loads)"
        say(f"[time] {card} | window_gather {tag}: 1 iteration paced {paced:.5f} ms, on the "
            f"card's clock {t1:.5f}, host {host:.5f} a call (bound {b1:.5f} by {by1}; plain "
            f"paced {plain:.5f}, card {plain_card:.5f}; torch.gather paced {lib:.5f}, card "
            f"{lib_card:.5f}, host {lib_host:.5f}); {iters_i} "
            f"iterations {ti:.4f} ms (bound {bi:.5f} by {byi}; plain {plain_i:.3f}), "
            f"{2 * iters_i} {t2:.4f} ms, slope {slope * 1e3:.4f} us an iteration")
        return dict(ms=paced, plain_ms=plain, bound_ms=b1, bound_by=by1, library_ms=lib)

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
            t1, c1, h1 = _three_ways(torch, lambda: gb.compact_item(mask, col, win, kind, 1))
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
            ctas = math.prod(gb.item_plan(fc).grid)
            say(f"[time] {card} | compact_item {name} fc={fc} ({ctas} CTAs): 1 iteration paced "
                f"{t1:.5f} ms, on the card's clock {c1:.5f}, host {h1:.5f} a call (bound "
                f"{b1:.5f} by {by1}; plain {plain:.4f}; library none); 200 iterations "
                f"{ti:.4f} ms (bound {bi:.4f} by {byi}), 400 {t2:.4f} ms, slope "
                f"{slope * 1e3:.3f} us an iteration (bound {flops / PEAK_BF16_FLOP_S * 1e6:.3f} "
                "us by operations); torch.matmul on the pre-expanded bf16 A (the products "
                f"alone) {yard:.5f} ms")
            if parent:
                check(gb.item_within(parent[0](mask, col, win, kind, 3),
                                     gb._compact_item_torch(mask, col, win, kind, 3)),
                      f"the older compact_item {name} fc={fc} differs from its plain version")
                p1, pc, ph = _three_ways(torch, lambda: parent[0](mask, col, win, kind, 1))
                pi = cuda_ms(torch, lambda: parent[0](mask, col, win, kind, 200), reps=3)
                p2 = cuda_ms(torch, lambda: parent[0](mask, col, win, kind, 400), reps=3)
                say(f"[time] {card} | parent compact_item {name} fc={fc}: 1 iteration paced "
                    f"{p1:.5f} ms, on the card's clock {pc:.5f}, host {ph:.5f} a call; 200 "
                    f"iterations {pi:.4f} ms, 400 {p2:.4f} ms, slope {(p2 - pi) / 200 * 1e3:.3f} "
                    "us an iteration")
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


def _sass_ops(lib, marker):
    """Each kernel whose name holds ``marker`` in ``build/kernels/lib<lib>.so``
    (``cuobjdump -sass``): {kernel: (HGMMA, UTMALDG, HMMA, highest
    register, local loads and stores (spills))}."""
    import re

    from adaqp_tpu_torch.utils.cuda_build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    so = os.path.join(HERE, "build", "kernels", f"lib{lib}.so")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    found = {}
    for chunk in out.stdout.split("Function : ")[1:]:
        name = chunk.split()[0]
        if marker not in name:
            continue
        ops = [t.split()[1 if t.startswith("@") else 0].split(".")[0]
               for t in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", chunk)]
        regs = max(int(r) for r in re.findall(r"\bR(\d+)\b", chunk))
        found[name] = (*(ops.count(op) for op in ("HGMMA", "UTMALDG", "HMMA")), regs,
                       ops.count("LDL") + ops.count("STL"))
    return found


def _expand_sass():
    """Each expand kernel of ``build/kernels/libexpand_tile.so`` in
    ``cuobjdump -sass``: fails unless every one multiplies with HGMMA
    (wgmma), loads by UTMALDG (TMA), holds no HMMA (mma.sync) and uses a
    register past the launch's 168 (R168 or above: ptxas gave the
    consumers their setmaxnreg count, and did not hold the kernel to the
    launch's, spilling). Returns {kernel: (HGMMA, UTMALDG, HMMA, highest
    register)}."""
    found = _sass_ops("expand_tile", "expand_kernel")
    check(len(found) == 4, f"{len(found)} expand kernels in libexpand_tile.so, expected 4")
    for name, (hg, tma, hmma, regs, _) in found.items():
        check(hg > 0 and tma > 0 and hmma == 0, f"{name}: {hg} HGMMA, {tma} UTMALDG, {hmma} HMMA")
        check(regs >= 168, f"{name}: its highest register is R{regs}, within the launch's 168")
    say("[expand] SASS of the 4 kernels (one a variant): HGMMA "
        f"{sorted({v[0] for v in found.values()})}, UTMALDG {sorted({v[1] for v in found.values()})}"
        f", HMMA 0 in every one; highest register R{min(v[3] for v in found.values())}-"
        f"R{max(v[3] for v in found.values())}")
    return found


def _item_sass():
    """compact_item's two kernels (a kind each) in ``cuobjdump -sass`` of
    ``build/kernels/libcompact_item.so``: fails unless each multiplies with
    HGMMA (wgmma) and holds no HMMA (mma.sync), and kind 0's loads by
    UTMALDG (TMA)."""
    found = _sass_ops("compact_item", "compact_item_kernel")
    check(len(found) == 2, f"{len(found)} compact_item kernels in libcompact_item.so, expected 2")
    for name, (hg, tma, hmma, regs, local) in found.items():
        check(hg > 0 and hmma == 0, f"{name}: {hg} HGMMA, {hmma} HMMA")
        say(f"[gather] SASS of {name}: {hg} HGMMA, {tma} UTMALDG, {hmma} HMMA, highest "
            f"register R{regs}, {local} local loads and stores")
    check(any(v[1] > 0 for v in found.values()), "compact_item: no UTMALDG in either kernel")
    return found


def phase_expand(torch, args):
    """expand_spmm's four variants against their plain versions, one pass
    each: on a small layout (a random 5,000-node graph, F=128, 384 (an odd
    count of 128-column chunks) and 640, with and without the all-zero
    tiles that cover destination blocks with no dense tile, so a block with
    no tiles must give zeros), on a hub layout (one destination block of 26
    tiles, its 832 K-steps cycling the window ring, and empty blocks; F=384
    and 640), and on the Reddit-degree layout at F=640 (the main's shapes;
    built here and kept for the timing); then the script's main at that size, with its launches
    checked against the plan. First the kernels' SASS (wgmma, TMA, no
    mma.sync). Returns (max |kernel - plain|, the main's launches, the
    device layout, host seconds of its build)."""
    import numpy as np

    from adaqp_tpu_torch.ops import spmm_block as sb
    from adaqp_tpu_torch.scripts import microbench_expand as me

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_helpers import holed as without_empty_tiles
    from torch_helpers import hub_layout

    _expand_sass()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = dict.fromkeys(me.VARIANTS, 0.0)  # max |kernel - plain| a variant
    n = 5000
    src = rng.integers(0, n, 200_000).astype(np.int32)
    dst = np.where(rng.random(200_000) < 0.7, (src + rng.integers(-300, 300, 200_000)) % n,
                   rng.integers(0, n, 200_000)).astype(np.int32)
    lay = sb.block_layout(src, dst, n, min_edges=64).to_device("cuda")
    t = int(lay.blk_ptr[-1])
    holed = without_empty_tiles(lay)
    empty = (holed.blk_ptr[1:] == holed.blk_ptr[:-1]).nonzero().flatten()
    check(empty.numel() > 0 and int(holed.blk_ptr[-1]) > lay.n_pad // sb.BD,
          "the holed layout has no empty destination block, or too few tiles")
    hub = hub_layout(rng, "cuda")
    hub_tiles = torch.diff(hub.blk_ptr)
    hub_empty = (hub_tiles == 0).nonzero().flatten()
    check(int(hub_tiles.max()) >= 24 and hub_empty.numel() > 0,
          f"the hub layout's blocks hold {int(hub_tiles.max())} tiles at most and "
          f"{hub_empty.numel()} none")
    cases = [(lay, f"{t} tiles", (128, 384, 640), empty[:0]),
             (holed, f"{int(holed.blk_ptr[-1])} tiles, {empty.numel()} empty blocks",
              (128, 384, 640), empty),
             (hub, f"hub: {int(hub.blk_ptr[-1])} tiles, {int(hub_tiles.max())} in block 0, "
              f"{hub_empty.numel()} empty blocks", (384, 640), hub_empty)]
    for d, tag, fs, none in cases:
        for f in fs:
            h = torch.randn(d.n_pad, f, generator=gen, device="cuda").to(torch.bfloat16)
            for variant in me.VARIANTS:
                worst[variant] = max(worst[variant], _hold_expand(
                    torch, me, d, h, variant, f"{variant} {tag} F={f}"))
            rows = (none[:, None] * sb.BD + torch.arange(sb.BD, device="cuda")).flatten()
            for variant in me.VARIANTS if none.numel() else ():
                check(not me.expand_spmm(d, h, variant)[rows].any(),
                      f"expand_spmm {variant} ({tag}): a destination block without tiles is "
                      "not zero")

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


def _parent_probes(torch, csrc):
    """The ``expand_spmm`` and ``transpose_u32`` kernels of the ``csrc``
    directory of an older tree whose expand_tile.cu takes TMA maps
    (``adaqp_expand_maps``: ``wgmma`` on fragments expanded in registers; the
    32 x 32 tile transpose), built with the port's ``nvcc`` flags and called
    through that tree's C signatures and wrappers, line for line but for the
    launch counts (so that a call costs the host what it cost there):
    ``expand(layout, h, variant)`` and ``transpose(x)``."""
    import ctypes
    import functools

    from adaqp_tpu_torch.ops.spmm_walk import check_cuda_operands
    from adaqp_tpu_torch.scripts import microbench_expand as me
    from adaqp_tpu_torch.utils.cuda_build import raise_on

    libs = _build_parent(csrc, ["expand_tile", "transpose_u32"])
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ex, tr = libs["expand_tile"], libs["transpose_u32"]
    launch, encode, ex_err = ex.adaqp_expand_spmm, ex.adaqp_expand_maps, ex.adaqp_expand_error_string
    launch.argtypes = [vp, vp, vp, ci, vp, ci, ci, ci, vp]
    launch.restype = ci
    encode.argtypes = [vp, cl, ci, vp, cl, vp]
    encode.restype = ci
    ex_err.argtypes = [ci]
    ex_err.restype = ctypes.c_char_p
    fn, tr_err = tr.adaqp_transpose_u32, tr.adaqp_transpose_error_string
    fn.argtypes = [vp, vp, cl, ci, ci, vp]
    fn.restype = ci
    tr_err.argtypes = [ci]
    tr_err.restype = ctypes.c_char_p

    @functools.lru_cache(maxsize=256)
    def maps(h_ptr, n_src, f, masks_ptr, mask_rows):
        buf = ctypes.create_string_buffer(256)
        raise_on(ex_err, encode(h_ptr, n_src, f, masks_ptr, mask_rows, buf),
                 "the older expand_spmm's tensor maps")
        return buf

    def expand(layout, h, variant):
        check_cuda_operands(h, layout.n_src_pad, (
            ("masks", layout.masks, torch.int16),
            ("src_start", layout.src_start, torch.int32),
            ("blk_ptr", layout.blk_ptr, torch.int32),
        ))
        n_blocks = layout.n_pad // me.BD
        if layout.blk_ptr.numel() != n_blocks + 1 or tuple(layout.masks.shape[1:]) != (
                me.BD, me.WORDS):
            raise ValueError("layout shapes do not match n_pad")
        if layout.masks.data_ptr() % 16:
            raise ValueError("expand_spmm's mask loads need 16-byte-aligned masks")
        out = torch.empty((layout.n_pad, h.shape[1]), dtype=torch.bfloat16, device=h.device)
        if layout.masks.shape[0] == 0:
            return out.zero_()
        index = h.device.index
        m = maps(h.data_ptr(), h.shape[0], h.shape[1], layout.masks.data_ptr(),
                 layout.masks.shape[0] * me.BD)
        rc = launch(m, layout.src_start.data_ptr(), layout.blk_ptr.data_ptr(), n_blocks,
                    out.data_ptr(), h.shape[1], me.VARIANTS.index(variant), index,
                    torch._C._cuda_getCurrentRawStream(index))
        raise_on(ex_err, rc, "the older expand_spmm")
        return out

    def transpose(x):
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"x must be a contiguous 2-D tensor, got {tuple(x.shape)}")
        if x.element_size() != 4:
            raise TypeError(f"x must hold 32-bit words, got {x.dtype}")
        rows, cols = x.shape
        out = x.new_empty((cols, rows))
        if not rows or not cols:
            return out
        index = x.get_device()
        rc = fn(x.data_ptr(), out.data_ptr(), rows, cols, index,
                torch._C._cuda_getCurrentRawStream(index))
        raise_on(tr_err, rc, "the older transpose_u32")
        return out

    return expand, transpose


def phase_time_expand(torch, card, dev, host_s, parent=None):
    """Each variant at F=640 on the Reddit-degree layout: one pass (CUDA
    events) beside the bound of the function A^T h (the masks, index
    arrays, the h rows the edges read and out once at the memory rate, or
    the edges' products at the bf16 rate, as for block_spmm), the dense
    tiles' tensor-core time (every tile's 256 x 2048 x F product at the
    bf16 rate: the floor of this design, not of the function), the plain
    version, block_spmm (the window-stationary walk) and torch.sparse.mm of the
    tiles' edges; and the per-pass slope of chains of I and 2I passes,
    which must be nonzero. Then the wrapper's host time a call and the
    part its map cache saves, and, with ``parent``
    (:func:`_parent_probes`), the older kernel's variants in the same
    call, v0 in turns with this one."""
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
        f"({nnz / (t * sb.BD * sb.BS):.4%} dense), {h_rows} source rows read, tiles a "
        f"destination block {me.tile_spread(torch.diff(dev.blk_ptr).cpu().numpy())}, host build "
        f"{host_s:.1f} s; F={f}: bound of A^T h {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e9:.3f} GB, {2.0 * nnz * f / 1e12:.4f} TFLOP); dense tiles on the tensor "
        f"cores {dense_ms:.4f} ms ({dense_flops / 1e12:.3f} TFLOP); block_spmm (window-stationary walk) "
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
            f"{walk / ms:.2f}x block_spmm's speed, {lib / ms:.2f}x torch.sparse.mm's); chains "
            f"of {EXPAND_ITERS} / {2 * EXPAND_ITERS} passes {ti:.3f} / {t2:.3f} ms, slope "
            f"{slope:.4f} ms a pass ({slope / ms:.3f} of one pass); plain {plain:.2f} ms")
        rows[variant] = dict(ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib)
    # the wrapper's host time a call, and the part of it that its map cache
    # saves: encoding the two TMA maps of this call's h and masks
    key = (h.data_ptr(), h.shape[0], f, dev.masks.data_ptr(), dev.masks.shape[0] * sb.BD)
    call_us = _host_ms(torch, lambda: me.expand_spmm(dev, h, "v0"), reps=20) * 1e3
    encode_us = _host_ms(torch, lambda: me._maps.__wrapped__(*key), reps=200) * 1e3
    say(f"[time] {card} | expand_spmm v0 F={f}: host {call_us:.1f} us a call with its maps "
        f"cached; encoding the maps (what the cache saves a call) {encode_us:.1f} us")
    if parent is not None:
        expand = parent[0]
        for variant in me.VARIANTS:
            if variant == "v0":  # in turns: parent, this, this, parent
                ms = [cuda_ms(torch, lambda: expand(dev, h, variant), reps=10),
                      cuda_ms(torch, lambda: me.expand_spmm(dev, h, variant), reps=10),
                      cuda_ms(torch, lambda: me.expand_spmm(dev, h, variant), reps=10),
                      cuda_ms(torch, lambda: expand(dev, h, variant), reps=10)]
                say(f"[time] {card} | expand_spmm v0 F={f} in turns, the older kernel / this "
                    f"one: {ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} / {ms[3]:.4f} ms a pass")
            else:
                ms = cuda_ms(torch, lambda: expand(dev, h, variant), reps=10)
                say(f"[time] {card} | expand_spmm {variant} F={f}, the older kernel: {ms:.4f} "
                    f"ms a pass (this one {rows[variant]['ms']:.4f})")
    me.expand_spmm.launches, sb.block_spmm.launches = saved
    return rows


# the transpose's shapes: the probe's, odd ones, and the wire's (the plane
# probe's k1 * cnt rows of wpr = 25 words)
TRANSPOSE_SHAPES = ((4096, 25), (1, 1), (33, 31), (1000, 7), (7, 1000), (4097, 65),
                    (100_003, 25), (1_856_512, 25))


def phase_r5(torch, card, parent=None):
    """transpose_u32 bit for bit with x.t().contiguous() at the probe's
    shape, odd shapes and the wire's; its time at the probe's and the
    wire's shapes beside x.t().contiguous() (plain and library) and, with
    ``parent`` (:func:`_parent_probes`), the older
    kernel through its own wrapper: each read three ways (paced by the
    host, 20 calls between two events; on the card's clock, the same calls
    behind a spin; host time a call), in two rounds, the second in reverse
    order; then the script's main at its own sizes (the scatter and plane
    lines), with its launches checked."""
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
        calls = {"transpose_u32": lambda: pr.transpose_u32(x),
                 "x.t().contiguous()": lambda: pr._transpose_torch(x)}
        if parent is not None:
            calls["older kernel"] = lambda: parent[1](x)
        reads = {name: [] for name in calls}
        for names in (list(calls), list(calls)[::-1]):
            for name in names:
                reads[name].append(_three_ways(torch, calls[name]))
        bound_ms, bound_by = _bound(2 * x.numel() * 4, 0, 1)

        def spread(name, i):
            a, b = sorted(r[i] for r in reads[name])
            return f"{a:.5f}-{b:.5f}"

        say(f"[time] {card} | transpose_u32 {list(shape)} u32, ms paced / on the card's clock / "
            f"host a call (two rounds): " + "; ".join(
                f"{name} {spread(name, 0)} / {spread(name, 1)} / {spread(name, 2)}"
                for name in calls)
            + f"; bound {bound_ms:.5f} by {bound_by} (transpose_u32 on the card's clock: "
            f"{bound_ms / min(r[1] for r in reads['transpose_u32']):.1%} of it)")
        first = reads["transpose_u32"][0]
        rows[shape] = dict(ms=first[0], plain_ms=reads["x.t().contiguous()"][0][0],
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=reads["x.t().contiguous()"][0][0])
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
    p.add_argument("--nodes", type=int, default=32_768,
                   help="nodes of the K=1 graph (edges keep Reddit's mean degree)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--nodes_k", type=int, default=32_768, help="nodes of the K=4 graph")
    p.add_argument("--epochs_k", type=int, default=12,
                   help="AdaQP epochs at K=4 (reassignment at 6 and 11 with a cycle of 5)")
    p.add_argument("--epochs_pad", type=int, default=8,
                   help="AdaQP epochs of train_pad (reassignment at 6 with a cycle of 5)")
    p.add_argument("--epochs_parity", type=int, default=20,
                   help="epochs of each accuracy_parity run (the script's own default is 60)")
    p.add_argument("--nodes_agg", type=int, default=131_072,
                   help="nodes of the products-degree graph of train_agg")
    p.add_argument("--epochs_agg", type=int, default=8,
                   help="epochs of each train_agg run and each remat run")
    p.add_argument("--nodes_remat", type=int, default=None,
                   help="nodes of the products-degree graph of remat (default: --nodes_agg, "
                        "on train_agg's graph and layout when it ran)")
    p.add_argument("--nodes_sage", type=int, default=131_072,
                   help="nodes of sage's Yelp-shaped graph (GraphSAINT's Yelp: 716,847)")
    p.add_argument("--only", type=str, default=None,
                   help="comma-separated phases to run (agg, pad, quant, gather, expand, r5, "
                        "gpu_tests, e2e, e2e_k, e2e_pad, k1, train_k, ckpt, partition, parity, "
                        "train_pad, e2e_agg, train_agg, remat, sage; ckpt and remat run train_k "
                        "first); build always "
                        "runs, and the result lines print only for a full run")
    p.add_argument("--parent_rows", type=str, default=None,
                   help="a csrc directory of an older tree whose quant_rows.cu has the "
                        "contiguous C interface: train_pad also times the per-bucket padded "
                        "exchange around its kernels")
    p.add_argument("--parent_gather", type=str, default=None,
                   help="a csrc directory of an older tree: the gather timing also times its "
                        "compact_item.cu, and the timing after train_agg its spmm_compact.cu "
                        "(gather_rows), with their older C interfaces on the same inputs")
    p.add_argument("--parent_probes", type=str, default=None,
                   help="a csrc directory of an older tree whose expand_tile.cu takes TMA maps: "
                        "the expand and r5 timing also time its expand_tile.cu and "
                        "transpose_u32.cu on the same inputs")
    p.add_argument("--profile", action="store_true",
                   help="also trace a few K=1 training steps with torch.profiler (the "
                        "Reddit run, each train_agg run and sage's K=1 run)")
    args = p.parse_args()
    if args.parent_rows:
        args.parent_rows = os.path.abspath(args.parent_rows)
    if args.parent_gather:
        args.parent_gather = os.path.abspath(args.parent_gather)
    if args.parent_probes:
        args.parent_probes = os.path.abspath(args.parent_probes)
    if args.nodes_remat is None:
        args.nodes_remat = args.nodes_agg
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
    parent_gather = None
    if args.parent_gather and (want("gather") or want("train_agg")):
        parent_gather = _parent_gather(torch, args.parent_gather)
    if want("gather"):
        gather_errs, gather_l = run("gather", phase_gather, torch, SEED)
        gtimes = run("time", phase_time_gather, torch, card, SEED, parent_gather)
    parent_probes = None
    if args.parent_probes and (want("expand") or want("r5")):
        parent_probes = _parent_probes(torch, args.parent_probes)
    if want("expand"):
        expand_err, expand_l, expand_lay, expand_host = run("expand", phase_expand, torch, args)
        etimes = run("time", phase_time_expand, torch, card, expand_lay, expand_host,
                     parent_probes)
        del expand_lay
        torch.cuda.empty_cache()
    if want("r5"):
        r5_l, r5_err, r5_time = run("r5", phase_r5, torch, card, parent_probes)
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
    k4 = ckpt_l = None
    if want("train_k") or want("ckpt") or want("remat"):
        k4 = run("train_k", phase_train_k, torch, args)
        lanes = k4["AdaQP"][0]["lanes"]
        qtimes = run("time", phase_time_quant, torch, card, lanes)
    if want("ckpt"):
        ckpt_l = run("ckpt", phase_ckpt, torch, args, k4)
    if want("partition"):
        run("partition", phase_partition, torch, args)
        torch.cuda.empty_cache()
    if want("parity"):
        parity_l = run("parity", phase_parity, torch, args)
    if want("train_pad"):
        kpad = run("train_pad", phase_train_pad, torch, args, k4)
        ptimes, pad_path_err = run("time", phase_time_pad, torch, card, kpad)
    if want("e2e_agg"):
        run("e2e_agg", phase_e2e_agg, torch, SEED)
    agg_graph = None
    if want("train_agg"):
        agg, agg_graph = run("train_agg", phase_train_agg, torch, args)
        atimes = run("time", phase_time_agg, torch, card, agg, parent_gather)
        for r in agg.values():  # the timing's layouts: remat reads the card's memory
            r.pop("layout", None)
        torch.cuda.empty_cache()
    if want("remat"):
        remat_l = run("remat", phase_remat, torch, args, agg_graph, k4, ckpt_l)
    del agg_graph
    if want("sage"):
        sage = run("sage", phase_sage, torch, args, card)
    if only is not None:
        say("[done] partial run (--only): no result lines")
        return
    # the K=4 paths (all ranks): train_k's AdaQP run, its resumed run (ckpt)
    # and the accuracy-parity runs
    k4_strip, k4_q, k4_u = (sum(r["launches"][i] for r in k4["AdaQP"]) for i in range(3))
    ck_strip, ck_q, ck_u = (sum(r[i] for r in ckpt_l) for i in range(3))
    agg_l = {k: sum(r["launches"][k] for r in agg.values()) for k in _wrappers()}
    pad_q = sum(r["pad_launches"][0] for r in kpad)
    pad_d = sum(r["pad_launches"][1] for r in kpad)
    say(f"[result] strip_spmm launches: K=1 train {launches}, K=4 AdaQP train {k4_strip} "
        f"(all ranks), its resumed run {ck_strip}, accuracy parity {parity_l['strip_spmm']}, "
        f"products train {agg_l['strip_spmm']}, remat {remat_l['strip']}, SAGE K=1 "
        f"{sage['k1'][0]}, SAGE K=4 {sage['k4'][0]}; quant_pack / unpack_dequant: K=4 AdaQP "
        f"train {k4_q} / {k4_u}, resumed {ck_q} / {ck_u}, accuracy parity "
        f"{parity_l['quant_pack']} / {parity_l['unpack_dequant']}, remat "
        f"{remat_l['quant_pack']} / {remat_l['unpack_dequant']}, SAGE K=4 {sage['k4'][1]} / "
        f"{sage['k4'][2]}")
    say(card)
    say(json.dumps({"kernels": [
        {"name": "strip_spmm", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/spmm_strip.cu",
         "replaces": "adaqp_tpu/ops/spmm_strip.py:277",
         "launches": launches + k4_strip + ck_strip + parity_l["strip_spmm"]
         + agg_l["strip_spmm"] + remat_l["strip"] + sage["strip"],
         "max_abs_err": max(err, sage["strip_err"]),
         **times[640]},
        {"name": "quant_pack", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/quant_pack.cu",
         "replaces": "adaqp_tpu/ops/quant_pallas.py:103",
         "launches": k4_q + ck_q + parity_l["quant_pack"] + remat_l["quant_pack"]
         + sage["quant_pack"], "max_abs_err": max(pack_err, sage["pack_err"]),
         **qtimes[640][0]},
        {"name": "unpack_dequant", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/quant_pack.cu",
         "replaces": "adaqp_tpu/ops/quant_pallas.py:202",
         "launches": k4_u + ck_u + parity_l["unpack_dequant"] + remat_l["unpack_dequant"]
         + sage["unpack_dequant"], "max_abs_err": max(quant_err, sage["unpack_err"]),
         **qtimes[640][1]},
        {"name": "block_spmm", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/spmm_strip.cu",
         "replaces": "adaqp_tpu/ops/spmm_block.py:248",
         "launches": agg_l["block_spmm"], "max_abs_err": agg["block"]["err"],
         **atimes[("block_spmm", 256)]},
        {"name": "compact_spmm", "route": "cuda",
         "source": "adaqp_tpu_torch/csrc/spmm_strip.cu",
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
