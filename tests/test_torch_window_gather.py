"""The window gather and the compact item of the port against the TPU
kernels they replace, on the CPU.

``scripts/microbench_gather.py`` builds its three kernels inside ``main()``,
so they cannot be imported: this file holds a verbatim copy of each body
(``mk_kernel`` from ``:71-80``, ``mk_sq`` from ``:129-145``, ``mk_item`` from
``:211-238``), run through ``pallas_call`` in interpret mode. The one change
is in ``mk_item``: ``acc[...] = jnp.zeros_like(acc)`` at its start, because
the script never zeroes its VMEM accumulator (it reads NaN in interpret
mode). The port's plain versions must equal the window gathers bit for bit
(sums in x's dtype, one rounding an iteration) and the items within
``2^-7 |ref| + 1e-6`` (f32 products summed in another order, then one bf16
rounding). ``chip_smoke.py`` and the ``gpu`` tests of ``tests/test_torch_gpu.py``
hold the CUDA kernels against these plain versions on the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from adaqp_tpu_torch.ops.spmm_block import expand_masks
from adaqp_tpu_torch.ops.spmm_compact import BD, BS, CSUB, GROUP, WORDS
from adaqp_tpu_torch.scripts import microbench_gather as gb

SBK = 8  # scripts/microbench_gather.py:240


# --- verbatim from scripts/microbench_gather.py:71-80
def mk_kernel(iters):
    def kern(x_ref, idx_ref, o_ref):
        x = x_ref[...]
        idx = idx_ref[...]

        def body(k, acc):
            return acc + jnp.take_along_axis(x, idx, axis=0)

        o_ref[...] = jax.lax.fori_loop(0, iters, body, jnp.zeros_like(x))
    return kern


# --- verbatim from scripts/microbench_gather.py:129-145
def mk_sq(iters, axis, inkernel_idx):
    def kern(x_ref, idx_ref, o_ref):
        xw = x_ref[...]
        if inkernel_idx:
            v = idx_ref[...]  # [1, D] i32
            if axis == 0:
                idx = jnp.broadcast_to(v.reshape(-1, 1), xw.shape)
            else:
                idx = jnp.broadcast_to(v, xw.shape)
        else:
            idx = idx_ref[...]

        def body(k, acc):
            return acc + jnp.take_along_axis(xw, idx, axis=axis)

        o_ref[...] = jax.lax.fori_loop(0, iters, body, jnp.zeros_like(xw))
    return kern


# --- from scripts/microbench_gather.py:211-238, with the accumulator zeroed
def mk_item(iters, kind, fc):
    def kern(mask_ref, col_ref, win_ref, o_ref, acc):
        acc[...] = jnp.zeros_like(acc)  # the one change: the script never zeroes acc
        words = mask_ref[...]
        win = win_ref[...]

        def body(k, _):
            rep = pltpu.repeat(words.astype(jnp.int32), 16, axis=1)
            bit = jax.lax.broadcasted_iota(jnp.int32, (BD, BS), 1) // WORDS
            a = ((rep >> bit) & 1).astype(jnp.float32).astype(jnp.bfloat16)
            if kind == 0:
                acc[pl.ds(0, BD), :] += jnp.dot(
                    a, win, preferred_element_type=jnp.float32
                )
            else:
                colv = col_ref[...]
                idx = jnp.broadcast_to(colv.reshape(BS, 1), (BS, fc))
                g = jnp.take_along_axis(win, idx, axis=0)
                for s in range(GROUP):
                    acc[pl.ds(s % SBK * BD, BD), :] += jnp.dot(
                        a[:, s * CSUB : (s + 1) * CSUB],
                        g[s * CSUB : (s + 1) * CSUB, :],
                        preferred_element_type=jnp.float32,
                    )
            return 0

        jax.lax.fori_loop(0, iters, body, 0)
        o_ref[...] = acc[:].astype(jnp.bfloat16)
    return kern


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _window(rng, shape, length, dtype, form, axis):
    """x [shape] in ``dtype`` and its int32 index: a full random one, or a
    1-D column list [1, length]."""
    x = rng.normal(size=shape).astype(np.float32)
    if form == "full":
        idx = rng.integers(0, length, shape).astype(np.int32)
    else:
        idx = rng.integers(0, length, (1, length)).astype(np.int32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return xj, xt, idx


@pytest.mark.parametrize("r,f,dtype,iters", [
    (8, 128, "float32", 1), (8, 256, "bfloat16", 5), (256, 128, "bfloat16", 3),
    (256, 256, "float32", 5), (1024, 128, "float32", 3), (1024, 256, "bfloat16", 5),
])
def test_element_gather_matches_the_tpu_kernel(r, f, dtype, iters):
    rng = np.random.default_rng(r + f + iters)
    xj, xt, idx = _window(rng, (r, f), r, dtype, "full", 0)
    ref = pl.pallas_call(mk_kernel(iters), out_shape=jax.ShapeDtypeStruct((r, f), xj.dtype),
                         interpret=True)(xj, jnp.asarray(idx))
    got = gb.window_gather(xt, torch.from_numpy(idx), iters, 0)
    assert got.dtype == xt.dtype and got.shape == (r, f)
    assert np.array_equal(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("shape,iters", [((256, 128), 3), ((1024, 256), 5), ((8, 256), 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["full", "1d"])
@pytest.mark.parametrize("axis", [0, 1])
def test_square_window_matches_the_tpu_kernel(axis, form, dtype, shape, iters):
    shape = shape if axis == 0 else shape[::-1]
    length = shape[axis]
    rng = np.random.default_rng(length + iters + axis)
    xj, xt, idx = _window(rng, shape, length, dtype, form, axis)
    ref = pl.pallas_call(mk_sq(iters, axis, form == "1d"),
                         out_shape=jax.ShapeDtypeStruct(shape, xj.dtype),
                         interpret=True)(xj, jnp.asarray(idx))
    got = gb.window_gather(xt, torch.from_numpy(idx), iters, axis)
    assert np.array_equal(got.float().numpy(), _np(ref))


# [4096, 256] f32 and [2048, 640] bf16 (the probe's windows), [257, 2048]
# and [2048, 257] (widths that two lines a block do not divide), and
# [1000, 300] f32 (a gather axis that is no multiple of 256)
PLANS = [(4096, 256, 0, 4), (2048, 640, 0, 2), (640, 2048, 1, 2), (2048, 257, 0, 4),
         (257, 2048, 1, 2), (1000, 300, 0, 4), (300, 1000, 1, 4), (8, 256, 0, 4)]


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("rows,cols,axis,esize", PLANS)
def test_window_plan_stages_each_element_once(rows, cols, axis, esize, full):
    plan = gb.window_plan(rows, cols, axis, esize, full)
    length, lines = (rows, cols) if axis == 0 else (cols, rows)
    # block b owns lines [b * plan.lines, (b + 1) * plan.lines): each line once
    owners = np.zeros(lines, np.int64)
    for b in range(plan.blocks):
        owners[b * plan.lines:(b + 1) * plan.lines] += 1
    assert (owners == 1).all()
    # and one position range, the whole gather axis: its slab holds every
    # position of its lines, and after it their index (a full one) or the
    # 1-D index, so x and a full index are read once in all
    index = length * (plan.lines if full else 1) * 4
    if axis == 0:
        assert plan.stride >= plan.lines
        assert plan.smem >= length * plan.stride * esize + index
    else:
        assert plan.stride >= length
        assert plan.smem >= plan.lines * plan.stride * esize + index
    staged = sum(min(plan.lines, lines - b * plan.lines) for b in range(plan.blocks)) * length
    assert staged == rows * cols
    assert plan.smem <= gb.MAX_SMEM
    # about one wave of one or two blocks an SM
    assert gb.SMS // 2 <= plan.blocks <= 2 * gb.SMS or plan.lines == 1


@pytest.mark.parametrize("rows,cols,axis,esize", PLANS)
def test_window_plan_loads_and_slab(rows, cols, axis, esize):
    plan = gb.window_plan(rows, cols, axis, esize)
    lines = cols if axis == 0 else rows
    seg = [plan.lines * esize, lines % plan.lines * esize] if axis == 0 else [cols * esize]
    # one load a unit: it divides the row stride and every staged segment
    assert plan.unit in (2, 4, 8, 16) and plan.unit >= esize
    assert all(n % plan.unit == 0 for n in [cols * esize, *seg])
    if axis == 0:
        # a position's lines an odd number of words apart: a warp's random
        # rows of one line land on every bank
        assert plan.stride * esize % 4 == 0 and plan.stride * esize // 4 % 2 == 1
    else:
        assert plan.stride * esize % 16 == 0


@pytest.mark.parametrize("rows,cols,axis,esize,want", [
    (4096, 256, 0, 4, (2, 128, 8)),    # ROADMAP's 11a: 2 f32 columns, 8-byte loads
    (2048, 256, 0, 2, (2, 128, 4)),    # 11b: 2 bf16 columns
    (256, 2048, 1, 2, (2, 128, 16)),
    # 5 columns a block, one block an SM: 4 would put 8 on some SMs (160 blocks)
    (2048, 640, 0, 2, (5, 128, 2)),
    (640, 2048, 1, 2, (5, 128, 16)),
    (4096, 8, 0, 4, (1, 8, 4)),        # fewer lines than SMs: a block a line
    (4096, 8, 1, 4, (32, 128, 16)),    # many short lines: 32 a block
])
def test_window_plan_picks(rows, cols, axis, esize, want):
    plan = gb.window_plan(rows, cols, axis, esize)
    assert (plan.lines, plan.blocks, plan.unit) == want


def test_window_plan_takes_lines_and_refuses_a_line_too_long():
    # the slab, then the staged index: [4096][1] f32 and [4096][1] int32
    assert gb.window_plan(4096, 256, 0, 4, lines=1) == (1, 256, 1, 4, 2 * 16384)
    # 4 lines 5 words apart, and their index
    assert gb.window_plan(4096, 256, 0, 4, lines=4).smem == 4096 * 5 * 4 + 4096 * 4 * 4
    # 2 bf16 lines a word, and a 1-D index: its 2,048 entries
    assert gb.window_plan(2048, 256, 0, 2, False).smem == 2048 * 2 * 2 + 2048 * 4
    assert gb.window_plan(4096, 256, 0, 4, align=4).unit == 4
    # 2 f32 lines of 16,384 positions and their index exceed 227 KB: the plan takes one
    assert gb.window_plan(16384, 256, 0, 4).lines == 1
    with pytest.raises(ValueError, match="shared memory"):
        gb.window_plan(65536, 256, 0, 4)
    with pytest.raises(ValueError, match="shared memory"):
        gb.window_plan(4096, 256, 0, 4, lines=8)


def _item_inputs(rng, fc):
    mask = rng.integers(0, 1 << 16, (BD, WORDS)).astype(np.uint16).view(np.int16)
    col = rng.integers(0, BS, BS).astype(np.int32).reshape(16, 128)
    win = rng.normal(size=(BS, fc)).astype(np.float32)
    return mask, col, win


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("fc", [256, 384])
@pytest.mark.parametrize("kind", [0, 1])
def test_compact_item_matches_the_tpu_kernel(kind, fc, iters):
    rng = np.random.default_rng(fc + kind)
    mask, col, win = _item_inputs(rng, fc)
    winj = jnp.asarray(win).astype(jnp.bfloat16)
    ref = pl.pallas_call(
        mk_item(iters, kind, fc),
        out_shape=jax.ShapeDtypeStruct((SBK * BD, fc), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((SBK * BD, fc), jnp.float32)],
        interpret=True,
    )(jnp.asarray(mask), jnp.asarray(col), winj)
    ref = torch.from_numpy(_np(ref))
    got = gb.compact_item(torch.from_numpy(mask), torch.from_numpy(col),
                          torch.from_numpy(win).to(torch.bfloat16), kind, iters)
    assert got.dtype == torch.bfloat16 and got.shape == (SBK * BD, fc)
    assert torch.isfinite(ref).all()
    assert gb.item_within(got, ref)
    if kind == 0:
        assert not got[BD:].any() and not ref[BD:].any()


def test_compact_item_expands_the_mask_as_the_tile_layouts_do():
    # one set bit: halfword 5 of row 3, bit 9 -> virtual column 9 * 128 + 5
    mask = torch.zeros(BD, WORDS, dtype=torch.int16)
    mask[3, 5] = 1 << 9
    win = torch.zeros(BS, 8, dtype=torch.bfloat16)
    win[9 * WORDS + 5] = torch.arange(1, 9, dtype=torch.bfloat16)
    col = torch.arange(BS, dtype=torch.int32)
    for kind in (0, 1):
        out = gb.compact_item(mask, col, win, kind, 3)
        row = 3 if kind == 0 else (9 * WORDS + 5) // CSUB * BD + 3
        assert torch.equal(out[row], 3 * torch.arange(1, 9, dtype=torch.bfloat16))
        assert int((out != 0).sum()) == 8


@pytest.mark.parametrize("bad,match", [
    (dict(idx=torch.zeros(4, 8, dtype=torch.int64)), "int32"),
    (dict(idx=torch.zeros(1, 8, dtype=torch.int32)), "neither"),
    (dict(x=torch.zeros(4, 8, dtype=torch.float16)), "f32 or bf16"),
    (dict(axis=2), "axis"),
    (dict(iters=0), "iters"),
    (dict(lines=0), "lines"),
])
def test_window_gather_refuses(bad, match):
    args = dict(x=torch.zeros(4, 8), idx=torch.zeros(4, 8, dtype=torch.int32), iters=1, axis=0)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        gb.window_gather(**args)


@pytest.mark.parametrize("bad,match", [
    (dict(mask=torch.zeros(BD, WORDS, dtype=torch.int32)), "mask"),
    (dict(col=torch.zeros(BS - 1, dtype=torch.int32)), "col"),
    (dict(win=torch.zeros(BS, 8)), "win"),
    (dict(kind=2), "kind"),
    (dict(win=torch.zeros(BS, 8, dtype=torch.bfloat16, device="meta"),
          mask=torch.zeros(BD, WORDS, dtype=torch.int16, device="meta"),
          col=torch.zeros(BS, dtype=torch.int32, device="meta")), "no compact_item"),
])
def test_compact_item_refuses(bad, match):
    args = dict(mask=torch.zeros(BD, WORDS, dtype=torch.int16),
                col=torch.zeros(BS, dtype=torch.int32),
                win=torch.zeros(BS, 8, dtype=torch.bfloat16), kind=0, iters=1)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        gb.compact_item(**args)


def _item_writes(fc, kind):
    """Each CTA of ``gb.item_plan`` with the output blocks the kernel
    (csrc/compact_item.cu) has it write: ``[((slice, chunk, share), [(row0,
    rows, col0, cols), ...]), ...]``. Kind 1 writes its unit's 64 x 128
    sums at rows ``256 slice + 64 share``; kind 0's CTA writes rows ``8
    slice..`` of its share (the cluster's sums over the slices) and its 56
    rows of zeros past row 256."""
    slices, chunks, shares = gb.item_plan(fc).grid
    rows = gb.ITEM_ROWS
    zero = (SBK * BD - BD) // (slices * shares)
    out = []
    for s in range(slices):
        for c in range(chunks):
            c0 = c * gb.ITEM_COLS
            cols = min(gb.ITEM_COLS, fc - c0)
            for sh in range(shares):
                if kind == 1:
                    blocks = [(s * BD + sh * rows, rows, c0, cols)]
                else:
                    blocks = [(sh * rows + s * (rows // slices), rows // slices, c0, cols),
                              (BD + (sh * slices + s) * zero, zero, c0, cols)]
                out.append(((s, c, sh), blocks))
    return out


@pytest.mark.parametrize("fc", [1, 64, 100, 136, 256, 384, 640])
def test_item_plan_writes_every_output_once_on_the_same_units(fc):
    """Each kind's CTAs write every element of the [2048, fc] output once
    (kind 1 its unit's sums; kind 0 an eighth of its share's sums over the
    cluster and 56 zero rows); both kinds run the same (slice, chunk, share)
    units, each once."""
    plan = gb.item_plan(fc)
    assert plan.ld % 8 == 0 and fc <= plan.ld < fc + 8 and plan.grid[0] == GROUP
    units = {}
    for kind in (0, 1):
        seen = np.zeros((SBK * BD, fc), np.int32)
        writes = _item_writes(fc, kind)
        for _, blocks in writes:
            for r0, nr, c0, nc in blocks:
                seen[r0:r0 + nr, c0:c0 + nc] += 1
        assert (seen == 1).all()
        units[kind] = [u for u, _ in writes]
        assert len(units[kind]) == math.prod(plan.grid) == len(set(units[kind]))
    assert units[0] == units[1]


def test_item_plan_spreads_both_kinds_over_the_card():
    assert math.prod(gb.item_plan(384).grid) >= 96
    assert math.prod(gb.item_plan(256).grid) >= 64
    with pytest.raises(ValueError, match="fc"):
        gb.item_plan(0)


def test_item_fragments_hold_the_columns_of_a():
    """The kernel's A fragments (csrc/compact_item.cu): the thread of lane l
    in warp w of share sh holds mask words 8g + 4j + l % 4 of rows 64 sh +
    16 w + l // 4 + 8 rr; at k16 step kk of slice s, word group g = kk % 8
    at bit 2s + kk // 8 gives A's columns 256s + 16kk + 2 (l % 4) + 8j and
    the next (low halfword, then high) of those rows."""
    mask = np.random.default_rng(3).integers(0, 1 << 16, (BD, WORDS)).astype(np.uint16)
    a = expand_masks(torch.from_numpy(mask.view(np.int16))[None])[0].numpy()
    words = mask.view(np.uint32).reshape(BD, WORDS // 2)
    s, kk, row, quad, j = np.meshgrid(np.arange(GROUP), np.arange(16), np.arange(BD),
                                      np.arange(4), np.arange(2), indexing="ij")
    word = words[row, 8 * (kk % 8) + 4 * j + quad]
    bit = 2 * s + kk // 8
    col = s * CSUB + 16 * kk + 2 * quad + 8 * j
    assert (a[row, col] == (word >> bit) & 1).all()
    assert (a[row, col + 1] == (word >> (16 + bit)) & 1).all()
    seen = np.zeros(a.shape, np.int32)
    np.add.at(seen, (row, col), 1)
    np.add.at(seen, (row, col + 1), 1)
    assert (seen == 1).all()


def test_main_prints_the_probe_on_the_cpu(capsys):
    got = gb.main(["--device", "cpu", "--iters", "1"])
    assert got == {"microbench_gather.py:72": 0, "microbench_gather.py:130": 0,
                   "microbench_gather.py:212": 0}
    lines = capsys.readouterr().out.splitlines()
    heads = [" ".join(x.split()[:2]) for x in lines]
    assert heads == (["library row"] + ["element gather"] * 5 + ["window perm"] * 8
                     + ["library row"] * 2 + ["compact full-item", "compact group-item"] * 2)
    assert all(x.endswith("correct=True") for x in lines if not x.startswith("library"))


def test_main_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gb.main(["--iters", "1"])
