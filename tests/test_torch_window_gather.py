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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

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
