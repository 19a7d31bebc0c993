"""The mask-expansion probe of the port against the TPU kernel it replaces.

``scripts/microbench_expand.py::make_run`` builds the Pallas kernel; the
script is imported by path and its ``PrefetchScalarGridSpec`` (``:131-152``)
restated here around ``make_run(variant, F)`` with ``interpret=True``. One
pass over a small block layout must match the port's ``expand_spmm`` for
each of v0-v3 (on the CPU its plain version, on the port's own
``block_layout`` of the same edges) within ``2^-7 |ref| + 1e-6``: both sum
exact products in f32 in another order and round once to bf16. The CUDA
kernel is held against the same plain version by ``chip_smoke.py`` and the
``gpu`` tests of ``tests/test_torch_gpu.py``.
"""
import importlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from adaqp_tpu_torch.ops import spmm_block as tblock
from adaqp_tpu_torch.scripts import microbench_expand as me

jblock = importlib.import_module("adaqp_tpu.ops.spmm_block")

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "microbench_expand.py"
F = 128
N = 3000  # n_pad 4096: 16 destination blocks over 2 source blocks


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("ref_microbench_expand", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def graph():
    """Banded edges over N nodes plus a uniform sprinkle: dense tiles near
    the diagonal, sparse ones (the ELL part, which neither kernel reads)
    elsewhere, and all-zero tiles for the padding rows' blocks."""
    rng = np.random.default_rng(7)
    e = 60_000
    src = rng.integers(0, N, e)
    dst = np.where(rng.random(e) < 0.9, (src + rng.integers(-500, 500, e)) % N,
                   rng.integers(0, N, e))
    jl = jblock.block_layout(src.astype(np.int32), dst.astype(np.int32), N, min_edges=192)
    tl = tblock.block_layout(src.astype(np.int32), dst.astype(np.int32), N, min_edges=192)
    h = rng.normal(size=(tl.n_pad, F)).astype(np.float32)
    return jl, tl, h


def _pallas_pass(script, variant, lay, h):
    """One pass of the reference kernel in interpret mode (the script's
    grid spec, restated)."""
    dev = lay.to_device()
    t = dev.masks.shape[0]
    kern = script.make_run(variant, F)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3,
        grid=(t,),
        in_specs=[
            pl.BlockSpec((1, script.BD, script.WORDS), lambda i, ss, fi, db: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.ANY),
        ],
        out_specs=pl.BlockSpec((script.BD, F), lambda i, ss, fi, db: (db[i], 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.VMEM((2, script.BS, F), h.dtype),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.VMEM((script.BD, F), jnp.float32),
        ],
    )
    call = pl.pallas_call(kern, grid_spec=grid_spec, interpret=True,
                          out_shape=jax.ShapeDtypeStruct((lay.n_pad, F), h.dtype))
    return call(dev.src_start, dev.is_first, dev.dst_blk, dev.masks, h)


def test_layouts_are_the_same_arrays(graph):
    jl, tl, _ = graph
    assert (jl.n, jl.n_pad, jl.n_src_pad) == (tl.n, tl.n_pad, tl.n_src_pad) == (N, 4096, 4096)
    for name in ("masks", "src_start", "dst_blk", "is_first"):
        a, b = getattr(jl, name), getattr(tl, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    dense = int((tl.masks != 0).any(axis=(1, 2)).sum())
    assert 8 <= dense <= 32 and tl.straggler is not None


@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v3"])
def test_expand_spmm_matches_the_tpu_kernel(script, graph, variant):
    jl, tl, h = graph
    ref = _pallas_pass(script, variant, jl, jnp.asarray(h).astype(jnp.bfloat16))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    d = tl.to_device("cpu")
    before = me.expand_spmm.launches
    got = me.expand_spmm(d, torch.from_numpy(h).to(torch.bfloat16), variant)
    assert me.expand_spmm.launches == before  # the plain version: no launch
    assert got.dtype == torch.bfloat16 and got.shape == (tl.n_pad, F)
    err = (got.float() - ref).abs()
    assert (err <= 2.0 ** -7 * ref.abs() + 1e-6).all(), (variant, float(err.max()))
    assert ref.abs().max() > 0
    if variant == "v3":  # wrong math on purpose: far from the true product
        true = tblock._run_block_torch(d, torch.from_numpy(h).to(torch.bfloat16))
        assert (got.float() - true.float()).abs().max() > 1e3
    else:
        assert torch.equal(got, tblock._run_block_torch(d, torch.from_numpy(h).to(torch.bfloat16)))


def test_output_is_the_f32_sum_rounded_once(graph):
    _, tl, h = graph
    d = tl.to_device("cpu")
    hb = torch.from_numpy(h).to(torch.bfloat16)
    t = int(d.blk_ptr[-1])
    for variant, expand in (("v0", tblock.expand_masks), ("v3", me.expand_raw)):
        f32 = tblock.run_tiles_torch(d.masks, d.src_start, d.dst_blk[:t], d.n_pad,
                                     hb.float(), expand)
        assert torch.equal(f32.to(torch.bfloat16), me.expand_spmm(d, hb, variant))


def _square(n=2048):
    e = np.arange(n, dtype=np.int32)
    return tblock.block_layout(e, e, n, min_edges=1).to_device("cpu")


@pytest.mark.parametrize("bad,exc,match", [
    (dict(f=96), ValueError, "multiple of 128"),
    (dict(f=0), ValueError, "multiple of 128"),
    (dict(dtype=torch.float32), TypeError, "bfloat16"),
    (dict(variant="v4"), ValueError, "variant"),
    (dict(rows=1024), ValueError, r"\[2048, F\]"),
    (dict(f=130), ValueError, "multiple of 128"),
    (dict(device="meta"), ValueError, "no expand_spmm"),
])
def test_expand_spmm_refuses(bad, exc, match):
    args = dict(f=128, dtype=torch.bfloat16, variant="v0", rows=2048, device="cpu")
    args.update(bad)
    lay = _square()
    if args["device"] == "meta":
        lay = lay.to("meta")
    h = torch.zeros(args["rows"], args["f"], dtype=args["dtype"], device=args["device"])
    with pytest.raises(exc, match=match):
        me.expand_spmm(lay, h, args["variant"])


def test_expand_spmm_refuses_a_rectangular_layout():
    e = np.arange(300, dtype=np.int32)
    lay = tblock.block_layout(e, e, 300, min_edges=1, n_src=4000).to_device("cpu")
    assert lay.n_src_pad != lay.n_pad
    with pytest.raises(ValueError, match="square"):
        me.expand_spmm(lay, torch.zeros(lay.n_src_pad, 128, dtype=torch.bfloat16), "v0")


def test_main_prints_the_probe_on_the_cpu(capsys, tmp_path):
    argv = ["--device", "cpu", "--n", "2048", "--e", "65536", "--f", "128", "--iters", "2",
            "--cache_dir", str(tmp_path)]
    assert me.main(argv) == {"expand_spmm": 0}
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and lines[0].endswith("(built)")
    assert lines[1].startswith("tiles=") and "n_pad=2048 f=128" in lines[1]
    assert [x.split(":")[0] for x in lines[2:]] == ["v0", "v1", "v2", "v3"]
    assert all("ms/pass" in x and "us/tile" in x for x in lines[2:])
    me.main(argv)
    assert capsys.readouterr().out.splitlines()[0].endswith("(cached)")


def test_main_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        me.main(["--n", "2048", "--e", "65536", "--cache_dir", str(tmp_path)])



@pytest.mark.parametrize("shape", [(2048, 128), (2048, 384), (1024, 128)])
def test_map_cache_is_keyed_by_address_and_shape(monkeypatch, shape):
    encoded = []

    def encode(h, rows, f, masks, mask_rows, buf):
        encoded.append((h, rows, f, masks, mask_rows))
        return 0

    monkeypatch.setattr(me, "_lib", lambda: (None, encode, None))
    me._maps.cache_clear()
    h = torch.zeros(2048 * 384, dtype=torch.bfloat16)[:shape[0] * shape[1]].view(shape)
    masks = torch.zeros(3, 256, 128, dtype=torch.int16)

    def maps(h, masks):
        return me._maps(h.data_ptr(), h.shape[0], h.shape[1], masks.data_ptr(),
                        masks.shape[0] * me.BD)

    first = maps(h, masks)
    assert maps(h, masks) is first and len(encoded) == 1  # one encoding a signature
    assert encoded[0] == (h.data_ptr(), shape[0], shape[1], masks.data_ptr(), 3 * 256)
    wide = h.view(shape[0] // 2, shape[1] * 2)  # the same address, another shape
    assert maps(wide, masks) is not first and len(encoded) == 2
    assert maps(h, masks[:2]) is not first and len(encoded) == 3
    assert maps(h, masks[1:]) is not first and len(encoded) == 4  # another address
    me._maps.cache_clear()


@pytest.mark.parametrize("tiles,want", [
    ([16] * 8, "16 / 16 / 16 (least / median / most)"),
    ([1, 35, 39, 0], "0 / 18 / 39 (least / median / most)"),
    ([], "none"),
])
def test_tile_spread_reads_least_median_most(tiles, want):
    assert me.tile_spread(np.array(tiles, dtype=np.int64)) == want
