"""The port's quantization against the JAX package's, on the CPU.

The port's plain versions (``ops/quant.py``, the CPU side of
``ops/quant_cuda.py``) take the same rows as the JAX functions and, where
the JAX side draws ``jax.random.uniform(key, shape)``, those very uniforms;
then words, scales and rmins must agree bit for bit. XLA:CPU may fuse
``(x - rmin) * scale + u`` into one rounding where PyTorch rounds twice, so
a code whose ``y + u`` lies within an ulp of an integer can differ: those
are counted and bounded (at most 1e-4 of the codes). The card's kernels are
held against the same plain versions by ``chip_smoke.py`` and by the
``gpu`` tests of ``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaqp_tpu.comm import exchange_ragged as jxr
from adaqp_tpu.comm.wire import wire_cols as jwire_cols
from adaqp_tpu.ops import quant as jquant
from adaqp_tpu.ops import quant_pallas
from adaqp_tpu_torch.comm.wire import wire_cols
from adaqp_tpu_torch.ops import quant as tquant
from adaqp_tpu_torch.ops import quant_cuda as qc

SHAPES = [(300, 64, 50), (257, 640, 602)]  # (N, F, f_true)


def _rows(rng, n, f, ft):
    x = rng.normal(size=(n, f)) * rng.uniform(0.1, 10.0, size=(n, 1))
    x[:, ft:] = 0.0  # layout padding
    x[3] = 1.25  # a constant row
    return x.astype(np.float32)


@pytest.mark.parametrize("n,f,ft", SHAPES)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_and_pack_match_jax(rng, bits, n, f, ft):
    x = _rows(rng, n, f, ft)
    key = jax.random.PRNGKey(bits * 1000 + f)
    u = np.asarray(jax.random.uniform(key, (n, f), dtype=jnp.float32))
    q, scale, rmin = jquant.quantize_rows(jnp.asarray(x), bits, key, f_true=ft)
    fw = jwire_cols(ft, bits)
    assert fw == wire_cols(ft, bits)
    assert tquant.bytes_per_row(fw, bits) == jquant.bytes_per_row(fw, bits)
    assert tquant.values_per_byte(bits) == jquant.values_per_byte(bits)
    words = np.asarray(jquant.pack_words(jxr._to_width(q, fw), bits)).view(np.int32)

    tq, ts, tr = tquant.quantize_rows(torch.tensor(x), bits, torch.tensor(u), ft)
    tw = tquant.pack_words(tquant.to_width(tq, fw), bits).numpy()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(scale))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(rmin))
    differ = int((tq.numpy() != np.asarray(q)).sum())
    assert differ <= 1e-4 * q.size, differ
    if differ == 0:
        np.testing.assert_array_equal(tw, words)
    # packing alone is exact on the same codes
    jq = torch.tensor(np.asarray(jxr._to_width(q, fw)))
    np.testing.assert_array_equal(tquant.pack_words(jq, bits).numpy(), words)
    # the port's own pack and unpack are inverses
    np.testing.assert_array_equal(tquant.unpack_words(torch.tensor(tw), bits, fw).numpy(),
                                  tquant.to_width(tq, fw).numpy())


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpack_dequant_matches_interpret_kernel_and_portable(rng, bits):
    n, f_pad, f_true = quant_pallas.ROW_BLOCK, 256, 100
    fw = wire_cols(f_true, bits)
    x = jnp.asarray(rng.normal(size=(n, f_pad)), dtype=jnp.float32)
    q, scale, rmin = jquant.quantize_rows(x, bits, jax.random.PRNGKey(3), f_true=f_true)
    w = jquant.pack_words(q[:, :fw], bits)
    want = np.asarray(quant_pallas.unpack_dequantize_rows_tpu(
        w, scale, rmin, bits, f_true, fw, f_pad, interpret=True))
    tw = torch.tensor(np.asarray(w).view(np.int32))
    got = qc.unpack_dequant(tw, torch.tensor(np.asarray(scale)), torch.tensor(np.asarray(rmin)),
                            bits, f_true, fw, f_pad).numpy()
    np.testing.assert_array_equal(got, want)
    # and through the wire's bf16 parameter words, as the exchange decodes
    params = jnp.stack([scale, rmin], axis=-1).astype(jnp.bfloat16)
    pw = jax.lax.bitcast_convert_type(params.reshape(n, 1, 2), jnp.uint32)[:, 0]
    want = np.asarray(jxr._words_to_rows(w, pw, bits, f_true, fw, f_pad))
    ts, tr = tquant.split_param_words(torch.tensor(np.asarray(pw).view(np.int32)))
    got = qc.unpack_dequant(tw, ts, tr, bits, f_true, fw, f_pad).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_param_word_matches_wire(rng, bits):
    n, f, ft = 200, 64, 60
    x = _rows(rng, n, f, ft)
    key = jax.random.PRNGKey(7)
    _, pw = jxr._quant_to_words(jnp.asarray(x), bits, key, ft, wire_cols(ft, bits))
    _, scale, rmin = jquant.quantize_rows(jnp.asarray(x), bits, key, f_true=ft)
    got = tquant.param_words(torch.tensor(np.asarray(scale)), torch.tensor(np.asarray(rmin)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pw).view(np.int32))
    s, r = tquant.split_param_words(got)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jnp.asarray(scale).astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(
        r.numpy(), np.asarray(jnp.asarray(rmin).astype(jnp.bfloat16).astype(jnp.float32)))


def test_generator_stream():
    # 1M draws: uniform on [0, 1) with 24-bit resolution, rows independent
    u = qc.uniforms(qc.stream_key(42, 1, 0, 2, 1, 0), 1000, 1000)
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 4 * (1 / 12 / n) ** 0.5
    assert abs(float(u.var()) - 1 / 12) < 4 * (1 / 180 / n) ** 0.5  # var of U^2-ish: 1/180
    assert torch.equal(u * 2**24, torch.floor(u * 2**24))
    c = torch.corrcoef(torch.stack([u[:-1].reshape(-1), u[1:].reshape(-1)]))[0, 1]
    assert abs(float(c)) < 4 / (n ** 0.5)
    # a pure function of (key, row, col): a sub-block draws the same numbers
    k = qc.stream_key(9)
    np.testing.assert_array_equal(qc.uniforms(k, 40, 30).numpy(), qc.uniforms(k, 50, 70)[:40, :30].numpy())
    assert not torch.equal(qc.uniforms(k, 8, 8), qc.uniforms(qc.stream_key(10), 8, 8))
    assert qc.stream_key(1, 2, 3) != qc.stream_key(1, 2, 4) != qc.stream_key(2, 1, 3)


def test_cpu_wrappers_run_the_plain_versions(rng):
    x = torch.tensor(_rows(rng, 40, 64, 60)).to(torch.bfloat16)
    before = (qc.quant_pack.launches, qc.unpack_dequant.launches)
    w, s, r = qc.quant_pack(x, 4, 60, 64, 11)
    u = qc.uniforms(11, 40, 64)
    q, s0, r0 = tquant.quantize_rows(x, 4, u, 60)
    assert torch.equal(w, tquant.pack_words(q, 4)) and torch.equal(s, s0) and torch.equal(r, r0)
    y = qc.unpack_dequant(w, s, r, 4, 60, 64, 128)
    assert y.shape == (40, 128) and not y[:, 60:].any()
    err = (y[:, :60] - x[:, :60].float()).abs()
    assert bool((err <= (1.0 / s)[:, None] * (1 + 1e-3) + 1e-6).all())  # one step
    e = qc.quant_pack(x[:0], 8, 60, 60, 1)
    assert e[0].shape == (0, 15) and e[1].shape == (0,)
    assert (qc.quant_pack.launches, qc.unpack_dequant.launches) == before
    with pytest.raises(ValueError, match="no quant_pack"):
        qc.quant_pack(x.to("meta"), 4, 60, 64, 1)
    with pytest.raises(ValueError, match="f_wire"):
        qc.quant_pack(x, 4, 60, 61, 1)
