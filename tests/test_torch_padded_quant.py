"""The padded wire's quantization in the port against the JAX package's, on
the CPU.

The byte-packed forms (``pad_features``, ``pack_rows``/``unpack_rows``,
``message_quantize``/``message_dequantize``) take the same inputs as the
JAX functions and, where JAX draws ``jax.random.uniform(key, shape)``,
those very uniforms. As in ``test_torch_quant.py``, XLA:CPU may round
``(x - rmin) * scale + u`` once where PyTorch rounds twice, so a code whose
``y + u`` lies within an ulp of an integer may differ: those are counted and
bounded (at most 1e-4 of the codes); everything else is bit for bit.

``_dequant_rows_torch`` is held bit for bit against the TPU kernel
``dequantize_rows_tpu`` in interpret mode. ``_quant_kernel`` draws from the
TPU's hardware generator and has no interpret mode, so ``_quant_rows_torch``
is held against ``quantize_rows`` with injected uniforms, and against the
ragged wire's ``quant_pack`` (the same generator, the same codes). The card's
kernels are held against these plain versions by ``chip_smoke.py`` and by
the ``gpu`` tests of ``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaqp_tpu.ops import quant as jquant
from adaqp_tpu.ops import quant_pallas
from adaqp_tpu_torch.comm.wire import wire_cols
from adaqp_tpu_torch.ops import quant as tquant
from adaqp_tpu_torch.ops import quant_cuda as qc

# (N, F stored, f_true): f_true == F, f_true < F with F_wire < F (the
# mask), f_true < F_wire (layer-0 Reddit widths), and F not a multiple of 4
# (F_wire > F: the codes are padded)
SHAPES = [(300, 64, 64), (300, 64, 50), (257, 640, 602), (129, 50, 50), (40, 18, 17)]


def _rows(rng, n, f, ft):
    x = rng.normal(size=(n, f)) * rng.uniform(0.1, 10.0, size=(n, 1))
    x[:, ft:] = 0.0  # layout padding
    x[3] = 1.25  # a constant row
    return x.astype(np.float32)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_rows_matches_jax(rng, bits):
    for n, fw in ((33, 64), (8, 604), (5, 4)):
        q = rng.integers(0, 2**bits, size=(n, fw)).astype(np.uint8)
        want = np.asarray(jquant.pack_rows(jnp.asarray(q), bits))
        got = tquant.pack_rows(torch.tensor(q), bits)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.shape == (n, tquant.bytes_per_row(fw, bits))
        back = tquant.unpack_rows(got, bits, fw).numpy()
        np.testing.assert_array_equal(back, np.asarray(jquant.unpack_rows(jnp.asarray(want), bits, fw)))
        np.testing.assert_array_equal(back, q)
    for f in (1, 4, 17, 602):
        assert tquant.pad_features(f, bits) == jquant.pad_features(f, bits)
        assert tquant.pad_features(f) == jquant.pad_features(f)


@pytest.mark.parametrize("n,f,ft", SHAPES)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_message_quantize_and_dequantize_match_jax(rng, bits, n, f, ft):
    x = _rows(rng, n, f, ft)
    key = jax.random.PRNGKey(bits * 100 + f + ft)
    u = np.asarray(jax.random.uniform(key, (n, f), dtype=jnp.float32))
    f_true = None if ft == f else ft
    jw, jp = jquant.message_quantize(jnp.asarray(x), bits, key, f_true=f_true)
    tw, tp = tquant.message_quantize(torch.tensor(x), bits, torch.tensor(u), f_true)
    assert tp.dtype == torch.bfloat16 and tw.dtype == torch.uint8
    assert tuple(tw.shape) == jw.shape and tuple(tp.shape) == jp.shape
    np.testing.assert_array_equal(tp.float().numpy(), np.asarray(jp.astype(jnp.float32)))
    fw = tquant.pad_features(ft)
    jq = np.asarray(jquant.unpack_rows(jw, bits, fw))
    tq = tquant.unpack_rows(tw, bits, fw).numpy()
    differ = int((tq != jq).sum())
    assert differ <= 1e-4 * tq.size, differ
    # the receive side on the same wire, bit for bit, at the stored width
    # and at a wider layout width (the pad after the true columns)
    for f_pad in (f, f + 30):
        want = np.asarray(jquant.message_dequantize(jw, jp, bits, f_pad, f_true=ft))
        got = tquant.message_dequantize(torch.tensor(np.asarray(jw)),
                                        torch.tensor(np.asarray(jp.astype(jnp.float32))).to(torch.bfloat16),
                                        bits, f_pad, ft)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[:, ft:].any()


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_dequant_rows_matches_interpret_kernel(rng, bits):
    n, f = quant_pallas.ROW_BLOCK, 256
    x = jnp.asarray(rng.normal(size=(n, f)), dtype=jnp.float32)
    q, scale, rmin = jquant.quantize_rows(x, bits, jax.random.PRNGKey(bits), f_true=200)
    want = np.asarray(quant_pallas.dequantize_rows_tpu(q, scale, rmin, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(jquant.dequantize_rows(q, scale, rmin, bits)))
    args = [torch.tensor(np.asarray(a)) for a in (q, scale, rmin)]
    np.testing.assert_array_equal(qc._dequant_rows_torch(*args).numpy(), want)
    # through the wire's bf16 pair, widened, as the receiver decodes
    sb, rb = (a.to(torch.bfloat16).float() for a in args[1:])
    want = np.asarray(quant_pallas.dequantize_rows_tpu(
        q, jnp.asarray(sb.numpy()), jnp.asarray(rb.numpy()), interpret=True))
    np.testing.assert_array_equal(qc.dequant_rows(args[0], sb, rb).numpy(), want)


@pytest.mark.parametrize("n,f,ft", SHAPES)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_rows_plain_matches_jax_and_quant_pack(rng, bits, n, f, ft):
    x = _rows(rng, n, f, ft)
    key = jax.random.PRNGKey(bits + 7 * f)
    u = np.asarray(jax.random.uniform(key, (n, f), dtype=jnp.float32))
    jq, js, jr = jquant.quantize_rows(jnp.asarray(x), bits, key, f_true=ft)
    tq, ts, tr = tquant.quantize_rows(torch.tensor(x), bits, torch.tensor(u), ft)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int((tq.numpy() != np.asarray(jq)).sum()) <= 1e-4 * tq.numel()
    # the plain version of the kernel: the counter generator's uniforms,
    # a code for every column (padding included)
    xt = torch.tensor(x)
    q, s, r = qc._quant_rows_torch(xt, bits, ft, 99)
    q0, s0, r0 = tquant.quantize_rows(xt, bits, qc.uniforms(99, n, f), ft)
    assert torch.equal(q, q0) and torch.equal(s, s0) and torch.equal(r, r0)
    assert q.shape == (n, f) and q.dtype == torch.uint8 and int(q.max()) <= 2**bits - 1
    assert not q[3].any()  # the constant row codes 0
    # the same launch key draws the same codes as the ragged wire's kernel
    fw = wire_cols(ft, bits)
    words, ws, wr = qc._quant_pack_torch(xt, bits, ft, fw, 99)
    assert torch.equal(ws, s) and torch.equal(wr, r)
    assert torch.equal(tquant.unpack_words(words, bits, fw)[:, :min(f, fw)], q[:, :min(f, fw)])


def test_cpu_wrappers_run_the_plain_versions(rng):
    x = torch.tensor(_rows(rng, 40, 64, 60)).to(torch.bfloat16)
    before = (qc.quant_rows.launches, qc.dequant_rows.launches)
    q, s, r = qc.quant_rows(x, 4, 60, 11)
    q0, s0, r0 = tquant.quantize_rows(x, 4, qc.uniforms(11, 40, 64), 60)
    assert torch.equal(q, q0) and torch.equal(s, s0) and torch.equal(r, r0)
    y = qc.dequant_rows(q, s, r)
    assert torch.equal(y, q.float() / s[:, None] + r[:, None])
    err = (y[:, :60] - x[:, :60].float()).abs()
    assert bool((err <= (1.0 / s)[:, None] * (1 + 1e-3) + 1e-6).all())  # one step
    e = qc.quant_rows(x[:0], 8, 60, 1)
    assert e[0].shape == (0, 64) and e[1].shape == (0,)
    assert qc.dequant_rows(e[0], e[1], e[2]).shape == (0, 64)
    assert (qc.quant_rows.launches, qc.dequant_rows.launches) == before


def test_other_devices_raise(rng):
    x = torch.tensor(_rows(rng, 8, 16, 16))
    with pytest.raises(ValueError, match="no quant_rows"):
        qc.quant_rows(x.to("meta"), 4, 16, 1)
    q, s, r = (t.to("meta") for t in qc.quant_rows(x, 4, 16, 1))
    with pytest.raises(ValueError, match="no dequant_rows"):
        qc.dequant_rows(q, s, r)
    with pytest.raises(ValueError, match="bits"):
        qc.quant_rows(x, 3, 16, 1)
