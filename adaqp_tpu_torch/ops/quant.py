"""Stochastic integer message quantization (2/4/8-bit) — plain PyTorch.

Semantics of the JAX package's ``ops/quant.py:88-187`` (themselves the
reference's ``src/quantization_cuda_kernel.cu:35-122``):

- per-ROW ``rmin``/``rmax`` over the first ``f_true`` feature columns
  (columns past it are layout padding and never enter the range);
- ``scale = (2**bits - 1) / max(rmax - rmin, 1e-10)``;
- stochastic rounding ``q = clip(floor((x - rmin) * scale + u), 0,
  2**bits - 1)`` with ``u`` in [0, 1), which is unbiased:
  ``E[q / scale + rmin] == x``;
- dequantization ``x_hat = q / scale + rmin``.

The uniforms ``u`` are an explicit argument here, so that the tests can
hand both packages the same numbers; the kernels draw them from the
counter-based generator in ``quant_cuda.py``.

Wire bytes: the column-packed layout of the padded dense wire
(``pack_rows``): with ``m = 8 // bits`` codes per byte, byte ``j`` of a row
holds the codes of columns ``j * m .. (j + 1) * m - 1``, code ``k`` at bit
offset ``k * bits``; rows are ``pad_features(f_true)`` columns wide
(:func:`message_quantize`, :func:`message_dequantize`).

Wire words: the word-interleaved layout of the ragged wire
(``pack_words``): with ``m = 32 // bits`` codes per u32 word and ``wpr =
F_wire / m`` words per row, word ``j`` of a row holds the codes of columns
``t * wpr + j`` for ``t < m``, code ``t`` at bit offset ``t * bits``.
Words live in ``torch.int32`` tensors (PyTorch's unsigned 32-bit type has
few operators); only their bits matter.

Every division is an IEEE division of two tensors: ``scalar / tensor`` in
PyTorch multiplies by a reciprocal, which rounds twice and would move a
code across a boundary now and then.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..common.types import BITS_SET

RANGE_EPS = 1e-10
_U32 = 0xFFFFFFFF


def values_per_byte(bits: int) -> int:
    if bits not in BITS_SET:
        raise ValueError(f"bits must be one of {BITS_SET}, got {bits}")
    return 8 // bits


def pad_features(f: int, bits: int = 2) -> int:
    """Smallest F' >= f divisible by ``values_per_byte(bits)`` (a multiple
    of 4 serves every width of BITS_SET)."""
    m = values_per_byte(bits)
    return -(-f // m) * m


def bytes_per_row(f_pad: int, bits: int) -> int:
    """Packed bytes per row (reference: ``get_qsize``,
    ``AdaQP/communicator/buffer.py:181-186``)."""
    m = values_per_byte(bits)
    if f_pad % m:
        raise ValueError(f"f_pad={f_pad} not divisible by {m} for bits={bits}")
    return f_pad * bits // 8


def row_minmax(x: torch.Tensor, f_true: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row min and max over the first ``f_true`` columns."""
    if f_true is not None and f_true < x.shape[-1]:
        x = x[..., :f_true]
    return x.amin(dim=-1), x.amax(dim=-1)


def row_scale(rmin: torch.Tensor, rmax: torch.Tensor, bits: int) -> torch.Tensor:
    """``(2**bits - 1) / max(rmax - rmin, 1e-10)`` in f32, one IEEE division."""
    d = torch.clamp_min(rmax - rmin, RANGE_EPS)
    return torch.div(torch.full_like(d, 2.0**bits - 1.0), d)


def quantize_rows(x: torch.Tensor, bits: int, u: torch.Tensor,
                  f_true: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows of ``x`` [N, F] (f32 or bf16) with uniforms ``u`` [N, F] ->
    ``(q uint8 [N, F], scale f32 [N], rmin f32 [N])``. Codes in columns
    ``>= f_true`` come from whatever those columns hold; the receiver
    drops them."""
    x = x.float()
    rmin, rmax = row_minmax(x, f_true)
    scale = row_scale(rmin, rmax, bits)
    y = (x - rmin[:, None]) * scale[:, None]
    q = torch.clamp(torch.floor(y + u), 0.0, 2.0**bits - 1.0)
    return q.to(torch.uint8), scale, rmin


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, rmin: torch.Tensor
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: uint8 codes [N, F] with f32
    ``scale``/``rmin`` [N] -> f32 ``q / scale + rmin`` [N, F]."""
    return q.float() / scale.float()[:, None] + rmin.float()[:, None]


def pack_rows(q: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 codes [N, F_wire] -> the column-packed wire stream uint8
    [N, F_wire * bits / 8]."""
    m = values_per_byte(bits)
    n, fw = q.shape
    if fw % m:
        raise ValueError(f"feature dim {fw} not padded for bits={bits}")
    if bits == 8:
        return q
    g = q.reshape(n, fw // m, m).to(torch.int32)
    shifts = torch.arange(m, device=q.device, dtype=torch.int32) * bits
    # slots occupy disjoint bit ranges: the sum is the bitwise or
    return (g << shifts).sum(dim=-1).to(torch.uint8)


def unpack_rows(p: torch.Tensor, bits: int, f_wire: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows`: uint8 [N, F_wire * bits / 8] -> uint8
    codes [N, f_wire]."""
    if bits == 8:
        return p
    m = values_per_byte(bits)
    shifts = torch.arange(m, device=p.device, dtype=torch.int32) * bits
    g = (p.to(torch.int32)[..., None] >> shifts) & (2**bits - 1)
    return g.reshape(p.shape[0], f_wire).to(torch.uint8)


def message_quantize(x: torch.Tensor, bits: int, u: torch.Tensor,
                     f_true: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The padded wire's send side: rows [N, F] with uniforms ``u`` [N, F]
    -> ``(wire uint8 [N, F_wire * bits / 8], params bf16 [N, 2] = (scale,
    rmin))`` with ``F_wire = pad_features(f_true)``: only the true columns,
    rounded up to the packing multiple, travel; when ``F_wire > F`` the
    codes are padded with zeros."""
    f = x.shape[-1]
    ft = f if f_true is None else f_true
    q, scale, rmin = quantize_rows(x, bits, u, ft)
    packed = pack_rows(to_width(q, pad_features(ft)), bits)
    return packed, torch.stack([scale, rmin], dim=-1).to(torch.bfloat16)


def message_dequantize(packed: torch.Tensor, params: torch.Tensor, bits: int,
                       f_pad: int, f_true: Optional[int] = None) -> torch.Tensor:
    """The padded wire's receive side: (wire, bf16 params) -> f32 rows
    [N, f_pad]; columns ``>= f_true`` are zero (layout padding, absent
    from the wire)."""
    ft = f_pad if f_true is None else f_true
    x = dequantize_rows(unpack_rows(packed, bits, pad_features(ft)), params[:, 0], params[:, 1])
    return true_columns(x, ft, f_pad)


def to_width(x: torch.Tensor, width: int) -> torch.Tensor:
    """Slice or zero-pad the last axis to ``width``."""
    f = x.shape[-1]
    if f >= width:
        return x[..., :width]
    return torch.nn.functional.pad(x, (0, width - f))


def true_columns(x: torch.Tensor, f_true: int, width: int) -> torch.Tensor:
    """Rows [N, F] with columns ``>= f_true`` zeroed, then sliced or
    zero-padded to ``width``."""
    if f_true < x.shape[-1]:
        x = torch.where(torch.arange(x.shape[-1], device=x.device) < f_true, x, 0.0)
    return to_width(x, width)


def _as_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same 32 bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def pack_words(q: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 codes [N, F_wire] -> int32 words [N, F_wire * bits / 32]."""
    m = 32 // bits
    n, fw = q.shape
    if fw % m:
        raise ValueError(f"feature dim {fw} not word-aligned for bits={bits}")
    g = q.to(torch.int64).reshape(n, m, fw // m)
    shifts = torch.arange(m, device=q.device, dtype=torch.int64) * bits
    # slots occupy disjoint bit ranges: the sum is the bitwise or
    return _as_int32((g << shifts[None, :, None]).sum(dim=1))


def unpack_words(w: torch.Tensor, bits: int, f_wire: int) -> torch.Tensor:
    """Inverse of :func:`pack_words`: int32 words [N, wpr] -> uint8 codes
    [N, f_wire]."""
    m = 32 // bits
    n = w.shape[0]
    shifts = torch.arange(m, device=w.device, dtype=torch.int64) * bits
    g = ((w.to(torch.int64) & _U32)[:, None, :] >> shifts[None, :, None]) & (2**bits - 1)
    return g.reshape(n, f_wire).to(torch.uint8)


def dequantize_words(words: torch.Tensor, scale: torch.Tensor, rmin: torch.Tensor,
                     bits: int, f_true: int, f_wire: int, f_pad: int) -> torch.Tensor:
    """Words [N, wpr] with per-row f32 ``scale``/``rmin`` -> f32 rows
    [N, f_pad]: ``q / scale + rmin``, columns ``>= f_true`` zeroed, then
    sliced or zero-padded to ``f_pad``."""
    return true_columns(dequantize_rows(unpack_words(words, bits, f_wire), scale, rmin),
                        f_true, f_pad)


def param_words(scale: torch.Tensor, rmin: torch.Tensor) -> torch.Tensor:
    """(scale, rmin) rounded to bf16 and packed into one int32 word per row:
    scale in the low half, rmin in the high half (the little-endian bitcast
    of a ``[N, 2]`` bf16 pair, as the JAX package's wire packs it)."""
    s = scale.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    r = rmin.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    return (r << 16) | s


def split_param_words(pw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`param_words`: the bf16 scale and rmin as f32."""
    scale = (pw << 16).view(torch.float32)
    rmin = (pw & -65536).view(torch.float32)
    return scale, rmin
