"""The quantized wires' kernels.

The ragged wire's pair: ``quant_pack`` replaces the JAX package's TPU
kernel ``ops/quant_pallas.py::_quant_pack_kernel`` (rows -> per-row range
-> stochastic codes -> word-interleaved u32 words) and ``unpack_dequant``
replaces ``_unpack_dequant_kernel`` (words -> f32 rows), both in
``csrc/quant_pack.cu``. The padded dense wire's pair: ``quant_rows``
replaces ``_quant_kernel`` (rows -> u8 codes, one per column, with the
per-row scale and rmin) and ``dequant_rows`` replaces ``_dequant_kernel``
(u8 codes -> f32 rows), both in ``csrc/quant_rows.cu``. All four are CUDA
C++ for ``sm_90a``, built with ``nvcc`` at first use and loaded with
``ctypes``. Each wrapper launches its kernel on a CUDA tensor (and adds one
to its ``launches`` count), runs the plain PyTorch version on a CPU tensor,
and raises on anything else; nothing falls back from one to the other.

The random numbers. The TPU kernel draws from the chip's hardware
generator, which nothing can reproduce. Here the uniform of element
(row, col) of a launch is a pure function of the launch's 32-bit ``key``
and of (row, col), whatever the launch geometry:

    h = mix32(mix32(key ^ row) ^ col),   u = (h & 0xFFFFFF) * 2**-24

with ``mix32`` the lowbias32 integer hash (two xorshift-multiply rounds).
:func:`uniforms` computes the same function with int64 torch ops (the
32 x 32-bit products are split into 16-bit limbs so they never overflow),
so the kernel and the plain version draw the same codes bit for bit, on
the card and on the CPU. :func:`stream_key` folds any tuple of integers
(seed, epoch, rank, layer, direction, bucket) into such a key.

Arithmetic: both versions compute ``(x - rmin) * scale + u`` with one
rounding per operation (the kernel uses ``__fsub_rn``/``__fmul_rn``/
``__fadd_rn``, so no FMA contraction) and IEEE divisions, so words, scales
and dequantized rows agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.cuda_build import raise_on as _raise_on
from .quant import dequantize_rows, dequantize_words, pack_words, quantize_rows, to_width

_M1, _M2 = 0x7FEB352D, 0x846CA68B
_MASK = 0xFFFFFFFF


def _mix32_int(x: int) -> int:
    x &= _MASK
    x ^= x >> 16
    x = (x * _M1) & _MASK
    x ^= x >> 15
    x = (x * _M2) & _MASK
    x ^= x >> 16
    return x


def stream_key(*parts: int) -> int:
    """A 32-bit generator key from a tuple of integers (each folded in
    through ``mix32``, 32 bits at a time; negative parts are taken modulo
    2**64)."""
    h = 0x9E3779B9
    for p in parts:
        p = int(p) & ((1 << 64) - 1)
        h = _mix32_int(h ^ (p & _MASK))
        h = _mix32_int(h ^ (p >> 32))
    return h


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for int64 ``x`` in [0, 2**32), in 16-bit limbs."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def uniforms(key: int, n: int, f: int, device=None) -> torch.Tensor:
    """f32 [n, f] uniforms in [0, 1) of launch ``key`` (plain version of
    the kernel's generator)."""
    row = torch.arange(n, device=device, dtype=torch.int64)[:, None]
    col = torch.arange(f, device=device, dtype=torch.int64)[None, :]
    h = _mix32(_mix32(row ^ (key & _MASK)) ^ col)
    return (h & 0xFFFFFF).to(torch.float32) * (2.0**-24)


# ---------------------------------------------------------------------------
# plain PyTorch versions (unpack_dequant's is ``quant.dequantize_words``)
# ---------------------------------------------------------------------------


def _quant_rows_torch(x: torch.Tensor, bits: int, f_true: int, key: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n, f = x.shape
    return quantize_rows(x, bits, uniforms(key, n, f, x.device), f_true)


def _dequant_rows_torch(q: torch.Tensor, scale: torch.Tensor, rmin: torch.Tensor
                        ) -> torch.Tensor:
    return dequantize_rows(q, scale, rmin)


def _quant_pack_torch(x: torch.Tensor, bits: int, f_true: int, f_wire: int,
                      key: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n, f = x.shape
    q, scale, rmin = quantize_rows(x, bits, uniforms(key, n, f, x.device), f_true)
    return pack_words(to_width(q, f_wire), bits), scale, rmin


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("quant_pack")
    if lib.adaqp_quant_pack.argtypes is None:
        vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.adaqp_quant_pack.argtypes = [
            vp, ci, ci, ci, ci, ci, ci, cu, vp, vp, vp, ci, vp]
        lib.adaqp_quant_pack.restype = ci
        lib.adaqp_unpack_dequant.argtypes = [
            vp, vp, vp, ci, ci, ci, ci, ci, vp, ci, vp]
        lib.adaqp_unpack_dequant.restype = ci
        lib.adaqp_quant_error_string.argtypes = [ci]
        lib.adaqp_quant_error_string.restype = ctypes.c_char_p
    return lib


def _rows_lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("quant_rows")
    if lib.adaqp_quant_rows.argtypes is None:
        vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.adaqp_quant_rows.argtypes = [vp, ci, ci, ci, ci, ci, cu, vp, vp, vp, ci, vp]
        lib.adaqp_quant_rows.restype = ci
        lib.adaqp_dequant_rows.argtypes = [vp, vp, vp, ci, ci, vp, ci, vp]
        lib.adaqp_dequant_rows.restype = ci
        lib.adaqp_quant_rows_error_string.argtypes = [ci]
        lib.adaqp_quant_rows_error_string.restype = ctypes.c_char_p
    return lib


def _check_bits(bits: int, f_true: int, f_wire: int):
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    m = 32 // bits
    if f_wire % m or f_wire < f_true or f_true <= 0:
        raise ValueError(f"f_wire={f_wire} invalid for bits={bits}, f_true={f_true}")


def _quant_pack_cuda(x, bits, f_true, f_wire, key):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be a 2-D f32 or bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    n, f = x.shape
    wpr = f_wire * bits // 32
    dev = x.device
    words = torch.empty((n, wpr), dtype=torch.int32, device=dev)
    scale = torch.empty(n, dtype=torch.float32, device=dev)
    rmin = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return words, scale, rmin
    lib = _lib()
    rc = lib.adaqp_quant_pack(
        x.data_ptr(), int(x.dtype == torch.bfloat16), n, f, min(f_true, f), bits,
        wpr, key & _MASK, words.data_ptr(), scale.data_ptr(), rmin.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib.adaqp_quant_error_string, rc, "quant_pack")
    quant_pack.launches += 1
    return words, scale, rmin


def _unpack_dequant_cuda(words, scale, rmin, bits, f_true, f_wire, f_pad, out):
    n, wpr = words.shape
    dev = words.device
    for name, t, dt in (("words", words, torch.int32), ("scale", scale, torch.float32),
                        ("rmin", rmin, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {dev}, got {t.dtype} on {t.device}")
    if scale.shape != (n,) or rmin.shape != (n,) or wpr != f_wire * bits // 32:
        raise ValueError("words, scale and rmin disagree in shape")
    if out is None:
        out = torch.empty((n, f_pad), dtype=torch.float32, device=dev)
    elif (out.shape != (n, f_pad) or out.dtype != torch.float32 or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous f32 [{n}, {f_pad}] on {dev}")
    if n == 0:
        return out
    lib = _lib()
    rc = lib.adaqp_unpack_dequant(
        words.data_ptr(), scale.data_ptr(), rmin.data_ptr(), n, bits, f_true,
        wpr, f_pad, out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib.adaqp_quant_error_string, rc, "unpack_dequant")
    unpack_dequant.launches += 1
    return out


def _quant_rows_cuda(x, bits, f_true, key):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be a 2-D f32 or bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    n, f = x.shape
    dev = x.device
    q = torch.empty((n, f), dtype=torch.uint8, device=dev)
    scale = torch.empty(n, dtype=torch.float32, device=dev)
    rmin = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return q, scale, rmin
    lib = _rows_lib()
    rc = lib.adaqp_quant_rows(
        x.data_ptr(), int(x.dtype == torch.bfloat16), n, f, min(f_true, f), bits,
        key & _MASK, q.data_ptr(), scale.data_ptr(), rmin.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib.adaqp_quant_rows_error_string, rc, "quant_rows")
    quant_rows.launches += 1
    return q, scale, rmin


def _dequant_rows_cuda(q, scale, rmin):
    dev = q.device
    for name, t, dt in (("q", q, torch.uint8), ("scale", scale, torch.float32),
                        ("rmin", rmin, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {dev}, got {t.dtype} on {t.device}")
    n, f = q.shape
    if scale.shape != (n,) or rmin.shape != (n,):
        raise ValueError("q, scale and rmin disagree in shape")
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _rows_lib()
    rc = lib.adaqp_dequant_rows(
        q.data_ptr(), scale.data_ptr(), rmin.data_ptr(), n, f, out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib.adaqp_quant_rows_error_string, rc, "dequant_rows")
    dequant_rows.launches += 1
    return out


def quant_rows(x: torch.Tensor, bits: int, f_true: int, key: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows ``x`` [N, F] (f32 or bf16) -> ``(q uint8 [N, F], scale f32 [N],
    rmin f32 [N])`` with the uniforms of launch ``key``: the range over the
    first ``f_true`` columns, a code for every column. N=0 launches
    nothing.

    CUDA ``x``: the kernel (one more ``quant_rows.launches`` per launch).
    CPU ``x``: the plain version."""
    if bits not in (2, 4, 8) or f_true <= 0:
        raise ValueError(f"bits={bits}, f_true={f_true}: bits must be 2, 4 or 8, f_true > 0")
    if x.device.type == "cuda":
        return _quant_rows_cuda(x, bits, f_true, key)
    if x.device.type == "cpu":
        return _quant_rows_torch(x, bits, f_true, key)
    raise ValueError(f"no quant_rows for device {x.device}")


def dequant_rows(q: torch.Tensor, scale: torch.Tensor, rmin: torch.Tensor) -> torch.Tensor:
    """uint8 codes ``q`` [N, F] with f32 ``scale``/``rmin`` [N] -> f32
    ``q / scale + rmin`` [N, F]. N=0 launches nothing.

    CUDA ``q``: the kernel (one more ``dequant_rows.launches`` per launch).
    CPU ``q``: the plain version."""
    if q.device.type == "cuda":
        return _dequant_rows_cuda(q, scale, rmin)
    if q.device.type == "cpu":
        return _dequant_rows_torch(q, scale, rmin)
    raise ValueError(f"no dequant_rows for device {q.device}")


def quant_pack(x: torch.Tensor, bits: int, f_true: int, f_wire: int, key: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows ``x`` [N, F] (f32 or bf16) -> ``(words int32 [N, f_wire * bits
    / 32], scale f32 [N], rmin f32 [N])`` with the uniforms of launch
    ``key``. Columns past ``F`` (when ``f_wire > F``) carry code 0. N=0
    launches nothing.

    CUDA ``x``: the kernel (one more ``quant_pack.launches`` per launch).
    CPU ``x``: the plain version."""
    _check_bits(bits, f_true, f_wire)
    if x.device.type == "cuda":
        return _quant_pack_cuda(x, bits, f_true, f_wire, key)
    if x.device.type == "cpu":
        return _quant_pack_torch(x, bits, f_true, f_wire, key)
    raise ValueError(f"no quant_pack for device {x.device}")


def unpack_dequant(words: torch.Tensor, scale: torch.Tensor, rmin: torch.Tensor,
                   bits: int, f_true: int, f_wire: int, f_pad: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Words [N, wpr] with f32 ``scale``/``rmin`` [N] -> f32 rows [N, f_pad]
    (``q / scale + rmin``; columns ``>= f_true`` zero). ``out``, when
    given, is a contiguous f32 [N, f_pad] tensor written in place (e.g. a
    row range of a larger buffer). N=0 launches nothing.

    CUDA ``words``: the kernel (one more ``unpack_dequant.launches`` per
    launch). CPU ``words``: the plain version."""
    _check_bits(bits, f_true, f_wire)
    if words.device.type == "cuda":
        return _unpack_dequant_cuda(words, scale, rmin, bits, f_true, f_wire, f_pad, out)
    if words.device.type == "cpu":
        x = dequantize_words(words, scale, rmin, bits, f_true, f_wire, f_pad)
        if out is None:
            return x
        out.copy_(x)
        return out
    raise ValueError(f"no unpack_dequant for device {words.device}")


quant_pack.launches = 0
unpack_dequant.launches = 0
quant_rows.launches = 0
dequant_rows.launches = 0
