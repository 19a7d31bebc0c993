"""The quantized wires' kernels.

The ragged wire's pair, both in ``csrc/quant_pack.cu``: the ``quant_pack``
kernel replaces the JAX package's TPU kernel
``ops/quant_pallas.py::_quant_pack_kernel`` (rows -> per-row range ->
stochastic codes -> word-interleaved u32 words) and the ``unpack_dequant``
kernel replaces ``_unpack_dequant_kernel`` (words -> f32 rows). One launch
serves one direction of one layer's exchange: :func:`pack_lanes` gathers
each lane's source row, quantizes it with its bucket's width and key and
writes its words and parameter word at the lane's offsets in the send
buffer (32-bit lanes copy their f32 bits); :func:`unpack_lanes` reads each
lane's words at its offsets and writes its f32 row straight into the
output (forward: at its destination, through the inverse map; backward:
added into its destination). The lane
tables (:class:`Lanes`) come from ``comm/wire.py``. :func:`quant_pack` and
:func:`unpack_dequant` are the contiguous forms (row ``l`` is lane ``l``)
and launch the same two kernels. ``_pack_lanes_torch`` and
``_unpack_lanes_torch`` are the plain versions: the gather, the per-bucket
``_quant_pack_torch`` / ``dequantize_words`` and the placement, driven by
the same tables. The padded dense wire's pair, both in
``csrc/quant_rows.cu``: the ``quant_rows`` kernel replaces
``_quant_kernel`` (rows -> per-row range -> stochastic codes) and the
``dequant_rows`` kernel replaces ``_dequant_kernel`` (codes -> f32 rows),
each with the torch ops the exchange ran around it. One launch serves one
direction of one layer's exchange too: :func:`quant_frames` gathers each
lane's source row, quantizes it with its bucket's width and key and writes
its frame (the column-packed codes, then the bf16 scale and rmin) at the
lane's byte offset in the send buffer; :func:`dequant_frames` reads each
lane's frame and stores its f32 row at its destination, or adds it there
(the backward). The lane tables (:class:`Frames`) come from
``comm/exchange.py``. :func:`quant_rows` and :func:`dequant_rows` are the
contiguous forms (row ``l`` is lane ``l``, one code byte a column, f32 scale
and rmin) and launch the same two kernels. ``_quant_frames_torch`` and
``_dequant_frames_torch`` are the plain versions: the gather, the
per-bucket ``_quant_rows_torch``, ``pack_rows`` and frame, and the
unframe, ``unpack_rows``, ``_dequant_rows_torch``, ``true_columns`` and the
placement, driven by the same tables. All four kernels are CUDA C++ for
``sm_90a``, built with ``nvcc`` at first use and loaded with ``ctypes``.
Each wrapper launches its kernel on a CUDA tensor (and adds one to its
``launches`` count), runs the plain PyTorch version on a CPU tensor, and
raises on anything else; nothing falls back from one to the other. The
wire's four (``pack_lanes``, ``unpack_lanes``, ``quant_frames``,
``dequant_frames``) run inside the span ``adaqp.quantization``.

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
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.cuda_build import raise_on as _raise_on
from ..utils.timer import span
from .quant import (bytes_per_row, dequantize_rows, dequantize_words, pack_rows, pack_words,
                    pad_features, param_words, quantize_rows, row_minmax, split_param_words,
                    to_width, true_columns, unpack_rows)

MAX_BUCKETS = 4  # the kernels' bucket vocabulary: 2, 4, 8 and 32 bits


@dataclasses.dataclass
class Lanes:
    """One direction's lanes on one rank: the lanes of all buckets
    concatenated in bucket order, each bucket's lanes in peer order.
    Int64 tensors of one entry a lane, on the rank's device."""

    counts: Tuple[int, ...]  # lanes per bucket (host)
    row: torch.Tensor  # send: the source row; receive: the destination row
    bucket: torch.Tensor
    index: torch.Tensor  # the lane's index inside its bucket
    word_off: torch.Tensor  # its first word in the buffer
    param_off: Optional[torch.Tensor]  # its parameter word (None: the wire has none)

    @property
    def n(self) -> int:
        return sum(self.counts)


@dataclasses.dataclass(eq=False)
class Frames:
    """One direction of one layer's padded exchange on one rank: the lanes
    of all buckets in bucket order, each bucket's ``[K, cap]`` lanes peer
    after peer, and where each lane's frame lies in the direction's uint8
    buffer, in which bucket ``i`` is the contiguous ``[K, cap,
    frame_bytes(i)]`` slice at byte ``starts[i]``. Int64 tensors of one
    entry a lane, on the rank's device (:func:`make_frames`)."""

    bits: Tuple[int, ...]
    f_true: int  # the range's columns; the wire carries pad_features(f_true)
    counts: Tuple[int, ...]  # lanes per bucket (host)
    starts: Tuple[int, ...]  # each bucket's first byte (host)
    nbytes: int
    src: torch.Tensor  # the source row; past the rows given, a zero row
    dst: torch.Tensor  # the destination row; outside the output, dropped
    bucket: torch.Tensor
    index: torch.Tensor  # the lane's row in its bucket's batch (its uniforms)
    frame_off: torch.Tensor  # its frame's first byte

    @property
    def n(self) -> int:
        return sum(self.counts)

    @property
    def f_wire(self) -> int:
        return pad_features(self.f_true)

    def frame_bytes(self, i: int) -> int:
        """Bytes a frame of bucket ``i``: its codes, then the bf16 pair."""
        return bytes_per_row(self.f_wire, self.bits[i]) + 4

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Each bucket's slice of a direction's buffer."""
        return [buf[s:s + n * self.frame_bytes(i)]
                for i, (s, n) in enumerate(zip(self.starts, self.counts))]


def make_frames(bits: Sequence[int], srcs: Sequence[torch.Tensor],
                dsts: Sequence[torch.Tensor], f_true: int) -> Frames:
    """The lane tables of one direction: per bucket ``i`` of ``bits[i]``
    bits, its lanes' source and destination rows (``[K, cap]`` or flat, in
    lane order; each lane's index in the bucket is its position there).
    Buckets lie back to back in the buffer, frames back to back in each."""
    dev = srcs[0].device if srcs else None
    counts = [int(src.numel()) for src in srcs]
    frame = [bytes_per_row(pad_features(f_true), b) + 4 for b in bits]
    starts = [sum(n * fb for n, fb in zip(counts[:i], frame)) for i in range(len(counts))]

    def cat(parts):
        if not parts:
            return torch.zeros(0, dtype=torch.int64, device=dev)
        return torch.cat([p.reshape(-1).long() for p in parts])

    return Frames(
        bits=tuple(int(b) for b in bits), f_true=int(f_true), counts=tuple(counts),
        starts=tuple(starts), nbytes=sum(n * fb for n, fb in zip(counts, frame)),
        src=cat(srcs), dst=cat(dsts),
        bucket=torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                       torch.tensor(counts, dtype=torch.int64, device=dev)),
        index=cat([torch.arange(n, device=dev) for n in counts]),
        frame_off=cat([s + torch.arange(n, device=dev) * fb
                       for s, n, fb in zip(starts, counts, frame)]),
    )

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


def _bucket_slices(lanes: Lanes):
    start = 0
    for bi, n in enumerate(lanes.counts):
        if n:
            yield bi, slice(start, start + n)
        start += n


def _pack_lanes_torch(x: torch.Tensor, lanes: Lanes, bits: Sequence[int], wpr: Sequence[int],
                      keys: Sequence[int], f_true: int, n_words: int, with_range: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    dev = x.device
    buf = torch.empty(n_words, dtype=torch.int32, device=dev)
    ranges = []
    for bi, sl in _bucket_slices(lanes):
        b, n = bits[bi], sl.stop - sl.start
        rows = x[lanes.row[sl]]
        if b == 32:
            words = to_width(rows.float(), wpr[bi]).contiguous().view(torch.int32)
            pw = torch.zeros(n, dtype=torch.int32, device=dev)
        else:
            words, scale, rmin = _quant_pack_torch(rows, b, f_true, wpr[bi] * 32 // b, keys[bi])
            pw = param_words(scale, rmin)
        buf[lanes.word_off[sl, None] + torch.arange(wpr[bi], device=dev)] = words
        if lanes.param_off is not None:
            buf[lanes.param_off[sl]] = pw
        if with_range:
            lo, hi = row_minmax(rows.float(), f_true)
            ranges.append(hi - lo)
    if not with_range:
        return buf, None
    return buf, (torch.cat(ranges) if ranges else torch.empty(0, device=dev))


def _unpack_lanes_torch(buf: torch.Tensor, lanes: Lanes, bits: Sequence[int],
                        wpr: Sequence[int], f_true: int, f_pad: int,
                        inv: Optional[torch.Tensor] = None,
                        add_into: Optional[torch.Tensor] = None) -> torch.Tensor:
    dev, s_tot = buf.device, lanes.n
    # one f32 row per lane, buckets in order; with inv, one zero row past
    # the end for the output rows that receive nothing
    rows = torch.empty((s_tot + (0 if inv is None else 1), f_pad), dtype=torch.float32,
                       device=dev)
    for bi, sl in _bucket_slices(lanes):
        b = bits[bi]
        words = buf[lanes.word_off[sl, None] + torch.arange(wpr[bi], device=dev)]
        part = rows[sl]
        if b == 32:  # wpr == f_true: 32-bit lanes carry exact width
            part[:, :wpr[bi]] = words.view(torch.float32)
            part[:, wpr[bi]:] = 0.0
        else:
            scale, rmin = split_param_words(buf[lanes.param_off[sl]])
            part.copy_(dequantize_words(words, scale, rmin, b, f_true, wpr[bi] * 32 // b, f_pad))
    if add_into is not None:
        return add_into.index_add_(0, lanes.row, rows) if s_tot else add_into
    if inv is None:
        return rows
    rows[s_tot] = 0.0
    return rows[inv]


def _quant_frames_torch(x: torch.Tensor, fr: Frames, keys: Sequence[int],
                        with_range: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    dev, (n, f) = x.device, x.shape
    buf = torch.empty(fr.nbytes, dtype=torch.uint8, device=dev)
    rng = torch.zeros(n, dtype=torch.float32, device=dev) if with_range else None
    xz = torch.cat([x, x.new_zeros((1, f))])  # the sentinels' zero row
    for bi, sl in _bucket_slices(fr):
        # a bucket's lanes are its batch's rows in order (make_frames)
        b, src = fr.bits[bi], fr.src[sl]
        rows = xz[src.clamp(max=n)]
        q, scale, rmin = _quant_rows_torch(rows, b, fr.f_true, keys[bi])
        pair = torch.stack([scale, rmin], dim=-1).to(torch.bfloat16).view(torch.uint8)
        frame = torch.cat([pack_rows(to_width(q, fr.f_wire), b), pair], dim=-1)
        buf[fr.frame_off[sl, None] + torch.arange(fr.frame_bytes(bi), device=dev)] = frame
        if with_range:
            lo, hi = row_minmax(rows.float(), fr.f_true)
            real = src < n
            rng[src[real]] = (hi - lo)[real]
    return buf, rng


def _dequant_frames_torch(buf: torch.Tensor, fr: Frames, out: torch.Tensor,
                          add: bool = False) -> torch.Tensor:
    dev, (n_out, f_out) = buf.device, out.shape
    rows = torch.empty((fr.n, f_out), dtype=torch.float32, device=dev)
    for bi, sl in _bucket_slices(fr):
        nb = fr.frame_bytes(bi)
        frame = buf[fr.frame_off[sl, None] + torch.arange(nb, device=dev)]
        q = unpack_rows(frame[:, :nb - 4], fr.bits[bi], fr.f_wire).contiguous()
        p = frame[:, nb - 4:].contiguous().view(torch.bfloat16).float()
        x = _dequant_rows_torch(q, p[:, 0].contiguous(), p[:, 1].contiguous())
        rows[sl] = true_columns(x, fr.f_true, f_out)
    keep = (fr.dst >= 0) & (fr.dst < n_out)
    if add:
        return out.index_add_(0, fr.dst[keep], rows[keep])
    out[fr.dst[keep]] = rows[keep]
    return out


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("quant_pack")
    if lib.adaqp_pack_lanes.argtypes is None:
        vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.adaqp_pack_lanes.argtypes = [
            vp, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
        lib.adaqp_pack_lanes.restype = ci
        lib.adaqp_unpack_lanes.argtypes = [
            vp, ci, i64, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
        lib.adaqp_unpack_lanes.restype = ci
        lib.adaqp_quant_error_string.argtypes = [ci]
        lib.adaqp_quant_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _bucket_args(bits: Sequence[int], wpr: Sequence[int], keys: Sequence[int] = ()):
    nb = len(bits)
    if not 1 <= nb <= MAX_BUCKETS or len(wpr) != nb:
        raise ValueError(f"{nb} buckets: the kernels take 1 to {MAX_BUCKETS}, one wpr each")
    return (nb, (ctypes.c_int * nb)(*bits), (ctypes.c_int * nb)(*wpr),
            (ctypes.c_uint32 * nb)(*[k & _MASK for k in keys]) if keys else None)


def _check_lanes(lanes: Lanes, dev: torch.device):
    for name in ("row", "bucket", "index", "word_off", "param_off"):
        t = getattr(lanes, name)
        if t is None and name == "param_off":
            continue
        if (t.device != dev or t.dtype != torch.int64 or not t.is_contiguous()
                or t.shape != (lanes.n,)):
            raise ValueError(f"lane table {name} must be contiguous int64 [{lanes.n}] on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _rows_operand(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be a 2-D f32 or bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _launch_pack(x, n_lanes, f_true, bucket_args, tables, words, scale, rmin, rng):
    dev = x.device
    lib = _lib()
    rc = lib.adaqp_pack_lanes(
        x.data_ptr(), int(x.dtype == torch.bfloat16), n_lanes, x.shape[1],
        min(f_true, x.shape[1]), *bucket_args, *tables, words.data_ptr(), _ptr(scale),
        _ptr(rmin), _ptr(rng), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib.adaqp_quant_error_string, rc, "quant_pack")
    quant_pack.launches += 1


def _launch_unpack(words, n_out, n_lanes, f_true, f_pad, bucket_args, tables, scale, rmin, out):
    dev = words.device
    lib = _lib()
    rc = lib.adaqp_unpack_lanes(
        words.data_ptr(), n_out, n_lanes, f_true, f_pad, *bucket_args[:3], *tables,
        _ptr(scale), _ptr(rmin), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib.adaqp_quant_error_string, rc, "unpack_dequant")
    unpack_dequant.launches += 1


def _rows_lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("quant_rows")
    if lib.adaqp_quant_rows.argtypes is None:
        vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.adaqp_quant_rows.argtypes = [
            vp, ci, i64, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
        lib.adaqp_quant_rows.restype = ci
        lib.adaqp_dequant_rows.argtypes = [
            vp, ci, i64, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, ci, vp, ci, vp]
        lib.adaqp_dequant_rows.restype = ci
        lib.adaqp_quant_rows_error_string.argtypes = [ci]
        lib.adaqp_quant_rows_error_string.restype = ctypes.c_char_p
    return lib


def _launch_quant_rows(x, n_lanes, f_true, f_wire, bits, keys, tables, out, scale, rmin, rng):
    dev, nb = x.device, len(bits)
    lib = _rows_lib()
    rc = lib.adaqp_quant_rows(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], n_lanes, x.shape[1],
        min(f_true, x.shape[1]), f_wire, nb, (ctypes.c_int * nb)(*bits),
        (ctypes.c_uint32 * nb)(*[k & _MASK for k in keys]), *[_ptr(t) for t in tables],
        out.data_ptr(), _ptr(scale), _ptr(rmin), _ptr(rng), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib.adaqp_quant_rows_error_string, rc, "quant_rows")
    quant_rows.launches += 1


def _launch_dequant_rows(buf, n_lanes, f_true, f_wire, bits, tables, scale, rmin, add, out):
    dev, nb = buf.device, len(bits)
    lib = _rows_lib()
    rc = lib.adaqp_dequant_rows(
        buf.data_ptr(), n_lanes, out.shape[0], f_true, f_wire, out.shape[1], nb,
        (ctypes.c_int * nb)(*bits), *[_ptr(t) for t in tables], _ptr(scale), _ptr(rmin),
        int(add), out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib.adaqp_quant_rows_error_string, rc, "dequant_rows")
    dequant_rows.launches += 1


def _check_frames(fr: Frames, dev: torch.device):
    if not 1 <= len(fr.bits) <= MAX_BUCKETS or any(b not in (2, 4, 8) for b in fr.bits):
        raise ValueError(f"bucket widths {fr.bits}: the kernels take 1 to {MAX_BUCKETS} "
                         "buckets of 2, 4 or 8 bits")
    for name in ("src", "dst", "bucket", "index", "frame_off"):
        t = getattr(fr, name)
        if (t.device != dev or t.dtype != torch.int64 or not t.is_contiguous()
                or t.shape != (fr.n,)):
            raise ValueError(f"lane table {name} must be contiguous int64 [{fr.n}] on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_bits(bits: int, f_true: int, f_wire: int):
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    m = 32 // bits
    if f_wire % m or f_wire < f_true or f_true <= 0:
        raise ValueError(f"f_wire={f_wire} invalid for bits={bits}, f_true={f_true}")


def _quant_pack_cuda(x, bits, f_true, f_wire, key):
    x = _rows_operand(x)
    n, f = x.shape
    wpr = f_wire * bits // 32
    dev = x.device
    words = torch.empty((n, wpr), dtype=torch.int32, device=dev)
    scale = torch.empty(n, dtype=torch.float32, device=dev)
    rmin = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _launch_pack(x, n, f_true, _bucket_args((bits,), (wpr,), (key,)), (None,) * 5,
                     words, scale, rmin, None)
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
    if n and f_pad:
        _launch_unpack(words, n, n, f_true, f_pad, _bucket_args((bits,), (wpr,)), (None,) * 5,
                       scale, rmin, out)
    return out


def _pack_lanes_cuda(x, lanes, bits, wpr, keys, f_true, n_words, with_range):
    x = _rows_operand(x)
    dev = x.device
    _check_lanes(lanes, dev)
    args = _bucket_args(bits, wpr, keys)
    words = torch.empty(n_words, dtype=torch.int32, device=dev)
    rng = torch.empty(lanes.n, dtype=torch.float32, device=dev) if with_range else None
    if lanes.n:
        tables = (lanes.row, lanes.bucket, lanes.index, lanes.word_off, lanes.param_off)
        _launch_pack(x, lanes.n, f_true, args, [_ptr(t) for t in tables], words, None, None,
                     rng)
    return words, rng


def _unpack_lanes_cuda(buf, lanes, bits, wpr, f_true, f_pad, inv, add_into):
    dev = buf.device
    if buf.dtype != torch.int32 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError(f"the buffer must be contiguous 1-D int32, got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    _check_lanes(lanes, dev)
    if lanes.param_off is None and any(b != 32 for b, n in zip(bits, lanes.counts) if n):
        raise ValueError("quantized lanes need parameter words")
    args = _bucket_args(bits, wpr)
    if inv is not None and (inv.device != dev or inv.dtype != torch.int64 or inv.dim() != 1
                            or not inv.is_contiguous()):
        raise ValueError(f"inv must be contiguous 1-D int64 on {dev}")
    if add_into is not None:
        if inv is not None:
            raise ValueError("inv and add_into exclude each other")
        if (add_into.dtype != torch.float32 or add_into.device != dev or add_into.dim() != 2
                or add_into.shape[1] != f_pad or not add_into.is_contiguous()):
            raise ValueError(f"add_into must be contiguous f32 [*, {f_pad}] on {dev}")
        out = add_into
    n_out = lanes.n if inv is None else inv.numel()
    if lanes.n == 0:  # nothing received: no launch
        return out if add_into is not None else torch.zeros(
            (n_out, f_pad), dtype=torch.float32, device=dev)
    if add_into is None:
        out = torch.empty((n_out, f_pad), dtype=torch.float32, device=dev)
    if n_out and f_pad:
        dst = None if add_into is None else lanes.row
        tables = (inv, dst, lanes.bucket, lanes.word_off, lanes.param_off)
        _launch_unpack(buf, n_out, lanes.n, f_true, f_pad, args, [_ptr(t) for t in tables],
                       None, None, out)
    return out


def _quant_rows_cuda(x, bits, f_true, key):
    x = _rows_operand(x)
    n, f = x.shape
    dev = x.device
    q = torch.empty((n, f), dtype=torch.uint8, device=dev)
    scale = torch.empty(n, dtype=torch.float32, device=dev)
    rmin = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _launch_quant_rows(x, n, f_true, f, (bits,), (key,), (None,) * 4, q, scale, rmin, None)
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
    if n and f:
        _launch_dequant_rows(q, n, f, f, (8,), (None,) * 3, scale, rmin, False, out)
    return out


def _quant_frames_cuda(x, fr, keys, with_range):
    x = _rows_operand(x)
    dev = x.device
    _check_frames(fr, dev)
    if len(keys) != len(fr.bits):
        raise ValueError(f"{len(keys)} keys for {len(fr.bits)} buckets")
    buf = torch.empty(fr.nbytes, dtype=torch.uint8, device=dev)
    rng = torch.zeros(x.shape[0], dtype=torch.float32, device=dev) if with_range else None
    if fr.n:
        tables = (fr.src, fr.bucket, fr.index, fr.frame_off)
        _launch_quant_rows(x, fr.n, fr.f_true, fr.f_wire, fr.bits, keys, tables, buf, None,
                           None, rng)
    return buf, rng


def _dequant_frames_cuda(buf, fr, out, add):
    dev = buf.device
    if buf.dtype != torch.uint8 or buf.shape != (fr.nbytes,) or not buf.is_contiguous():
        raise ValueError(f"the buffer must be contiguous uint8 [{fr.nbytes}], got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    if (out.dtype != torch.float32 or out.device != dev or out.dim() != 2
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous 2-D f32 tensor on {dev}")
    _check_frames(fr, dev)
    if fr.n and out.numel():
        tables = (fr.dst, fr.bucket, fr.frame_off)
        _launch_dequant_rows(buf, fr.n, fr.f_true, fr.f_wire, fr.bits, tables, None, None, add,
                             out)
    return out


def quant_rows(x: torch.Tensor, bits: int, f_true: int, key: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows ``x`` [N, F] (f32 or bf16) -> ``(q uint8 [N, F], scale f32 [N],
    rmin f32 [N])`` with the uniforms of launch ``key``: the range over the
    first ``f_true`` columns, a code for every column. N=0 launches
    nothing.

    CUDA ``x``: the ``quant_rows`` kernel (one more ``quant_rows.launches``
    per launch). CPU ``x``: the plain version."""
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

    CUDA ``q``: the ``dequant_rows`` kernel (one more
    ``dequant_rows.launches`` per launch). CPU ``q``: the plain version."""
    if q.device.type == "cuda":
        return _dequant_rows_cuda(q, scale, rmin)
    if q.device.type == "cpu":
        return _dequant_rows_torch(q, scale, rmin)
    raise ValueError(f"no dequant_rows for device {q.device}")


def quant_frames(x: torch.Tensor, fr: Frames, keys: Sequence[int], with_range: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One direction's send buffer: uint8 ``[fr.nbytes]`` holding, at each
    lane's ``frame_off``, the frame of row ``x[fr.src]`` (f32 or bf16; a
    zero row for a source past ``x``'s rows) quantized at its bucket's
    width with the uniforms of ``keys[bucket]`` at the lane's index: the
    codes of the ``pad_features(fr.f_true)`` wire columns (0 past ``x``'s
    columns), column-packed, then the bf16 scale and rmin. With
    ``with_range``, also f32 ``[N]``: each source row's ``rmax - rmin``
    over the first ``fr.f_true`` columns, 0 for rows no lane reads (else
    None).

    CUDA ``x``: one launch of the ``quant_rows`` kernel (one more
    ``quant_rows.launches``; none without lanes). CPU ``x``: the plain
    version."""
    with span("adaqp.quantization"):
        if x.device.type == "cuda":
            return _quant_frames_cuda(x, fr, keys, with_range)
        if x.device.type == "cpu":
            return _quant_frames_torch(x, fr, keys, with_range)
    raise ValueError(f"no quant_frames for device {x.device}")


def dequant_frames(buf: torch.Tensor, fr: Frames, out: torch.Tensor, add: bool = False
                   ) -> torch.Tensor:
    """A received buffer (uint8 ``[fr.nbytes]``) into ``out`` (f32 ``[R,
    F]``), which it returns: each lane whose destination lies in ``[0, R)``
    stores its row there (``q / scale + rmin`` with the frame's bf16 pair,
    columns ``>= fr.f_true`` zero), or with ``add`` adds it there (on the
    card with atomics: the order of a sum of three or more rows varies, as
    ``index_add_``'s does). Rows no lane writes keep their contents.

    CUDA ``buf``: one launch of the ``dequant_rows`` kernel (one more
    ``dequant_rows.launches``; none without lanes). CPU ``buf``: the plain
    version."""
    with span("adaqp.quantization"):
        if buf.device.type == "cuda":
            return _dequant_frames_cuda(buf, fr, out, add)
        if buf.device.type == "cpu":
            return _dequant_frames_torch(buf, fr, out, add)
    raise ValueError(f"no dequant_frames for device {buf.device}")


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


def pack_lanes(x: torch.Tensor, lanes: Lanes, bits: Sequence[int], wpr: Sequence[int],
               keys: Sequence[int], f_true: int, n_words: int, with_range: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One direction's send buffer: int32 ``[n_words]`` holding, for every
    lane of ``lanes``, the ``wpr[b]`` words of row ``x[lanes.row]`` (f32 or
    bf16) quantized at ``bits[b]`` with the uniforms of ``keys[b]`` at the
    lane's index inside bucket ``b``, and its parameter word; 32-bit lanes
    carry their f32 bits and a zero parameter word. With ``with_range``,
    also each lane's f32 ``rmax - rmin`` over the first ``f_true`` columns
    (else None).

    CUDA ``x``: one launch of the ``quant_pack`` kernel (one more
    ``quant_pack.launches``; none without lanes). CPU ``x``: the plain
    version."""
    with span("adaqp.quantization"):
        if x.device.type == "cuda":
            return _pack_lanes_cuda(x, lanes, bits, wpr, keys, f_true, n_words, with_range)
        if x.device.type == "cpu":
            return _pack_lanes_torch(x, lanes, bits, wpr, keys, f_true, n_words, with_range)
    raise ValueError(f"no pack_lanes for device {x.device}")


def unpack_lanes(buf: torch.Tensor, lanes: Lanes, bits: Sequence[int], wpr: Sequence[int],
                 f_true: int, f_pad: int, inv: Optional[torch.Tensor] = None,
                 add_into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A received buffer -> f32 rows ``[f_pad]`` wide: without ``inv`` one
    row a lane (``[lanes.n, f_pad]``); with ``inv`` (int64, output row ->
    lane, ``lanes.n`` for none) one row an entry of ``inv``, zero where no
    lane arrives; with ``add_into`` (f32 ``[*, f_pad]``) each lane's row
    added into its row ``lanes.row`` there (the order of a sum of three or
    more rows varies on the card, as ``index_add_``'s does), which is
    returned. Columns ``>= f_true`` of quantized lanes are zero.

    CUDA ``buf``: one launch of the ``unpack_dequant`` kernel (one more
    ``unpack_dequant.launches``; none without lanes). CPU ``buf``: the
    plain version."""
    with span("adaqp.quantization"):
        if buf.device.type == "cuda":
            return _unpack_lanes_cuda(buf, lanes, bits, wpr, f_true, f_pad, inv, add_into)
        if buf.device.type == "cpu":
            return _unpack_lanes_torch(buf, lanes, bits, wpr, f_true, f_pad, inv, add_into)
    raise ValueError(f"no unpack_lanes for device {buf.device}")


quant_pack.launches = 0
unpack_dequant.launches = 0
quant_rows.launches = 0
dequant_rows.launches = 0
