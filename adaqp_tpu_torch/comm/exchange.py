"""The padded dense wire, and the variance proxy of boundary messages.

The JAX package's ``comm/exchange.py`` is the reference. The exact-size
ragged wire (``exchange_ragged.py``) is the default; this module is the
other ``wire_impl``: every channel of one bit-width bucket carries the same
number of lanes (the bucket's capacity, the largest lane count of that width
over all channels), so one bucket is one dense ``[K, cap, ...]`` tensor and
one ``all_to_all_single`` with equal splits.

A layer's buckets are ``(bucket_bits, bucket_arrays)``: per bucket a
bit-width (2, 4 or 8; 32 for raw f32 lanes) and four int64 ``[K, cap]``
index arrays of this rank, from ``assigner/assignment.py::
buckets_from_assignment``:

- forward: ``send_idx`` the local rows to send to each peer;
  ``recv_slot`` the halo slots of the rows received from each peer;
- backward: ``gather_slot`` the halo slots whose gradient goes back to each
  owner; ``scatter_idx`` the owner's local rows that add it up.

Padding lanes send row 0 and carry drop sentinels: ``recv_slot ==
gather_slot == r_pad`` (the receiver writes them to one spare row past the
halo, and the backward gathers a zero row there) and ``scatter_idx ==
L`` (one spare row past the local rows). JAX drops them with
``mode="drop"``; ``index_put_``/``index_add_`` have no such mode (on the
CPU an index out of range raises, on the card it writes out of bounds), so
each destination here has its spare row, sliced off after. A padding lane
is quantized, shipped and dropped like any other. The f32 exchange runs
over the plan's own ``send_idx``/``recv_slot`` (:func:`uniform_buckets`),
whose padding lanes scatter into row 0, as in JAX: what they add there is
the zero row their sentinel slot gathers, so row 0 keeps its value.

The wire of one quantized bucket: each lane's codes, column-packed
(``ops/quant.py::pack_rows``, ``pad_features(f_true) * bits / 8`` bytes),
then its bf16 (scale, rmin) pair as 4 bytes: one uint8 ``[K, cap, bytes +
4]`` tensor, so that one collective carries a bucket (JAX ships the codes
and the bf16 pairs as two tensors; gloo carries uint8 and bf16 alike, and
one tensor halves the collectives). The sender quantizes with the f32
scale, the receiver dequantizes with the bf16 pair, as in JAX. Raw f32
lanes (``exchange_fp``) ship the rows as they are.

The generator key of bucket ``i`` is ``stream_key(key, i)`` (JAX folds
the bucket index into its key); the uniform of a lane is drawn at its row
of the ``[K * cap, F]`` batch, so the lanes to different peers draw
independently.

:func:`padded_start` gathers, quantizes and starts each bucket's
all-to-all without waiting; :func:`padded_finish` waits and places the
rows inside ``_PaddedExchange``, a ``torch.autograd.Function`` whose
backward is the transpose routing: each rank gathers the gradient of its
halo slots, quantizes it with the backward key (every column live: hidden
layers only), ships it back to the owners, and adds it into their rows.
The sink's gradient is the backward variance trace, per halo slot, of the
unquantized gradient rows. The overlapped modes start the exchange, run
the local aggregation and then finish; the serial modes finish first
(``ops/dist_ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.quant import pack_rows, pad_features, to_width, true_columns, unpack_rows
from ..ops.quant_cuda import dequant_rows, quant_rows, stream_key

FP_BITS = 32  # a bucket of raw f32 lanes

Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def variance_proxy(rows: torch.Tensor, num_feats: int) -> torch.Tensor:
    """Per-row quantization-variance proxy ``(F/6) * (rmax - rmin)^2``
    (reference: ``op_util.py:91-99``). ``num_feats`` is the TRUE feature
    count; columns beyond it are layout padding and are masked out of the
    range (the reference traces exact-F rows)."""
    f = rows.shape[-1]
    if num_feats < f:
        col = torch.arange(f, device=rows.device) < num_feats
        inf = torch.tensor(float("inf"), dtype=rows.dtype, device=rows.device)
        rmin = torch.where(col, rows, inf).amin(dim=-1)
        rmax = torch.where(col, rows, -inf).amax(dim=-1)
    else:
        rmin = rows.amin(dim=-1)
        rmax = rows.amax(dim=-1)
    return range_proxy(rmax - rmin, num_feats)


def range_proxy(d: torch.Tensor, num_feats: int) -> torch.Tensor:
    """:func:`variance_proxy` from the rows' ranges ``d = rmax - rmin``."""
    return (num_feats / 6.0) * d ** 2


def padded_all_to_all(x: torch.Tensor, async_op: bool = False
                      ) -> Tuple[torch.Tensor, Optional[dist.Work]]:
    """Chunk ``j`` of ``x`` [K, ...] to rank ``j``; chunk ``j`` of the
    result from rank ``j``. Returns ``(out, work)``; with ``async_op`` the
    caller waits on ``work`` before reading ``out``."""
    out = torch.empty_like(x)
    return out, dist.all_to_all_single(out, x.contiguous(), async_op=async_op)


def uniform_buckets(send_idx: torch.Tensor, recv_slot: torch.Tensor, bits: int):
    """Every lane of the plan in one bucket of width ``bits`` (the uniform
    scheme; ``FP_BITS`` for the full-precision exchange). The padding lanes
    add their zero gradient rows into row 0, as in JAX."""
    return (bits,), ((send_idx, recv_slot, recv_slot, send_idx),)


def _quant_lanes(rows: torch.Tensor, bits: int, key: int, f_true: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows [K, cap, F] -> (wire uint8 [K, cap, F_wire * bits / 8], params
    bf16 [K, cap, 2] = (scale, rmin)) with ``F_wire = pad_features(f_true)``:
    the ``quant_rows`` kernel, then ``pack_rows``."""
    k, cap, f = rows.shape
    ft = f if f_true is None else f_true
    q, scale, rmin = quant_rows(rows.reshape(k * cap, f), bits, ft, key)
    wire = pack_rows(to_width(q, pad_features(ft)), bits)
    params = torch.stack([scale, rmin], dim=-1).to(torch.bfloat16)
    return wire.reshape(k, cap, -1), params.reshape(k, cap, 2)


def _dequant_lanes(wire: torch.Tensor, params: torch.Tensor, bits: int, f: int,
                   f_true: Optional[int] = None) -> torch.Tensor:
    """(wire [K, cap, bytes], bf16 params [K, cap, 2]) -> f32 rows
    [K, cap, f]: ``unpack_rows``, the ``dequant_rows`` kernel with the bf16
    pair widened to f32, columns ``>= f_true`` zeroed, padded to ``f``."""
    k, cap, _ = wire.shape
    ft = f if f_true is None else f_true
    f_wire = pad_features(ft)
    q = unpack_rows(wire.reshape(k * cap, -1), bits, f_wire).contiguous()
    p = params.reshape(k * cap, 2).float()
    x = dequant_rows(q, p[:, 0].contiguous(), p[:, 1].contiguous())
    return true_columns(x, ft, f).reshape(k, cap, f)


def _frame(wire: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """One uint8 [K, cap, bytes + 4] tensor: each lane's codes, then its
    bf16 pair's 4 bytes."""
    return torch.cat([wire, params.contiguous().view(torch.uint8)], dim=-1)


def _unframe(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return buf[..., :-4], buf[..., -4:].contiguous().view(torch.bfloat16)


@dataclasses.dataclass
class _Shipped:
    """One bucket in flight."""

    bits: int
    dest: torch.Tensor  # [K * cap] destination rows (sentinels included)
    out: torch.Tensor
    work: Optional[dist.Work]
    sendbuf: torch.Tensor  # kept alive until the transfer is done


def _ship(rows: torch.Tensor, bits: int, key: int, f_true: int, dest: torch.Tensor,
          async_op: bool) -> _Shipped:
    """Quantize one bucket's lane rows [K, cap, F] (raw f32 for FP_BITS)
    and start its all-to-all."""
    if bits == FP_BITS:
        buf = rows.float().contiguous()
    else:
        buf = _frame(*_quant_lanes(rows, bits, key, f_true))
    out, work = padded_all_to_all(buf, async_op)
    return _Shipped(bits, dest.reshape(-1), out, work, buf)


def _land(s: _Shipped, f: int, f_true: int) -> torch.Tensor:
    """Wait for a shipped bucket: its received rows, f32 [K * cap, f]."""
    if s.work is not None:
        s.work.wait()
    if s.bits == FP_BITS:
        return s.out.reshape(-1, f)
    wire, params = _unframe(s.out)
    return _dequant_lanes(wire, params, s.bits, f, f_true).reshape(-1, f)


@dataclasses.dataclass
class PaddedPending:
    """A started padded exchange and what its backward needs."""

    buckets: Tuple[Tuple[int, ...], Tuple[Quad, ...]]
    shipped: List[_Shipped]
    r_pad: int
    f: int
    f_true: int
    device: torch.device

    def finish(self) -> torch.Tensor:
        """Remote rows f32 [r_pad, F]; slots no lane fills stay zero."""
        remote = torch.zeros((self.r_pad + 1, self.f), dtype=torch.float32, device=self.device)
        for s in self.shipped:
            remote[s.dest] = _land(s, self.f, self.f_true)
        return remote[: self.r_pad]


def padded_start(h: torch.Tensor, buckets, r_pad: int, key: int = 0,
                 f_true: Optional[int] = None) -> PaddedPending:
    """Gather each bucket's lanes of ``h`` [L, F], quantize them with the
    key ``stream_key(key, i)`` of bucket ``i`` and start their all-to-alls
    without waiting."""
    f = h.shape[1]
    ft = f if f_true is None else f_true
    bits, arrays = buckets
    with torch.no_grad():
        shipped = [_ship(h[send_idx], b, stream_key(key, i), ft, recv_slot, True)
                   for i, (b, (send_idx, recv_slot, _, _)) in enumerate(zip(bits, arrays))]
    return PaddedPending(buckets, shipped, r_pad, f, ft, h.device)


class _PaddedExchange(torch.autograd.Function):
    """Finishes a started padded exchange; its backward is the transpose
    routing over the same buckets."""

    @staticmethod
    def forward(ctx, h, sink, pending: PaddedPending, key_bwd: int):
        ctx.pending, ctx.key, ctx.shape, ctx.h_dtype = pending, key_bwd, h.shape, h.dtype
        return pending.finish()

    @staticmethod
    def backward(ctx, g):
        p: PaddedPending = ctx.pending
        (l, f), dev = ctx.shape, g.device
        want_trace = ctx.needs_input_grad[1]
        g_pad = torch.cat([g.float(), g.new_zeros((1, f), dtype=torch.float32)])
        trace = torch.zeros(p.r_pad + 1, dtype=torch.float32, device=dev) if want_trace else None
        bits, arrays = p.buckets
        shipped = []
        for i, (b, (_, _, gather_slot, scatter_idx)) in enumerate(zip(bits, arrays)):
            back = g_pad[gather_slot]  # [K, cap, F]; sentinel slots read zeros
            if want_trace:
                trace[gather_slot.reshape(-1)] = variance_proxy(back, f).reshape(-1)
            shipped.append(_ship(back, b, stream_key(ctx.key, i), f, scatter_idx, True))
        ct = torch.zeros((l + 1, f), dtype=torch.float32, device=dev)
        for s in shipped:
            ct.index_add_(0, s.dest, _land(s, f, f))
        gh = ct[:l].to(ctx.h_dtype) if ctx.needs_input_grad[0] else None
        return gh, (trace[: p.r_pad] if want_trace else None), None, None


def padded_finish(h: torch.Tensor, sink: Optional[torch.Tensor], pending: PaddedPending,
                  key_bwd: int = 0) -> torch.Tensor:
    """Wait for a started padded exchange: remote rows f32 ``[r_pad, F]``.
    Gradients flow to ``h`` and the backward trace to ``sink`` (a
    ``[r_pad]`` leaf, or None)."""
    return _PaddedExchange.apply(h, sink, pending, key_bwd)


def exchange_fp(h: torch.Tensor, send_idx: torch.Tensor, recv_slot: torch.Tensor,
                sink: Optional[torch.Tensor], r_pad: int) -> torch.Tensor:
    """The f32 boundary exchange (reference ``fp_msg_exchange``,
    ``comm.py:166-191``) over the plan's ``send_idx``/``recv_slot`` [K, S]:
    remote rows f32 [r_pad, F]."""
    buckets = uniform_buckets(send_idx, recv_slot, FP_BITS)
    return padded_finish(h, sink, padded_start(h, buckets, r_pad))


def exchange_quant(h: torch.Tensor, keys: Sequence[int], sink: Optional[torch.Tensor],
                   bucket_arrays: Sequence[Quad], bucket_bits: Sequence[int], r_pad: int,
                   f_true: Optional[int] = None) -> torch.Tensor:
    """The quantized boundary exchange (reference ``qt_msg_exchange``,
    ``comm.py:193-222``): ``keys = (forward key, backward key)``;
    ``f_true`` the true feature columns of ``h`` (the range and the wire
    width). Remote rows f32 [r_pad, F]."""
    buckets = (tuple(bucket_bits), tuple(bucket_arrays))
    return padded_finish(h, sink, padded_start(h, buckets, r_pad, keys[0], f_true), keys[1])
