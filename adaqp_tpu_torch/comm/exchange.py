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

The wire of one quantized bucket: each lane's frame, its codes
column-packed (``ops/quant.py::pack_rows``, ``pad_features(f_true) * bits
/ 8`` bytes), then its bf16 (scale, rmin) pair as 4 bytes: a uint8 ``[K,
cap, bytes + 4]`` slice, so that one collective carries a bucket (JAX
ships the codes and the bf16 pairs as two tensors; gloo carries uint8 and
bf16 alike, and one tensor halves the collectives). The sender quantizes
with the f32 scale, the receiver dequantizes with the bf16 pair, as in
JAX. Raw f32 lanes (``exchange_fp``) ship the rows as they are.

The generator key of bucket ``i`` is ``stream_key(key, i)`` (JAX folds
the bucket index into its key); the uniform of a lane is drawn at its row
of the ``[K * cap, F]`` batch, so the lanes to different peers draw
independently.

A quantized direction runs on lane tables (:class:`PaddedWire`, one
``ops/quant_cuda.py::Frames`` a direction, built once an assignment by
:func:`padded_wire`): the buckets' slices lie back to back in one uint8
buffer a direction. One launch of the ``quant_rows`` kernel
(``quant_frames``) gathers every lane's source row, quantizes it and
writes its frame into the send buffer; each bucket's all-to-all ships its
own slice; once they have landed, one launch of the ``dequant_rows``
kernel (``dequant_frames``) stores every lane's row at its halo slot, or
adds it into its owner's row, and drops the sentinel lanes. The f32
exchange keeps its per-bucket gather, all-to-all and placement.

:func:`quant_start` (:func:`padded_start` for the f32 exchange) quantizes
and starts the all-to-alls without waiting; :func:`padded_finish` waits
and places the rows inside ``_PaddedExchange``, a
``torch.autograd.Function`` whose backward is the transpose routing: each
rank quantizes the gradient of its halo slots with the backward key (every
column live: hidden layers only), ships it back to the owners, and adds it
into their rows. The sink's gradient is the backward variance trace, per
halo slot, of the unquantized gradient rows (from the send kernel's
ranges). The overlapped modes start the exchange, run the local
aggregation and then finish; the serial modes finish first
(``ops/dist_ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.quant_cuda import Frames, dequant_frames, make_frames, quant_frames, stream_key

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


def padded_all_to_all(x: torch.Tensor, async_op: bool = False,
                      out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[dist.Work]]:
    """Chunk ``j`` of ``x`` [K, ...] to rank ``j``; chunk ``j`` of the
    result (``out``, or a new tensor like ``x``) from rank ``j``. Returns
    ``(out, work)``; with ``async_op`` the caller waits on ``work`` before
    reading ``out``."""
    out = torch.empty_like(x) if out is None else out
    return out, dist.all_to_all_single(out, x.contiguous(), async_op=async_op)


def uniform_buckets(send_idx: torch.Tensor, recv_slot: torch.Tensor, bits: int):
    """Every lane of the plan in one bucket of width ``bits`` (the uniform
    scheme; ``FP_BITS`` for the full-precision exchange). The padding lanes
    add their zero gradient rows into row 0, as in JAX."""
    return (bits,), ((send_idx, recv_slot, recv_slot, send_idx),)


@dataclasses.dataclass
class PaddedWire:
    """One layer's quantized padded exchange on one rank: the lane tables
    of its forward direction (``f_true`` columns, ``send_idx`` to
    ``recv_slot``) and of its backward (every column, ``gather_slot`` to
    ``scatter_idx``)."""

    fwd: Frames
    bwd: Frames


def padded_wire(buckets, f_true: int, f: int) -> PaddedWire:
    """A layer's buckets ``(bits, quads)`` of ``[K, cap]`` index arrays ->
    its lane tables for rows of ``f`` columns, ``f_true`` of them true."""
    bits, arrays = buckets
    if any(b not in (2, 4, 8) for b in bits):
        raise ValueError(f"bucket widths {bits}: the quantized wire takes 2, 4 and 8 bits")
    col = lambda j: [quad[j] for quad in arrays]
    return PaddedWire(make_frames(bits, col(0), col(1), f_true),
                      make_frames(bits, col(2), col(3), f))


def _ship_frames(buf: torch.Tensor, fr: Frames) -> Tuple[torch.Tensor, List[dist.Work]]:
    """Each bucket's slice of a send buffer to its peers, without waiting:
    the receive buffer and the all-to-alls in flight."""
    recv = torch.empty_like(buf)
    works = [padded_all_to_all(s, True, r)[1]
             for s, r in zip(fr.views(buf), fr.views(recv)) if s.numel()]
    return recv, works


@dataclasses.dataclass
class _Shipped:
    """One f32 bucket in flight."""

    dest: torch.Tensor  # [K * cap] destination rows (sentinels included)
    out: torch.Tensor
    work: Optional[dist.Work]
    sendbuf: torch.Tensor  # kept alive until the transfer is done


def _ship(rows: torch.Tensor, dest: torch.Tensor, async_op: bool) -> _Shipped:
    """Start one f32 bucket's all-to-all of its lane rows [K, cap, F]."""
    buf = rows.float().contiguous()
    out, work = padded_all_to_all(buf, async_op)
    return _Shipped(dest.reshape(-1), out, work, buf)


def _land(s: _Shipped, f: int) -> torch.Tensor:
    """Wait for a shipped f32 bucket: its received rows, f32 [K * cap, f]."""
    if s.work is not None:
        s.work.wait()
    return s.out.reshape(-1, f)


@dataclasses.dataclass
class PaddedPending:
    """A started f32 padded exchange and what its backward needs."""

    buckets: Tuple[Tuple[int, ...], Tuple[Quad, ...]]
    shipped: List[_Shipped]
    r_pad: int
    f: int
    device: torch.device

    def finish(self) -> torch.Tensor:
        """Remote rows f32 [r_pad, F]; slots no lane fills stay zero."""
        remote = torch.zeros((self.r_pad + 1, self.f), dtype=torch.float32, device=self.device)
        for s in self.shipped:
            remote[s.dest] = _land(s, self.f)
        return remote[: self.r_pad]

    def backward(self, g: torch.Tensor, key: int, l: int, want_trace: bool):
        """The transpose routing of ``g`` [r_pad, F]: (the owners' rows'
        gradient f32 [l, F], the backward trace [r_pad] or None)."""
        f, dev = self.f, g.device
        g_pad = torch.cat([g.float(), g.new_zeros((1, f), dtype=torch.float32)])
        trace = torch.zeros(self.r_pad + 1, dtype=torch.float32, device=dev) if want_trace else None
        shipped = []
        for _, _, gather_slot, scatter_idx in self.buckets[1]:
            back = g_pad[gather_slot]  # [K, cap, F]; sentinel slots read zeros
            if want_trace:
                trace[gather_slot.reshape(-1)] = variance_proxy(back, f).reshape(-1)
            shipped.append(_ship(back, scatter_idx, True))
        ct = torch.zeros((l + 1, f), dtype=torch.float32, device=dev)
        for s in shipped:
            ct.index_add_(0, s.dest, _land(s, f))
        return ct[:l], (trace[: self.r_pad] if want_trace else None)


@dataclasses.dataclass
class QuantPending:
    """A started quantized padded exchange: the forward's buffers in
    flight, and the lane tables its backward runs on."""

    wire: PaddedWire
    sendbuf: torch.Tensor  # kept alive until the transfers are done
    recvbuf: torch.Tensor
    works: List[dist.Work]
    r_pad: int
    f: int

    def finish(self) -> torch.Tensor:
        """Remote rows f32 [r_pad, F]; slots no lane fills stay zero."""
        for w in self.works:
            w.wait()
        remote = torch.zeros((self.r_pad, self.f), dtype=torch.float32,
                             device=self.recvbuf.device)
        return dequant_frames(self.recvbuf, self.wire.fwd, remote)

    def backward(self, g: torch.Tensor, key: int, l: int, want_trace: bool):
        """As :meth:`PaddedPending.backward`, quantized with ``key``."""
        fr = self.wire.bwd
        keys = [stream_key(key, i) for i in range(len(fr.bits))]
        send, rng = quant_frames(g, fr, keys, with_range=want_trace)
        recv, works = _ship_frames(send, fr)
        for w in works:
            w.wait()
        ct = torch.zeros((l, self.f), dtype=torch.float32, device=g.device)
        return (dequant_frames(recv, fr, ct, add=True),
                range_proxy(rng, fr.f_true) if want_trace else None)


def padded_start(h: torch.Tensor, buckets, r_pad: int) -> PaddedPending:
    """Start the f32 padded exchange of ``h`` [L, F] (buckets of
    ``FP_BITS``) without waiting: each bucket's gathered rows ship as they
    are."""
    bits, arrays = buckets
    if any(b != FP_BITS for b in bits):
        raise ValueError(f"bucket widths {bits}: quantized buckets start with quant_start")
    with torch.no_grad():
        shipped = [_ship(h[send_idx], recv_slot, True) for send_idx, recv_slot, _, _ in arrays]
    return PaddedPending(buckets, shipped, r_pad, h.shape[1], h.device)


def quant_start(h: torch.Tensor, wire: PaddedWire, r_pad: int, key: int,
                f_true: int) -> QuantPending:
    """Quantize every lane of ``h`` [L, F] into one send buffer (one
    ``quant_rows`` launch) and start each bucket's all-to-all without
    waiting."""
    if wire.fwd.f_true != f_true or wire.bwd.f_true != h.shape[1]:
        raise ValueError(f"lane tables for {wire.fwd.f_true} / {wire.bwd.f_true} columns, rows "
                         f"of {f_true} true / {h.shape[1]} columns")
    keys = [stream_key(key, i) for i in range(len(wire.fwd.bits))]
    with torch.no_grad():
        send, _ = quant_frames(h, wire.fwd, keys)
        recv, works = _ship_frames(send, wire.fwd)
    return QuantPending(wire, send, recv, works, r_pad, h.shape[1])


class _PaddedExchange(torch.autograd.Function):
    """Finishes a started padded exchange; its backward is the transpose
    routing over the same buckets."""

    @staticmethod
    def forward(ctx, h, sink, pending, key_bwd: int):
        ctx.pending, ctx.key, ctx.shape, ctx.h_dtype = pending, key_bwd, h.shape, h.dtype
        return pending.finish()

    @staticmethod
    def backward(ctx, g):
        want_trace = ctx.needs_input_grad[1]
        ct, trace = ctx.pending.backward(g, ctx.key, ctx.shape[0], want_trace)
        gh = ct.to(ctx.h_dtype) if ctx.needs_input_grad[0] else None
        return gh, trace, None, None


def padded_finish(h: torch.Tensor, sink: Optional[torch.Tensor], pending,
                  key_bwd: int = 0) -> torch.Tensor:
    """Wait for a started padded exchange (``PaddedPending`` or
    ``QuantPending``): remote rows f32 ``[r_pad, F]``. Gradients flow to
    ``h`` and the backward trace to ``sink`` (a ``[r_pad]`` leaf, or
    None)."""
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
    ft = h.shape[1] if f_true is None else f_true
    wire = padded_wire((tuple(bucket_bits), tuple(bucket_arrays)), ft, h.shape[1])
    return padded_finish(h, sink, quant_start(h, wire, r_pad, keys[0], ft), keys[1])
