"""Boundary exchange over exact-size ragged wire buffers.

The JAX package's ``comm/exchange_ragged.py`` is the reference. One
direction of one layer runs in three steps:

1. **pack** (:func:`pack_dir`): one launch of the ``quant_pack`` kernel
   (``ops/quant_cuda.py::pack_lanes``) gathers every lane's source row
   (one row per lane, so a row sent to two peers is quantized twice,
   independently, as in the reference, ``AdaQP/model/op_util.py:189-209``),
   quantizes it with its bucket's width and key (b=32 lanes ship their f32
   bits as they are) and writes its words and parameter word at the lane's
   offsets in the send buffer, laid out per peer as ``comm/wire.py``
   describes;
2. **ship**: one ``all_to_all_single`` at exact per-pair sizes
   (``comm/ragged.py``), asynchronous so that the caller can overlap it;
3. **unpack** (:func:`unpack_dir`): one launch of the ``unpack_dequant``
   kernel (``unpack_lanes``) reads every received lane at its offsets. The
   forward writes each lane's f32 row straight into its destination row
   (through the inverse map ``d_inv``: every halo slot has one sender;
   slots that receive nothing are zero); the backward adds each lane's row
   into the owner's row (a row may come back from several peers; the JAX
   package sorts by destination for its TPU segment sum, which buys
   nothing here: the card adds with atomics, so where three or more peers
   return one row the order of its sum varies; on the CPU one
   ``index_add_``).

On the CPU the same two functions run the kernels' plain versions
(``_pack_lanes_torch``, ``_unpack_lanes_torch``). Spans: starting the
all-to-all is ``adaqp.communication.start``, the wait for it
``adaqp.communication.wait`` (both directions); the kernels run inside
``adaqp.quantization`` (``ops/quant_cuda.py``).

The parameter word. Scale and rmin travel as bf16, packed into one word
(``ops/quant.py::param_words``); the receiver dequantizes with the bf16
values while the sender quantized with the f32 scale, exactly as the JAX
package's wire does.

:func:`exchange_start` runs step 1 and starts step 2; :func:`exchange_finish`
waits and unpacks inside :class:`_Exchange`, a ``torch.autograd.Function``
whose backward runs the layer's backward wire (receiver to owner) with a
scatter-add and returns the per-slot backward variance trace as the
gradient of the ``sink`` leaf. A ``None`` backward plan (layer 0: input
features need no gradient) makes the backward exchange nothing on every
rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.quant_cuda import pack_lanes, stream_key, unpack_lanes
from ..utils.timer import span
from .exchange import range_proxy
from .ragged import ragged_all_to_all
from .wire import LocalWire


def pack_dir(w: LocalWire, src: torch.Tensor, key: int, f_true: int,
             trace: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """This rank's send buffer (int32, ``sum(w.send_splits)`` words) from
    its source rows ``src`` [n, F]; bucket ``i`` draws the uniforms of
    ``stream_key(key, i)``. With ``trace``, also the variance proxy of
    every lane row, buckets concatenated (the backward trace; None without
    lanes)."""
    keys = [stream_key(key, bi) for bi in range(len(w.bits))]
    buf, rng = pack_lanes(src, w.send_lanes, w.bits, w.wpr, keys, f_true,
                          sum(w.send_splits), with_range=trace)
    if rng is None or not w.send_lanes.n:
        return buf, None
    return buf, range_proxy(rng, f_true)


def unpack_dir(w: LocalWire, recvbuf: torch.Tensor, scatter_add: bool,
               f_true: int, f_pad: int) -> torch.Tensor:
    """A received buffer -> f32 ``[w.out_len, f_pad]``: placed by the
    inverse map (forward) or added into the destination rows (backward)."""
    lanes = w.recv_lanes
    if not scatter_add:
        if w.d_inv is None:
            raise ValueError("a forward wire needs unique destinations (d_inv)")
        return unpack_lanes(recvbuf, lanes, w.bits, w.wpr, f_true, f_pad, inv=w.d_inv)
    out = torch.zeros((w.out_len, f_pad), dtype=torch.float32, device=recvbuf.device)
    return unpack_lanes(recvbuf, lanes, w.bits, w.wpr, f_true, f_pad, add_into=out)


@dataclasses.dataclass
class Pending:
    """A started exchange: the buffers in flight and how to unpack them."""

    wire: LocalWire
    sendbuf: torch.Tensor  # kept alive until the transfer is done
    recvbuf: torch.Tensor
    work: Optional[dist.Work]
    f_true: int
    f_pad: int

    def finish(self, scatter_add: bool) -> torch.Tensor:
        with span("adaqp.communication.wait"):
            if self.work is not None:
                self.work.wait()
        return unpack_dir(self.wire, self.recvbuf, scatter_add, self.f_true, self.f_pad)


def _start(w: LocalWire, src: torch.Tensor, key: int, f_true: int,
           async_op: bool, trace: bool = False):
    sendbuf, tr = pack_dir(w, src, key, f_true, trace)
    with span("adaqp.communication.start"):
        recvbuf, work = ragged_all_to_all(sendbuf, w.send_splits, w.recv_splits, async_op)
    return Pending(w, sendbuf, recvbuf, work, f_true, src.shape[1]), tr


def exchange_start(h: torch.Tensor, wfwd: LocalWire, key: int, f_true: int) -> Pending:
    """Pack this rank's boundary rows of ``h`` and start the forward
    all-to-all without waiting for it."""
    with torch.no_grad():
        return _start(wfwd, h, key, f_true, async_op=True)[0]


class _Exchange(torch.autograd.Function):
    """Finishes a started forward exchange; its backward is the transpose
    routing over the backward wire."""

    @staticmethod
    def forward(ctx, h, sink, pending: Pending, wbwd: Optional[LocalWire],
                key_bwd: int):
        ctx.wbwd, ctx.key, ctx.f_true = wbwd, key_bwd, pending.f_true
        ctx.h_dtype = h.dtype
        ctx.r_pad = pending.wire.out_len
        return pending.finish(scatter_add=False)

    @staticmethod
    def backward(ctx, g):
        want_trace = ctx.needs_input_grad[1]
        w = ctx.wbwd
        if w is None:
            trace = (torch.zeros(ctx.r_pad, dtype=torch.float32, device=g.device)
                     if want_trace else None)
            return None, trace, None, None, None
        p, tr = _start(w, g.contiguous(), ctx.key, ctx.f_true, async_op=False,
                       trace=want_trace)
        gh = p.finish(scatter_add=True).to(ctx.h_dtype)
        trace = None
        if want_trace:
            # per halo slot (this rank's backward-send lanes), as the
            # reference traces the gradient exchange (op_util.py:91-99)
            trace = torch.zeros(ctx.r_pad, dtype=torch.float32, device=g.device)
            if tr is not None:
                trace[w.send_lanes.row] = tr
        return (gh if ctx.needs_input_grad[0] else None), trace, None, None, None


def exchange_finish(h: torch.Tensor, sink: Optional[torch.Tensor], pending: Pending,
                    wbwd: Optional[LocalWire], key_bwd: int) -> torch.Tensor:
    """Wait for a started exchange and unpack it: remote rows f32
    ``[r_pad, F]``. Gradients flow to ``h`` through ``wbwd`` and the
    backward trace to ``sink`` (a ``[r_pad]`` leaf, or None)."""
    return _Exchange.apply(h, sink, pending, wbwd, key_bwd)


def exchange_ragged(h, sink, wfwd, wbwd, keys, f_true) -> torch.Tensor:
    """Both halves back to back: ``keys = (forward key, backward key)``."""
    return exchange_finish(h, sink, exchange_start(h, wfwd, keys[0], f_true),
                           wbwd, keys[1])
