"""Boundary exchange over exact-size ragged wire buffers.

The JAX package's ``comm/exchange_ragged.py`` is the reference. One
direction of one layer runs in three steps:

1. **pack** (:func:`pack_dir`): gather each bucket's lane rows from the
   source rows (one row per lane, so a row sent to two peers is quantized
   twice, independently, as in the reference, ``AdaQP/model/op_util.py:
   189-209``), quantize and pack them with the ``quant_pack`` kernel (b=32
   lanes ship their f32 bits as they are), and lay the words out per peer
   as ``comm/wire.py`` describes;
2. **ship**: one ``all_to_all_single`` at exact per-pair sizes
   (``comm/ragged.py``), asynchronous so that the caller can overlap it;
3. **unpack** (:func:`unpack_dir`): each bucket's received words go through
   the ``unpack_dequant`` kernel into one f32 row buffer (bucket after
   bucket); the forward places them with a gather through the inverse map
   ``d_inv`` (every halo slot has one sender), the backward adds them into
   the owners' rows with one ``index_add_`` over ``d_rows`` (a row may come
   back from several peers; the JAX package sorts by destination for its
   TPU segment sum, which buys nothing here: the card adds with atomics).

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
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.quant import param_words, split_param_words, to_width
from ..ops.quant_cuda import quant_pack, stream_key, unpack_dequant
from .exchange import variance_proxy
from .ragged import ragged_all_to_all
from .wire import LocalWire


def _bucket_words(w: LocalWire, bi: int, rows: torch.Tensor, key: int, f_true: int
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One bucket's lane rows [S, F] -> (words int32 [S, wpr], param words
    int32 [S] or None). b=32 lanes carry raw f32 bits and a zero param
    word; quantized lanes draw the uniforms of ``stream_key(key, bi)``."""
    b = w.bits[bi]
    if b == 32:
        words = to_width(rows.float(), w.fw[bi]).contiguous().view(torch.int32)
        pw = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
        return words, (pw if w.has_params else None)
    words, scale, rmin = quant_pack(rows, b, f_true, w.fw[bi], stream_key(key, bi))
    return words, param_words(scale, rmin)


def pack_dir(w: LocalWire, src: torch.Tensor, key: int, f_true: int,
             trace: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """This rank's send buffer (int32, ``sum(w.send_splits)`` words) from
    its source rows ``src`` [n, F]. With ``trace``, also the variance proxy
    of every lane row, buckets concatenated (the backward trace)."""
    nb = len(w.bits)
    words: List[Optional[torch.Tensor]] = [None] * nb
    pwords: List[Optional[torch.Tensor]] = [None] * nb
    traces = []
    for bi in range(nb):
        if w.q_rows[bi].numel() == 0:
            continue
        rows = src[w.q_rows[bi]]
        if trace:
            traces.append(variance_proxy(rows.float(), f_true))
        words[bi], pwords[bi] = _bucket_words(w, bi, rows, key, f_true)
    pieces = []
    start = [0] * nb
    for j in range(len(w.send_cnt[0]) if nb else 0):  # peers, ascending
        cnt = [w.send_cnt[bi][j] for bi in range(nb)]
        for bi in range(nb):
            if cnt[bi]:
                pieces.append(words[bi][start[bi]:start[bi] + cnt[bi]].reshape(-1))
        if w.has_params:
            for bi in range(nb):
                if cnt[bi]:
                    pieces.append(pwords[bi][start[bi]:start[bi] + cnt[bi]])
        for bi in range(nb):
            start[bi] += cnt[bi]
    if pieces:
        sendbuf = torch.cat(pieces)
    else:
        sendbuf = torch.empty(0, dtype=torch.int32, device=src.device)
    return sendbuf, (torch.cat(traces) if traces else None)


def unpack_dir(w: LocalWire, recvbuf: torch.Tensor, scatter_add: bool,
               f_true: int, f_pad: int) -> torch.Tensor:
    """A received buffer -> f32 ``[w.out_len, f_pad]``: placed by the
    inverse map (forward) or added into the destination rows (backward)."""
    nb = len(w.bits)
    n_send = len(w.recv_cnt[0]) if nb else 0
    blocks = [[] for _ in range(nb)]
    pblocks = [[] for _ in range(nb)]
    o = 0
    for j in range(n_send):  # senders, ascending
        cnt = [w.recv_cnt[bi][j] for bi in range(nb)]
        for bi in range(nb):
            if cnt[bi]:
                n = cnt[bi] * w.wpr[bi]
                blocks[bi].append(recvbuf[o:o + n].view(cnt[bi], w.wpr[bi]))
                o += n
        if w.has_params:
            for bi in range(nb):
                if cnt[bi]:
                    pblocks[bi].append(recvbuf[o:o + cnt[bi]])
                    o += cnt[bi]
    r_tot = [sum(c) for c in w.recv_cnt]
    s_tot = sum(r_tot)
    dev = recvbuf.device
    # one f32 row per received lane, buckets in order; the forward's gather
    # reads one zero row past the end for slots that receive nothing
    rows = torch.empty((s_tot + (0 if scatter_add else 1), f_pad),
                       dtype=torch.float32, device=dev)
    off = 0
    for bi, b in enumerate(w.bits):
        if not r_tot[bi]:
            continue
        part = rows[off:off + r_tot[bi]]
        words = torch.cat(blocks[bi]) if len(blocks[bi]) > 1 else blocks[bi][0]
        if b == 32:
            fw = w.fw[bi]  # == f_true: b=32 lanes carry exact width
            part[:, :fw] = words.view(torch.float32)
            part[:, fw:] = 0.0
        else:
            scale, rmin = split_param_words(torch.cat(pblocks[bi]))
            unpack_dequant(words.contiguous(), scale, rmin, b, f_true, w.fw[bi],
                           f_pad, out=part)
        off += r_tot[bi]
    if not scatter_add:
        if w.d_inv is None:
            raise ValueError("a forward wire needs unique destinations (d_inv)")
        rows[s_tot] = 0.0
        return rows[w.d_inv]
    out = torch.zeros((w.out_len, f_pad), dtype=torch.float32, device=dev)
    if s_tot:
        out.index_add_(0, torch.cat(w.d_rows), rows)
    return out


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
        if self.work is not None:
            self.work.wait()
        return unpack_dir(self.wire, self.recvbuf, scatter_add, self.f_true, self.f_pad)


def _start(w: LocalWire, src: torch.Tensor, key: int, f_true: int,
           async_op: bool, trace: bool = False):
    sendbuf, tr = pack_dir(w, src, key, f_true, trace)
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
                trace[torch.cat(w.q_rows)] = tr
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
