"""Distributed GNN aggregation — the analog of the reference's autograd ops
layer (``AdaQP/model/ops.py``); the JAX package's ``ops/dist_ops.py`` is the
reference.

:func:`dist_aggregate` splits the aggregation by EDGE SOURCE into a
local-source part and a halo-source part; the halo rows come from the
boundary exchange on the run's wire (``wire_impl``):

- ragged (``comm/exchange_ragged.py``): the caller passes the layer's wire
  plan, the fp wire (Vanilla, AdaQP-p, and evaluation in every mode) or
  the quantized one (AdaQP, AdaQP-q in training);
- padded (``comm/exchange.py``): the caller passes the layer's lane
  tables (``PaddedWire``) in quantized training, and None otherwise: the
  f32 exchange runs over the plan's ``send_idx``/``recv_slot``
  (``exchange_fp``), as in the JAX package's ``dist_ops.py:150-172``.

The schedule follows the run mode (reference ``ops.py:132-193``):

- serial modes (Vanilla, AdaQP-q): the exchange finishes before the local
  aggregation starts (the JAX package's ``optimization_barrier``);
- overlapped modes (AdaQP, AdaQP-p): the all-to-all is in flight while the
  local aggregation runs, and is waited for just before the halo part.

Both schedules run the same operations on the same data, so they give the
same bits. At K=1 no message crosses partitions: the halo input is a
constant zero block.

Recomputation (``ShardStatic.remat``, :class:`LayerTape`): the model
recomputes a whole layer in the backward pass (``model/gnn.py``). The
layer's first forward runs the schedule above and keeps the halo rows it
received; the recompute reads them instead of exchanging again, so each
exchange ships once a step and its backward (the transpose routing and the
backward trace) runs once. The JAX package's ``jax.checkpoint`` runs the
layer's collective again when it recomputes; on one card the host-staged
exchange is the largest part of a K>1 step, and the rows it would bring
are the ones already here. The forward trace, which has no gradient, is
computed in the first forward only.

The aggregation ``A^T h`` runs on the run's tile kernel, chosen by the
layout type of ``blocks`` (:func:`pick_block_kernel`: strip, block or
compact), in the aggregation dtype; with no ``blocks`` (``spmm_impl=
segment``) it is a segment sum over the shard's edge lists
(:class:`PairSegSpmm`) in the dtype of its inputs, as in the JAX package.

Aggregation math (reference ``ops.py:17-67``, global degrees clamped >= 1):

- GCN      : out = D_in^-1/2 * A^T * (D_out^-1/2 * h)
- SAGE mean: out = (A^T h) / d_in
- SAGE gcn : out = (A^T h + h) / (d_in + 1)
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from ..comm.exchange import (FP_BITS, padded_finish, padded_start, quant_start, uniform_buckets,
                             variance_proxy)
from ..comm.exchange_ragged import exchange_finish, exchange_start
from ..common.types import AggregatorType, GNNType
from ..graph.device import ShardArrays, ShardStatic, agg_torch_dtype
from .spmm import segment_spmm, spmm_csr
from .spmm_block import BlockDevice, spmm_block
from .spmm_compact import CompactDevice, spmm_compact
from .spmm_strip import StripDevice, spmm_strip


def pick_block_kernel(dev):
    """Tile aggregation by device-layout type (strip, block or compact)."""
    for cls, fn in ((StripDevice, spmm_strip), (BlockDevice, spmm_block),
                    (CompactDevice, spmm_compact)):
        if isinstance(dev, cls):
            return fn
    raise TypeError(f"no tile aggregation for {type(dev).__name__}")


def _seg(src, dst, h, num_out, chunk):
    if chunk is None:
        return segment_spmm(src, dst, None, h, num_out)
    return spmm_csr(src, dst, None, h, num_out, chunk)


class PairSegSpmm(torch.autograd.Function):
    """Local + halo segment-sum aggregation with a gather-form backward.

    ``edges = (fl_src, fl_dst, fh_src, fh_dst, bl_src, bl_dst, bh_src,
    bh_dst)``: the forward lists and their prebuilt dst-sorted transposes
    (``graph/layout.py``). The backward runs the same gather + sum on the
    transposed lists (the reference aggregating gradients on its prebuilt
    ``bwd_graph``, ``AdaQP/model/ops.py:83-95``) and returns each gradient
    in its input's dtype."""

    @staticmethod
    def forward(ctx, hl, hr, edges, l_max: int, r_pad: int, chunk):
        ctx.edges, ctx.dims, ctx.chunk = edges, (l_max, r_pad), chunk
        ctx.dtypes = (hl.dtype, hr.dtype)
        fl_s, fl_d, fh_s, fh_d = edges[:4]
        return _seg(fl_s, fl_d, hl, l_max, chunk) + _seg(fh_s, fh_d, hr, l_max, chunk)

    @staticmethod
    def backward(ctx, g):
        bl_s, bl_d, bh_s, bh_d = ctx.edges[4:]
        (l_max, r_pad), (dl, dr) = ctx.dims, ctx.dtypes
        g_l = g_r = None
        if ctx.needs_input_grad[0]:
            g_l = _seg(bl_s, bl_d, g, l_max, ctx.chunk).to(dl)
        if ctx.needs_input_grad[1]:
            g_r = _seg(bh_s, bh_d, g, r_pad, ctx.chunk).to(dr)
        return g_l, g_r, None, None, None, None


class _Fork(torch.autograd.Function):
    """Two aliases of one tensor; their gradients add in one order."""

    @staticmethod
    def forward(ctx, h):
        ctx.set_materialize_grads(False)
        return h.view_as(h), h.view_as(h)

    @staticmethod
    def backward(ctx, g_agg, g_self):
        if g_agg is None or g_self is None:
            return g_self if g_agg is None else g_agg
        return g_agg + g_self


def fork(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h`` for the aggregation and ``h`` for a SAGE layer's self term.

    Autograd adds the gradients of a tensor's consumers in the order their
    backward nodes run, and the exchange's node is made where the exchange
    finishes: after the local aggregation in overlapped modes, before it
    in serial ones. With two consumers the order cannot change the sum; a
    SAGE layer's self term makes a third, so it takes its own alias, whose
    gradient joins the aggregation's after the aggregation's two have
    added: both schedules then give the same bits."""
    return _Fork.apply(h) if h.requires_grad else (h, h)


class LayerTape:
    """What a recomputed layer keeps of its first forward for the recompute
    in the backward pass: the state of the dropout generator ``gen`` (or
    None) before the layer drew its mask, and the halo rows its exchange
    delivered (f32 ``[r_pad, F]``). :meth:`replay` is the recompute's
    context: it turns the generator back to that state, so that the
    recompute draws the same mask (``torch.utils.checkpoint`` restores only
    the default generators), and puts it back where the forward pass left
    it afterwards."""

    def __init__(self, gen: Optional[torch.Generator]):
        self.gen = gen
        self.gen_state = None if gen is None else gen.get_state()
        self.remote: Optional[torch.Tensor] = None
        self.remote_grad = False
        self.replaying = False

    def keep(self, remote: torch.Tensor) -> None:
        self.remote, self.remote_grad = remote.detach(), remote.requires_grad

    def halo(self) -> torch.Tensor:
        """The kept halo rows, requiring a gradient where the first
        forward's did (the recompute must save what the forward saved)."""
        return self.remote.detach().requires_grad_(self.remote_grad)

    @contextlib.contextmanager
    def replay(self):
        now = None if self.gen is None else self.gen.get_state()
        if now is not None:
            self.gen.set_state(self.gen_state)
        self.replaying = True
        try:
            yield
        finally:
            self.replaying = False
            if now is not None:
                self.gen.set_state(now)

    def contexts(self):
        """``torch.utils.checkpoint``'s ``context_fn``: (forward, recompute)."""
        return contextlib.nullcontext(), self.replay()


def dist_aggregate(
    h: torch.Tensor,
    sh: ShardArrays,
    cfg: ShardStatic,
    blocks,
    f_true: Optional[int] = None,
    wire=None,
    keys: Tuple[int, int] = (0, 0),
    sink: Optional[torch.Tensor] = None,
    padded=None,
    tape: Optional[LayerTape] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Aggregate one partition's rows ``h`` [L, F] over the graph.

    ``blocks``: the rank's tile shards (strip, block or compact), or None
    for the segment sum over ``sh``'s edge lists. At K>1, the exchange on
    the wire ``cfg.wire``: ragged, ``wire`` this layer's ``(fwd, bwd)``
    pair of :class:`~adaqp_tpu_torch.comm.wire.LocalWire` (bwd None for
    layer 0); padded, ``padded`` this layer's lane tables
    (``comm/exchange.py::PaddedWire``) in quantized training, or None for
    the f32 exchange. ``keys`` are the
    (forward, backward) generator keys of the quantized buckets, and
    ``sink`` a ``[r_pad]`` leaf whose gradient becomes the backward
    variance trace (or None). ``tape``: a recomputed layer's
    :class:`LayerTape`; the first forward keeps its halo rows there, and a
    recompute (``tape.replaying``) reads them and starts no exchange.

    Returns ``(out [L, F], fwd_trace [K, S])``; fwd_trace is the
    per-sent-lane variance proxy (reference ``@trace_input``,
    ``op_util.py:91-99``), a value with no gradient (None in a recompute).
    """
    ft = h.shape[1] if f_true is None else f_true
    h_self = None
    if cfg.model is GNNType.SAGE and cfg.agg_type is not AggregatorType.MEAN:
        h, h_self = fork(h)
    replay = tape is not None and tape.replaying
    fwd_trace = None if replay else variance_proxy(h.detach()[sh.send_idx], ft)

    pending = None
    if cfg.k == 1:
        remote = torch.zeros((cfg.r_pad, h.shape[1]), dtype=torch.float32, device=h.device)
    elif replay:
        remote = tape.halo()
    elif cfg.wire == "ragged":
        if wire is None:
            raise ValueError("K>1 aggregation on the ragged wire needs this layer's wire plans")
        wfwd, wbwd = wire
        pending = exchange_start(h, wfwd, keys[0], ft)

        def finish():
            return exchange_finish(h, sink, pending, wbwd, keys[1])
    elif cfg.wire == "padded":
        if padded is None:  # the f32 exchange over the plan
            pending = padded_start(h, uniform_buckets(sh.send_idx, sh.recv_slot, FP_BITS),
                                   cfg.r_pad)
        else:
            pending = quant_start(h, padded, cfg.r_pad, keys[0], ft)

        def finish():
            return padded_finish(h, sink, pending, keys[1])
    else:
        raise ValueError(f"unknown wire {cfg.wire!r} (ragged or padded)")

    if pending is not None and not cfg.mode.overlapped:
        remote, pending = finish(), None

    l = cfg.l_max
    if blocks is None:
        # one function sums both parts (its backward needs both lists), so
        # the segment sum runs once the exchange is done, in every mode
        edges = sh.edges()

        def local_part(hl):
            return hl

        def pair(hl, hr):
            return PairSegSpmm.apply(hl, hr, edges, l, cfg.r_pad, cfg.edge_chunk)
    else:
        fl, bl, fh, bh = blocks.devices()
        kernel = pick_block_kernel(fl)
        dt = agg_torch_dtype(cfg)

        # the local part first: in overlapped modes it runs while the
        # exchange is in flight; the kernel emits dt (f32 accumulation inside)
        def local_part(hl):
            return kernel(fl, hl.to(dt), bl)

        def pair(local, hr):
            return local + kernel(fh, hr.to(dt), bh)

    if cfg.model is GNNType.GCN:
        local = local_part(h * torch.rsqrt(sh.deg_out[:l])[:, None])
    elif cfg.model is GNNType.SAGE:
        local = local_part(h)
    else:
        raise ValueError(f"unknown model {cfg.model}")
    if pending is not None:
        remote = finish()
    if tape is not None and not replay and cfg.k > 1:
        tape.keep(remote)
    if cfg.model is GNNType.GCN:
        hs_remote = remote * torch.rsqrt(sh.deg_out[l:])[:, None]
        out = pair(local, hs_remote) * torch.rsqrt(sh.deg_in[:l])[:, None]
    else:
        agg = pair(local, remote)
        if cfg.agg_type is AggregatorType.MEAN:
            out = agg / sh.deg_in[:l, None]
        else:  # 'gcn' aggregator (reference ops.py:41-46)
            out = (agg + h_self) / (sh.deg_in[:l, None] + 1.0)
    return out, fwd_trace
