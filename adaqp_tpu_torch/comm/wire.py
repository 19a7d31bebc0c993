"""Exact-size wire layout for the ragged boundary exchange (host numpy).

Lowers an :class:`~adaqp_tpu_torch.assigner.assignment.Assignment`
(per-message bit-widths) to the layouts that ``comm/exchange_ragged.py``
packs, ships with one ``all_to_all_single`` and unpacks. The JAX package's
``comm/wire.py`` is the reference. Each sender's buffer holds, per
receiver in ascending rank order, one slice

    [bucket 0 lanes' words | bucket 1 lanes' words | ... | param words]

where a bucket is one bit-width, a lane is one boundary message (one row
sent to one peer), each lane takes ``words_per_row(f_true, bits)`` u32
words, and each lane of a quantized wire has one param word (bf16 scale
and rmin). Receivers derive the same layout from the replicated
assignment, so no layout travels.

What differs from the reference, and why:

- **Exact sizes.** The JAX package aligns bucket segments to their words
  per row and slice starts to 128-word lane rows, and pads per-slot lane
  counts to a static cap that is the maximum over shards: TPU tiling and
  SPMD need every shard to run the same shapes. Here each rank has its own
  shapes, so slices are exact word counts, lanes sit back to back, and a
  rank's lane arrays hold its own lanes only (no sentinel rows).
- **No ``static_shapes``.** The JAX package rounds capacities to powers of
  two to keep jit caches warm across reassignments; PyTorch runs eagerly,
  so there is nothing to keep warm.

A :class:`WireDir` holds one direction of one layer for every rank (the
lowering is the same on all of them); :meth:`WireDir.local` gives one
rank's :class:`LocalWire` with index tensors on its device and the split
sizes as host ``int`` lists, so that an exchange never reads sizes back
from the device. It also lays out the rank's lane tables
(``ops/quant_cuda.py::Lanes``), once per wire: in each direction the
lanes of all buckets in bucket order, each with its row (source or
destination), bucket, index inside the bucket, and word and parameter-word
offsets in the buffer above, which the ``quant_pack`` and
``unpack_dequant`` kernels read and write directly (the JAX package's
``q_off``/``q_poff`` and ``d_off``/``d_poff``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..assigner.assignment import Assignment
from ..common.types import BITS_SET, WIRE_BITS_SET
from ..graph.layout import ExchangePlan
from ..ops.quant_cuda import Lanes


def wire_cols(f_true: int, bits: int) -> int:
    """Feature columns on the wire for one bit-width: the true width rounded
    up so each row's packed stream is whole 32-bit words."""
    m = 32 // bits  # values per word
    return -(-f_true // m) * m


def words_per_row(f_true: int, bits: int) -> int:
    return wire_cols(f_true, bits) * bits // 32


@dataclasses.dataclass
class WireDir:
    """One direction (fwd or bwd) of one layer's exchange, for all K ranks.

    Per-bucket tuples align with ``bits``; inside each, one numpy array per
    rank. Lanes of a bucket are ordered peer-major (ascending peer rank),
    then in plan lane order; ``cnt[ws, wr, b]`` is the lane count of
    sender ``ws`` to receiver ``wr`` in bucket ``b``."""

    bits: Tuple[int, ...]
    wpr: Tuple[int, ...]
    fw: Tuple[int, ...]  # wire columns per bucket (word-aligned true width)
    has_params: bool
    cnt: np.ndarray  # int64 [K, K, nb]
    send_sz: np.ndarray  # int64 [K(sender), K(receiver)] words
    recv_sz: np.ndarray  # int64 [K(receiver), K(sender)] words
    # sender side: per bucket, per rank, the source rows of its lanes
    q_rows: Tuple[Tuple[np.ndarray, ...], ...]
    # receiver side: per bucket, per rank, the destination rows of its lanes
    d_rows: Tuple[Tuple[np.ndarray, ...], ...]
    # gather map (unique destinations, forward wires): per rank, destination
    # row -> position in the bucket-concatenated received rows; rows that
    # receive nothing point one past the end (a zero row)
    d_inv: Optional[Tuple[np.ndarray, ...]]

    @property
    def k(self) -> int:
        return self.cnt.shape[0]

    def local(self, rank: int, out_len: int, device=None) -> "LocalWire":
        """Rank ``rank``'s view: index tensors on ``device``, split sizes
        and per-peer lane ranges as host ints. ``out_len`` is the row count
        of the unpacked destination."""
        k, nb = self.k, len(self.bits)
        peers_s = [wr for wr in range(k) if wr != rank]  # receivers
        peers_r = [ws for ws in range(k) if ws != rank]  # senders

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        inv = None
        if self.d_inv is not None:
            a = self.d_inv[rank]
            s_tot = int(sum(len(self.d_rows[b][rank]) for b in range(nb)))
            if len(a) < out_len:
                a = np.concatenate([a, np.full(out_len - len(a), s_tot, np.int64)])
            inv = idx(a[:out_len])
        return LocalWire(
            bits=self.bits, wpr=self.wpr, fw=self.fw, has_params=self.has_params,
            out_len=out_len,
            send_splits=[int(self.send_sz[rank, p]) for p in range(k)],
            recv_splits=[int(self.recv_sz[rank, p]) for p in range(k)],
            send_cnt=tuple(tuple(int(self.cnt[rank, p, b]) for p in peers_s) for b in range(nb)),
            recv_cnt=tuple(tuple(int(self.cnt[p, rank, b]) for p in peers_r) for b in range(nb)),
            q_rows=tuple(idx(self.q_rows[b][rank]) for b in range(nb)),
            d_rows=tuple(idx(self.d_rows[b][rank]) for b in range(nb)),
            d_inv=inv,
            send_lanes=self._lanes(self.cnt[rank], self.send_sz[rank],
                                   [self.q_rows[b][rank] for b in range(nb)], idx),
            recv_lanes=self._lanes(self.cnt[:, rank], self.recv_sz[rank],
                                   [self.d_rows[b][rank] for b in range(nb)], idx),
        )

    def _lanes(self, cnt: np.ndarray, sizes: np.ndarray, rows: Sequence[np.ndarray],
               idx) -> Lanes:
        """One side's lane table. ``cnt`` int [K, nb]: lanes per (peer in
        buffer order, bucket), 0 for the rank itself; ``sizes`` the words
        of each peer's slice; ``rows`` per bucket the lanes' rows, peer
        after peer. A slice holds its buckets' words, then (with params)
        its buckets' parameter words."""
        wpr = np.asarray(self.wpr, np.int64)
        words = cnt * wpr  # [K, nb]
        base = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        w_off, p_off = [], []
        for bi in range(len(self.bits)):
            for p in np.nonzero(cnt[:, bi])[0]:
                lane = np.arange(cnt[p, bi], dtype=np.int64)
                w_off.append(base[p] + words[p, :bi].sum() + lane * wpr[bi])
                p_off.append(base[p] + words[p].sum() + cnt[p, :bi].sum() + lane)
        counts = tuple(int(len(r)) for r in rows)
        cat = lambda parts: np.concatenate(parts) if parts else np.zeros(0, np.int64)
        return Lanes(
            counts=counts,
            row=idx(cat(list(rows))),
            bucket=idx(np.repeat(np.arange(len(counts)), counts)),
            index=idx(cat([np.arange(n) for n in counts])),
            word_off=idx(cat(w_off)),
            param_off=idx(cat(p_off)) if self.has_params else None,
        )


@dataclasses.dataclass
class LocalWire:
    """One rank's side of one direction: what ``exchange_ragged`` needs."""

    bits: Tuple[int, ...]
    wpr: Tuple[int, ...]
    fw: Tuple[int, ...]
    has_params: bool
    out_len: int
    send_splits: List[int]  # words to each rank (0 to itself)
    recv_splits: List[int]  # words from each rank
    send_cnt: Tuple[Tuple[int, ...], ...]  # per bucket, lanes to each peer
    recv_cnt: Tuple[Tuple[int, ...], ...]  # per bucket, lanes from each peer
    q_rows: Tuple[torch.Tensor, ...]
    d_rows: Tuple[torch.Tensor, ...]
    d_inv: Optional[torch.Tensor]
    send_lanes: Lanes  # this rank's lanes to send, buckets in order
    recv_lanes: Lanes  # the lanes it receives, buckets in order

    def quant_launches(self) -> Tuple[int, int]:
        """(quant_pack, unpack_dequant) launches one exchange over this
        wire makes: one if it sends any lane, one if it receives any, for
        all buckets (32-bit lanes included) together."""
        return int(self.send_lanes.n > 0), int(self.recv_lanes.n > 0)


def _build_dir(channels: dict, k: int, f_true: int, bits_set: Sequence[int],
               has_params: bool) -> WireDir:
    """One direction's layout. ``channels[(ws, wr)] = (bits_per_lane,
    gather_idx, scatter_idx)`` for wire-sender ``ws`` -> wire-receiver
    ``wr``, lanes in the plan's order."""
    nb = len(bits_set)
    wpr = tuple(words_per_row(f_true, b) for b in bits_set)
    fw = tuple(wire_cols(f_true, b) for b in bits_set)
    empty = np.zeros(0, np.int64)
    lanes = {}
    cnt = np.zeros((k, k, nb), np.int64)
    for (ws, wr), (bl, gi, si) in channels.items():
        for bi, b in enumerate(bits_set):
            sel = np.where(np.asarray(bl) == b)[0]
            lanes[(ws, wr, bi)] = (np.asarray(gi)[sel].astype(np.int64),
                                   np.asarray(si)[sel].astype(np.int64))
            cnt[ws, wr, bi] = len(sel)
    wpr_arr = np.asarray(wpr, np.int64)
    send_sz = (cnt * wpr_arr).sum(axis=2)
    if has_params:
        send_sz += cnt.sum(axis=2)
    recv_sz = send_sz.T.copy()

    q_rows = tuple(
        tuple(np.concatenate([lanes.get((ws, wr, bi), (empty, empty))[0]
                              for wr in range(k) if wr != ws] or [empty])
              for ws in range(k))
        for bi in range(nb))
    d_rows = tuple(
        tuple(np.concatenate([lanes.get((ws, wr, bi), (empty, empty))[1]
                              for ws in range(k) if ws != wr] or [empty])
              for wr in range(k))
        for bi in range(nb))

    # received rows are concatenated bucket after bucket; position p of a
    # lane is its bucket's offset plus its index within the bucket
    cat = [np.concatenate([d_rows[bi][wr] for bi in range(nb)]) for wr in range(k)]
    unique = all(len(np.unique(c)) == len(c) for c in cat)
    d_inv = None
    if unique:
        d_inv = []
        for c in cat:
            inv = np.full(int(c.max()) + 1 if len(c) else 0, len(c), np.int64)
            inv[c] = np.arange(len(c))
            d_inv.append(inv)
        d_inv = tuple(d_inv)
    return WireDir(
        bits=tuple(int(b) for b in bits_set), wpr=wpr, fw=fw, has_params=has_params,
        cnt=cnt, send_sz=send_sz, recv_sz=recv_sz, q_rows=q_rows, d_rows=d_rows,
        d_inv=d_inv,
    )


def _fwd_channels(plan: ExchangePlan, fwd_bits: np.ndarray, k: int) -> dict:
    ch = {}
    for s in range(k):
        for r in range(k):
            cnt = int(plan.counts[s, r])
            if s == r or cnt == 0:
                continue
            ch[(s, r)] = (
                fwd_bits[s, r, :cnt],
                plan.send_idx[s, r, :cnt],
                plan.recv_slot[r, s, :cnt],
            )
    return ch


def _bwd_channels(plan: ExchangePlan, bwd_bits: np.ndarray, k: int) -> dict:
    """Backward: receiver r returns halo-slot gradients to owner s (wire
    sender = r): gathered from the halo gradient by slot, scatter-ADDED
    into the owner's local rows."""
    ch = {}
    for r in range(k):
        offset = 0
        for s in range(k):
            if s == r:
                continue
            cnt = int(plan.counts[s, r])
            if cnt:
                slots = np.arange(offset, offset + cnt)
                ch[(r, s)] = (
                    bwd_bits[r, slots],
                    slots.astype(np.int64),
                    plan.send_idx[s, r, :cnt],
                )
            offset += cnt
    return ch


def wire_from_assignment(
    plan: ExchangePlan,
    assignment: Assignment,
    layer_dims: Sequence[int],
    bits_set: Sequence[int] = BITS_SET,
) -> List[Tuple[WireDir, Optional[WireDir]]]:
    """Quantized wire plans per layer: ``(fwd, bwd)``; bwd is ``None`` for
    layer 0 (input features carry no gradient). ``layer_dims``: the TRUE
    message width per layer. ``bits_set``: the bucket vocabulary (the
    assigner's options; b=32 lanes ship raw f32 words and keep a zero
    param word)."""
    k = plan.send_idx.shape[0]
    out = []
    for layer in range(assignment.num_layers):
        ft = int(layer_dims[layer])
        fwd = _build_dir(_fwd_channels(plan, assignment.fwd[layer], k), k, ft,
                         bits_set, True)
        bwd = None
        if layer > 0:
            bwd = _build_dir(_bwd_channels(plan, assignment.bwd[layer], k), k, ft,
                             bits_set, True)
        out.append((fwd, bwd))
    return out


def wire_fp(plan: ExchangePlan, layer_dims: Sequence[int], num_layers: int
            ) -> List[Tuple[WireDir, Optional[WireDir]]]:
    """Full-precision wire plans (Vanilla, AdaQP-p, evaluation): one 32-bit
    bucket, no params — exact per-pair f32 transfers."""
    k = plan.send_idx.shape[0]
    lm = np.arange(plan.send_idx.shape[2])[None, None, :] < plan.counts[:, :, None]
    fwd_bits = np.where(lm, 32, 0).astype(np.int32)
    slot = np.arange(plan.r_pad)[None, :]
    bwd_bits = np.where(slot < plan.num_remote[:, None], 32, 0).astype(np.int32)
    out = []
    for layer in range(num_layers):
        ft = int(layer_dims[layer])
        fwd = _build_dir(_fwd_channels(plan, fwd_bits, k), k, ft, (32,), False)
        bwd = None
        if layer > 0:
            bwd = _build_dir(_bwd_channels(plan, bwd_bits, k), k, ft, (32,), False)
        out.append((fwd, bwd))
    return out


def wire_bytes(dirs: Sequence[WireDir]) -> int:
    """Bytes one pass over the given directions moves (all ranks)."""
    return int(sum(int(d.send_sz.sum()) * 4 for d in dirs))


def exact_message_bytes(
    plan: ExchangePlan, assignment: Assignment, layer_dims: Sequence[int],
    param_bytes: int = 4,
) -> int:
    """Reference-exact packed byte count (``get_qsize`` math,
    ``AdaQP/communicator/buffer.py:181-186``): per message
    ``ceil(F_true * bits / 8)`` data bytes plus params."""
    k = plan.send_idx.shape[0]
    total = 0
    for layer in range(assignment.num_layers):
        ft = int(layer_dims[layer])
        fb = assignment.fwd[layer]
        for s in range(k):
            for r in range(k):
                cnt = int(plan.counts[s, r])
                if s == r or cnt == 0:
                    continue
                bl = fb[s, r, :cnt]
                for b in WIRE_BITS_SET:
                    c = int((bl == b).sum())
                    total += c * (-(-ft * b // 8) + param_bytes)
        if layer > 0:
            bb = assignment.bwd[layer]
            for r in range(k):
                valid = bb[r, : int(plan.num_remote[r])]
                for b in WIRE_BITS_SET:
                    c = int((valid == b).sum())
                    total += c * (-(-ft * b // 8) + param_bytes)
    return total
