"""Partition layout builder — the analog of the reference's manager layer
(``AdaQP/manager/conversion.py`` + ``processing.py`` + ``graphEngine.py``),
host-side numpy shared by every rank.

Per partition p (all arrays padded to global maxima and stacked on a leading
``part`` axis; each rank reads its own row):

- local node ordering **central | marginal | padding** — the reference's
  reorder invariant (``conversion.py:56-90``): *marginal* nodes are local
  nodes with at least one remote in-neighbor, *central* the rest.
- remote (halo) slots: one per in-halo node, grouped by owner rank in rank
  order, sorted by global id within a group. Feature matrices are addressed
  as ``[local (Lmax rows) | remote (R_pad rows)]``.
- forward edges = all global edges (u -> v) with part(v) == p, src relabeled
  to local slot or ``Lmax + remote_slot``; split by SOURCE locality:
  *local-src* edges (computable before any exchange) vs *halo-src* edges
  (need remote data). This is a deliberate redesign of the reference's
  central/marginal SUBGRAPH decomposition (``conversion.py:114-172``): with
  segment-sum aggregation the split-by-edge-source form is semantically
  identical (sum over a disjoint edge partition), needs no node relabeling
  or copy buffers, and strictly increases the work that can overlap with the
  exchange (local->marginal edges also run pre-join).
- backward edges = the TRANSPOSE of the forward edge lists (grads flow
  v -> u along each forward edge u -> v), dst-sorted so the backward
  aggregation is the same gather-form segment-sum as the forward — never
  AD's unsorted scatter transpose (the reference prebuilds a reverse graph
  for the same reason, ``graphEngine.py:135-147``; here the exchange's
  custom VJP transposes the routing, so only the edge transpose is needed).
  ``bwd_local`` reverses local-src edges (identical to ``fwd_local`` for
  bidirected graphs); ``bwd_halo`` maps local rows -> remote slots (the
  cotangent of the halo rows).
- exchange plan: for each ordered pair (s -> r), the nodes s must send to r
  (r's halo nodes owned by s) with padded send gather indices and receiver
  scatter slots, plus the per-message aggregation-importance scores the
  assigner consumes (``processing.py:81-107``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..common.types import GNNType
from ..helper.dataset import GraphData


def _round_up(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


_PLAN_FIELDS = (
    "send_idx", "recv_slot", "counts", "num_remote", "scores_fp",
    "scores_bp", "remote_global",
)
_LAYOUT_ARRAYS = (
    "part_id", "local_ids", "num_local", "num_central", "num_marginal",
    "feats", "labels", "train_mask", "val_mask", "test_mask",
    "deg_in_fwd", "deg_out_fwd",
)
_LAYOUT_VERSION = 2  # r2: transposed bwd lists, no plan_bwd/deg_*_bwd freight


def save_layout(path: str, lay: "PartitionLayout"):
    """Persist a built layout (the analog of the reference's cached
    send_idx/recv_idx/agg_scores .npy files, ``processing.py:76-78``)."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save = {
        "k": lay.k, "l_max": lay.l_max, "num_feats": lay.num_feats,
        "num_classes": lay.num_classes, "multilabel": int(lay.multilabel),
        "is_bidirected": int(lay.is_bidirected), "f_true": lay.f_true,
        "version": _LAYOUT_VERSION,
    }
    for f in _LAYOUT_ARRAYS:
        save[f] = getattr(lay, f)
    for tag, pair in (
        ("fl", lay.fwd_local), ("fh", lay.fwd_halo),
        ("bl", lay.bwd_local), ("bh", lay.bwd_halo),
    ):
        save[tag + "_src"], save[tag + "_dst"] = pair
    for f in _PLAN_FIELDS:
        save[f"pf_{f}"] = getattr(lay.plan_fwd, f)
    save["pf_s_pad"] = lay.plan_fwd.s_pad
    save["pf_r_pad"] = lay.plan_fwd.r_pad
    tmp = path + ".tmp.npz"
    np.savez(tmp, **save)
    import os as _os

    _os.replace(tmp, path + ".npz")


def load_layout(path: str) -> Optional["PartitionLayout"]:
    import os

    if not os.path.exists(path + ".npz"):
        return None
    z = np.load(path + ".npz")
    if int(z.get("version", 1)) != _LAYOUT_VERSION:
        return None  # stale cache format: rebuild

    pf = ExchangePlan(
        *(z[f"pf_{f}"] for f in _PLAN_FIELDS),
        int(z["pf_s_pad"]), int(z["pf_r_pad"]),
    )
    bid = bool(int(z["is_bidirected"]))
    fl = (z["fl_src"], z["fl_dst"])
    fh = (z["fh_src"], z["fh_dst"])
    bl = fl if bid else (z["bl_src"], z["bl_dst"])
    bh = (z["bh_src"], z["bh_dst"])
    kw = {f: z[f] for f in _LAYOUT_ARRAYS}
    return PartitionLayout(
        k=int(z["k"]), l_max=int(z["l_max"]), num_feats=int(z["num_feats"]),
        num_classes=int(z["num_classes"]), multilabel=bool(int(z["multilabel"])),
        is_bidirected=bid, f_true=int(z["f_true"]),
        fwd_local=fl, fwd_halo=fh, bwd_local=bl, bwd_halo=bh, plan_fwd=pf,
        **kw,
    )


@dataclass
class ExchangePlan:
    """Boundary exchange pattern for one direction (fwd or bwd).

    ``send_idx[s, r, j]`` = sender-side local slot of the j-th node s sends
    to r (0-padded; ``counts[s, r]`` valid lanes) — SENDER-major, so sharding
    on axis 0 gives each shard its own gather map. ``recv_slot[r, s, j]`` =
    receiver-side remote slot where the j-th lane from s lands (sentinel
    ``R_pad`` pads — dropped by scatter) — RECEIVER-major, same reason.
    Scores are sender-side, lane-aligned with ``send_idx``.
    """

    send_idx: np.ndarray  # int32 [K(sender), K(receiver), S_pad]
    recv_slot: np.ndarray  # int32 [K(receiver), K(sender), S_pad]
    counts: np.ndarray  # int64 [K, K]
    num_remote: np.ndarray  # int64 [K]
    scores_fp: np.ndarray  # f32 [K, K, S_pad]
    scores_bp: np.ndarray  # f32 [K, K, S_pad]
    remote_global: np.ndarray  # int64 [K, R_pad], -1 pad
    s_pad: int
    r_pad: int

    @property
    def num_parts(self) -> int:
        return self.send_idx.shape[0]


@dataclass
class PartitionLayout:
    """Everything a K-partition training run needs, host-side numpy."""

    k: int
    l_max: int  # padded local rows
    num_feats: int  # feature columns AFTER lane padding (f_pad)
    num_classes: int
    multilabel: bool
    is_bidirected: bool
    f_true: int  # raw feature count before padding
    part_id: np.ndarray  # int32 [N_global]
    local_ids: np.ndarray  # int64 [K, Lmax], -1 pad
    num_local: np.ndarray  # int64 [K]
    num_central: np.ndarray  # int64 [K]
    num_marginal: np.ndarray  # int64 [K]
    feats: np.ndarray  # f32 [K, Lmax, F]
    labels: np.ndarray  # int32 [K, Lmax] or f32 [K, Lmax, C]
    train_mask: np.ndarray  # bool [K, Lmax]
    val_mask: np.ndarray
    test_mask: np.ndarray
    # degrees (global, clamped >= 1) addressed [local | remote]
    deg_in_fwd: np.ndarray  # f32 [K, Lmax + R_pad]
    deg_out_fwd: np.ndarray
    # edges: (src, dst) int32, dst sentinel = out-row count on padding
    fwd_local: Tuple[np.ndarray, np.ndarray]  # [K, E_lc] each
    fwd_halo: Tuple[np.ndarray, np.ndarray]  # [K, E_hl] (src = Lmax + slot)
    # TRANSPOSED forward lists, dst-sorted (backward aggregation; module doc)
    bwd_local: Tuple[np.ndarray, np.ndarray]  # is fwd_local when bidirected
    bwd_halo: Tuple[np.ndarray, np.ndarray]  # src = local row, dst = slot
    plan_fwd: ExchangePlan


def _build_plan(
    graph: GraphData,
    part_id: np.ndarray,
    k: int,
    local_slot: np.ndarray,
    cross_src: np.ndarray,
    cross_dst: np.ndarray,
    model_type: GNNType,
    pad_multiple: int,
) -> Tuple[ExchangePlan, Dict[int, Dict[int, np.ndarray]]]:
    """Build an exchange plan from the cross-partition edges (src remote to
    dst's owner). Returns the plan and, per receiver, the ordered halo node
    lists {r: {s: global_ids}} used for remote-slot-relative relabeling."""
    n = graph.num_nodes
    din = np.maximum(graph.in_degrees, 1).astype(np.float64)
    dout = np.maximum(graph.out_degrees, 1).astype(np.float64)

    owner_s = part_id[cross_src]
    owner_r = part_id[cross_dst]
    # per (s, r): unique src nodes, sorted by global id
    halo_lists: Dict[int, Dict[int, np.ndarray]] = {r: {} for r in range(k)}
    pair_nodes: Dict[Tuple[int, int], np.ndarray] = {}
    for s in range(k):
        for r in range(k):
            if s == r:
                continue
            m = (owner_s == s) & (owner_r == r)
            nodes = np.unique(cross_src[m])
            pair_nodes[(s, r)] = nodes
            halo_lists[r][s] = nodes

    counts = np.zeros((k, k), np.int64)
    for (s, r), nodes in pair_nodes.items():
        counts[s, r] = len(nodes)
    s_pad = _round_up(int(counts.max()) if counts.size else 1, pad_multiple)
    num_remote = counts.sum(axis=0)
    r_pad = _round_up(int(num_remote.max()), pad_multiple)

    send_idx = np.zeros((k, k, s_pad), np.int32)
    recv_slot = np.full((k, k, s_pad), r_pad, np.int32)
    scores_fp = np.zeros((k, k, s_pad), np.float32)
    scores_bp = np.zeros((k, k, s_pad), np.float32)
    remote_global = np.full((k, r_pad), -1, np.int64)

    # aggregation-importance scores (reference: processing.py:81-107):
    # for each sent node u and receiving partition r,
    #   GCN : fp = dout(u)^-1/2 * sum_{u->v, part(v)=r} din(v)^-1/2
    #         bp = din(u)^-1/2  * sum_{v->u, part(v)=r} dout(v)^-1/2
    #   SAGE: fp = sum_{u->v, part(v)=r} din(v)^-1
    #         bp = sum_{v->u, part(v)=r} dout(v)^-1
    # computed over the global edge list restricted to the receiver.
    fp_acc: Dict[Tuple[int, int], Dict[int, float]] = {}
    bp_acc: Dict[Tuple[int, int], Dict[int, float]] = {}
    su, sv = graph.src, graph.dst
    pu, pv = part_id[su], part_id[sv]
    crossing = pu != pv
    cu, cv = su[crossing], sv[crossing]
    cpu, cpv = pu[crossing], pv[crossing]
    if model_type is GNNType.GCN:
        fp_w = dout[cu] ** -0.5 * din[cv] ** -0.5
        bp_w = din[cu] ** -0.5 * dout[cv] ** -0.5
    else:
        fp_w = din[cv] ** -1.0
        bp_w = dout[cv] ** -1.0
    # fp: accumulate per (sender-part, receiver-part, src node)
    for arr, acc in ((fp_w, fp_acc), (bp_w, bp_acc)):
        key = (cpu.astype(np.int64) * k + cpv) * n + cu
        uniq, inv = np.unique(key, return_inverse=True)
        sums = np.zeros(len(uniq))
        np.add.at(sums, inv, arr)
        for u_key, val in zip(uniq, sums):
            node = int(u_key % n)
            sr = int(u_key // n)
            s, r = sr // k, sr % k
            acc.setdefault((s, r), {})[node] = val

    for r in range(k):
        offset = 0
        for s in range(k):
            if s == r:
                continue
            nodes = halo_lists[r][s]
            c = len(nodes)
            remote_global[r, offset : offset + c] = nodes
            send_idx[s, r, :c] = local_slot[nodes]
            recv_slot[r, s, :c] = np.arange(offset, offset + c, dtype=np.int32)
            fp_map = fp_acc.get((s, r), {})
            bp_map = bp_acc.get((s, r), {})
            scores_fp[s, r, :c] = [fp_map.get(int(u), 0.0) for u in nodes]
            scores_bp[s, r, :c] = [bp_map.get(int(u), 0.0) for u in nodes]
            offset += c
        assert offset == num_remote[r]

    plan = ExchangePlan(
        send_idx, recv_slot, counts, num_remote, scores_fp, scores_bp,
        remote_global, s_pad, r_pad,
    )
    return plan, halo_lists


def _build_edges(
    src: np.ndarray,
    dst: np.ndarray,
    part_id: np.ndarray,
    k: int,
    local_slot: np.ndarray,
    remote_slot_of: Dict[int, Dict[int, int]],
    l_max: int,
    pad_multiple: int,
):
    """Relabel and split per-part edges into (local-src, halo-src) lists,
    dst-sorted, padded with (src=0, dst=l_max) drop sentinels."""
    pv = part_id[dst]
    pu = part_id[src]
    local_lists = []
    halo_lists = []
    for p in range(k):
        m = pv == p
        s_g, d_g = src[m], dst[m]
        is_local = pu[m] == p
        d_l = local_slot[d_g]
        # local-src edges
        ls, ld = local_slot[s_g[is_local]], d_l[is_local]
        order = np.argsort(ld, kind="stable")
        local_lists.append((ls[order], ld[order]))
        # halo-src edges
        rs_map = remote_slot_of[p]
        hs_g = s_g[~is_local]
        hs = np.fromiter((rs_map[int(u)] for u in hs_g), np.int32, len(hs_g)) + l_max
        hd = d_l[~is_local]
        order = np.argsort(hd, kind="stable")
        halo_lists.append((hs[order], hd[order]))

    def _stack(lists):
        e_pad = _round_up(max(len(a) for a, _ in lists), pad_multiple)
        ss = np.zeros((k, e_pad), np.int32)
        dd = np.full((k, e_pad), l_max, np.int32)  # sentinel: dropped rows
        for p, (a, b) in enumerate(lists):
            ss[p, : len(a)] = a
            dd[p, : len(b)] = b
        return ss, dd

    return _stack(local_lists), _stack(halo_lists)


def _transpose_stacked(
    pair: Tuple[np.ndarray, np.ndarray],
    dst_lim: int,
    new_dst_sentinel: int,
    shift: int = 0,
):
    """Transpose stacked edge lists: each valid edge (s, d) (d < dst_lim)
    becomes (d, s - shift), dst-sorted, padded back to the same width with
    (src=0, dst=sentinel) drop rows. Grad flow v -> u along u -> v."""
    s_arr, d_arr = pair
    k, e = s_arr.shape
    ns = np.zeros((k, e), np.int32)
    nd = np.full((k, e), new_dst_sentinel, np.int32)
    for p in range(k):
        valid = d_arr[p] < dst_lim
        news = d_arr[p][valid].astype(np.int32)
        newd = (s_arr[p][valid] - shift).astype(np.int32)
        order = np.argsort(newd, kind="stable")
        ns[p, : len(news)] = news[order]
        nd[p, : len(newd)] = newd[order]
    return ns, nd


def build_layout(
    graph: GraphData,
    part_id: np.ndarray,
    model_type: GNNType = GNNType.GCN,
    pad_multiple: int = 8,
    edge_pad_multiple: int = 64,
    feat_pad_multiple: int = 4,
) -> PartitionLayout:
    """``feat_pad_multiple``: features are zero-padded to this multiple —
    4 covers every packing width in BITS_SET (2-bit packs 4 values/byte);
    the bitmask-tile path uses 128 so every row is a whole number of
    16-byte vectors."""
    n = graph.num_nodes
    k = int(part_id.max()) + 1
    part_id = part_id.astype(np.int32)

    # ---- forward cross-partition edges define halo & marginal sets ----
    pu, pv = part_id[graph.src], part_id[graph.dst]
    crossing = pu != pv
    cross_src, cross_dst = graph.src[crossing], graph.dst[crossing]

    # marginal = local dsts of crossing edges (reference: conversion.py:62-67)
    is_marginal = np.zeros(n, bool)
    is_marginal[cross_dst] = True

    # ---- local ordering: central | marginal ----
    local_slot = np.full(n, -1, np.int64)
    num_local = np.zeros(k, np.int64)
    num_central = np.zeros(k, np.int64)
    num_marginal = np.zeros(k, np.int64)
    locals_per_part = []
    for p in range(k):
        members = np.where(part_id == p)[0]
        central = members[~is_marginal[members]]
        marginal = members[is_marginal[members]]
        ordered = np.concatenate([central, marginal])
        locals_per_part.append(ordered)
        local_slot[ordered] = np.arange(len(ordered))
        num_local[p] = len(ordered)
        num_central[p] = len(central)
        num_marginal[p] = len(marginal)
        # reference invariant (graphEngine.py:66)
        assert num_local[p] == num_central[p] + num_marginal[p]

    l_max = _round_up(int(num_local.max()), pad_multiple)

    # ---- exchange plan (forward; backward routing is its transpose) ----
    plan_fwd, halo_fwd = _build_plan(
        graph, part_id, k, local_slot, cross_src, cross_dst, model_type, pad_multiple
    )
    is_bid = graph.is_bidirected

    def _slot_maps(halo_lists) -> Dict[int, Dict[int, int]]:
        out = {}
        for r in range(k):
            m = {}
            offset = 0
            for s in range(k):
                if s == r:
                    continue
                for u in halo_lists[r][s]:
                    m[int(u)] = offset
                    offset += 1
            out[r] = m
        return out

    slots_fwd = _slot_maps(halo_fwd)

    # ---- edge lists + their transposes (backward aggregation) ----
    fwd_local, fwd_halo = _build_edges(
        graph.src, graph.dst, part_id, k, local_slot, slots_fwd, l_max, edge_pad_multiple
    )
    # bidirected: the reversed local edge multiset equals the forward one,
    # so the dst-sorted transpose is the identical array (zero extra cache)
    bwd_local = (
        fwd_local if is_bid else _transpose_stacked(fwd_local, l_max, l_max)
    )
    bwd_halo = _transpose_stacked(
        fwd_halo, l_max, plan_fwd.r_pad, shift=l_max
    )

    # ---- per-part node data ----
    f = _round_up(graph.num_feats, feat_pad_multiple)
    local_ids = np.full((k, l_max), -1, np.int64)
    feats = np.zeros((k, l_max, f), np.float32)
    if graph.multilabel:
        labels = np.zeros((k, l_max, graph.num_classes), np.float32)
    else:
        labels = np.zeros((k, l_max), np.int32)
    train_mask = np.zeros((k, l_max), bool)
    val_mask = np.zeros((k, l_max), bool)
    test_mask = np.zeros((k, l_max), bool)
    for p in range(k):
        ordered = locals_per_part[p]
        c = len(ordered)
        local_ids[p, :c] = ordered
        feats[p, :c, : graph.num_feats] = graph.feats[ordered]
        labels[p, :c] = graph.labels[ordered]
        train_mask[p, :c] = graph.train_mask[ordered]
        val_mask[p, :c] = graph.val_mask[ordered]
        test_mask[p, :c] = graph.test_mask[ordered]

    def _degrees(plan: ExchangePlan):
        di = np.ones((k, l_max + plan.r_pad), np.float32)
        do = np.ones((k, l_max + plan.r_pad), np.float32)
        din = np.maximum(graph.in_degrees, 1).astype(np.float32)
        dout = np.maximum(graph.out_degrees, 1).astype(np.float32)
        for p in range(k):
            ordered = locals_per_part[p]
            c = len(ordered)
            di[p, :c] = din[ordered]
            do[p, :c] = dout[ordered]
            rg = plan.remote_global[p]
            valid = rg >= 0
            di[p, l_max : l_max + valid.sum()] = din[rg[valid]]
            do[p, l_max : l_max + valid.sum()] = dout[rg[valid]]
        return di, do

    deg_in_fwd, deg_out_fwd = _degrees(plan_fwd)

    return PartitionLayout(
        k=k,
        l_max=l_max,
        num_feats=f,
        f_true=graph.num_feats,
        num_classes=graph.num_classes,
        multilabel=graph.multilabel,
        is_bidirected=is_bid,
        part_id=part_id,
        local_ids=local_ids,
        num_local=num_local,
        num_central=num_central,
        num_marginal=num_marginal,
        feats=feats,
        labels=labels,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        deg_in_fwd=deg_in_fwd,
        deg_out_fwd=deg_out_fwd,
        fwd_local=fwd_local,
        fwd_halo=fwd_halo,
        bwd_local=bwd_local,
        bwd_halo=bwd_halo,
        plan_fwd=plan_fwd,
    )
