"""Graph partitioning (host side).

The reference partitions with METIS via DGL
(``AdaQP/helper/partition.py:69-72``, ``dgl.distributed.partition_graph`` with
``num_hops=1``). Neither DGL nor METIS bindings exist in this environment, so
we provide:

- ``random``  — hash partitioning (worst-case comm; baseline).
- ``ldg``     — Linear Deterministic Greedy streaming partitioning
  (Stanton & Kliot, KDD'12): processes nodes in BFS order, assigns each to
  the partition holding most of its already-placed neighbors, weighted by a
  capacity penalty. Edge-cut quality approaches METIS on power-law graphs at
  a fraction of the cost.
- ``metis``   — uses pymetis if importable, else falls back to ``ldg``.

LDG runs the C++ implementation of the same algorithm (``native/``, built
with ``g++`` on first use), which gives the numpy path's partition; where
the library cannot be built or loaded, a WARNING carries the reason and
the numpy path runs. Either way an INFO line says which path ran.
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("adaqp_tpu_torch")


def _csr_from_edges(src: np.ndarray, dst: np.ndarray, n: int):
    order = np.argsort(src, kind="stable")
    s, d = src[order], dst[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, s + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, d


def _bfs_order(indptr: np.ndarray, nbrs: np.ndarray, n: int) -> np.ndarray:
    """BFS order from the max-degree node (restarting per component)."""
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    degree = np.diff(indptr)
    seeds = np.argsort(-degree)
    from collections import deque

    q = deque()
    for s in seeds:
        if visited[s]:
            continue
        q.append(s)
        visited[s] = True
        while q:
            v = q.popleft()
            order[pos] = v
            pos += 1
            for u in nbrs[indptr[v] : indptr[v + 1]]:
                if not visited[u]:
                    visited[u] = True
                    q.append(u)
    assert pos == n
    return order


def partition_ldg(src: np.ndarray, dst: np.ndarray, n: int, k: int, slack: float = 1.05,
                  native: bool = True) -> np.ndarray:
    """Linear Deterministic Greedy streaming partitioning in BFS order: the
    native library's unless ``native`` is False or it is unavailable."""
    if k == 1:
        return np.zeros(n, np.int32)
    if native:
        from ..native import NativeUnavailable, ldg_partition

        try:
            part = ldg_partition(src, dst, n, k, slack)
        except NativeUnavailable as exc:
            logger.warning("native LDG unavailable, running the numpy path: %s", exc)
        else:
            logger.info("LDG partition of %d nodes into %d parts: native path", n, k)
            return part
    logger.info("LDG partition of %d nodes into %d parts: numpy path", n, k)
    indptr, nbrs = _csr_from_edges(src, dst, n)
    order = _bfs_order(indptr, nbrs, n)
    cap = slack * n / k
    part = np.full(n, -1, np.int32)
    sizes = np.zeros(k, np.int64)
    for v in order:
        neigh_parts = part[nbrs[indptr[v] : indptr[v + 1]]]
        counts = np.bincount(neigh_parts[neigh_parts >= 0], minlength=k).astype(np.float64)
        score = counts * (1.0 - sizes / cap)
        # tie-break toward the least-loaded partition
        best = np.lexsort((sizes, -score))[0]
        part[v] = best
        sizes[best] += 1
    return part


def partition_random(n: int, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # balanced random: shuffle then block-split
    part = np.arange(n) % k
    rng.shuffle(part)
    return part.astype(np.int32)


def partition_metis(src: np.ndarray, dst: np.ndarray, n: int, k: int) -> np.ndarray:
    try:
        import pymetis  # type: ignore
    except ImportError:
        logger.warning("pymetis unavailable; falling back to LDG streaming partitioning")
        return partition_ldg(src, dst, n, k)
    indptr, nbrs = _csr_from_edges(src, dst, n)
    _, membership = pymetis.part_graph(k, xadj=indptr, adjncy=nbrs)
    return np.asarray(membership, np.int32)


def partition_graph(graph, k: int, method: str = "ldg", seed: int = 0) -> np.ndarray:
    """Partition a GraphData into k parts; returns part_id int32 [N]."""
    if method == "random":
        return partition_random(graph.num_nodes, k, seed)
    # drop self-loops for partitioning (they carry no cut information)
    keep = graph.src != graph.dst
    src, dst = graph.src[keep], graph.dst[keep]
    if method == "ldg":
        return partition_ldg(src, dst, graph.num_nodes, k)
    if method == "metis":
        return partition_metis(src, dst, graph.num_nodes, k)
    raise ValueError(f"unknown partition method {method!r}")
