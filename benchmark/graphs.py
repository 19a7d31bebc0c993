"""The benchmark's graph generators: frozen copies, drawn with torch on the device.

A configuration's graph is its dataset. Structure, features, labels and
splits all come from the configuration's ``data_seed``; ``--seed`` never
reaches them. Both generators draw on the device in a few large calls and
hand the graph over as host numpy arrays (what the program's ``GraphData``
holds), together with a digest of those arrays that keys the program's
partition and layout caches.

- ``banded``: a copy of the banded small-world generator with a heavy
  tail (``helper/dataset.py::synth_reddit``): ``edges`` unique directed
  pairs, one self-loop a node included, zipf-distributed band offsets,
  standard normal features, uniform labels, about two thirds of the nodes
  training.
- ``rmat``: a copy of the structured R-MAT generator
  (``helper/dataset.py::rmat_graph`` with ``structured=True``) rewritten
  for the device, cut to ``pairs`` undirected pairs drawn at random from
  those it makes (0: all), each in both directions, with one self-loop a
  node, and turned into a GraphSAINT-style multilabel task as
  GraphSAINT's Yelp files are read (each node's labels its community and
  one class drawn at random; features scaled by the training rows'
  statistics).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np
import torch

ZIPF_A = 1.3  # band-width law of the banded generator


@dataclass
class Graph:
    """Host arrays of one generated graph, as the program's ``GraphData``
    takes them. ``src -> dst`` carries a message from src to dst."""

    num_nodes: int
    src: np.ndarray  # int32 [E]
    dst: np.ndarray  # int32 [E]
    feats: np.ndarray  # f32 [N, F]
    labels: np.ndarray  # int32 [N] or f32 [N, C]
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    multilabel: bool
    digest: str

    @property
    def num_edges(self) -> int:
        return len(self.src)


def _digest(*arrays: np.ndarray) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(str((a.dtype, a.shape)).encode())
        h.update(np.ascontiguousarray(a).view(np.uint8).data)
    return h.hexdigest()


def _host(src, dst, feats, labels, tm, vm, sm, c, multilabel) -> Graph:
    arrays = [x.cpu().numpy() for x in (src, dst, feats, labels, tm, vm, sm)]
    src, dst, feats, labels, tm, vm, sm = arrays
    return Graph(len(tm), src, dst, feats, labels, tm, vm, sm, c, multilabel,
                 _digest(src, dst, labels, tm, vm, feats[:: max(1, len(feats) // 4096)]))


def _zipf_clipped(m: int, cap: int, gen, a: float = ZIPF_A) -> torch.Tensor:
    """``m`` draws of min(Z, cap), Z ~ Zipf(a) on k >= 1, by inverse CDF."""
    from scipy.special import zeta

    dev = gen.device
    k = torch.arange(1, max(cap, 1), dtype=torch.float64, device=dev)
    cdf = torch.cumsum(k.pow(-a), 0) / zeta(a)
    u = torch.rand(m, generator=gen, dtype=torch.float64, device=dev)
    return torch.searchsorted(cdf, u, right=True) + 1


def _banded_keys(n: int, target: int, gen) -> torch.Tensor:
    """``target`` unique directed non-loop edges as int64 keys src*n+dst."""
    dev = gen.device

    def randint(high, m):
        return torch.randint(0, high, (m,), generator=gen, device=dev)

    keys = torch.empty(0, dtype=torch.int64, device=dev)
    for _ in range(8):
        short = target - keys.numel()
        if short <= 0:
            break
        m = int(short * 1.6) + 1024
        src = randint(n, m)
        delta = _zipf_clipped(m, n // 2, gen)
        sign = randint(2, m) * 2 - 1
        dst = (src + sign * delta) % n
        before = keys.numel()
        keys = torch.unique(torch.cat([keys, src * n + dst]))
        if keys.numel() - before < short // 20:  # the band is saturated
            break
    while keys.numel() < target:  # uniform top-up
        short = target - keys.numel()
        m = int(short * 1.3) + 1024
        src, dst = randint(n, m), randint(n, m)
        keys = torch.unique(torch.cat([keys, (src * n + dst)[src != dst]]))
    if keys.numel() > target:  # a random subset, not a sorted prefix
        keep = torch.randperm(keys.numel(), generator=gen, device=dev)[:target]
        keys = keys[torch.sort(keep).values]
    return keys


def banded(nodes: int, edges: int, feats: int, classes: int, data_seed: int,
           device) -> Graph:
    gen = torch.Generator(device=device).manual_seed(data_seed)
    n = nodes
    keys = _banded_keys(n, edges - n, gen)  # the self-loops are added below
    loop = torch.arange(n, device=keys.device)
    src = torch.cat([keys // n, loop])
    dst = torch.cat([keys % n, loop])
    del keys
    order = torch.sort(dst, stable=True).indices
    src, dst = src[order].int(), dst[order].int()
    x = torch.randn(n, feats, generator=gen, device=device)
    labels = torch.randint(0, classes, (n,), generator=gen, device=device).int()
    u = torch.rand(2, n, generator=gen, device=device)
    tm = u[0] < 0.66
    vm = ~tm & (u[1] < 0.4)
    sm = ~tm & ~vm
    return _host(src, dst, x, labels, tm, vm, sm, classes, False)


def rmat(nodes: int, draws_per_node: int, feats: int, classes: int, data_seed: int,
         device, pairs: int = 0, hint: float = 2.5, homophily: float = 0.3,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    gen = torch.Generator(device=device).manual_seed(data_seed)
    n, e = nodes, nodes * draws_per_node
    scale = int(math.ceil(math.log2(n)))

    def rand(m):
        return torch.rand(m, generator=gen, device=device)

    src = torch.zeros(e, dtype=torch.int64, device=device)
    dst = torch.zeros(e, dtype=torch.int64, device=device)
    for _ in range(scale):
        s_bit = (rand(e) >= a + b).long()  # the bottom half
        r2 = rand(e)
        d_bit = torch.where(s_bit == 0, (r2 >= a / (a + b)).long(),
                            (r2 >= c / (1 - a - b)).long())
        src = (src << 1) | s_bit
        dst = (dst << 1) | d_bit
    src, dst = src % n, dst % n
    shift = max(scale - int(math.ceil(math.log2(classes))), 0)
    if homophily > 0.0:
        # rewire that share of the edges onto a random node of the same
        # community: labels are id-prefix blocks of 2**shift ids
        m = rand(e) < homophily
        k = int(m.sum())
        cls = (src[m] >> shift) % classes
        reps = max((n >> shift) // classes, 1)
        blk = torch.randint(0, reps, (k,), generator=gen, device=device)
        off = torch.randint(0, 1 << shift, (k,), generator=gen, device=device)
        dst[m] = (((blk * classes + cls) << shift) + off) % n
    # symmetrize, drop repeats and self-loops, keep ``pairs`` of the
    # undirected pairs drawn at random, then one self-loop a node
    lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
    keys = torch.unique((lo * n + hi)[lo != hi])
    if pairs:
        if keys.numel() < pairs:
            raise ValueError(f"the R-MAT drew {keys.numel()} pairs, under the {pairs} asked for")
        keep = torch.randperm(keys.numel(), generator=gen, device=device)[:pairs]
        keys = keys[torch.sort(keep).values]
    u, v = keys // n, keys % n
    keys = torch.sort(torch.cat([u * n + v, v * n + u])).values
    loop = torch.arange(n, device=device)
    src = torch.cat([keys // n, loop]).int()
    dst = torch.cat([keys % n, loop]).int()
    del keys, u, v, lo, hi
    community = (torch.arange(n, device=device) >> shift) % classes
    x = torch.randn(n, feats, generator=gen, device=device)
    hinted = community < feats
    x[hinted, community[hinted]] += hint
    order = torch.randperm(n, generator=gen, device=device)
    role = torch.empty(n, dtype=torch.int64, device=device)
    role[order] = torch.arange(n, device=device)
    tm = role < int(0.6 * n)
    vm = ~tm & (role < int(0.6 * n) + int(0.2 * n))
    sm = ~tm & ~vm
    labels = torch.zeros((n, classes), device=device)
    labels[loop, community] = 1.0
    labels[loop, torch.randint(0, classes, (n,), generator=gen, device=device)] = 1.0
    # GraphSAINT's Yelp is read with the features scaled by the training
    # rows' mean and standard deviation
    mu = x[tm].mean(0)
    sd = x[tm].std(0, unbiased=False)
    x = (x - mu) / torch.clamp_min(sd, 1e-8)
    return _host(src, dst, x, labels, tm, vm, sm, classes, True)


GENERATORS = {"banded": banded, "rmat": rmat}


def make(config: dict, device) -> Graph:
    """The graph of a configuration file's ``graph`` section."""
    spec = dict(config["graph"])
    return GENERATORS[spec.pop("generator")](
        nodes=config["num_nodes"], feats=config["num_feats"], classes=config["num_classes"],
        data_seed=config["data_seed"], device=device, **spec)
