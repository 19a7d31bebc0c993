"""Plain PyTorch reference of full-graph GNN training, in float32 with TF32 off.

It imports nothing of the program. It follows the published layers:
- GCN: ``out = D_in^-1/2 A^T D_out^-1/2 h @ W + b``;
- GraphSAGE-mean: ``out = h @ W_self + (A^T h / d_in) @ W_neigh + b``.
Between layers come dropout, LayerNorm and ReLU, in that order. The loss
is summed over the training rows and divided by their count: cross
entropy, or for a multilabel task BCE with logits summed over the
classes. Adam takes the step. The aggregation is a sparse matrix product
(``torch.sparse``), and its backward is the product with the transpose.

Its inputs are the benchmark's: the graph, the initial parameters, and the
seed. The dropout masks are drawn from the seed by the recipe that the
configuration's training defines: for epoch ``e`` and rank ``r``, a
generator on the card seeded with ``stream_key(seed, e, r, 0)`` draws one
Bernoulli tensor of ``[rows, width]`` per layer that has dropout, in layer
order, and row ``i`` of it belongs to the rank's ``i``-th node. Which node
that is, and how many rows a rank draws, the caller passes in
(``placement``).

``precision="fp8"`` gives the control: the same computation with every
tensor that the configuration holds in bfloat16 rounded to float8 (e4m3,
one scale a tensor), forward and backward. ``fault`` plants one of the
faults a training step can have: ``"frozen"`` (the step leaves the
parameters unchanged), ``"half_batch"`` (half of the training rows left
out and the mean taken over the rest) or ``"no_exchange"`` (the edges
between partitions dropped from the sums, as if no halo row arrived; the
partition is ``part``, a rank for each node).
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn value
_MASK32 = 0xFFFFFFFF


def _mix32(x: int) -> int:
    x &= _MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def stream_key(*parts: int) -> int:
    """A 32-bit generator key from integers, 32 bits at a time."""
    h = 0x9E3779B9
    for p in parts:
        p = int(p) & ((1 << 64) - 1)
        h = _mix32(h ^ (p & _MASK32))
        h = _mix32(h ^ (p >> 32))
    return h


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    s = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class _Aggregate(torch.autograd.Function):
    """``m @ h`` with ``m`` a sparse [N, N] matrix; the backward ``mt @ g``."""

    @staticmethod
    def forward(ctx, h, m, mt):
        ctx.mt = mt
        return m @ h

    @staticmethod
    def backward(ctx, g):
        return ctx.mt @ g.contiguous(), None, None


def _csr(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n))
    return coo.coalesce().to_sparse_csr()


def init_params(seed: int, model: str, dims: Sequence[Tuple[int, int]], use_norm: bool,
                device) -> Dict[str, torch.Tensor]:
    """Xavier-uniform weights (gain sqrt(2) for GraphSAGE), zero biases,
    unit LayerNorm scales, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    gain = math.sqrt(2.0) if model == "sage" else 1.0
    names = ("w_neigh", "w_self") if model == "sage" else ("w",)
    params = {}
    for i, (din, dout) in enumerate(dims):
        a = gain * math.sqrt(6.0 / (din + dout))
        for name in names:
            params[f"{i}.{name}"] = torch.empty((din, dout), device=device).uniform_(
                -a, a, generator=gen)
        params[f"{i}.b"] = torch.zeros(dout, device=device)
        if use_norm and i < len(dims) - 1:
            params[f"{i}.ln_scale"] = torch.ones(dout, device=device)
            params[f"{i}.ln_bias"] = torch.zeros(dout, device=device)
    return params


class Reference:
    """One graph on the device, ready for :meth:`train`."""

    def __init__(self, graph, model: str, dims: Sequence[Tuple[int, int]], dropout: float,
                 use_norm: bool, lr: float, weight_decay: float, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(device)
        n = graph.num_nodes
        src = torch.as_tensor(graph.src, device=dev).long()
        dst = torch.as_tensor(graph.dst, device=dev).long()
        ones = torch.ones(src.numel(), device=dev)
        with warnings.catch_warnings():  # torch's notes on sparse tensors being beta
            warnings.simplefilter("ignore", UserWarning)
            self.m = _csr(dst, src, ones, n)
            self.mt = _csr(src, dst, ones, n)
        self.deg_in = torch.clamp_min(torch.bincount(dst, minlength=n).float(), 1.0)
        self.deg_out = torch.clamp_min(torch.bincount(src, minlength=n).float(), 1.0)
        del src, dst, ones
        self.feats = torch.as_tensor(graph.feats, device=dev, dtype=torch.float32)
        self.multilabel = bool(graph.multilabel)
        self.labels = torch.as_tensor(graph.labels, device=dev)
        if not self.multilabel:
            self.labels = self.labels.long()
        self.train_mask = torch.as_tensor(graph.train_mask, device=dev)
        self.n, self.dev = n, dev
        self.model, self.dims, self.dropout, self.use_norm = model, list(dims), dropout, use_norm
        self.lr, self.weight_decay = lr, weight_decay

    def dropout_masks(self, seed: int, epoch: int, placement) -> List[torch.Tensor]:
        """keep [N, width] for each layer with dropout. ``placement``: for
        each rank, (rank, rows it draws, global node of each of its rows)."""
        widths = [dout for _, dout in self.dims[:-1]]
        keep = [torch.zeros((self.n, w), dtype=torch.bool, device=self.dev) for w in widths]
        for rank, rows, nodes in placement:
            nodes = torch.as_tensor(nodes, device=self.dev).long()
            gen = torch.Generator(device=self.dev).manual_seed(stream_key(seed, epoch, rank, 0))
            for k, w in zip(keep, widths):
                full = torch.empty((rows, w), device=self.dev).bernoulli_(
                    1.0 - self.dropout, generator=gen).bool()
                k[nodes] = full[:nodes.numel()]
        return keep

    def forward(self, params, keep: List[torch.Tensor], r, m=None) -> torch.Tensor:
        m, mt = (self.m, self.mt) if m is None else m
        h = r(self.feats)
        last = len(self.dims) - 1
        rs_in, rs_out = torch.rsqrt(self.deg_in)[:, None], torch.rsqrt(self.deg_out)[:, None]
        for i in range(len(self.dims)):
            if self.model == "gcn":
                agg = r(_Aggregate.apply(r(h * rs_out), m, mt))
                out = r(r(agg * rs_in) @ r(params[f"{i}.w"]) + r(params[f"{i}.b"]))
            else:
                agg = r(_Aggregate.apply(h, m, mt))
                out = r(r(agg / self.deg_in[:, None]) @ r(params[f"{i}.w_neigh"])
                        + r(params[f"{i}.b"]))
                out = r(out + h @ r(params[f"{i}.w_self"]))
            if i < last:
                if self.dropout > 0.0:
                    out = torch.where(keep[i], out / (1.0 - self.dropout), 0.0)
                if self.use_norm:
                    out = r(F.layer_norm(out, (out.shape[-1],), params[f"{i}.ln_scale"],
                                         params[f"{i}.ln_bias"], eps=1e-5))
                out = torch.relu(out)
            h = out
        return h

    def loss(self, logits: torch.Tensor, fault: Optional[str]) -> torch.Tensor:
        mask = self.train_mask
        if fault == "half_batch":
            mask = mask & (torch.arange(self.n, device=self.dev) % 2 == 0)
        if self.multilabel:
            y = self.labels
            per_node = (torch.clamp_min(logits, 0.0) - logits * y
                        + torch.log1p(torch.exp(-logits.abs()))).sum(-1)
        else:
            per_node = F.cross_entropy(logits, self.labels, reduction="none")
        return torch.where(mask, per_node, 0.0).sum() / mask.sum()

    def _local_only(self, part) -> Tuple[torch.Tensor, torch.Tensor]:
        part = torch.as_tensor(part, device=self.dev)
        coo = self.m.to_sparse_coo().coalesce()
        dst, src = coo.indices()
        keep = part[dst] == part[src]
        ones = torch.ones(int(keep.sum()), device=self.dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return (_csr(dst[keep], src[keep], ones, self.n),
                    _csr(src[keep], dst[keep], ones, self.n))

    def train(self, params0: Dict[str, torch.Tensor], seed: int, steps: int, placement,
              precision: str = "f32", fault: Optional[str] = None, part=None) -> dict:
        """``steps`` epochs from ``params0``: each epoch's loss, the first
        gradient of each leaf and each leaf's change after the last step."""
        r = _RoundFp8.apply if precision == "fp8" else (lambda x: x)
        m = self._local_only(part) if fault == "no_exchange" else None
        params = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
        opt = torch.optim.Adam(list(params.values()), lr=self.lr,
                               weight_decay=self.weight_decay, foreach=False)
        losses, grad1 = [], None
        for epoch in range(1, steps + 1):
            keep = self.dropout_masks(seed, epoch, placement)
            opt.zero_grad(set_to_none=True)
            loss = self.loss(self.forward(params, keep, r, m).float(), fault)
            loss.backward()
            if grad1 is None:
                grad1 = {k: p.grad.detach().clone() for k, p in params.items()}
            if fault != "frozen":
                opt.step()
            losses.append(float(loss.detach()))
        delta = {k: (p.detach() - params0[k]) for k, p in params.items()}
        return {"losses": losses, "grad1": grad1, "delta": delta}
