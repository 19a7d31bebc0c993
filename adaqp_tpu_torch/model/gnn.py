"""Distributed GCN / GraphSAGE models (functional: a list of parameter dicts).

Mirrors the reference model layer (``AdaQP/model/distGCN.py`` /
``distSAGE.py``): L conv layers; between layers (not after the last):
dropout -> LayerNorm (optional) -> ReLU, in exactly that order
(``distGCN.py:79-84``). Weights Xavier-uniform (ReLU gain for SAGE linear
layers, ``distSAGE.py:38-44``), biases zero. Weights keep the JAX package's
``[din, dout]`` layout (``agg @ w``), so its parameters carry across
unchanged (:func:`params_from_numpy`).

- GCN layer  : ``out = aggregate(h) @ W + b``   (aggregate-then-transform,
  ``distGCN.py:40-50``)
- SAGE mean  : ``out = h @ W_self + aggregate(h) @ W_neigh + b``
  (``distSAGE.py:46-60``)
- SAGE 'gcn' : ``out = aggregate(h) @ W_neigh + b``
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common.types import AggregatorType, GNNType
from ..graph.device import ShardArrays, ShardStatic
from ..ops.dist_ops import dist_aggregate

Params = List[Dict[str, torch.Tensor]]


def _xavier(gen: torch.Generator, shape, gain=1.0):
    fan_in, fan_out = shape
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-a, a, generator=gen)


def _layer_dims(cfg: ShardStatic) -> List[Tuple[int, int]]:
    dims = [(cfg.f_pad, cfg.hidden)]
    dims += [(cfg.hidden, cfg.hidden)] * (cfg.num_layers - 2)
    dims += [(cfg.hidden, cfg.num_classes)]
    return dims


def init_params(gen: torch.Generator, cfg: ShardStatic, device=None) -> Params:
    """Fresh parameters (leaf tensors with ``requires_grad``) on ``device``,
    drawn on the CPU generator ``gen`` so that one seed gives the same
    parameters on every device. The draws differ from the JAX package's."""
    params = []
    relu_gain = math.sqrt(2.0)
    for i, (din, dout) in enumerate(_layer_dims(cfg)):
        layer: Dict[str, torch.Tensor] = {"b": torch.zeros(dout)}
        if cfg.model is GNNType.GCN:
            layer["w"] = _xavier(gen, (din, dout))
        else:
            layer["w_neigh"] = _xavier(gen, (din, dout), relu_gain)
            if cfg.agg_type is not AggregatorType.GCN:
                layer["w_self"] = _xavier(gen, (din, dout), relu_gain)
        if cfg.use_norm and i < cfg.num_layers - 1:
            layer["ln_scale"] = torch.ones(dout)
            layer["ln_bias"] = torch.zeros(dout)
        params.append({k: v.to(device).requires_grad_() for k, v in layer.items()})
    return params


def params_from_numpy(params, device=None) -> Params:
    """The JAX package's parameters (a list of dicts of arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) as f32 leaf tensors."""
    return [
        {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device,
                         requires_grad=True)
         for k, v in layer.items()}
        for layer in params
    ]


def apply_gnn(
    params: Params,
    sh: ShardArrays,
    cfg: ShardStatic,
    train: bool,
    blocks,
    dropout_gen: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass for one partition.

    ``dropout_gen`` draws the dropout masks (train mode with dropout > 0).
    Returns (logits [L, classes] f32, fwd_traces [num_layers, K, S])."""
    h = sh.feats
    traces = []
    n_layers = cfg.num_layers
    # the configured aggregation dtype also drives the dense transform and
    # the inter-layer activations; logits return in f32 for the loss
    dt = torch.bfloat16 if cfg.agg_dtype == "bfloat16" else None
    for i, layer in enumerate(params):
        # layer 0 consumes zero-padded input features; deeper layers run at
        # exact hidden width (the variance range must ignore pad columns)
        ft = cfg.f_true if (i == 0 and cfg.f_true) else h.shape[1]
        agg, tr = dist_aggregate(h, sh, cfg, blocks, f_true=ft)
        if dt is not None:
            agg = agg.to(dt)

        def w(name):
            m = layer[name]
            return m.to(dt) if dt is not None else m

        if cfg.model is GNNType.GCN:
            out = agg @ w("w") + w("b")
        else:
            out = agg @ w("w_neigh") + w("b")
            if "w_self" in layer:
                out = out + h.to(agg.dtype) @ w("w_self")
        if i < n_layers - 1:
            if train and cfg.dropout > 0.0:
                keep = torch.empty(out.shape, device=out.device).bernoulli_(
                    1.0 - cfg.dropout, generator=dropout_gen
                ).bool()
                out = torch.where(keep, out / (1.0 - cfg.dropout), 0.0)
            if cfg.use_norm:
                # normalization statistics in f32 regardless of dt
                out = F.layer_norm(
                    out.float(), (out.shape[-1],), layer["ln_scale"],
                    layer["ln_bias"], eps=1e-5,
                ).to(agg.dtype)
            out = torch.relu(out)
        else:
            out = out.float()
        h = out
        traces.append(tr.float())
    return h, torch.stack(traces)
