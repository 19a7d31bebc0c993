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

With ``ShardStatic.remat`` a training pass recomputes each whole layer
(aggregation, transform, dropout, LayerNorm, ReLU) in the backward pass
and keeps only its input (:func:`remat_layer`; the JAX package wraps the
layer in ``jax.checkpoint``, ``gnn.py:145-148``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..common.types import AggregatorType, GNNType
from ..graph.device import ShardArrays, ShardStatic
from ..ops.dist_ops import LayerTape, dist_aggregate, fork

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


def remat_layer(fn, h: torch.Tensor, gen: Optional[torch.Generator]):
    """``fn(h, tape)`` with the tensors its backward needs recomputed in the
    backward pass instead of kept: ``torch.utils.checkpoint`` in its
    non-reentrant form, which passes gradients to the tensors ``fn``
    captures (the parameters, the sinks of the backward trace) and takes an
    ``h`` that needs none (layer 0's features). The :class:`LayerTape`
    replays the dropout generator ``gen`` and the received halo rows; with
    no ``gen`` the default generators are preserved instead."""
    tape = LayerTape(gen)
    return torch.utils.checkpoint.checkpoint(
        fn, h, tape, use_reentrant=False, preserve_rng_state=gen is None,
        context_fn=tape.contexts)


def apply_gnn(
    params: Params,
    sh: ShardArrays,
    cfg: ShardStatic,
    train: bool,
    blocks,
    dropout_gen: Optional[torch.Generator] = None,
    wires: Optional[Sequence] = None,
    keys: Optional[Sequence[Tuple[int, int]]] = None,
    sinks: Optional[Sequence[Optional[torch.Tensor]]] = None,
    padded: Optional[Sequence] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass for one partition.

    ``dropout_gen`` draws the dropout masks (train mode with dropout > 0).
    At K>1, per layer, on the wire ``cfg.wire``: ``wires[i]`` the ragged
    ``(fwd, bwd)`` wire plans, or ``padded[i]`` the padded wire's lane
    tables (quantized training; None for the f32 exchange); ``keys[i]`` the (forward,
    backward) generator keys of the quantized buckets, ``sinks[i]`` a
    ``[r_pad]`` leaf for the backward variance trace or None. In training
    with ``cfg.remat`` each layer is recomputed in the backward pass.
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

        def layer_fn(h, tape=None, i=i, layer=layer, ft=ft):
            h_self = h
            if "w_self" in layer:  # a third consumer of h (dist_ops.fork)
                h, h_self = fork(h)
            agg, tr = dist_aggregate(
                h, sh, cfg, blocks, f_true=ft,
                wire=None if wires is None else wires[i],
                keys=(0, 0) if keys is None else keys[i],
                sink=None if sinks is None else sinks[i],
                padded=None if padded is None else padded[i],
                tape=tape,
            )
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
                    out = out + h_self.to(agg.dtype) @ w("w_self")
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
            return out, tr

        if cfg.remat and train:
            h, tr = remat_layer(layer_fn, h, dropout_gen)
        else:
            h, tr = layer_fn(h)
        traces.append(tr.float())
    return h, torch.stack(traces)
