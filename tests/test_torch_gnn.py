"""The port's GCN / GraphSAGE against the JAX package's at K=1, on the CPU.

Same graph (drawn with numpy), same parameters (the JAX init carried across
by ``params_from_numpy``), f32 aggregation and no dropout: the logits and
every parameter gradient must agree. The JAX side runs its segment-sum
aggregation, an implementation independent of the port's bitmask tiles;
the port runs the strip tiles with an ELL tail (plain version on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaqp_tpu.common.types import AggregatorType as JAgg
from adaqp_tpu.common.types import GNNType as JGNN
from adaqp_tpu.graph import build_layout as j_build_layout
from adaqp_tpu.graph.device import shard_arrays_from_layout as j_shard_arrays
from adaqp_tpu.graph.device import static_from_layout as j_static
from adaqp_tpu.helper.dataset import GraphData as JGraph
from adaqp_tpu.model import apply_gnn as j_apply, init_params as j_init
from adaqp_tpu.model.loss import masked_loss_sum as j_loss
from adaqp_tpu_torch.common.types import AggregatorType, GNNType
from adaqp_tpu_torch.graph import build_layout
from adaqp_tpu_torch.graph.device import shard_arrays_from_layout, static_from_layout
from adaqp_tpu_torch.graph.strip_shards import build_strip_shards
from adaqp_tpu_torch.helper.dataset import GraphData, sbm_graph
from adaqp_tpu_torch.model import apply_gnn, params_from_numpy
from adaqp_tpu_torch.model.loss import masked_loss_sum

PAD = dict(pad_multiple=2048, feat_pad_multiple=128)


def _graph_arrays(directed: bool):
    g = sbm_graph(n=700, blocks=4, p_in=0.05, p_out=0.004, num_feats=20, seed=3)
    src, dst = g.src, g.dst
    if directed:  # drop a third of the non-loop edges: in != out degrees
        keep = (src == dst) | (np.random.default_rng(5).random(len(src)) > 0.33)
        src, dst = src[keep], dst[keep]
    return (g.num_nodes, src, dst, g.feats, g.labels, g.train_mask, g.val_mask,
            g.test_mask, g.num_classes)


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("model,agg", [("gcn", "mean"), ("sage", "mean"), ("sage", "gcn")])
def test_forward_and_param_grads_match_jax(model, agg, directed):
    arrays = _graph_arrays(directed)
    n = arrays[0]
    part = np.zeros(n, np.int32)

    jg = JGraph(*arrays)
    jlay = j_build_layout(jg, part, JGNN(model), **PAD)
    jst = j_static(jlay, model=JGNN(model), agg_type=JAgg(agg), num_layers=3,
                   hidden=32, dropout=0.0, use_norm=True)
    jsh = j_shard_arrays(jlay).local()
    jparams = j_init(jax.random.PRNGKey(11), jst)
    count = float(jg.train_mask.sum())
    sinks = jnp.zeros((3, jst.r_pad))

    def jloss(params):
        logits, _ = j_apply(params, jsh, jst, sinks, True)
        return j_loss(logits, jsh.labels, jsh.train_mask, False) / count, logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    tg = GraphData(*arrays)
    lay = build_layout(tg, part, GNNType(model), **PAD)
    assert lay.is_bidirected != directed
    st = static_from_layout(lay, model=GNNType(model), agg_type=AggregatorType(agg),
                            num_layers=3, hidden=32, dropout=0.0, use_norm=True)
    assert st.f_pad == jst.f_pad == 128
    # the last destination block's tile goes to the ELL tail, the others stay tiles
    blocks = build_strip_shards(lay, min_edges=int(np.bincount(arrays[2] // 256)[-1]) + 1)
    tiles, ell_edges = blocks.counts[0]
    assert tiles > 0 and ell_edges > 0  # both halves of the aggregation run
    sh = shard_arrays_from_layout(lay)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    logits, traces = apply_gnn(params, sh, st, True, blocks)
    loss = masked_loss_sum(logits, sh.labels, sh.train_mask, False) / count
    loss.backward()

    assert traces.shape == (3, 1, jst.s_pad)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    for layer, jlayer in zip(params, jgrads):
        assert layer.keys() == jlayer.keys()
        for name, p in layer.items():
            np.testing.assert_allclose(
                p.grad.numpy(), np.asarray(jlayer[name]), rtol=1e-4, atol=1e-6,
                err_msg=name,
            )
