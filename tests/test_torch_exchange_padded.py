"""The port's padded dense wire over gloo ranks on the CPU, against the JAX
package's ``comm/exchange.py`` on its CPU mesh.

K=2 and K=4 ranks are spawned; each imports only torch and the port (it
checks that), exchanges the boundary rows of the same layout and hands its
results back to this process, where JAX runs. Checked:

- ``buckets_from_assignment`` gives JAX's arrays for uniform and random
  assignments;
- fp exchange: the forward halo rows equal JAX's ``exchange_fp`` bit for
  bit; the gradient scatter-added into the owners' rows agrees within 1e-6
  relative (the order of the duplicate adds is free); and both equal the
  port's ragged fp exchange bit for bit;
- 4-bit padded exchange: every received element within one step (the bf16
  scale's) plus the bf16 rounding of the carried pair; unbiased over 200
  keys within 4 sigma; a row sent to several peers drawn independently for
  each;
- the backward variance trace of a mixed-width (random) assignment equals
  JAX's exactly: it is a function of the unquantized gradient rows.
"""
import sys

import numpy as np
import pytest
import torch

from adaqp_tpu_torch.assigner.assignment import (buckets_from_assignment, random_assignment,
                                                 uniform_assignment)
from adaqp_tpu_torch.comm.distributed import spawn
from adaqp_tpu_torch.graph.layout import ExchangePlan

SEEDS = 200
BITS = 4
PLAN_FIELDS = ("send_idx", "recv_slot", "counts", "num_remote", "scores_fp",
               "scores_bp", "remote_global", "s_pad", "r_pad")


def _local(lowered, rank):
    """One layer's lowered buckets -> this rank's (bits, int64 quads)."""
    bits, arrays = lowered
    return bits, tuple(tuple(torch.as_tensor(a[rank]).long() for a in quad) for quad in arrays)


def _rank_exchange(rank, world, device, plan_fields, feats, gw, f_true, l_max):
    """One rank: the padded and the ragged fp exchange with their
    gradients; the mixed-width exchange's backward trace; SEEDS draws of
    the 4-bit padded exchange."""
    from adaqp_tpu_torch.comm.exchange import exchange_fp, exchange_quant
    from adaqp_tpu_torch.comm.exchange_ragged import exchange_ragged
    from adaqp_tpu_torch.comm.wire import wire_fp

    plan = ExchangePlan(**plan_fields)
    f = feats.shape[-1]
    send_idx = torch.as_tensor(plan.send_idx[rank]).long()
    recv_slot = torch.as_tensor(plan.recv_slot[rank]).long()
    g = torch.tensor(gw[rank])

    h = torch.tensor(feats[rank], requires_grad=True)
    remote = exchange_fp(h, send_idx, recv_slot, None, plan.r_pad)
    (remote * g).sum().backward()
    wf, wb = wire_fp(plan, [f, f], 2)[1]
    hr = torch.tensor(feats[rank], requires_grad=True)
    rr = exchange_ragged(hr, None, wf.local(rank, plan.r_pad), wb.local(rank, l_max), (0, 0), f)
    (rr * g).sum().backward()

    # mixed widths, a hidden layer: the backward trace through the sink
    mixed = _local(buckets_from_assignment(plan, random_assignment(plan, 2, 5), l_max)[1], rank)
    hm = torch.tensor(feats[rank], requires_grad=True)
    sink = torch.zeros(plan.r_pad, requires_grad=True)
    rm = exchange_quant(hm, (5, 6), sink, mixed[1], mixed[0], plan.r_pad)
    (rm * g).sum().backward()

    bits, quads = _local(buckets_from_assignment(plan, uniform_assignment(plan, 1, BITS), l_max)[0],
                         rank)
    x = torch.tensor(feats[rank])
    first = None
    acc = torch.zeros((plan.r_pad, f), dtype=torch.float64)
    for s in range(SEEDS):
        rq = exchange_quant(x, (1000 + s, 0), None, quads, bits, plan.r_pad, f_true)
        first = rq if first is None else first
        acc += rq.double()
    assert "jax" not in sys.modules and "adaqp_tpu" not in sys.modules
    return {"remote": remote.detach().numpy(), "grad": h.grad.numpy(),
            "ragged": rr.detach().numpy(), "ragged_grad": hr.grad.numpy(),
            "trace": sink.grad.numpy(), "mixed_grad": hm.grad.numpy(),
            "first": first.numpy(), "mean": (acc / SEEDS).numpy()}


def _jax_layout(k):
    from adaqp_tpu.common.types import GNNType
    from adaqp_tpu.graph import build_layout, partition_graph
    from adaqp_tpu.helper import sbm_graph

    g = sbm_graph(n=240, blocks=4, num_feats=16, seed=8)
    return build_layout(g, partition_graph(g, k, "ldg"), GNNType.GCN)


def _port_plan(lay):
    return ExchangePlan(**{f: getattr(lay.plan_fwd, f) for f in PLAN_FIELDS})


def _shard(fn, k, n_in):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from adaqp_tpu.graph.device import make_mesh

    return shard_map(fn, mesh=make_mesh(k), in_specs=(P("part"),) * n_in,
                     out_specs=(P("part"), P("part")))


def _jax_fp(lay, gw):
    import jax
    import jax.numpy as jnp

    from adaqp_tpu.comm.exchange import exchange_fp as jexchange_fp

    plan, k = lay.plan_fwd, lay.k

    def run(h):
        def body(h, sk, si, rs, g):
            rem = jexchange_fp(h[0], si[0], rs[0], sk[0], plan.r_pad, "part")
            return rem[None], (rem * g[0]).sum()[None]

        return _shard(body, k, 5)(h, jnp.zeros((k, plan.r_pad)), jnp.asarray(plan.send_idx),
                                  jnp.asarray(plan.recv_slot), jnp.asarray(gw))

    h = jnp.asarray(lay.feats)
    rem = np.asarray(jax.jit(run)(h)[0])
    grad = np.asarray(jax.jit(jax.grad(lambda h: run(h)[1].sum()))(h))
    return rem, grad


def _jax_trace(lay, gw, lowered):
    """JAX exchange_quant's backward trace (the sink's cotangent) over one
    layer's lowered buckets."""
    import jax
    import jax.numpy as jnp

    from adaqp_tpu.comm.exchange import exchange_quant as jexchange_quant

    plan, k = lay.plan_fwd, lay.k
    bits, arrays = lowered
    leaves = [jnp.asarray(a) for quad in arrays for a in quad]

    def run(sink):
        def body(h, sk, g, *lv):
            quads = tuple(tuple(lv[4 * i + j][0] for j in range(4)) for i in range(len(bits)))
            keys = jax.random.split(jax.random.PRNGKey(0), 2)
            rem = jexchange_quant(h[0], keys, sk[0], quads, bits, plan.r_pad,
                                  lay.num_feats, "part")
            return rem[None], (rem * g[0]).sum()[None]

        return _shard(body, k, 3 + len(leaves))(jnp.asarray(lay.feats), sink, jnp.asarray(gw),
                                                *leaves)

    return np.asarray(jax.jit(jax.grad(lambda s: run(s)[1].sum()))(jnp.zeros((k, plan.r_pad))))


@pytest.fixture(scope="module", params=[2, 4])
def exchanged(request, tmp_path_factory):
    k = request.param
    lay = _jax_layout(k)
    rng = np.random.default_rng(k)
    gw = rng.normal(size=(k, lay.plan_fwd.r_pad, lay.num_feats)).astype(np.float32)
    fields = {f: getattr(lay.plan_fwd, f) for f in PLAN_FIELDS}
    feats = np.asarray(lay.feats, np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # one thread a rank beside other test workers
        res = spawn(_rank_exchange, k, "cpu",
                    args=(fields, feats, gw, lay.f_true, lay.l_max),
                    workdir=str(tmp_path_factory.mktemp(f"launch{k}")))
    return k, lay, gw, res


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("scheme", ["uniform", "random"])
def test_buckets_match_jax(k, scheme):
    from adaqp_tpu.assigner.assignment import buckets_from_assignment as jbuckets
    from adaqp_tpu.assigner.assignment import random_assignment as jrandom
    from adaqp_tpu.assigner.assignment import uniform_assignment as juniform

    lay = _jax_layout(k)
    plan, jplan = _port_plan(lay), lay.plan_fwd
    if scheme == "uniform":
        asg, jasg = uniform_assignment(plan, 3, 4), juniform(jplan, 3, 4)
    else:
        asg, jasg = random_assignment(plan, 3, 11), jrandom(jplan, 3, 11)
    got = buckets_from_assignment(plan, asg, lay.l_max)
    want = jbuckets(jplan, jasg, lay.l_max)
    assert len(got) == len(want) == 3
    for (gb, ga), (wb, wa) in zip(got, want):
        assert gb == wb and len(ga) == len(wa)
        for gq, wq in zip(ga, wa):
            for a, b in zip(gq, wq):
                assert a.dtype == np.int32 and a.shape[2] % 8 == 0
                np.testing.assert_array_equal(a, np.asarray(b))
    if scheme == "random":
        assert len(got[0][0]) > 1  # mixed widths


def test_fp_exchange_matches_jax_and_ragged(exchanged):
    k, lay, gw, res = exchanged
    rem, grad = _jax_fp(lay, gw)
    for r in range(k):
        np.testing.assert_array_equal(res[r]["remote"], rem[r])
        np.testing.assert_allclose(res[r]["grad"], grad[r], rtol=1e-6,
                                   atol=1e-6 * np.abs(grad).max())
        np.testing.assert_array_equal(res[r]["remote"], res[r]["ragged"])
        np.testing.assert_array_equal(res[r]["grad"].view(np.int32),
                                      res[r]["ragged_grad"].view(np.int32))
    assert np.abs(rem).sum() > 0 and np.abs(grad).sum() > 0


def test_backward_trace_matches_jax(exchanged):
    k, lay, gw, res = exchanged
    plan = _port_plan(lay)
    lowered = buckets_from_assignment(plan, random_assignment(plan, 2, 5), lay.l_max)[1]
    assert len(lowered[0]) > 1  # mixed widths
    want = _jax_trace(lay, gw, lowered)
    for r in range(k):
        np.testing.assert_array_equal(res[r]["trace"], want[r])
        assert res[r]["trace"][: int(plan.num_remote[r])].min() > 0
        assert np.isfinite(res[r]["mixed_grad"]).all() and np.abs(res[r]["mixed_grad"]).sum() > 0


def _true_rows(lay, r):
    """Receiver r's halo rows from the senders' own rows, and the mask of
    slots that receive one."""
    plan = lay.plan_fwd
    out = np.zeros((plan.r_pad, lay.num_feats), np.float32)
    got = np.zeros(plan.r_pad, bool)
    for s in range(lay.k):
        c = int(plan.counts[s, r])
        if s != r and c:
            out[plan.recv_slot[r, s, :c]] = lay.feats[s][plan.send_idx[s, r, :c]]
            got[plan.recv_slot[r, s, :c]] = True
    return out, got


def _bf16(x):
    return torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).float().numpy()


def test_quantized_exchange_within_a_step_and_unbiased(exchanged):
    k, lay, _, res = exchanged
    qmax = 2.0**BITS - 1
    ft = lay.f_true
    for r in range(k):
        x, got = _true_rows(lay, r)
        x = x[:, :ft].astype(np.float64)
        first, mean = res[r]["first"][:, :ft], res[r]["mean"][:, :ft]
        assert not res[r]["first"][:, ft:].any() and not first[~got].any()
        x, first, mean = x[got], first[got], mean[got]
        rmin, rmax = x.min(1, keepdims=True), x.max(1, keepdims=True)
        scale = qmax / np.maximum(rmax - rmin, 1e-10)
        scale_w, rmin_w = _bf16(scale), _bf16(rmin)
        step = 1.0 / scale_w
        # one step, plus what the bf16 parameters move a decoded value
        slack = np.abs(rmin - rmin_w) + qmax * np.abs(1 / scale_w - 1 / scale) + 1e-6
        assert (np.abs(first - x) <= step + slack).all()
        expect = (x - rmin) * scale / scale_w + rmin_w
        z = (mean - expect) / step
        sigma = 0.5 / np.sqrt(SEEDS * z.size)  # each draw is within one step
        assert abs(z.mean()) <= 4 * sigma, (z.mean(), sigma)
        assert np.abs(z).max() < 0.5


def test_quantized_draws_independent_per_peer(exchanged):
    k, lay, _, res = exchanged
    plan = lay.plan_fwd
    copies = {}
    for r in range(k):
        rg = plan.remote_global[r]
        for s in range(k):
            for i in range(int(plan.counts[s, r])):
                slot = int(plan.recv_slot[r, s, i])
                copies.setdefault((s, int(rg[slot])), []).append(res[r]["first"][slot])
    groups = [v for v in copies.values() if len(v) > 1]
    assert len(groups) > 20 if k > 2 else not groups  # at K=2 one peer each
    differ = sum(any(not np.array_equal(v[0], w) for w in v[1:]) for v in groups)
    assert differ >= 0.95 * len(groups), (differ, len(groups))
