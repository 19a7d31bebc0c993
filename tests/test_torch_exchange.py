"""The port's boundary exchange over gloo ranks on the CPU, against the JAX
package's ``exchange_ragged`` on its CPU mesh.

K=2 and K=4 ranks are spawned (``file://`` rendezvous under ``tmp_path``);
each imports only torch and the port (it checks that), exchanges the
boundary rows of the same layout, and hands its results back to this
process, where JAX runs. Checked:

- fp wire: the forward halo rows equal JAX's bit for bit; the backward
  rows (the gradient scatter-added into the owners' rows) agree within
  1e-6 relative, the order of the duplicate adds being free;
- 4-bit wire: every received element lies within one step of the true
  value, the step ``1/scale`` taken with the bf16 scale the wire carries,
  plus the bf16 rounding of the carried rmin and scale; the mean over 200
  keys is unbiased within 4 sigma (against the expectation the bf16
  parameters imply); a row sent to several peers is drawn independently
  for each (``tests/test_wire.py::test_per_peer_independent_draws``).
"""
import sys

import numpy as np
import pytest
import torch

from adaqp_tpu_torch.assigner.assignment import uniform_assignment
from adaqp_tpu_torch.comm.distributed import spawn
from adaqp_tpu_torch.comm.exchange_ragged import exchange_ragged
from adaqp_tpu_torch.comm.wire import wire_fp, wire_from_assignment
from adaqp_tpu_torch.graph.layout import ExchangePlan

SEEDS = 200
BITS = 4
PLAN_FIELDS = ("send_idx", "recv_slot", "counts", "num_remote", "scores_fp",
               "scores_bp", "remote_global", "s_pad", "r_pad")


def _rank_exchange(rank, world, device, plan_fields, feats, gw, f_true, l_max):
    """One rank: the fp exchange and its gradient, then SEEDS draws of the
    4-bit exchange."""
    plan = ExchangePlan(**plan_fields)
    f = feats.shape[-1]
    wf, wb = wire_fp(plan, [f, f], 2)[1]
    lf, lb = wf.local(rank, plan.r_pad), wb.local(rank, l_max)
    h = torch.tensor(feats[rank], requires_grad=True)
    remote = exchange_ragged(h, None, lf, lb, (0, 0), f_true)
    (remote * torch.tensor(gw[rank])).sum().backward()
    qf = wire_from_assignment(plan, uniform_assignment(plan, 1, BITS), [f_true])[0][0]
    lq = qf.local(rank, plan.r_pad)
    x = torch.tensor(feats[rank])
    first = None
    acc = torch.zeros((plan.r_pad, f), dtype=torch.float64)
    for s in range(SEEDS):
        rq = exchange_ragged(x, None, lq, None, (1000 + s, 0), f_true)
        first = rq if first is None else first
        acc += rq.double()
    assert "jax" not in sys.modules and "adaqp_tpu" not in sys.modules
    return (remote.detach().numpy(), h.grad.numpy(), first.numpy(),
            (acc / SEEDS).numpy())


def _jax_layout(k):
    from adaqp_tpu.common.types import GNNType
    from adaqp_tpu.graph import build_layout, partition_graph
    from adaqp_tpu.helper import sbm_graph

    g = sbm_graph(n=240, blocks=4, num_feats=16, seed=8)
    return build_layout(g, partition_graph(g, k, "ldg"), GNNType.GCN)


def _jax_fp(lay, gw):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from adaqp_tpu.comm.exchange_ragged import exchange_ragged as jexchange
    from adaqp_tpu.comm.wire import wire_fp as jwire_fp
    from adaqp_tpu.graph.device import make_mesh

    plan, f, k = lay.plan_fwd, lay.num_feats, lay.k
    wdev = jax.tree.map(jnp.asarray, jwire_fp(plan, [f, f], 2)[1])
    sink = jnp.zeros((k, plan.r_pad))

    def run(h):
        def body(h, sk, w, g):
            wf, wb = w
            rem = jexchange(h[0], None, sk[0], wf.local(), wb.local(), plan.r_pad, f,
                            "part", lay.f_true)
            return rem[None], (rem * g[0]).sum()[None]

        return shard_map(body, mesh=make_mesh(k), in_specs=(P("part"),) * 4,
                         out_specs=(P("part"), P("part")))(h, sink, wdev, jnp.asarray(gw))

    h = jnp.asarray(lay.feats)
    rem = np.asarray(jax.jit(run)(h)[0])
    grad = np.asarray(jax.jit(jax.grad(lambda h: run(h)[1].sum()))(h))
    return rem, grad


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


def test_fp_exchange_matches_jax(exchanged):
    k, lay, gw, res = exchanged
    rem, grad = _jax_fp(lay, gw)
    for r in range(k):
        np.testing.assert_array_equal(res[r][0], rem[r])
        np.testing.assert_allclose(res[r][1], grad[r], rtol=1e-6, atol=1e-6 * np.abs(grad).max())
    assert np.abs(rem).sum() > 0


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
        first, mean = res[r][2][:, :ft], res[r][3][:, :ft]
        assert not res[r][2][:, ft:].any() and not first[~got].any()
        x, first, mean = x[got], first[got], mean[got]
        rmin, rmax = x.min(1, keepdims=True), x.max(1, keepdims=True)
        scale = qmax / np.maximum(rmax - rmin, 1e-10)
        scale_w, rmin_w = _bf16(scale), _bf16(rmin)
        step = 1.0 / scale_w
        # one step, plus what the bf16 parameters move a decoded value
        slack = np.abs(rmin - rmin_w) + qmax * np.abs(1 / scale_w - 1 / scale) + 1e-6
        assert (np.abs(first - x) <= step + slack).all()
        # E[q] = (x - rmin) * scale, decoded with the carried parameters
        expect = (x - rmin) * scale / scale_w + rmin_w
        z = (mean - expect) / step
        sigma = 0.5 / np.sqrt(SEEDS * z.size)  # each draw is within one step
        assert abs(z.mean()) <= 4 * sigma, (z.mean(), sigma)
        assert np.abs(z).max() < 0.5  # no element drifts by half a step


def test_quantized_draws_independent_per_peer(exchanged):
    k, lay, _, res = exchanged
    plan = lay.plan_fwd
    copies = {}
    for r in range(k):
        rg = plan.remote_global[r]
        for s in range(k):
            for i in range(int(plan.counts[s, r])):
                slot = int(plan.recv_slot[r, s, i])
                copies.setdefault((s, int(rg[slot])), []).append(res[r][2][slot])
    groups = [v for v in copies.values() if len(v) > 1]
    assert len(groups) > 20 if k > 2 else not groups  # at K=2 one peer each
    differ = sum(any(not np.array_equal(v[0], w) for w in v[1:]) for v in groups)
    assert differ >= 0.95 * len(groups), (differ, len(groups))
