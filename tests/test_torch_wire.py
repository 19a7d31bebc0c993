"""The port's wire layouts (``comm/wire.py``) against the JAX package's.

Both lower the same ``ExchangePlan`` and ``Assignment`` (the JAX layout's
arrays, handed to the port as numpy). The JAX layouts pad each per-slot
lane count to a static cap (the maximum over shards, rounded up to whole
128-word lane rows) and fill the gaps with a sentinel; the port keeps each
rank's exact lanes. So every lane array must equal the JAX array with its
sentinel entries removed, positions into the capped concatenation must map
onto the port's exact positions, and the JAX caps must be the port's
largest per-slot counts rounded up by the JAX rule.
"""
import numpy as np
import pytest

from adaqp_tpu.assigner import random_assignment as jrandom_assignment
from adaqp_tpu.assigner import uniform_assignment as juniform_assignment
from adaqp_tpu.comm import wire as jwire
from adaqp_tpu.common.types import BITS_SET, WIRE_BITS_SET
from adaqp_tpu.common.types import GNNType as JGNNType
from adaqp_tpu.graph import build_layout as jbuild_layout
from adaqp_tpu.graph import partition_graph as jpartition_graph
from adaqp_tpu.helper import sbm_graph as jsbm_graph
from adaqp_tpu_torch.assigner.assignment import Assignment
from adaqp_tpu_torch.comm import wire
from adaqp_tpu_torch.graph.layout import ExchangePlan

K = 4
PAD = int(jwire._PAD)
F = 16  # true widths that are whole words at every bit-width


@pytest.fixture(scope="module")
def jlayout():
    g = jsbm_graph(n=240, blocks=4, num_feats=F, seed=8)
    return jbuild_layout(g, jpartition_graph(g, K, "ldg"), JGNNType.GCN)


def _port_plan(jplan):
    return ExchangePlan(**{f: getattr(jplan, f) for f in (
        "send_idx", "recv_slot", "counts", "num_remote", "scores_fp", "scores_bp",
        "remote_global", "s_pad", "r_pad")})


def _plans(jlay, kind):
    jplan, plan = jlay.plan_fwd, _port_plan(jlay.plan_fwd)
    dims = [jlay.f_true, F, F]
    if kind == "fp":
        return jwire.wire_fp(jplan, dims, 3), wire.wire_fp(plan, dims, 3)
    if kind == "uniform4":
        jasg = juniform_assignment(jplan, 3, 4)
        bits_set = BITS_SET
    else:
        bits_set = WIRE_BITS_SET if kind == "fp32_lanes" else BITS_SET
        jasg = jrandom_assignment(jplan, 3, seed=5, bits_set=bits_set)
    asg = Assignment(list(jasg.fwd), list(jasg.bwd))
    return (jwire.wire_from_assignment(jplan, jasg, dims, bits_set=bits_set),
            wire.wire_from_assignment(plan, asg, dims, bits_set=bits_set))


def _real(a):
    a = np.asarray(a)
    return a[a != PAD]


def _exact_positions(jdir, r):
    """JAX capped-concatenation position -> the port's exact position."""
    cat = np.concatenate([np.asarray(jdir.sgd_rows[bi][r]) for bi in range(len(jdir.bits))])
    pos = np.full(len(cat) + 1, -1, np.int64)
    real = cat != PAD
    pos[np.nonzero(real)[0]] = np.arange(real.sum())
    pos[len(cat)] = real.sum()  # the never-received sentinel
    return pos


@pytest.mark.parametrize("kind", ["fp", "uniform4", "random", "fp32_lanes"])
def test_wire_matches_jax(jlayout, kind):
    jplans, plans = _plans(jlayout, kind)
    for layer, ((jf, jb), (pf, pb)) in enumerate(zip(jplans, plans)):
        assert (jb is None) == (pb is None) == (layer == 0)
        for jd, pd in ((jf, pf), (jb, pb)):
            if jd is None:
                continue
            assert pd.bits == jd.bits and pd.wpr == jd.wpr and pd.fw == jd.fw
            assert pd.has_params == jd.has_params
            for bi in range(len(pd.bits)):
                lane_q = jwire.WIRE_LANE // int(np.gcd(jd.wpr[bi], jwire.WIRE_LANE))
                for r in range(K):
                    np.testing.assert_array_equal(pd.q_rows[bi][r], _real(jd.q_rows[bi][r]))
                    np.testing.assert_array_equal(pd.q_rows[bi][r], _real(jd.sgq_rows[bi][r]))
                    np.testing.assert_array_equal(pd.d_rows[bi][r], _real(jd.d_rows[bi][r]))
                    np.testing.assert_array_equal(pd.d_rows[bi][r], _real(jd.sgd_rows[bi][r]))
                # caps: the largest exact count per peer slot, as sender and
                # as receiver, rounded up to whole lane rows
                for j in range(K - 1):
                    most = max(
                        max(pd.cnt[ws, [p for p in range(K) if p != ws][j], bi] for ws in range(K)),
                        max(pd.cnt[[p for p in range(K) if p != wr][j], wr, bi] for wr in range(K)),
                    )
                    assert jd.sg_cap[bi][j] == -(-most // lane_q) * lane_q
                assert jd.sg_start[bi] == tuple(
                    int(x) for x in np.cumsum((0,) + jd.sg_cap[bi])[:K - 1])
            # exact sizes: data words plus one param word per lane
            lanes = pd.cnt.sum(axis=2)
            want = (pd.cnt * np.asarray(pd.wpr)).sum(axis=2) + (lanes if pd.has_params else 0)
            np.testing.assert_array_equal(pd.send_sz, want)
            assert (pd.send_sz <= np.asarray(jd.send_sz)).all()
            np.testing.assert_array_equal(pd.recv_sz, pd.send_sz.T)
            # placement maps
            assert (pd.d_inv is not None) == bool(jd.has_inv)
            assert (pd.d_inv is None) == bool(jd.has_sort)
            for r in range(K):
                pos = _exact_positions(jd, r)
                if jd.has_inv:
                    jinv = pos[np.minimum(np.asarray(jd.sgd_inv[r]), len(pos) - 1)]
                    inv = np.full(len(jinv), pos[-1])
                    inv[:len(pd.d_inv[r])] = pd.d_inv[r]
                    np.testing.assert_array_equal(inv, jinv)
                if jd.has_sort:
                    # the port adds in arrival order: each received row goes
                    # to the destination JAX's sorted scatter gives it
                    keep = np.asarray(jd.sgd_rows_sorted[r]) != PAD
                    cat = np.concatenate([pd.d_rows[bi][r] for bi in range(len(pd.bits))])
                    np.testing.assert_array_equal(cat[pos[np.asarray(jd.sgd_sort[r])[keep]]],
                                                  np.asarray(jd.sgd_rows_sorted[r])[keep])


@pytest.mark.parametrize("kind", ["uniform4", "random"])
def test_wire_bytes_are_the_exact_message_bytes(jlayout, kind):
    jplans, plans = _plans(jlayout, kind)
    jplan, plan = jlayout.plan_fwd, _port_plan(jlayout.plan_fwd)
    dims = [jlayout.f_true, F, F]
    jasg = (juniform_assignment(jplan, 3, 4) if kind == "uniform4"
            else jrandom_assignment(jplan, 3, seed=5))
    asg = Assignment(list(jasg.fwd), list(jasg.bwd))
    dirs = [d for pair in plans for d in pair if d is not None]
    jdirs = [d for pair in jplans for d in pair if d is not None]
    assert jlayout.f_true % 16 == 0  # every width packs into whole words
    exact = wire.exact_message_bytes(plan, asg, dims)
    assert exact == jwire.exact_message_bytes(jplan, jasg, dims)
    assert wire.wire_bytes(dirs) == exact
    assert jwire.wire_bytes(jdirs) >= exact  # the JAX wire ships alignment gaps


def test_local_views(jlayout):
    jplans, plans = _plans(jlayout, "random")
    plan = jlayout.plan_fwd
    for pf, pb in plans:
        for r in range(K):
            lf = pf.local(r, plan.r_pad)
            assert lf.send_splits == [int(x) for x in pf.send_sz[r]]
            assert lf.recv_splits == [int(x) for x in pf.send_sz[:, r]]
            assert lf.send_splits[r] == lf.recv_splits[r] == 0
            assert len(lf.d_inv) == plan.r_pad
            # slots that receive nothing read the zero row past the end
            s_tot = sum(len(x) for x in lf.d_rows)
            got = set(np.nonzero(lf.d_inv.numpy() < s_tot)[0].tolist())
            assert got == set(np.concatenate([x.numpy() for x in lf.d_rows]).tolist())
            pack, unpack = lf.quant_launches()
            assert pack == int(any(sum(c) for c in lf.send_cnt))
            assert unpack == int(any(sum(c) for c in lf.recv_cnt))
            if pb is not None:
                lb = pb.local(r, jlayout.l_max)
                assert lb.out_len == jlayout.l_max and lb.d_inv is None
