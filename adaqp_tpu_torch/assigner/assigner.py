"""Adaptive bit-width assigner — variance-vs-communication-time MILP.

Reference: ``AdaQP/assigner/assigner.py`` (436 LoC, PuLP + Gurobi/CBC).
Copied from the JAX package's ``assigner/assigner.py`` (numpy/scipy), which
re-designed the reference thus:

- traces arrive functionally (forward from the model's aux outputs,
  backward from the exchange gradient taps) instead of a tracing singleton;
- the solver is scipy/HiGHS (``scipy.optimize.milp``) — no Gurobi license
  machinery;
- the time objective models a single all-to-all makespan ``Z >= alpha *
  MB_c + beta`` per channel instead of the reference's gloo ring-round
  makespan variables (``assigner.py:364-377``), because the exchange IS
  one all-to-all;
- one rank solves for all channels: the port's Trainer all-gathers the
  traces to rank 0 and broadcasts the result, in place of the reference's
  ``gather_object``/``scatter_object_list`` round trip
  (``assigner.py:262-292``).

Math kept from the reference:

- per-message combined variance ``score^2 * traced_variance``
  (``assigner.py:162-212``) with ``bits_cost(b) = 1/(2^b-1)^2``
  (``assigner.py:29``);
- messages sorted by combined variance descending and grouped into
  ``group_size`` chunks per channel; one bit-width per group;
- objective ``lambda * Vnorm(sum var) + (1-lambda) * Tnorm(makespan)``
  with both normalization modes (``assigner.py:312-431``): ``magnitude``
  divides each objective by its worst-case magnitude; ``nadir_utopia``
  (the reference's effective default — no call site overrides it,
  ``assigner.py:312``) scales by the PARETO RANGE ``(nadir - utopia)`` of
  each objective, so a given lambda trades normalized-range units instead
  of magnitude fractions. One deviation: the reference's per-round time
  utopia takes the *min over channels* at 2 bits (``assigner.py:351-360``),
  which under-shoots the achievable makespan; our single-all-to-all Z's
  utopia is the achievable minimum ``max_c(alpha_c * bytes_c(2) + beta_c)``;
- one independent problem per layer-direction: forward 0..L-1, backward
  1..L-1 (2L-1 solves, ``assigner.py:275-285``).
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import sparse
from scipy.optimize import LinearConstraint, Bounds, milp

from ..common.types import BITS_SET
from ..graph.layout import ExchangePlan
from .assignment import Assignment, uniform_assignment

logger = logging.getLogger("adaqp_tpu_torch")


def bits_cost(b: int) -> float:
    """Quantization-variance multiplier per bit-width (reference
    ``assigner.py:29``)."""
    return 1.0 / (2.0**b - 1.0) ** 2


@dataclass
class AssignerConfig:
    group_size: int = 100
    coe_lambda: float = 0.5
    assign_bits: int = 8  # uniform bootstrap width
    wire_feats: int = 0  # packed feature dim on the wire (f_pad)
    param_bytes: int = 4  # bf16 (scale, rmin) per message
    # wall-clock cap per solve. Generous: the 2L-1 solves run CONCURRENTLY,
    # so on a loaded host a tight cap could expire before any incumbent is
    # found and silently degrade that direction to uniform bits; with the
    # rel-gap below, typical solves finish in well under a second anyway
    time_limit_s: float = 60.0
    # accept near-optimal incumbents: proving the last 1% of optimality is
    # what makes HiGHS run to the time limit; the assignment objective is a
    # heuristic trade-off to begin with (reference tolerates CBC defaults)
    mip_rel_gap: float = 0.01
    # objective normalization: "nadir_utopia" (reference effective default,
    # assigner.py:312) or "magnitude" (assigner.py:319-335)
    normal_mode: str = "nadir_utopia"
    # widths the MILP may assign. Default = the reference's quantized set;
    # include 32 (raw fp32 lanes, common/types.WIRE_BITS_SET) on mixed
    # fabrics so fast channels can skip quantization entirely
    bits_options: Tuple[int, ...] = BITS_SET


@dataclass
class ChannelProblem:
    """One channel's grouped statistics for a layer-direction."""

    key: Tuple[int, int]  # (sender, receiver) for fwd; (receiver, owner) for bwd
    group_lanes: List[np.ndarray]  # lane (or slot) indices per group
    group_var: np.ndarray  # [G] summed combined variance per group
    group_count: np.ndarray  # [G] messages per group


def _group_channel(
    combined: np.ndarray, lanes: np.ndarray, group_size: int
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    order = np.argsort(-combined)
    lanes_sorted = lanes[order]
    var_sorted = combined[order]
    groups, gvar, gcount = [], [], []
    for i in range(0, len(lanes_sorted), group_size):
        sl = slice(i, i + group_size)
        groups.append(lanes_sorted[sl])
        gvar.append(var_sorted[sl].sum())
        gcount.append(len(lanes_sorted[sl]))
    return groups, np.asarray(gvar), np.asarray(gcount, np.int64)


def _chan_ab(alpha, beta, key: Tuple[int, int]) -> Tuple[float, float]:
    """Per-channel (alpha, beta): scalars broadcast; [K, K] arrays index by
    the ordered (sender, receiver) pair (reference fits per channel,
    ``profile.py:97-106``)."""
    if np.ndim(alpha) == 0:
        return float(alpha), float(beta)
    s, r = key
    a = float(alpha[s, r])
    b = float(beta[s, r])
    if a <= 0.0:  # unprofiled channel (e.g. zero-traffic): neutral fallback
        nz = np.asarray(alpha)[np.asarray(alpha) > 0]
        a = float(nz.mean()) if nz.size else 1.0
    return a, b


def _solve_direction(
    problems: List[ChannelProblem],
    cfg: AssignerConfig,
    alpha,
    beta,
    wire_feats: Optional[int] = None,
) -> Dict[Tuple[int, int], np.ndarray]:
    """Solve one layer-direction MILP; returns per-channel array of group
    bit choices (len == #groups). ``wire_feats`` overrides the config's
    message dim (layer-0 messages carry features, deeper layers hidden).
    ``alpha``/``beta`` are scalars or per-channel [K, K] arrays."""
    if not problems:
        return {}
    from ..comm.wire import wire_cols

    bs = tuple(cfg.bits_options)
    nb = len(bs)
    wf = cfg.wire_feats if wire_feats is None else wire_feats
    # bytes per message at width b: word-aligned packed width (the exact
    # layout the ragged wire ships, comm/wire.py) + params overhead (the
    # wire reserves param words per lane even for b=32, comm/wire.py)
    msg_bytes = {b: wire_cols(wf, b) * b / 8.0 + cfg.param_bytes for b in bs}
    ab = {id(pr): _chan_ab(alpha, beta, pr.key) for pr in problems}
    # flatten variables x[c, g, b]
    var_index = {}
    idx = 0
    for ci, pr in enumerate(problems):
        for g in range(len(pr.group_var)):
            for bi in range(nb):
                var_index[(ci, g, bi)] = idx
                idx += 1
    z_idx = idx
    n_vars = idx + 1

    # normalizers (reference assigner.py:317-361). Constant offsets drop out
    # of argmin, so both modes reduce to a pair of denominators:
    #   magnitude:    V / v_den + Z / t_den  with worst-case magnitudes
    #   nadir_utopia: (V - Vu)/(Vn - Vu) + (Z - Tu)/(Tn - Tu) — Pareto-range
    #     scaling; Vn = all-min-bits variance, Vu = all-max-bits, Tn = Z at
    #     all-max-bits, Tu = achievable Z at all-min-bits (see module doc)
    def chan_time(pr, b):
        a_c, b_c = ab[id(pr)]
        return a_c * (pr.group_count.sum() * msg_bytes[b]) / 1e6 + b_c

    v_nadir = sum(pr.group_var.sum() for pr in problems) * bits_cost(min(bs))
    v_utopia = sum(pr.group_var.sum() for pr in problems) * bits_cost(max(bs))
    t_nadir = max(chan_time(pr, max(bs)) for pr in problems)
    t_utopia = max(chan_time(pr, min(bs)) for pr in problems)
    if cfg.normal_mode == "magnitude":
        v_den, t_den = v_nadir, t_nadir
    elif cfg.normal_mode == "nadir_utopia":
        v_den, t_den = v_nadir - v_utopia, t_nadir - t_utopia
    else:
        raise ValueError(f"unknown normal_mode {cfg.normal_mode!r}")
    v_den = max(v_den, 1e-12)
    t_den = max(t_den, 1e-12)

    c = np.zeros(n_vars)
    for ci, pr in enumerate(problems):
        for g, gv in enumerate(pr.group_var):
            for bi, b in enumerate(bs):
                c[var_index[(ci, g, bi)]] = cfg.coe_lambda * gv * bits_cost(b) / v_den
    c[z_idx] = (1.0 - cfg.coe_lambda) / t_den

    # constraints assembled as ONE sparse block: dense per-row
    # LinearConstraints cost O(rows * n_vars) memory/time and dominated the
    # reassignment wall clock (~65 s at 4K groups; sparse: sub-second)
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    rhs_lo: List[float] = []
    rhs_hi: List[float] = []
    r = 0
    # one bit per group
    for ci, pr in enumerate(problems):
        for g in range(len(pr.group_var)):
            for bi in range(nb):
                rows.append(r)
                cols.append(var_index[(ci, g, bi)])
                vals.append(1.0)
            rhs_lo.append(1.0)
            rhs_hi.append(1.0)
            r += 1
    # makespan: alpha_c * MB_c + beta_c <= Z  for every channel, with the
    # CHANNEL's own profiled coefficients (per-pair on mixed fabrics)
    for ci, pr in enumerate(problems):
        a_c, b_c = ab[id(pr)]
        for g, cnt in enumerate(pr.group_count):
            for bi, b in enumerate(bs):
                rows.append(r)
                cols.append(var_index[(ci, g, bi)])
                vals.append(a_c * cnt * msg_bytes[b] / 1e6)
        rows.append(r)
        cols.append(z_idx)
        vals.append(-1.0)
        rhs_lo.append(-np.inf)
        rhs_hi.append(-b_c)
        r += 1
    a_mat = sparse.csr_matrix((vals, (rows, cols)), shape=(r, n_vars))
    constraints = LinearConstraint(a_mat, np.asarray(rhs_lo), np.asarray(rhs_hi))

    integrality = np.ones(n_vars)
    integrality[z_idx] = 0
    lb = np.zeros(n_vars)
    ub = np.ones(n_vars)
    ub[z_idx] = np.inf
    res = milp(
        c,
        constraints=constraints,
        integrality=integrality,
        bounds=Bounds(lb, ub),
        options={"time_limit": cfg.time_limit_s, "mip_rel_gap": cfg.mip_rel_gap},
    )
    out: Dict[Tuple[int, int], np.ndarray] = {}
    if res.x is None:
        logger.warning("MILP infeasible/timeout; falling back to uniform %d-bit", cfg.assign_bits)
        for pr in problems:
            out[pr.key] = np.full(len(pr.group_var), cfg.assign_bits, np.int32)
        return out
    x = np.round(res.x)
    for ci, pr in enumerate(problems):
        choice = np.zeros(len(pr.group_var), np.int32)
        for g in range(len(pr.group_var)):
            for bi, b in enumerate(bs):
                if x[var_index[(ci, g, bi)]] > 0.5:
                    choice[g] = b
        # safety: any unset group gets the bootstrap width
        choice[choice == 0] = cfg.assign_bits
        out[pr.key] = choice
    return out


class Assigner:
    """Periodic adaptive bit-width assignment from accumulated traces."""

    def __init__(
        self,
        plan: ExchangePlan,
        num_layers: int,
        cfg: AssignerConfig,
        cost_model: Tuple = (1.0, 0.1),
    ):
        """``cost_model``: (alpha, beta) — scalars, or per-channel [K, K]
        arrays from :func:`.profile.fit_cost_model`."""
        self.plan = plan
        self.num_layers = num_layers
        self.cfg = cfg
        self.alpha, self.beta = cost_model
        k = plan.send_idx.shape[0]
        self.k = k
        # slot-keyed backward scores [K, R_pad] from the sender-side
        # lane-aligned plan scores
        self.scores_bp_slot = np.zeros((k, plan.r_pad), np.float32)
        for r in range(k):
            offset = 0
            for s in range(k):
                if s == r:
                    continue
                cnt = int(plan.counts[s, r])
                self.scores_bp_slot[r, offset : offset + cnt] = plan.scores_bp[
                    s, r, :cnt
                ]
                offset += cnt

    def bootstrap(self) -> Assignment:
        return uniform_assignment(self.plan, self.num_layers, self.cfg.assign_bits)

    def assign(
        self,
        fwd_traces: np.ndarray,  # [L, K, K, S] accumulated variance proxies
        bwd_traces: np.ndarray,  # [L, K, R_pad]
        layer_dims: Optional[List[int]] = None,  # wire dims per layer
    ) -> Assignment:
        plan = self.plan
        cfg = self.cfg
        k = self.k
        if layer_dims is None:
            layer_dims = [cfg.wire_feats] * self.num_layers

        def build_fwd(layer: int) -> List[ChannelProblem]:
            problems = []
            for s in range(k):
                for r in range(k):
                    cnt = int(plan.counts[s, r])
                    if s == r or cnt == 0:
                        continue
                    lanes = np.arange(cnt)
                    combined = (
                        plan.scores_fp[s, r, :cnt] ** 2 * fwd_traces[layer, s, r, :cnt]
                    )
                    groups, gvar, gcnt = _group_channel(combined, lanes, cfg.group_size)
                    problems.append(ChannelProblem((s, r), groups, gvar, gcnt))
            return problems

        def build_bwd(layer: int) -> List[ChannelProblem]:
            problems = []
            for r in range(k):
                offset = 0
                for s in range(k):
                    if s == r:
                        continue
                    cnt = int(plan.counts[s, r])
                    if cnt == 0:
                        continue
                    slots = np.arange(offset, offset + cnt)
                    combined = (
                        self.scores_bp_slot[r, slots] ** 2
                        * bwd_traces[layer, r, slots]
                    )
                    groups, gvar, gcnt = _group_channel(
                        combined, slots, cfg.group_size
                    )
                    problems.append(ChannelProblem((r, s), groups, gvar, gcnt))
                    offset += cnt
            return problems

        # the 2L-1 layer-direction MILPs are independent: solve them
        # concurrently (reference ThreadPool, ``assigner.py:275-285``;
        # HiGHS releases the GIL during the solve)
        tasks = []  # (kind, layer, problems)
        for layer in range(self.num_layers):
            tasks.append(("fwd", layer, build_fwd(layer)))
            if layer > 0:
                tasks.append(("bwd", layer, build_bwd(layer)))
        with ThreadPoolExecutor(max_workers=len(tasks)) as pool:
            sols = list(
                pool.map(
                    lambda t: _solve_direction(
                        t[2], cfg, self.alpha, self.beta, layer_dims[t[1]]
                    ),
                    tasks,
                )
            )
        solved = {(kind, layer): (pr, sol) for (kind, layer, pr), sol in zip(tasks, sols)}

        fwd_out: List[np.ndarray] = []
        bwd_out: List[np.ndarray] = []
        for layer in range(self.num_layers):
            problems, sol = solved[("fwd", layer)]
            fwd_bits = np.zeros_like(plan.send_idx, dtype=np.int32)
            for pr in problems:
                s, r = pr.key
                for g, lanes in enumerate(pr.group_lanes):
                    fwd_bits[s, r, lanes] = sol[pr.key][g]
            fwd_out.append(fwd_bits)

            # ---- backward (layer 0 carries no gradient exchange) ----
            bwd_bits = np.zeros((k, plan.r_pad), np.int32)
            if layer > 0:
                problems, sol = solved[("bwd", layer)]
                for pr in problems:
                    r, s = pr.key
                    for g, slots in enumerate(pr.group_lanes):
                        bwd_bits[r, slots] = sol[pr.key][g]
            else:
                # keep valid slots at the bootstrap width for bucket symmetry
                slot = np.arange(plan.r_pad)[None, :]
                bwd_bits = np.where(
                    slot < plan.num_remote[:, None], cfg.assign_bits, 0
                ).astype(np.int32)
            bwd_out.append(bwd_bits)
        return Assignment(fwd_out, bwd_out)
