"""Analytical placement model (paper §5.2) — the per-window ILP.

    minimize   perf_ovh = sum_r hot_r * Lat_{t(r)}              (Eq. 2, 8)
    subject to sum_r cost(r, t(r)) <= TCO_min + alpha * MTS     (Eq. 2, 12)

with one placement decision t(r) in {0=DRAM, 1..N} per region. This is a
multiple-choice knapsack (MCKP). The paper solves it with Google OR-Tools on
an offloaded client; this repo has no solver dependency, so we implement:

  * ``solve_greedy`` — the LP-relaxation/dominance greedy: per-region convex
    hull of (cost, penalty) options, then globally take downgrade edges in
    ascending Δpenalty/Δcost-saved order until the budget holds. This is the
    classic MCKP LP solution (optimal up to one region's fractional edge; we
    round down = stay under budget).
  * ``solve_exact_dp`` — exact integer DP on a scaled cost grid, O(R·B);
    used by tests to bound the greedy's optimality gap and for tiny deploys.

Uniform-region fast path: when every region has the same size, the option
cost vector is shared and every hot region has the *same* hull structure
(penalty = hot_r · Lat_t scales the hull vertically), so the greedy becomes a
single argsort over R·E edge keys — fast enough to run every profile window
on the daemon core even for 10^5 regions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Solution:
    placement: np.ndarray  # (R,) int placement indices
    penalty: float  # modeled perf_ovh (seconds)
    cost: float  # modeled TCO (USD units)
    feasible: bool  # cost <= budget


def _hull_indices(costs: np.ndarray, pens: np.ndarray) -> List[int]:
    """Lower-left convex hull of (cost, penalty) options.

    Returns option indices ordered by decreasing cost (increasing penalty),
    starting from the min-penalty option and ending at the min-cost option.
    Dominated options (another option with <=cost and <=penalty) are dropped.
    """
    order = np.lexsort((pens, costs))  # by cost asc, penalty asc tiebreak
    best_pen = np.inf
    kept: List[int] = []
    for i in order:
        # Sweeping cost-ascending, an option is non-dominated iff it strictly
        # reduces penalty relative to every cheaper option.
        if pens[i] < best_pen - 1e-18:
            best_pen = pens[i]
            kept.append(int(i))
    kept.reverse()
    pts: List[Tuple[float, float, int]] = [(costs[i], pens[i], i) for i in kept]
    # pts: cost strictly decreasing, penalty strictly increasing. Now enforce
    # convexity (increasing slope of Δpen/Δcost_saved).
    hull_pts: List[Tuple[float, float, int]] = []
    for c, p, i in pts:
        while len(hull_pts) >= 2:
            c1, p1, _ = hull_pts[-2]
            c2, p2, _ = hull_pts[-1]
            # slope from pt1->pt2 must be <= slope pt1->current, else pt2 is
            # above the hull.
            if (p2 - p1) * (c1 - c) >= (p - p1) * (c1 - c2):
                hull_pts.pop()
            else:
                break
        hull_pts.append((c, p, i))
    return [i for _, _, i in hull_pts]


def solve_greedy(
    hotness: np.ndarray,
    option_costs: np.ndarray,
    option_lats: np.ndarray,
    budget: float,
) -> Solution:
    """LP-greedy MCKP. option_costs: (N+1,) uniform-region cost per option.

    option_lats: (N+1,) access latency per option (Lat_0 = 0).
    """
    hotness = np.asarray(hotness, dtype=np.float64)
    costs = np.asarray(option_costs, dtype=np.float64)
    lats = np.asarray(option_lats, dtype=np.float64)
    r = hotness.shape[0]

    # Shared hull for a unit-hot region; cold regions handled separately.
    hull = _hull_indices(costs, lats)
    hull_costs = costs[hull]
    hull_lats = lats[hull]
    n_edges = len(hull) - 1

    placement = np.full(r, hull[0], dtype=np.int64)  # min-penalty start
    cold = hotness <= 0
    # Cold regions: penalty 0 at every option -> place at min cost directly.
    min_cost_opt = int(np.argmin(costs))
    placement[cold] = min_cost_opt
    total_cost = float(costs[placement].sum())
    if total_cost <= budget or n_edges == 0:
        pen = float((hotness * lats[placement]).sum())
        return Solution(placement, pen, total_cost, total_cost <= budget)

    hot_idx = np.where(~cold)[0]
    # Edge k of region i: slope = hot_i * (Δlat_k / Δcost_k), saving Δcost_k.
    d_cost = hull_costs[:-1] - hull_costs[1:]  # (E,) >0 cost saved
    d_lat = hull_lats[1:] - hull_lats[:-1]  # (E,) >=0 penalty added
    slopes = np.where(d_cost > 0, d_lat / np.maximum(d_cost, 1e-30), np.inf)

    # Keys for all (region, edge) pairs; a region's edges must be taken in
    # order, which the global sort preserves because per-region slopes are
    # non-decreasing along the hull and share the hot_i factor.
    keys = hotness[hot_idx][:, None] * slopes[None, :]  # (H, E)
    flat_order = np.argsort(keys, axis=None, kind="stable")
    edge_savings = np.broadcast_to(d_cost[None, :], keys.shape).reshape(-1)

    need = total_cost - budget
    cum = np.cumsum(edge_savings[flat_order])
    take = int(np.searchsorted(cum, need) + 1)
    take = min(take, flat_order.shape[0])
    chosen = flat_order[:take]
    # Count edges taken per region -> final hull position.
    reg_of = chosen // n_edges
    steps = np.bincount(reg_of, minlength=hot_idx.shape[0])
    placement[hot_idx] = np.asarray(hull)[steps]

    total_cost = float(costs[placement].sum())
    pen = float((hotness * lats[placement]).sum())
    return Solution(placement, pen, total_cost, total_cost <= budget)


def solve_generic_greedy(
    hotness: np.ndarray,
    option_costs: np.ndarray,  # (R, N+1) per-region costs
    option_lats: np.ndarray,  # (N+1,)
    budget: float,
) -> Solution:
    """Per-region-cost variant (non-uniform region sizes). Python-loop hulls;
    use only for moderate R (tests, embedding row-groups)."""
    hotness = np.asarray(hotness, dtype=np.float64)
    costs = np.asarray(option_costs, dtype=np.float64)
    lats = np.asarray(option_lats, dtype=np.float64)
    r, _ = costs.shape

    placement = np.zeros(r, dtype=np.int64)
    edges = []  # (slope, region, from_opt, to_opt, saving)
    total_cost = 0.0
    for i in range(r):
        pens = hotness[i] * lats
        hull = _hull_indices(costs[i], pens)
        placement[i] = hull[0]
        total_cost += costs[i, hull[0]]
        for a, b in zip(hull[:-1], hull[1:]):
            dc = costs[i, a] - costs[i, b]
            dp = pens[b] - pens[a]
            slope = dp / max(dc, 1e-30)
            edges.append((slope, i, b, dc))
    if total_cost <= budget:
        pen = float((hotness * lats[placement]).sum())
        return Solution(placement, pen, total_cost, True)
    edges.sort(key=lambda e: e[0])
    for slope, i, to_opt, dc in edges:
        if total_cost <= budget:
            break
        placement[i] = to_opt
        total_cost -= dc
    total_cost = float(np.take_along_axis(costs, placement[:, None], axis=1).sum())
    pen = float((hotness * lats[placement]).sum())
    return Solution(placement, pen, total_cost, total_cost <= budget)


def solve_exact_dp(
    hotness: np.ndarray,
    option_costs: np.ndarray,  # (N+1,)
    option_lats: np.ndarray,
    budget: float,
    grid: int = 2000,
) -> Solution:
    """Exact MCKP via DP on a scaled integer cost grid. Small instances only.

    Costs are ceil-scaled so the DP solution is feasible (never understates
    cost); optimal up to the grid resolution.
    """
    hotness = np.asarray(hotness, dtype=np.float64)
    costs = np.asarray(option_costs, dtype=np.float64)
    lats = np.asarray(option_lats, dtype=np.float64)
    r = hotness.shape[0]
    scale = grid / max(budget, 1e-30)
    icosts = np.ceil(costs * scale - 1e-9).astype(np.int64)
    ibudget = grid

    NEG = np.inf
    dp = np.full(ibudget + 1, NEG)
    dp[0] = 0.0
    choice = np.zeros((r, ibudget + 1), dtype=np.int8)
    for i in range(r):
        pens = hotness[i] * lats
        ndp = np.full(ibudget + 1, NEG)
        nch = np.zeros(ibudget + 1, dtype=np.int8)
        for t in range(costs.shape[0]):
            c = int(icosts[t])
            if c > ibudget:
                continue
            cand = np.full(ibudget + 1, NEG)
            cand[c:] = dp[: ibudget + 1 - c] + pens[t]
            better = cand < ndp
            ndp = np.where(better, cand, ndp)
            nch = np.where(better, t, nch)
        dp = ndp
        choice[i] = nch
    # Backtrack from the best feasible budget cell.
    b = int(np.argmin(dp))
    placement = np.zeros(r, dtype=np.int64)
    for i in range(r - 1, -1, -1):
        t = int(choice[i, b])
        placement[i] = t
        b -= int(icosts[t])
    total_cost = float(costs[placement].sum())
    pen = float((hotness * lats[placement]).sum())
    return Solution(placement, pen, total_cost, total_cost <= budget)
