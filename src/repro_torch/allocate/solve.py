"""Budgeted bit allocation over probed site sensitivities (port of
``repro/allocate/solve.py``, numpy only, line for line: the same
arithmetic and tie-breaks, so identical scores give identical bits).

Multiple-choice knapsack: each site picks exactly one bit-width from the
probed candidates; minimize the summed sensitivity score subject to a
budget. Two solvers, selected automatically:

  greedy  marginal-gain on each site's efficient frontier: dominated levels
          (no score gain for extra cost) are dropped, the rest reduced to
          the lower convex hull so per-site upgrade ratios decrease, then
          all upgrade segments are applied globally in decreasing
          score-drop-per-cost order while they fit. Near-optimal, O(n log n).

  dp      exact dynamic program over integer costs (costs divided by their
          gcd). Used when the integer cost grid is small enough
          (``cells = n_sites * (capacity_int + 1) <= DP_CELL_CAP``) — the
          "exact small-N" regime; bigger problems fall back to greedy.

Budgets:

  avg_bits      numel-weighted average bits: capacity = value * total_numel,
                cost(site, b) = numel * b.
  weight_bytes  serving bytes (packed codes + affine grid, the same
                accounting as ``qtensor.tree_weight_bytes``): capacity =
                value, cost(site, b) = probed ``cost_bytes``. Note <=4-bit
                QTensors all store nibble-packed codes, so 2/3/4-bit levels
                cost the same bytes — the frontier collapses them to the
                best-scoring one.

The emitted ``SiteRule``s use exact (glob-escaped) site-name patterns and
are meant to be appended to the user recipe via ``recipe.with_rules`` —
later rules win, so the allocation overrides defaults and earlier rules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.allocate.sensitivity import ProbeResult, SiteScore
from repro_torch.core.quant_config import SiteRule, exact_site_pattern

BUDGET_KINDS = ("avg_bits", "weight_bytes")
OBJECTIVES = ("mse", "fisher", "combined")
DP_CELL_CAP = 4_000_000  # n_sites * (capacity_int + 1) ceiling for exact DP


@dataclasses.dataclass(frozen=True)
class Budget:
    """A bit budget: ``kind`` selects the cost model (see module doc)."""
    kind: str
    value: float

    def __post_init__(self):
        if self.kind not in BUDGET_KINDS:
            raise ValueError(f"budget kind {self.kind!r} not in "
                             f"{BUDGET_KINDS}")
        if not self.value > 0:
            raise ValueError(f"budget value must be > 0, got {self.value}")


@dataclasses.dataclass
class Allocation:
    """Solver output: chosen bits per site + budget accounting."""
    bits: Dict[str, int]
    budget: Budget
    solver: str            # "greedy" | "dp"
    objective: str
    predicted_score: float  # summed objective score of the chosen levels
    cost: float             # achieved cost in budget units
    capacity: float         # budget capacity in the same units
    avg_bits: float         # numel-weighted average of the chosen bits
    total_bytes: int        # summed per-site QTensor bytes

    def rules(self) -> Tuple[SiteRule, ...]:
        """Ordered per-site rules (exact-name patterns, deterministic
        order) compatible with ``recipe.resolve`` / ``recipe.with_rules``."""
        return tuple(SiteRule.make(exact_site_pattern(s), w_bits=b)
                     for s, b in sorted(self.bits.items()))


@dataclasses.dataclass(frozen=True)
class _Level:
    bits: int
    cost: int      # integer cost in budget units
    score: float
    bytes: int
    numel: int


def _objective_scores(probes: Dict[str, Dict[int, SiteScore]],
                      objective: str) -> Dict[str, Dict[int, float]]:
    """Collapse (mse, fisher) to one scalar per (site, bits). ``combined``
    sums the two metrics after normalizing each by its mean over all
    entries, so neither scale dominates."""
    if objective not in OBJECTIVES:
        raise ValueError(f"objective {objective!r} not in {OBJECTIVES}")
    entries = [s for per in probes.values() for s in per.values()]
    mse_norm = sum(s.mse for s in entries) / max(len(entries), 1) or 1.0
    fis_norm = sum(s.fisher for s in entries) / max(len(entries), 1) or 1.0

    def one(s: SiteScore) -> float:
        # cascade-weight all objectives: damage at depth i is paid by every
        # later block of the sequential reconstruction (see SiteScore)
        if objective == "mse":
            return s.cascade * s.mse
        if objective == "fisher":
            return s.cascade * s.fisher
        return s.cascade * (s.mse / mse_norm + s.fisher / fis_norm)

    return {site: {b: one(s) for b, s in per.items()}
            for site, per in probes.items()}


def _site_levels(probes: Dict[str, Dict[int, SiteScore]],
                 obj: Dict[str, Dict[int, float]],
                 budget: Budget) -> Dict[str, List[_Level]]:
    out = {}
    for site, per in probes.items():
        levels = []
        for b, s in sorted(per.items()):
            cost = s.numel * b if budget.kind == "avg_bits" else s.cost_bytes
            levels.append(_Level(bits=b, cost=int(cost), score=obj[site][b],
                                 bytes=s.cost_bytes, numel=s.numel))
        out[site] = sorted(levels, key=lambda l: (l.cost, l.score, l.bits))
    return out


def _frontier(levels: List[_Level]) -> List[_Level]:
    """Efficient frontier: drop dominated levels (no strict score drop for
    extra cost), then reduce to the lower convex hull so consecutive
    upgrade ratios (score drop per unit cost) are non-increasing."""
    front: List[_Level] = []
    for l in levels:  # cost-ascending
        if front and l.score >= front[-1].score:
            continue  # dominated: costs more (or same), scores no better
        if front and l.cost == front[-1].cost:
            front[-1] = l  # same cost, strictly better score
            continue
        front.append(l)
    hull: List[_Level] = []
    for p in front:
        while len(hull) >= 2:
            a, b = hull[-2], hull[-1]
            # pop b if jumping a->p is at least as efficient as a->b
            if (a.score - b.score) * (p.cost - a.cost) <= \
                    (a.score - p.score) * (b.cost - a.cost):
                hull.pop()
            else:
                break
        hull.append(p)
    return hull


def _greedy(fronts: Dict[str, List[_Level]], capacity: int
            ) -> Tuple[Dict[str, int], float, int]:
    chosen = {site: 0 for site in fronts}  # index into the site's frontier
    cost = sum(f[0].cost for f in fronts.values())
    score = sum(f[0].score for f in fronts.values())
    segments = []
    for site, f in fronts.items():
        for i in range(len(f) - 1):
            dcost = f[i + 1].cost - f[i].cost
            gain = f[i].score - f[i + 1].score
            segments.append((gain / max(dcost, 1e-12), gain, site, i))
    # decreasing efficiency; deterministic tie-break
    segments.sort(key=lambda s: (-s[0], -s[1], s[2], s[3]))
    for ratio, gain, site, i in segments:
        f = fronts[site]
        if chosen[site] != i:
            continue  # an earlier (more efficient) upgrade was skipped
        dcost = f[i + 1].cost - f[i].cost
        if cost + dcost > capacity:
            continue
        chosen[site] = i + 1
        cost += dcost
        score -= gain
    return ({site: fronts[site][i].bits for site, i in chosen.items()},
            score, cost)


def _dp(fronts: Dict[str, List[_Level]], capacity: int
        ) -> Tuple[Dict[str, int], float, int]:
    """Exact multiple-choice knapsack over an integerized cost grid."""
    sites = sorted(fronts)
    unit = 0
    for f in fronts.values():
        for l in f:
            unit = math.gcd(unit, l.cost)
    unit = max(unit, 1)
    cap = capacity // unit
    dp = np.zeros(cap + 1, np.float64)  # zero sites placed: score 0 any cost
    choice = np.zeros((len(sites), cap + 1), np.int16)
    for k, site in enumerate(sites):
        new = np.full(cap + 1, np.inf)
        pick = np.zeros(cap + 1, np.int16)
        for li, l in enumerate(fronts[site]):
            c = l.cost // unit
            if c > cap:
                continue
            cand = np.full(cap + 1, np.inf)
            cand[c:] = dp[:cap + 1 - c] + l.score
            better = cand < new
            new[better] = cand[better]
            pick[better] = li
        dp, choice[k] = new, pick
    if not np.isfinite(dp).any():
        raise ValueError("bit budget infeasible: even the cheapest levels "
                         "exceed the capacity")
    c = int(np.argmin(dp))
    score = float(dp[c])
    bits, cost = {}, 0
    for k in range(len(sites) - 1, -1, -1):
        l = fronts[sites[k]][int(choice[k, c])]
        bits[sites[k]] = l.bits
        cost += l.cost
        c -= l.cost // unit
    return bits, score, cost


def solve_allocation(probe: ProbeResult, budget: Budget,
                     objective: str = "combined",
                     solver: str = "auto") -> Allocation:
    """Pick one bit-width per probed site under ``budget``.

    ``solver``: "auto" runs the exact DP when the integer cost grid is small
    enough and greedy otherwise; "greedy"/"dp" force one (dp raises if its
    grid would exceed ``DP_CELL_CAP``).
    """
    if solver not in ("auto", "greedy", "dp"):
        raise ValueError(f"solver {solver!r} not in ('auto', 'greedy', 'dp')")
    probes = probe.scores
    if not probes:
        raise ValueError("no probed sites to allocate over")
    obj = _objective_scores(probes, objective)
    levels = _site_levels(probes, obj, budget)
    if budget.kind == "avg_bits":
        total_numel = sum(per[min(per)].numel for per in probes.values())
        capacity = int(budget.value * total_numel)
    else:
        capacity = int(budget.value)
    fronts = {site: _frontier(ls) for site, ls in levels.items()}
    floor = sum(f[0].cost for f in fronts.values())
    if floor > capacity:
        raise ValueError(
            f"bit budget infeasible: cheapest allocation costs {floor} "
            f"{budget.kind} units but the capacity is {capacity}")

    unit = 0
    for f in fronts.values():
        for l in f:
            unit = math.gcd(unit, l.cost)
    cells = len(fronts) * (capacity // max(unit, 1) + 1)
    use_dp = solver == "dp" or (solver == "auto" and cells <= DP_CELL_CAP)
    if solver == "dp" and cells > DP_CELL_CAP:
        raise ValueError(f"dp solver grid too large ({cells} cells > "
                         f"{DP_CELL_CAP}); use solver='greedy'")
    bits, score, cost = (_dp if use_dp else _greedy)(fronts, capacity)

    by_site = {site: {l.bits: l for l in ls} for site, ls in levels.items()}
    chosen = {site: by_site[site][b] for site, b in bits.items()}
    total_numel = sum(l.numel for l in chosen.values())
    return Allocation(
        bits=bits, budget=budget, solver="dp" if use_dp else "greedy",
        objective=objective, predicted_score=score, cost=float(cost),
        capacity=float(capacity),
        avg_bits=sum(l.numel * b for (b, l) in
                     ((bits[s], chosen[s]) for s in chosen)) / total_numel,
        total_bytes=sum(l.bytes for l in chosen.values()))
