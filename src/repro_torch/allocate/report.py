"""Serializable record of an automatic bit allocation (port of
``repro/allocate/report.py``; ``to_dict`` is the reference's document and
``digest`` its hex string for the same allocation).

``AllocationReport`` bundles the probe scores, the solver's choice and the
budget accounting into one JSON document. It is persisted through
``repro_torch.checkpoint`` (``<resume_dir>/allocation.json``) so that

  - a resumed PTQ run re-emits the identical rules without re-probing, and
  - a resume whose rules or allocation digest no longer match fails loudly
    with the allocation named (see ``PTQCheckpointer.load``).

The ``digest`` covers exactly the allocation *decision* (budget, objective
and the chosen bits per site) — probe timings and scores are recorded but
excluded, so re-probing on different hardware cannot invalidate a resume
that still quantizes identically.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Optional, Tuple

from repro_torch.allocate.sensitivity import ProbeResult
from repro_torch.allocate.solve import Allocation
from repro_torch.core.quant_config import SiteRule, exact_site_pattern


@dataclasses.dataclass
class AllocationReport:
    name: str
    budget: Dict[str, object]      # {"kind", "value"}
    objective: str
    solver: str
    # site -> {"bits", "numel", "bytes", "scores": {str(bits): {...}}}
    sites: Dict[str, dict]
    summary: Dict[str, float]      # avg_bits / total_bytes / cost / capacity
    probe: Dict[str, float]        # steps / seconds / steps_per_s / compiles

    @classmethod
    def build(cls, probe: ProbeResult, alloc: Allocation,
              name: Optional[str] = None) -> "AllocationReport":
        sites = {}
        for site, per in sorted(probe.scores.items()):
            chosen = alloc.bits[site]
            sites[site] = {
                "bits": chosen,
                "numel": per[chosen].numel,
                "bytes": per[chosen].cost_bytes,
                "scores": {str(b): {"mse": s.mse, "fisher": s.fisher,
                                    "bytes": s.cost_bytes}
                           for b, s in sorted(per.items())},
            }
        tag = name or (f"auto{alloc.budget.value:g}-{alloc.budget.kind}"
                       f"-{alloc.objective}")
        return cls(
            name=tag,
            budget={"kind": alloc.budget.kind, "value": alloc.budget.value},
            objective=alloc.objective,
            solver=alloc.solver,
            sites=sites,
            summary={"avg_bits": alloc.avg_bits,
                     "total_bytes": alloc.total_bytes,
                     "predicted_score": alloc.predicted_score,
                     "cost": alloc.cost, "capacity": alloc.capacity},
            probe={"steps": probe.steps, "seconds": probe.seconds,
                   "steps_per_s": probe.steps_per_s,
                   "compile_count": probe.compile_count},
        )

    # ------------------------------------------------------------- identity
    def bits(self) -> Dict[str, int]:
        return {site: int(d["bits"]) for site, d in self.sites.items()}

    def digest(self) -> str:
        doc = {"budget": self.budget, "objective": self.objective,
               "bits": self.bits()}
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()

    def meta(self) -> dict:
        """Compact identity passed into per-block PTQ checkpoints."""
        return {"name": self.name, "digest": self.digest(),
                "budget": dict(self.budget)}

    def rules(self) -> Tuple[SiteRule, ...]:
        """The allocation as ordered per-site rules — append to the user
        recipe with ``recipe.with_rules(*report.rules())``."""
        return tuple(SiteRule.make(exact_site_pattern(s), w_bits=b)
                     for s, b in sorted(self.bits().items()))

    # ---------------------------------------------------------- persistence
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AllocationReport":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, directory: str) -> str:
        from repro_torch.checkpoint import save_allocation
        return save_allocation(directory, self.to_dict())

    @classmethod
    def load(cls, directory: str) -> Optional["AllocationReport"]:
        from repro_torch.checkpoint import load_allocation
        d = load_allocation(directory)
        return None if d is None else cls.from_dict(d)

    # --------------------------------------------------------------- logging
    def pretty(self) -> str:
        lines = [f"allocation {self.name!r} (solver={self.solver}, "
                 f"objective={self.objective}, digest "
                 f"{self.digest()[:12]}):"]
        for site, d in sorted(self.sites.items()):
            lines.append(f"  {site}: w{d['bits']} "
                         f"({d['numel']} elems, {d['bytes']} B)")
        s = self.summary
        lines.append(f"  budget[{self.budget['kind']}={self.budget['value']}]"
                     f": avg_bits={s['avg_bits']:.3f} "
                     f"bytes={int(s['total_bytes'])} "
                     f"cost={s['cost']:.0f}/{s['capacity']:.0f}")
        lines.append(f"  probe: {int(self.probe['steps'])} probes in "
                     f"{self.probe['seconds']:.2f}s "
                     f"({self.probe['steps_per_s']:.1f}/s, "
                     f"{int(self.probe['compile_count'])} compiles)")
        return "\n".join(lines)


def validate_budget(report: AllocationReport, slack_sites: int = 0) -> bool:
    """True when the recorded allocation's cost is within its budget
    capacity. Both solvers guarantee cost <= capacity, so the default is
    strict; ``slack_sites`` > 0 allows that many single-bit-step roundings
    (one bit at the largest site for ``avg_bits``; the 4->8 half-numel code
    step for ``weight_bytes``) for callers re-checking a hand-edited
    allocation."""
    kind = report.budget["kind"]
    value = float(report.budget["value"])
    sites = report.sites.values()
    if kind == "avg_bits":
        cost = sum(d["numel"] * d["bits"] for d in sites)
        capacity = value * sum(d["numel"] for d in sites)
        step = max((d["numel"] for d in sites), default=0)
    else:
        cost = sum(d["bytes"] for d in sites)
        capacity = value
        step = max(((d["numel"] + 1) // 2 for d in sites), default=0)
    return cost <= capacity + slack_sites * step
