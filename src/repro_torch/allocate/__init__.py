"""Sensitivity-guided automatic mixed-precision allocation (port of
``repro/allocate``).

Probe -> solve -> rules: score every canonical weight site under candidate
bit-widths on the calibration set (``sensitivity``), pick one bit-width per
site under an ``avg_bits`` or ``weight_bytes`` budget (``solve``), and emit
ordered ``SiteRule``s that lay on top of any ``QuantRecipe`` via
``recipe.with_rules`` (``report``). The probe builds one body per distinct
(``apply_key``, bits) — not per site — and on a card captures each once in
a CUDA graph (``sensitivity``).

One-call entry:

    report = auto_allocate(blocks, recipe, x0,
                           Budget("avg_bits", 4.5))
    recipe = recipe.with_rules(*report.rules())
    quantize_blocks(blocks, recipe, x0, allocation=report.meta())
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.allocate.report import AllocationReport, validate_budget  # noqa: F401
from repro_torch.allocate.sensitivity import (DEFAULT_BITS,  # noqa: F401
                                              ProbeResult, SiteScore,
                                              probe_blocks)
from repro_torch.allocate.solve import (Allocation, Budget,  # noqa: F401
                                        solve_allocation)


def auto_allocate(blocks, recipe, x0, budget: Budget, *,
                  bits: Sequence[int] = DEFAULT_BITS,
                  objective: str = "combined", solver: str = "auto",
                  name: Optional[str] = None, mesh=None) -> AllocationReport:
    """Probe every site, solve the budget, return the report (rules +
    accounting). The caller applies ``report.rules()`` to its recipe and
    passes ``report.meta()`` to ``quantize_blocks`` for resume validation.
    ``mesh``: a ``DeviceMesh`` for data-parallel probing; every rank passes
    the whole ``x0`` and gets the same report."""
    probe = probe_blocks(blocks, recipe, x0, bits=bits, mesh=mesh)
    alloc = solve_allocation(probe, budget, objective=objective,
                             solver=solver)
    return AllocationReport.build(probe, alloc, name=name)
