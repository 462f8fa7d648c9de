"""quantlint over the port (port of ``repro/analysis``).

Four layers, one CLI (``python -m repro_torch.analysis.lint``):

- AST rules (QL1xx, :mod:`repro_torch.analysis.ast_rules`): the port's
  conventions — no CUDA graph or ``torch.compile`` outside the engine
  caches, no host sync or host entropy inside a captured body, no plain
  version as a kernel entry's default, no CUDA launch without a guard, no
  ad-hoc host clock outside ``obs/``.
- The traced-graph checks (QL2xx, :mod:`repro_torch.analysis.graph_checks`)
  over the step bodies traced by ``make_fx``
  (:mod:`repro_torch.analysis.trace`), with ``no_retrace``/``RetraceError``;
  the kernel-coverage report (QL207, :mod:`repro_torch.analysis.coverage`).
- quantcheck (QL3xx): interval proofs (:mod:`repro_torch.analysis.intervals`),
  the cross-backend kernel differ (QL304,
  :mod:`repro_torch.analysis.diffcheck`, on the card) and shard safety
  (:mod:`repro_torch.analysis.shardcheck`).
- memcheck (QL4xx, :mod:`repro_torch.analysis.memcheck`): storage liveness
  against per-entry memory budgets.
"""
from repro_torch.analysis.graph_checks import RetraceError, no_retrace
from repro_torch.analysis.report import AllowEntry, Finding, Report

__all__ = ["AllowEntry", "Finding", "Report", "RetraceError", "no_retrace"]
