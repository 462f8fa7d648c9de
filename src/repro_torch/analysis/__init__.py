"""quantlint over the port (port of ``repro/analysis``, item 15.1–15.2).

Three layers, one CLI (``python -m repro_torch.analysis.lint``):

- AST rules (QL1xx, :mod:`repro_torch.analysis.ast_rules`): the port's
  conventions — no CUDA graph or ``torch.compile`` outside the engine
  caches, no host sync or host entropy inside a captured body, no plain
  version as a kernel entry's default, no CUDA launch without a guard, no
  ad-hoc host clock outside ``obs/``.
- The kernel-coverage report (QL207, :mod:`repro_torch.analysis.coverage`):
  which kernel serves each QTensor layout, proven by recording.
- The cross-backend kernel differ (QL304,
  :mod:`repro_torch.analysis.diffcheck`): every kernel-table layout over a
  shape lattice, the CUDA kernels against their plain versions, on the
  card.

The traced-graph layers (QL2xx besides QL207, QL301–303, QL305–306, the
memcheck QL4xx) and ``no_retrace``/``RetraceError`` are item 15.3's.
"""
from repro_torch.analysis.report import AllowEntry, Finding, Report

__all__ = ["AllowEntry", "Finding", "Report"]
