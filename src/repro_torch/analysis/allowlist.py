"""Repo-wide default allowlist for quantlint over ``src/repro_torch/``
(port of ``repro/analysis/allowlist.py``).

Every entry must carry a reason — the allowlist is the place where an
intentional violation is *documented*, not merely silenced. Entries here are
file-scoped globs (line numbers shift too easily under refactors); narrow,
line-level suppressions belong inline as ``# quantlint: ignore[QLxxx]``.
``chip_smoke.py`` lies outside ``src/`` and is not linted, as the
reference's ``benchmarks/`` is not.

Rule catalog:

AST layer (QL1xx, analysis/ast_rules.py):
  QL101 graph-outside-engine      torch.cuda.CUDAGraph / torch.cuda.graph /
                                  torch.compile outside the engine caches
  QL102 host-sync-in-capture      .item()/.tolist()/.cpu()/.numpy(),
                                  int()/float()/bool() on the scope's
                                  tensors, or torch.as_tensor/torch.tensor
                                  with device= inside a captured scope
  QL103 host-entropy-in-capture   time.* / random.* / np.random.* inside a
                                  captured scope
  QL104 plain-default             a kernel entry whose backend parameter
                                  defaults to "torch"
  QL105 launch-without-guard      a CudaLibrary.call launch with no plan(),
                                  Plan argument or raise on a shape
                                  condition
  QL106 adhoc-host-clock          bare time.time/perf_counter/monotonic in
                                  host code outside repro_torch/obs/ —
                                  route timing through repro_torch.obs
                                  (Stopwatch/now()/spans)

coverage (QL2xx, analysis/coverage.py):
  QL207 kernel-fallback           QTensor layout served by the dequantize
                                  fallback instead of a kernel (warning)
  QL201-QL206 (unused inputs, retrace budget, donation, promotion, weak
  types, sharding honesty) are the traced-graph layer's: item 15.3

meta (analysis/report.py + ast_rules.py):
  QL110 stale-allowlist /         an allowlist entry — or an inline
        stale-inline-ignore       ``quantlint: ignore`` comment — suppressed
                                  nothing on a full run: the excused
                                  violation is gone; drop it (full runs
                                  only: partial layers would see false
                                  staleness)

quantcheck (QL3xx):
  QL304 kernel-parity /           the CUDA kernels against their plain
        dispatch-drift            versions on the shape lattice, in float32
                                  and bfloat16 (analysis/diffcheck.py's
                                  policy), or a layout dispatched to the
                                  wrong kernel; on the card only
  QL301-QL303 (interval proofs), QL305-QL306 (collectives) and the
  memcheck layer QL401-QL405 are item 15.3's
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.report import AllowEntry

DEFAULT_ALLOWLIST: List[AllowEntry] = [
    # --- QL101: CUDA graphs outside the engine caches ---------------------
    AllowEntry(
        "QL101", "src/repro_torch/core/reconstruct.py*",
        "the reconstruction engine cache itself: one captured Adam step per "
        "engine key (_get_engine), counted in engine_stats().step_compiles "
        "and pinned by tests/test_torch_recon_engine.py"),
    AllowEntry(
        "QL101", "src/repro_torch/allocate/sensitivity.py*",
        "the probe cache: one captured body per probe key (_probe_key), "
        "counted in engine_stats().probe_compiles and pinned by "
        "tests/test_torch_allocate.py"),
    AllowEntry(
        "QL101", "src/repro_torch/serve/engine.py*",
        "the serving engine: one graph per prefill bucket and one for "
        "decode, captured once in __init__; compile_count is frozen "
        "afterwards and pinned by tests/test_torch_serve.py"),
]


def default_allowlist() -> List[AllowEntry]:
    return list(DEFAULT_ALLOWLIST)
