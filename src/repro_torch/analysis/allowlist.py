"""Repo-wide default allowlist for quantlint over ``src/repro_torch/`` and
its traced graphs (port of ``repro/analysis/allowlist.py``).

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

graph layer (QL2xx, analysis/graph_checks.py over make_fx graphs, and
analysis/coverage.py):
  QL201 unused-input              a leaf passed into the traced body but
                                  dead in the graph
  QL202 retrace-budget            engines built, graphs captured or compile
                                  counters grow with layer count
  QL203 alias-unsafe              two labelled inputs share storage where one
                                  is written in place, or a written input is
                                  returned (itself or a view)
  QL204 f64-promotion             a float64 value inside a traced quant path
  QL205 weak-type-output          never fires: torch has no weakly typed
                                  values (the number is kept for the
                                  reference's catalog)
  QL206 sharding-unconstrained    a mesh= entry whose graph holds no
                                  collective over its data-parallel group
  QL207 kernel-fallback           QTensor layout served by the dequantize
                                  fallback instead of a kernel (warning)

meta (analysis/report.py + ast_rules.py):
  QL110 stale-allowlist /         an allowlist entry — or an inline
        stale-inline-ignore       ``quantlint: ignore`` comment — suppressed
                                  nothing on a full run: the excused
                                  violation is gone; drop it (full runs
                                  only: partial layers would see false
                                  staleness)

quantcheck (QL3xx, analysis/intervals.py + diffcheck.py + shardcheck.py):
  QL301 int-overflow              an integer node's value interval
                                  (contractions envelope-scaled to k_max)
                                  leaves its dtype range; the plain W8A8
                                  float64 accumulator is held to int32 (what
                                  K3 keeps) and 2^53; a fitting accumulator
                                  is reported as a proof (info)
  QL302 grid-saturation           a clamp bound is provably always active
  QL303 scale-underflow           a divisor interval entirely subnormal
                                  (< float32 tiny): the card keeps
                                  subnormals, so W/(s1*s2*s3) overflows to
                                  inf and the reciprocal rule's gradients go
                                  inf/NaN
  QL304 kernel-parity /           the CUDA kernels against their plain
        dispatch-drift            versions on the shape lattice, in float32
                                  and bfloat16 (analysis/diffcheck.py's
                                  policy), or a layout dispatched to the
                                  wrong kernel; on the card only
  QL305 lost-psum /               a mesh= entry's collective over a group
        collective-wrong-axis     other than its data group, or a loss that
                                  leaves without a reduction over it
  QL306 uncapturable-collective   a collective over a group that cannot be
                                  captured (gloo) inside a body that runs in
                                  a CUDA graph

memcheck (QL4xx, analysis/memcheck.py — liveness of each graph's storages
vs per-entry MemContract budgets; opt-in via ``lint --mem``):
  QL401 hbm-budget                peak live bytes exceed the entry's budget,
                                  at the traced window or scaled to the
                                  production envelope (serve_kv seq_max); a
                                  fitting peak is reported as a proof (info)
  QL402 dead-donation             a declared carry the graph never writes in
                                  place (its update is allocated fresh, or
                                  nowhere) — the silent inverse of QL203
  QL403 weight-traffic            the graph's live input bytes for a
                                  labelled group drifted from the accessors'
                                  claim (tree_weight_bytes, cache_bytes,
                                  hbm_per_slot_bytes); the bench-row check
                                  waits for the bench rows (ROADMAP item 3)
  QL404 cache-growth (info)       window state scaling with the *allocated*
                                  max_len, not the used length (--mem-json)
  QL405 kv-gap-static             the int8-vs-bf16 per-token KV gap proven
                                  (info) or refuted (error) from the two
                                  serve_decode graphs, each slot's bytes held
                                  to hbm_per_slot_bytes
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
    # --- QL204: float64 inside a traced quant path -----------------------
    AllowEntry(
        "QL204", "graph:*#f64-int-acc/*",
        "the plain W8A8 accumulator (kernels/ref.py:qmatmul_int8_ref): "
        "torch has no int32 matmul on CUDA, so the int8 codes are "
        "contracted in float64, exact for every K of the envelope (QL301 "
        "proves |acc| <= 2^14*k_max < 2^31 < 2^53); K3 keeps the same sum "
        "in int32 (csrc/qmatmul_int8.cu)"),
]


def default_allowlist() -> List[AllowEntry]:
    return list(DEFAULT_ALLOWLIST)
