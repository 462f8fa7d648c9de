"""quantlint CLI over the port — the AST rules, the traced-graph checks,
quantcheck, memcheck, the kernel coverage and the QL304 kernel differ (port
of ``repro/analysis/lint.py``).

    PYTHONPATH=src python -m repro_torch.analysis.lint            # the card
    PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu --ast-only
    PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu \\
        --jaxpr-only --mem                    # the graph layers on the CPU
    PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu \\
        --seed-bug a_state_drop               # must exit non-zero
    PYTHONPATH=src python -m repro_torch.analysis.lint --diff-full \\
        --parity-json parity.json --coverage-json coverage.json

Default run = AST rules (QL1xx) over ``src/repro_torch/``, then the graph
checks (QL2xx) and quantcheck (QL3xx: interval abstract interpretation and
shard safety) on the toy entry points (recon chunk, probe body, FlexRound
apply, every kernel-table qtensor_matmul layout) traced with ``make_fx``
on the device, the retrace-flatness check, the kernel-coverage report
(QL207) and a smoke subset (3 shapes per layout and dtype) of the QL304
differential sweep on the card. The sharded recon entry joins when the
process runs in a distributed world (``torchrun``) of 2 or more ranks.
``--jaxpr-only`` (the reference's name) skips the AST rules.

``--diff-full`` runs the full QL304 lattice (>= 20 shapes per layout,
float32 and bfloat16; what ``chip_smoke.py`` runs); ``--parity-json`` /
``--coverage-json`` write the parity matrix and the coverage rows.
``--decode-smoke`` also quantizes the smoke LM (export-only) and checks
its deploy-mode decode step and the serving engine's bodies. ``--device
cpu`` traces and checks everything on the CPU, then fails with an error
naming the card QL304 needs: no kernel runs on the CPU.

``--mem`` adds the memcheck layer (QL4xx): liveness of each graph's
storages against the per-entry memory budgets, carries written in place,
weight-traffic honesty and the cache-growth report, over every traced
entry plus the serving entries (including the bf16-KV decode variant for
the static int8-vs-bf16 gap proof). ``--mem-json`` writes the liveness
records. ``--bench-rows`` cross-checks them against bench rows, which the
port does not emit yet (ROADMAP item 3): it exits non-zero naming it.

``--seed-bug`` re-introduces a known regression to prove the analyzers
still catch it; the run must then exit non-zero: ``a_state_drop`` /
``per_layer_retrace`` (graph layer), ``int8_overflow`` /
``scale_underflow`` / ``lost_psum`` (quantcheck layer), ``dead_donation``
/ ``hbm_blowout`` (memcheck layer; combine with ``--mem``). Seeded runs
skip the differential sweep (targeted regression checks, not parity
runs).

Full runs (no ``--ast-only``/``--jaxpr-only``/``--seed-bug``, QL304 run)
also audit the suppressions themselves: an allowlist entry — or an inline
``# quantlint: ignore[QLxxx]`` comment — that suppressed nothing errors as
QL110.

Exit code: 1 if any error-severity finding survives the allowlist, else 0.
Warnings (QL207 conv fallbacks) never fail the run; they are the report's
job to keep visible.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional, Tuple

from repro_torch.analysis import ast_rules, graph_checks
from repro_torch.analysis.allowlist import default_allowlist
from repro_torch.analysis.report import Report, merge
from repro_torch.device import DeviceLike, resolve_device

SEED_BUGS = ("a_state_drop", "per_layer_retrace", "int8_overflow",
             "scale_underflow", "lost_psum", "dead_donation", "hbm_blowout")


def repo_paths() -> Tuple[str, str]:
    """(the package dir, repo root) resolved from the installed package, so
    lint output paths ("src/repro_torch/...") match the allowlist globs
    regardless of the working directory."""
    import repro_torch
    pkg = os.path.dirname(os.path.abspath(repro_torch.__file__))
    return pkg, os.path.dirname(os.path.dirname(pkg))


def sharded_mesh():
    """A flat (n, 1) mesh over the running world when it has 2 or more
    ranks, else None."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() < 2:
        return None
    from repro_torch.launch.mesh import make_flat_mesh
    return make_flat_mesh(dist.get_world_size())


def graph_entries(*, seed_bug: Optional[str] = None,
                  decode_smoke: bool = False, mem: bool = False,
                  device: DeviceLike = None, log=print) -> List:
    """The default traced-entry set (the reference's ``jaxpr_entries``);
    the sharded recon entry joins in a distributed world of 2+ ranks."""
    from repro_torch.analysis import trace
    dev = resolve_device(device)
    entries = [trace.recon_chunk_entry(device=dev),
               trace.probe_entry(device=dev),
               trace.flexround_apply_entry(device=dev),
               *trace.matmul_entries(device=dev)]
    if seed_bug == "a_state_drop":
        entries.append(trace.qtensor_matmul_entry("w8a8", drop_a_state=True,
                                                  device=dev))
    elif seed_bug == "int8_overflow":
        entries.append(trace.int8_overflow_entry(dev))
    elif seed_bug == "scale_underflow":
        entries.append(trace.flexround_apply_entry(underflow=True,
                                                   device=dev))
    elif seed_bug == "lost_psum":
        entries.append(trace.lost_psum_entry(device=dev))
    elif seed_bug == "dead_donation":
        entries.append(trace.dead_donation_entry(dev))
    elif seed_bug == "hbm_blowout":
        entries.append(trace.hbm_blowout_entry(dev))
    mesh = sharded_mesh()
    if mesh is not None:
        entries.append(trace.recon_chunk_entry(mesh=mesh, device=dev))
    else:
        log("quantlint: no distributed world of 2+ ranks — skipping the "
            "sharded recon entry (run under torchrun --nproc-per-node 2)")
    if decode_smoke or (mem and seed_bug is None):
        lm = trace.deploy_smoke_lm(device=dev)
        entries.append(trace.deploy_decode_entry(lm=lm, device=dev))
        # the serving loop: QL201/QL203 over the engine's bucket
        # prefill-insert and slot decode bodies, with the int8 KV-scale
        # range contract so QL303 proves the stored scales stay normal
        entries.append(trace.serve_prefill_entry(lm=lm, device=dev))
        entries.append(trace.serve_decode_entry(lm=lm, device=dev))
        if mem and seed_bug is None:
            # the bf16-KV decode variant exists for memcheck's static
            # int8-vs-bf16 per-slot gap proof (QL405)
            entries.append(trace.serve_decode_entry(kv_quant=False, lm=lm,
                                                    device=dev))
    return entries


def run_analysis(*, ast_only: bool = False, jaxpr_only: bool = False,
                 seed_bug: Optional[str] = None, decode_smoke: bool = False,
                 mem: bool = False, mem_json: Optional[str] = None,
                 use_allowlist: bool = True, diff_full: bool = False,
                 parity_json: Optional[str] = None,
                 coverage_json: Optional[str] = None,
                 device: DeviceLike = None, log=print) -> Report:
    """Build the quantlint report (shared by the CLI and ``launch/quantize
    --analyze``; ``device`` None: the card). On the CPU the QL304 sweep
    cannot run: the report then carries an error naming the card."""
    from repro_torch.analysis.intervals import check_intervals
    from repro_torch.analysis.shardcheck import check_shard_safety

    if seed_bug is not None and seed_bug not in SEED_BUGS:
        raise ValueError(f"seed_bug {seed_bug!r} not in {SEED_BUGS}")
    reports = []
    dev = None if ast_only else resolve_device(device)
    # the staleness audits are decidable on a full run only: a partial
    # layer never produces the findings an entry or an ignore exists for
    full_run = (not ast_only and not jaxpr_only and seed_bug is None
                and dev.type == "cuda")
    if not jaxpr_only:
        pkg, root = repo_paths()
        reports.append(ast_rules.lint_tree(pkg, rel_to=root,
                                           report_stale_ignores=full_run))
    if not ast_only:
        records = []
        entries = graph_entries(seed_bug=seed_bug, decode_smoke=decode_smoke,
                                mem=mem, device=dev, log=log)
        for entry in entries:
            reports.append(graph_checks.check_entry(entry))
            # quantcheck: interval numerics + shard safety per entry
            reports.append(check_intervals(entry))
            reports.append(check_shard_safety(entry))
            if mem:
                # memcheck: liveness + memory-budget contracts per entry
                from repro_torch.analysis.memcheck import check_memory
                mem_rep, mem_rec = check_memory(entry)
                reports.append(mem_rep)
                records.append(mem_rec)
        if mem and seed_bug is None:
            from repro_torch.analysis.memcheck import check_kv_static_gap
            reports.append(check_kv_static_gap(entries))
        if mem and mem_json:
            from repro_torch.analysis.memcheck import mem_report_json
            mem_report_json(records, mem_json, log=log)
        reports.append(graph_checks.check_retrace(
            per_layer=(seed_bug == "per_layer_retrace"), device=dev))
        from repro_torch.analysis.coverage import (coverage_table,
                                                   kernel_coverage)
        cov_rep, cov_rows = kernel_coverage(device=dev)
        reports.append(cov_rep)
        log("kernel coverage:")
        log(coverage_table(cov_rows))
        if coverage_json:
            with open(coverage_json, "w") as fh:
                json.dump({"rows": [dataclasses.asdict(r) for r in cov_rows]},
                          fh, indent=2)
            log(f"coverage rows written to {coverage_json}")
        # seeded runs are targeted regression checks, not parity runs
        if seed_bug is None and dev.type != "cuda":
            rep = Report()
            rep.add("QL304", "needs-card", "error", "diff:*",
                    "the QL304 sweep holds the CUDA kernels against their "
                    "plain versions and needs a CUDA card; on the CPU run "
                    "--ast-only, or run the sweep on the card")
            reports.append(rep)
        elif seed_bug is None:
            from repro_torch.analysis.diffcheck import (parity_json as pj,
                                                        parity_table,
                                                        run_diffcheck)
            diff_rep, rows = run_diffcheck(smoke=not diff_full, device=dev)
            reports.append(diff_rep)
            log(f"QL304 differential sweep ({'full' if diff_full else 'smoke'}"
                f" lattice, {len(rows)} cells):")
            log(parity_table(rows))
            if parity_json:
                with open(parity_json, "w") as fh:
                    json.dump(pj(rows), fh, indent=2)
                log(f"parity matrix written to {parity_json}")
    rep = merge(*reports)
    if use_allowlist:
        rep = rep.apply_allowlist(default_allowlist(), report_stale=full_run)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the graphs are traced and coverage and "
                         "QL304 run (default: the card)")
    ap.add_argument("--ast-only", action="store_true",
                    help="only the QL1xx AST rules (fast, no device)")
    ap.add_argument("--jaxpr-only", action="store_true",
                    help="only the QL2xx/QL3xx graph checks + coverage "
                         "(the reference's name; the graphs are make_fx's)")
    ap.add_argument("--decode-smoke", action="store_true",
                    help="also quantize the smoke LM (export-only) and "
                         "check its deploy-mode decode and serving bodies")
    ap.add_argument("--diff-full", action="store_true",
                    help="run the full QL304 shape lattice (>= 20 shapes per "
                         "layout) instead of the 3-shape smoke subset")
    ap.add_argument("--mem", action="store_true",
                    help="also run memcheck (QL4xx): graph liveness vs the "
                         "per-entry memory budgets (adds the serving "
                         "entries + the bf16-KV decode variant)")
    ap.add_argument("--mem-json", default=None, metavar="PATH",
                    help="write the memcheck liveness report to PATH "
                         "(implies nothing without --mem)")
    ap.add_argument("--bench-rows", action="append", default=None,
                    metavar="PATH",
                    help="bench rows to cross-check (QL403): not ported "
                         "yet, the port emits no bench rows (ROADMAP "
                         "Queue 1 item 3)")
    ap.add_argument("--seed-bug", choices=SEED_BUGS, default=None,
                    help="re-introduce a known regression; the run must "
                         "exit non-zero")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="report raw findings (skip the default allowlist)")
    ap.add_argument("--verbose", action="store_true",
                    help="also print info/allowlisted findings")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the structured findings to PATH")
    ap.add_argument("--parity-json", default=None, metavar="PATH",
                    help="write the QL304 parity matrix to PATH")
    ap.add_argument("--coverage-json", default=None, metavar="PATH",
                    help="write the QL207 coverage rows to PATH")
    args = ap.parse_args(argv)
    if args.ast_only and args.jaxpr_only:
        ap.error("--ast-only and --jaxpr-only are mutually exclusive")
    if args.bench_rows:
        print("repro_torch.analysis.lint: --bench-rows: the port emits no "
              "bench rows to cross-check yet (ROADMAP Queue 1 item 3: "
              "check_bench_rows comes with the benchmark rows)",
              file=sys.stderr)
        return 2

    rep = run_analysis(ast_only=args.ast_only, jaxpr_only=args.jaxpr_only,
                       seed_bug=args.seed_bug,
                       decode_smoke=args.decode_smoke,
                       mem=args.mem, mem_json=args.mem_json,
                       use_allowlist=not args.no_allowlist,
                       diff_full=args.diff_full,
                       parity_json=args.parity_json,
                       coverage_json=args.coverage_json, device=args.device)
    print(rep.pretty(verbose=args.verbose))
    if args.json:
        rep.save_json(args.json)
        print(f"findings written to {args.json}")
    return rep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
