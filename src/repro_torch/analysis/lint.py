"""quantlint CLI over the port — the AST rules, the kernel coverage and the
QL304 kernel differ (port of ``repro/analysis/lint.py``, item 15.1–15.2).

    PYTHONPATH=src python -m repro_torch.analysis.lint            # the card
    PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu --ast-only
    PYTHONPATH=src python -m repro_torch.analysis.lint --diff-full \\
        --parity-json parity.json --coverage-json coverage.json

Default run = AST rules (QL1xx) over ``src/repro_torch/``, then the
kernel-coverage report (QL207) and a smoke subset (3 shapes per layout and
dtype) of the QL304 differential sweep on the card. ``--diff-full`` runs
the full QL304 lattice (>= 20 shapes per layout, float32 and bfloat16;
what ``chip_smoke.py`` runs); ``--parity-json`` / ``--coverage-json`` write
the parity matrix and the coverage rows. ``--device cpu`` without
``--ast-only`` runs the AST rules and the coverage (plain versions), then
fails with an error naming the card QL304 needs: no kernel runs on the
CPU.

The reference's ``--jaxpr-only``, ``--mem``, ``--mem-json``,
``--bench-rows``, ``--decode-smoke`` and ``--seed-bug`` belong to the
traced-graph layers (item 15.3): each exits non-zero naming it.

Full runs (no ``--ast-only``, QL304 run) also audit the suppressions
themselves: an allowlist entry — or an inline ``# quantlint:
ignore[QLxxx]`` comment — that suppressed nothing errors as QL110.

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
from typing import Optional, Tuple

from repro_torch.analysis import ast_rules
from repro_torch.analysis.allowlist import default_allowlist
from repro_torch.analysis.report import Report, merge
from repro_torch.device import DeviceLike, resolve_device

# the reference's flags of the traced-graph layers: refused, never ignored
UNPORTED_FLAGS = ("--jaxpr-only", "--mem", "--mem-json", "--bench-rows",
                  "--decode-smoke", "--seed-bug")


def repo_paths() -> Tuple[str, str]:
    """(the package dir, repo root) resolved from the installed package, so
    lint output paths ("src/repro_torch/...") match the allowlist globs
    regardless of the working directory."""
    import repro_torch
    pkg = os.path.dirname(os.path.abspath(repro_torch.__file__))
    return pkg, os.path.dirname(os.path.dirname(pkg))


def run_analysis(*, ast_only: bool = False, use_allowlist: bool = True,
                 diff_full: bool = False, parity_json: Optional[str] = None,
                 coverage_json: Optional[str] = None,
                 device: DeviceLike = None, log=print) -> Report:
    """Build the quantlint report (the CLI's; ``device`` None: the card).
    On the CPU the QL304 sweep cannot run: the report then carries an
    error naming the card."""
    reports = []
    pkg, root = repo_paths()
    dev = None if ast_only else resolve_device(device)
    # the staleness audits are decidable on a full run only: a partial
    # layer never produces the findings an entry or an ignore exists for
    full_run = not ast_only and dev.type == "cuda"
    reports.append(ast_rules.lint_tree(pkg, rel_to=root,
                                       report_stale_ignores=full_run))
    if not ast_only:
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
        if dev.type != "cuda":
            rep = Report()
            rep.add("QL304", "needs-card", "error", "diff:*",
                    "the QL304 sweep holds the CUDA kernels against their "
                    "plain versions and needs a CUDA card; on the CPU run "
                    "--ast-only, or run the sweep on the card")
            reports.append(rep)
        else:
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
                    help="where coverage and QL304 run (default: the card)")
    ap.add_argument("--ast-only", action="store_true",
                    help="only the QL1xx AST rules (fast, no device)")
    ap.add_argument("--diff-full", action="store_true",
                    help="run the full QL304 shape lattice (>= 20 shapes per "
                         "layout) instead of the 3-shape smoke subset")
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
    for flag in UNPORTED_FLAGS:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f for f in UNPORTED_FLAGS
             if getattr(args, f[2:].replace("-", "_")) is not None]
    if given:
        print(f"repro_torch.analysis.lint: {', '.join(given)}: the "
              "traced-graph layers (QL2xx/3xx/4xx) are not ported yet "
              "(ROADMAP Queue 1 item 15.3)", file=sys.stderr)
        return 2

    rep = run_analysis(ast_only=args.ast_only,
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
