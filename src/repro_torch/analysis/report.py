"""Structured findings for the quant-correctness linter ("quantlint"), port
of ``repro/analysis/report.py`` (framework-free, copied and adapted).

Every analyzer — the AST rules (:mod:`repro_torch.analysis.ast_rules`), the
kernel coverage (:mod:`repro_torch.analysis.coverage`) and the kernel
differ (:mod:`repro_torch.analysis.diffcheck`) — emits :class:`Finding`s
into a :class:`Report`. A finding carries a stable rule id (``QL1xx`` = AST
rules, ``QL2xx`` = coverage, ``QL3xx`` = the differ), a severity, and a
location: ``file:line`` for AST findings, ``coverage:<site>`` and
``diff:<layout>#<cell>`` for the others.

Allowlisting: intentional violations are suppressed by
:class:`AllowEntry` rows — ``(rule, where-glob, reason)`` — either from the
repo-wide default list (:mod:`repro_torch.analysis.allowlist`) or inline
``# quantlint: ignore[QLxxx]`` comments (AST rules only; handled in
ast_rules). Suppressed findings are kept in the report, downgraded to
severity ``info`` with the allowlist reason attached, so ``--verbose`` output
and the JSON artifact still show what was waved through and why.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Iterable, List, Optional, Sequence

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str       # stable id, e.g. "QL201"
    name: str       # short slug, e.g. "unused-input"
    severity: str   # "error" | "warning" | "info"
    where: str      # "src/…/ops.py:104", "coverage:<site>" or "diff:<cell>"
    message: str
    allowlisted: str = ""  # reason, when suppressed by an allowlist entry

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def format(self) -> str:
        tag = f"{self.rule}/{self.name}"
        head = f"{self.severity.upper():7s} {tag:32s} {self.where}"
        body = f"  {self.message}"
        if self.allowlisted:
            body += f"\n  allowlisted: {self.allowlisted}"
        return head + "\n" + body


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    """One allowlist row: suppress ``rule`` findings whose location matches
    ``where`` (fnmatch glob). ``reason`` is mandatory — an allowlist entry
    without a why is a blanket ignore."""
    rule: str
    where: str
    reason: str

    def matches(self, f: Finding) -> bool:
        return (self.rule in (f.rule, f.name, "*")
                and fnmatch.fnmatch(f.where, self.where))


class Report:
    """Ordered collection of findings with allowlist + exit-code semantics."""

    def __init__(self, findings: Optional[Iterable[Finding]] = None):
        self.findings: List[Finding] = list(findings or ())

    def add(self, rule: str, name: str, severity: str, where: str,
            message: str) -> Finding:
        f = Finding(rule, name, severity, where, message)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        return self

    # ------------------------------------------------------------ filtering
    def apply_allowlist(self, entries: Sequence[AllowEntry],
                        report_stale: bool = False) -> "Report":
        """Return a new report with matched findings downgraded to ``info``
        (reason attached); unmatched findings pass through unchanged.

        ``report_stale=True`` additionally errors (QL110) on every allowlist
        entry that suppressed nothing: a stale entry is a standing blanket
        ignore waiting for an unrelated future finding to hide under it.
        Only meaningful when this report covers *all* analysis layers —
        partial runs (``--ast-only`` etc.) would see false staleness.
        """
        out = []
        used: set = set()
        for f in self.findings:
            hit = next((e for e in entries if e.matches(f)), None)
            if hit is not None:
                used.add((hit.rule, hit.where))
                if not f.allowlisted:
                    f = dataclasses.replace(f, severity="info",
                                            allowlisted=hit.reason)
            out.append(f)
        rep = Report(out)
        if report_stale:
            for e in entries:
                if (e.rule, e.where) not in used:
                    rep.add("QL110", "stale-allowlist", "error",
                            f"allowlist:{e.rule}@{e.where}",
                            f"allowlist entry for {e.rule} at {e.where!r} "
                            "matched no finding — the violation it excused "
                            "is gone; drop the entry (reason was: "
                            f"{e.reason})")
        return rep

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if rule in (f.rule, f.name)]

    def exit_code(self) -> int:
        return 1 if self.errors() else 0

    # ------------------------------------------------------------- output
    def pretty(self, verbose: bool = False) -> str:
        shown = [f for f in self.findings
                 if verbose or f.severity != "info"]
        lines = [f.format() for f in shown]
        n_err, n_warn = len(self.errors()), len(self.warnings())
        n_quiet = len(self.findings) - len(shown)
        tail = (f"quantlint: {n_err} error(s), {n_warn} warning(s), "
                f"{len(self.findings)} finding(s) total")
        if n_quiet:
            tail += f" ({n_quiet} info/allowlisted hidden; --verbose shows them)"
        return "\n".join(lines + [tail])

    def to_json(self) -> dict:
        return {
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "n_errors": len(self.errors()),
            "n_warnings": len(self.warnings()),
        }

    def save_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2)

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)


def merge(*reports: Report) -> Report:
    out = Report()
    for r in reports:
        out.extend(r)
    return out
