"""Render cell results as a summary and a markdown roofline table (a copy
of ``repro/roofline/report.py``).

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [results.json ...]

A results file is a list of cell records (``{"cell", "status", "memory":
{"peak_bytes_per_device"}, "analysis": roofline.analysis.analyze(...)}``),
or a dict holding one under ``"cells"`` (``chip_smoke.py``'s
``chiprun_out/chip_smoke.json``; the dry run's ``--out`` file). Multiple
files merge (later files override same cell ids). The memory line counts
the cells whose peak exceeds the card's memory
(``roofline.analysis.CARD_PEAKS``, the card the records name). The
collective column shows ``analyze_traced``'s term (the dry run's records)
and a dash for a record of ``analyze``, which has none (the world-of-one
cells). The summary counts the dry-run records traced on a CPU mesh
(``mesh_device``): their collective kinds are not the card's.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

from repro_torch.roofline.analysis import CardPeaks, peaks

GiB = 2**30


def load(paths: List[str]) -> Dict[str, dict]:
    cells: Dict[str, dict] = {}
    for p in paths:
        with open(p) as f:
            data = json.load(f)
            for r in (data["cells"] if isinstance(data, dict) else data):
                cells[r["cell"]] = r
    return cells


def _fix(cell: dict) -> dict:
    a = cell["analysis"]
    dom = a["bottleneck"]
    hints = {
        "compute": "raise arithmetic intensity (fuse, larger tiles) or "
                   "shard over more chips",
        "memory": "cut bytes: lower-precision weights/cache (FlexRound int8/"
                  "int4), fuse elementwise chains, avoid re-read of "
                  "activations",
        "collective": "reshard to remove resharding collectives, overlap "
                      "comm with compute, compress gradients",
    }
    return hints[dom]


def markdown(cells: Dict[str, dict]) -> str:
    rows = []
    head = ("| cell | peak GiB/dev | compute s | memory s | collective s | "
            "bottleneck | MODEL/HLO flops | roofline frac | one-line fix |")
    sep = "|" + "---|" * 9
    for cid, r in sorted(cells.items()):
        if r["status"] == "skipped":
            rows.append(f"| {cid} | — | — | — | — | skipped | — | — | "
                        f"{r['reason'][:60]} |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {cid} | ERROR {r.get('error', '')[:60]} "
                        "| | | | | | | |")
            continue
        a = r["analysis"]
        coll = (f"{a['collective_s']:.2e}" if "collective_s" in a else "—")
        rows.append(
            f"| {cid} | {r['memory']['peak_bytes_per_device']/GiB:.2f} "
            f"| {a['compute_s']:.2e} | {a['memory_s']:.2e} "
            f"| {coll} | {a['bottleneck']} "
            f"| {a['useful_flops_ratio']:.2f} | {a['roofline_fraction']:.4f} "
            f"| {_fix(r)} |")
    return "\n".join([head, sep] + rows)


def summary(cells: Dict[str, dict], card: Optional[CardPeaks] = None) -> str:
    """``card``: whose memory the peaks are held against (default: the
    card the first record names, else the current card)."""
    ok = [r for r in cells.values() if r["status"] == "ok"]
    sk = [r for r in cells.values() if r["status"] == "skipped"]
    er = [r for r in cells.values() if r["status"] == "error"]
    lines = [f"{len(ok)} compiled OK, {len(sk)} skipped (per assignment), "
             f"{len(er)} errors."]
    by_b = {}
    for r in ok:
        by_b.setdefault(r["analysis"]["bottleneck"], []).append(r["cell"])
    for b, cs in sorted(by_b.items()):
        lines.append(f"  {b}-bound: {len(cs)} cells")
    worst = sorted(ok, key=lambda r: r["analysis"]["roofline_fraction"])[:5]
    lines.append("  worst roofline fractions: " + ", ".join(
        f"{r['cell']}={r['analysis']['roofline_fraction']:.4f}"
        for r in worst))
    if card is None:
        named = [r["analysis"]["card"] for r in ok if "card" in r["analysis"]]
        card = peaks(named[0] if named else None)
    over = [r for r in ok
            if r["memory"]["peak_bytes_per_device"] > card.hbm_bytes]
    lines.append(f"  cells over the {card.name}'s "
                 f"{card.hbm_bytes / 1e9:.0f} GB: {len(over)}")
    for r in sorted(over, key=lambda r: -r["memory"]["peak_bytes_per_device"]):
        lines.append(f"    {r['cell']}: "
                     f"{r['memory']['peak_bytes_per_device']/GiB:.1f} GiB")
    cpu = [r["cell"] for r in ok if r.get("mesh_device") == "cpu"]
    if cpu:
        lines.append(f"  cells traced on a CPU mesh, whose all-to-alls are "
                     f"counted as the all-gathers DTensor issues there: "
                     f"{len(cpu)}")
    return "\n".join(lines)


def main():
    paths = sys.argv[1:] or ["chiprun_out/chip_smoke.json"]
    cells = load(paths)
    print(summary(cells))
    print()
    print(markdown(cells))


if __name__ == "__main__":
    main()
