"""Reading a ``torch.profiler`` Chrome trace (after ``chip_smoke.py``'s
``device_window``): the device's busy time in a window, as the union of
kernel, memcpy and memset intervals; the device operations with the most
time; and the idle gaps, each named by the host annotation that was open
when it began.

The window is the span of the annotation ``bench.window`` the harness
opens around the traced region.
"""
from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short(name: str, width: int = 160) -> str:
    """A kernel's name without ``void``, namespaces and argument lists,
    cut to ``width`` characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "cutlass::"):
        name = name.replace(junk, "")
    return name[:width]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read(path: Path, top: int = 10) -> Dict[str, Any]:
    """The window's figures from the trace file at ``path``: ``window_s``,
    ``busy_s``, ``device_ops`` and ``idle_gaps`` ([name, seconds], at most
    ``top`` each), and ``kernels``: every device op in the window as
    (name, start_us, dur_us)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    wins = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise ValueError(f"{path}: no {WINDOW} annotation")
    lo = min(e["ts"] for e in wins)
    hi = max(e["ts"] + e["dur"] for e in wins)
    spans, by_name, kernels = [], {}, []
    notes = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name") != WINDOW:
            notes.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        if cat not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        spans.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
        kernels.append((e["name"], e["ts"], e["dur"]))
    busy = _union(spans)
    gaps, end = [], lo
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    notes.sort()
    starts = [n[0] for n in notes]

    def host_at(t: float) -> str:
        """The innermost (latest-starting) annotation open at ``t``."""
        i = bisect.bisect_right(starts, t)
        for a, b, name in reversed(notes[max(0, i - 256):i]):
            if a <= t < b:
                return name
        return "host.unannotated"

    gaps.sort(key=lambda g: g[0] - g[1])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_ops": [[short(n), t / 1e6] for n, t in top_ops],
        "idle_gaps": [[host_at(a), (b - a) / 1e6] for a, b in gaps[:top]],
        "kernels": kernels,
    }
