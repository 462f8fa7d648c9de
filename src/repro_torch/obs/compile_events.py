"""Compile accounting of the port: CUDA-graph captures, attributed to spans
(port of ``repro/obs/compile_events.py``).

The reference counts every XLA backend compilation through one
``jax.monitoring`` listener. The port compiles nothing but the CUDA graphs
the serving engine captures, so the engine reports each capture here
(``record_capture``), and each is attributed to the innermost telemetry
span open when it ran (``serve.build``; ``<unattributed>`` while telemetry
is off, as in the reference). When the sink is on each capture also lands
as a ``kind="compile"`` JSONL event with its span, graph name and seconds.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from repro_torch.obs.telemetry import TELEMETRY

UNATTRIBUTED = "<unattributed>"

_LOCK = threading.Lock()
_CAPTURES: List[Tuple[str, str, float]] = []  # (graph name, span, seconds)


def record_capture(name: str, dur_s: float) -> None:
    """Count one CUDA-graph capture of ``dur_s`` seconds."""
    span = TELEMETRY.current_span() or UNATTRIBUTED
    with _LOCK:
        _CAPTURES.append((name, span, dur_s))
    if TELEMETRY.enabled:
        TELEMETRY.counter("cuda.graph_captures").inc()
        TELEMETRY.emit({"kind": "compile", "span": span, "graph": name,
                        "dur_s": round(dur_s, 6)})


def captures() -> int:
    """CUDA-graph captures recorded since the process started (or the last
    ``reset``)."""
    with _LOCK:
        return len(_CAPTURES)


def captures_by_span() -> Dict[str, int]:
    """Captures keyed by the telemetry span open when they ran."""
    out: Dict[str, int] = {}
    with _LOCK:
        for _, span, _ in _CAPTURES:
            out[span] = out.get(span, 0) + 1
    return out


def compile_summary() -> Dict:
    """The captures in one dict. The reconstruction loop captures nothing
    yet, so it has no ledger of its own here, only a note."""
    with _LOCK:
        seconds = sum(d for _, _, d in _CAPTURES)
    return {"graph_captures": captures(), "capture_s": seconds,
            "by_span": captures_by_span(),
            "recon": "eager: the reconstruction step is not captured, "
                     "nothing is compiled"}


def reset() -> None:
    """Forget the recorded captures (tests)."""
    with _LOCK:
        _CAPTURES.clear()
