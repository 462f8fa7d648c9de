"""Compile accounting of the port: CUDA-graph captures, attributed to spans
(port of ``repro/obs/compile_events.py``).

The reference counts every XLA backend compilation through one
``jax.monitoring`` listener. The port compiles nothing but CUDA graphs:
the serving engine's (one per prefill bucket and one for decode) and the
reconstruction engine's (one Adam step per engine, ``recon.step``). Each
capture is reported here (``record_capture``) and attributed to the
innermost telemetry span open when it ran (``serve.build``,
``recon.block``; ``<unattributed>`` while telemetry is off, as in the
reference). When the sink is on each capture also lands
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


def capture_seconds(name: str) -> List[float]:
    """The seconds of each recorded capture of graph ``name``."""
    with _LOCK:
        return [d for n, _, d in _CAPTURES if n == name]


def captures_by_span() -> Dict[str, int]:
    """Captures keyed by the telemetry span open when they ran."""
    out: Dict[str, int] = {}
    with _LOCK:
        for _, span, _ in _CAPTURES:
            out[span] = out.get(span, 0) + 1
    return out


def compile_summary() -> Dict:
    """The captures in one dict, with the reconstruction engine's counters
    under ``engine`` (as the reference reports them; its ``step_compiles``
    are the ``recon.step`` captures among ``graph_captures``)."""
    import dataclasses

    from repro_torch.core.reconstruct import engine_stats
    st = engine_stats()
    with _LOCK:
        seconds = sum(d for _, _, d in _CAPTURES)
    return {"graph_captures": captures(), "capture_s": seconds,
            "by_span": captures_by_span(),
            "engine": dict(dataclasses.asdict(st),
                           compile_count=st.compile_count)}


def reset() -> None:
    """Forget the recorded captures (tests)."""
    with _LOCK:
        _CAPTURES.clear()
