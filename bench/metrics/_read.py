"""Helpers the per-layer metric readers share."""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def spans_in(record: Dict[str, Any], name: str,
             window: tuple) -> List[Dict[str, Any]]:
    """The program's spans called ``name`` that lie inside ``window``
    (host times)."""
    lo, hi = window
    return [s for s in record.get("spans", ())
            if s["name"] == name and s["t_start"] >= lo - 1e-6
            and s["t_end"] <= hi + 1e-6]


def idle_share(record: Dict[str, Any]) -> Optional[float]:
    """Percent of the traced window with no kernel, copy or set running."""
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
