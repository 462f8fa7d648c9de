"""Scheduler: share of the slots active in a decode step."""
from __future__ import annotations

from typing import Optional

from bench.metrics._read import spans_in


def read(record) -> Optional[float]:
    """Percent of the slots active in a decode step: the ``active`` the
    program's ``serve.decode_step`` spans carry, over the untraced part."""
    if record.get("kind") != "serve":
        return None
    steps = spans_in(record, "serve.decode_step", record["clean"])
    if not steps:
        return None
    active = sum(s["attrs"]["active"] for s in steps) / len(steps)
    return 100.0 * active / record["slots"]
