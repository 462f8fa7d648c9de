"""Serving engine: mean decode-step wall time."""
from __future__ import annotations

from typing import Optional

from bench.metrics._read import spans_in


def read(record) -> Optional[float]:
    """Mean wall time of the program's ``serve.decode_step`` spans (the call
    ends in a host sync) over the untraced part of the window."""
    if record.get("kind") != "serve":
        return None
    steps = spans_in(record, "serve.decode_step", record["clean"])
    if not steps:
        return None
    return sum(s["dur_us"] for s in steps) / len(steps) / 1e3
