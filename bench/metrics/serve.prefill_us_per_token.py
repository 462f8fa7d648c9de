"""Serving engine: prefill wall time per true prompt token."""
from __future__ import annotations

from typing import Optional

from bench.metrics._read import spans_in


def read(record) -> Optional[float]:
    """The program's ``serve.prefill`` spans over the untraced part of the
    window, over the true prompt tokens those prefills admitted."""
    if record.get("kind") != "serve":
        return None
    lo, hi = record["clean"]
    spans = spans_in(record, "serve.prefill", record["clean"])
    n = sum(sum(lens) for t0, t1, _, lens in record["admits"]
            if t0 >= lo and t1 <= hi)
    if not spans or not n:
        return None
    return sum(s["dur_us"] for s in spans) / n
