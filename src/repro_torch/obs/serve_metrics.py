"""Per-request serving lifecycle metrics, engine and scheduler (port of
``repro/obs/serve_metrics.py``).

Always on and host-side: one ``ServeMetrics`` per :class:`ServeEngine`,
fed by the engine (prefill/decode latency, occupancy) and the scheduler
(queue wait, time-to-first-token, backlog, detokenize errors).
``ServeEngine.stats()`` and ``Scheduler.stats()`` drain the summaries
(p50/p95 per prefill bucket and per request).

When the global :data:`repro_torch.obs.telemetry.TELEMETRY` is enabled, each
admitted request additionally emits one ``kind="request"`` JSONL event
(rid, queue_wait_us, ttft_us, bucket) and the occupancy/backlog gauges are
mirrored; ``percentiles_from_events`` folds those records back into
percentiles.

Request lifecycle and where each metric is measured::

    submit ──queue_wait──> admit(prefill) ──> first token   [ttft ends here]
                                └─> decode steps ... finish

``ttft`` spans submit → end of the admitting prefill call (the prefill
logits already yield token #1, so first-token latency *is* prefill exit).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.obs.telemetry import TELEMETRY, Histogram, now as _now


class ServeMetrics:
    """Host-side request/latency accounting for one serve engine."""

    def __init__(self, telemetry=None):
        self.tel = telemetry or TELEMETRY
        self.queue_wait_us = Histogram("serve.queue_wait_us")
        self.ttft_us = Histogram("serve.ttft_us")
        self.decode_step_us = Histogram("serve.decode_step_us")
        self.prefill_us: Dict[int, Histogram] = {}
        self.occupancy = 0
        self.backlog_depth = 0
        self.detok_errors = 0
        self.requests_admitted = 0
        self.requests_finished = 0
        self._submit_t: Dict[int, float] = {}

    # ------------------------------------------------------------- engine
    def prefill_hist(self, bucket: int) -> Histogram:
        h = self.prefill_us.get(bucket)
        if h is None:
            h = self.prefill_us[bucket] = Histogram(
                f"serve.prefill_us.b{bucket}")
        return h

    def observe_prefill(self, bucket: int, us: float) -> None:
        self.prefill_hist(bucket).observe(us)
        if self.tel.enabled:
            self.tel.histogram(f"serve.prefill_us.b{bucket}").observe(us)

    def observe_decode(self, us: float, tokens: int) -> None:
        self.decode_step_us.observe(us)
        if self.tel.enabled:
            self.tel.histogram("serve.decode_step_us").observe(us)
            self.tel.counter("serve.tokens_emitted").inc(tokens)

    def set_occupancy(self, n: int) -> None:
        self.occupancy = n
        if self.tel.enabled:
            self.tel.gauge("serve.occupancy").set(n)

    def set_backlog(self, n: int) -> None:
        self.backlog_depth = n
        if self.tel.enabled:
            self.tel.gauge("serve.backlog_depth").set(n)

    # ---------------------------------------------------------- scheduler
    def on_submit(self, rid: int) -> None:
        self._submit_t[rid] = _now()

    def on_admitted(self, rid: int, bucket: int, admit_start: float,
                    first_token_t: float) -> None:
        """Called once per request when its admitting prefill returns.
        Queue wait ends when the prefill *starts*; TTFT when it returns
        (prefill emits the request's first token)."""
        self.requests_admitted += 1
        t_sub = self._submit_t.pop(rid, None)
        if t_sub is None:
            return  # admitted directly via engine.admit — no queue to time
        qw_us = max(admit_start - t_sub, 0.0) * 1e6
        ttft_us = max(first_token_t - t_sub, 0.0) * 1e6
        self.queue_wait_us.observe(qw_us)
        self.ttft_us.observe(ttft_us)
        if self.tel.enabled:
            self.tel.histogram("serve.queue_wait_us").observe(qw_us)
            self.tel.histogram("serve.ttft_us").observe(ttft_us)
            self.tel.emit({"kind": "request", "rid": rid, "bucket": bucket,
                           "queue_wait_us": round(qw_us, 3),
                           "ttft_us": round(ttft_us, 3)})

    def on_finished(self, rid: int) -> None:
        self.requests_finished += 1

    def count_detok_error(self) -> None:
        self.detok_errors += 1
        if self.tel.enabled:
            self.tel.counter("serve.detok_errors").inc()

    # ------------------------------------------------------------- drains
    def prefill_summary(self) -> Dict[int, Dict[str, float]]:
        return {b: h.summary() for b, h in sorted(self.prefill_us.items())}

    def request_summary(self) -> Dict[str, Any]:
        return {
            "admitted": self.requests_admitted,
            "finished": self.requests_finished,
            "queue_wait_us": self.queue_wait_us.summary(),
            "ttft_us": self.ttft_us.summary(),
            "decode_step_us": self.decode_step_us.summary(),
            "occupancy": self.occupancy,
            "backlog_depth": self.backlog_depth,
            "detok_errors": self.detok_errors,
        }


def percentiles_from_events(records, kind: str, field: str,
                            ) -> Optional[Dict[str, float]]:
    """Fold sink records (``kind`` match) into a percentile summary of one
    field — how the serve benchmark turns raw ``kind="request"`` JSONL
    events back into TTFT / queue-wait percentile rows."""
    h = Histogram(f"{kind}.{field}")
    for rec in records:
        if rec.get("kind") == kind and field in rec:
            h.observe(rec[field])
    return h.summary() if h.count else None
