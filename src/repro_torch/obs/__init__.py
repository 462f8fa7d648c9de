"""Observability layer of the port (``repro/obs``'s counterpart).

  telemetry.py       process-global counters/gauges/histograms + nested
                     host-side spans (disabled by default, no-op when off)
  sink.py            JSONL event sink + RunManifest (run identity stamped
                     into checkpoint meta, exports and serve stats);
                     ``check_bench`` and the ``--validate``/``--check-bench``
                     CLI (``python -m repro_torch.obs.sink``)
  serve_metrics.py   per-request lifecycle metrics: queue wait, TTFT,
                     per-bucket prefill histograms, occupancy/backlog
  compile_events.py  the serving engine's CUDA-graph captures, attributed to
                     the telemetry span open when each ran
  profiler.py        ``--profile``: one process-wide ``torch.profiler``
                     profile written as a Chrome trace, and ``annotate``
"""
from repro_torch.obs.sink import (  # noqa: F401
    SCHEMA_VERSION,
    JsonlSink,
    ListSink,
    RunManifest,
    check_bench,
    current_manifest,
    validate_events,
)
from repro_torch.obs.telemetry import (  # noqa: F401
    TELEMETRY,
    Counter,
    Gauge,
    Histogram,
    Stopwatch,
    counter,
    gauge,
    histogram,
    now,
    span,
)
from repro_torch.obs.serve_metrics import (  # noqa: F401
    ServeMetrics,
    percentiles_from_events,
)
