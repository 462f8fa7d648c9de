"""Process-global telemetry: counters, gauges, timing histograms, spans
(port of ``repro/obs/telemetry.py``).

* **Host-side only.** Spans and metrics are read on the host, around calls
  into the model or the engine, never inside them.
* **Negligible overhead when disabled.** ``span()`` returns a shared no-op
  singleton (no allocation, no clock read); counters and gauges are plain
  attribute bumps. The default state is disabled; ``TELEMETRY.enable(...)``
  (``launch/quantize --telemetry DIR``) turns it on.
* **Device work is attributed explicitly.** A span measures wall time; CUDA
  launches return before the device finishes, so a span around them
  measures the enqueue unless the caller opts in: ``sp.block_on(out)`` (or
  ``span(..., sync=out)``) synchronizes the device of every CUDA tensor in
  ``out`` at span exit, folding device completion into the span, as the
  reference's ``jax.block_until_ready`` does.

Span taxonomy (dotted, coarse to fine): ``recon.block > recon.chunk``,
``serve.build``, ``serve.prefill``, ``serve.decode_step``, ``serve.pump``.

The reference's static check QL106 flags bare host clocks outside
``repro/obs/``; this package's path does not match that exemption, so the
two clock bindings below carry inline ignores and every other module of the
port reads the clock through ``now()`` / ``Stopwatch``.
"""
from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs.sink import SCHEMA_VERSION, RunManifest

_clock = time.perf_counter  # quantlint: ignore[QL106]
_wall = time.time  # quantlint: ignore[QL106]


def now() -> float:
    """Monotonic host timestamp (seconds): the sanctioned absolute clock for
    lifecycle timing (queue wait, TTFT) outside this module."""
    return _clock()


class Stopwatch:
    """The sanctioned ad-hoc clock: started on construction, read via
    ``elapsed_s``/``elapsed_us``."""

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0 = _clock()

    def restart(self) -> None:
        self._t0 = _clock()

    def elapsed_s(self) -> float:
        return _clock() - self._t0

    def elapsed_us(self) -> float:
        return (_clock() - self._t0) * 1e6


def block_on(tree: Any) -> None:
    """Wait for the devices of every CUDA tensor in ``tree`` (nested dicts,
    lists and tuples) to finish their queued work."""
    devices = set()
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact-sample timing histogram (bounded reservoir): serving runs emit
    thousands of observations, so keeping the samples makes percentiles
    exact instead of bucket-quantized."""

    __slots__ = ("name", "values", "max_samples", "count", "total", "max")

    def __init__(self, name: str, max_samples: int = 65536):
        self.name = name
        self.values: List[float] = []
        self.max_samples = max_samples
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        if len(self.values) < self.max_samples:
            self.values.append(v)

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile over the retained samples (numpy's
        default method)."""
        if not self.values:
            return 0.0
        vs = sorted(self.values)
        k = (len(vs) - 1) * q / 100.0
        f, c = math.floor(k), math.ceil(k)
        if f == c:
            return vs[int(k)]
        return vs[f] + (vs[c] - vs[f]) * (k - f)

    def summary(self) -> Dict[str, float]:
        return {"count": float(self.count),
                "mean": self.total / self.count if self.count else 0.0,
                "p50": self.percentile(50),
                "p95": self.percentile(95),
                "max": self.max}


class _NullSpan:
    """Shared no-op span handed out while telemetry is disabled: no clock
    read, no allocation, every method inert."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **attrs) -> None:
        pass

    def block_on(self, tree: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("name", "attrs", "parent", "depth", "dur_us",
                 "_tel", "_sync", "_t0")

    def __init__(self, tel: "Telemetry", name: str, sync: Any,
                 attrs: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.attrs = attrs
        self._sync = sync
        self.parent: Optional[str] = None
        self.depth = 0
        self.dur_us = 0.0

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def block_on(self, tree: Any) -> None:
        """Register tensors whose device completion belongs to this span;
        their devices are synchronized at span exit."""
        self._sync = tree

    def __enter__(self) -> "Span":
        stack = self._tel._stack()
        self.parent = stack[-1].name if stack else None
        self.depth = len(stack)
        stack.append(self)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        if self._sync is not None:
            block_on(self._sync)
        self.dur_us = (_clock() - self._t0) * 1e6
        stack = self._tel._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tel._record_span(self, synced=self._sync is not None)
        return False


class Telemetry:
    """Process-global metric registry + span stack (per thread) + sink."""

    def __init__(self):
        self.enabled = False
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.manifest: Optional[RunManifest] = None
        self._sink = None
        self._lock = threading.Lock()
        self._tls = threading.local()

    # ------------------------------------------------------------- metrics
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            with self._lock:
                c = self.counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            with self._lock:
                g = self.gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            with self._lock:
                h = self.histograms.setdefault(name, Histogram(name))
        return h

    # --------------------------------------------------------------- spans
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, sync: Any = None, **attrs):
        """Nested wall-time span. Disabled mode returns a shared no-op
        context manager, so callers never branch on ``enabled``."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, sync, attrs)

    def current_span(self) -> Optional[str]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1].name if stack else None

    def _record_span(self, span: Span, synced: bool) -> None:
        self.histogram(f"span.{span.name}").observe(span.dur_us)
        rec = {"kind": "span", "name": span.name,
               "dur_us": round(span.dur_us, 3), "depth": span.depth,
               "parent": span.parent, "synced": synced}
        if span.attrs:
            rec["attrs"] = span.attrs
        self.emit(rec)

    # ---------------------------------------------------------------- sink
    def emit(self, record: Dict[str, Any]) -> None:
        if self._sink is not None:
            record.setdefault("schema", SCHEMA_VERSION)
            record.setdefault("ts", _wall())
            self._sink.emit(record)

    def enable(self, sink=None, manifest: Optional[RunManifest] = None
               ) -> None:
        self.enabled = True
        self._sink = sink
        self.manifest = manifest
        if manifest is not None and sink is not None:
            sink.emit(manifest.record())

    def disable(self) -> None:
        self.enabled = False
        if self._sink is not None:
            self._sink.close()
        self._sink = None

    @contextmanager
    def enabled_scope(self, sink=None,
                      manifest: Optional[RunManifest] = None):
        """Enable telemetry for a region, restoring the prior state after
        (tests use it)."""
        prev = (self.enabled, self._sink, self.manifest)
        self.enabled = True
        self._sink = sink
        self.manifest = manifest
        if manifest is not None and sink is not None:
            sink.emit(manifest.record())
        try:
            yield self
        finally:
            self.enabled, self._sink, self.manifest = prev

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {n: c.value for n, c in sorted(self.counters.items())},
            "gauges": {n: g.value for n, g in sorted(self.gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self.histograms.items())},
        }

    def reset(self) -> None:
        """Drop accumulated metrics (tests)."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()


TELEMETRY = Telemetry()


def span(name: str, sync: Any = None, **attrs):
    return TELEMETRY.span(name, sync=sync, **attrs)


def counter(name: str) -> Counter:
    return TELEMETRY.counter(name)


def gauge(name: str) -> Gauge:
    return TELEMETRY.gauge(name)


def histogram(name: str) -> Histogram:
    return TELEMETRY.histogram(name)


def enabled_scope(sink=None, manifest: Optional[RunManifest] = None):
    return TELEMETRY.enabled_scope(sink=sink, manifest=manifest)


def snapshot() -> Dict[str, Any]:
    return TELEMETRY.snapshot()


def reset() -> None:
    TELEMETRY.reset()
