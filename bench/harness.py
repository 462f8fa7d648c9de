"""What every driver shares: the run's description (``Job``), the spans it
collects from the program's telemetry, and the profiler window."""
from __future__ import annotations

import contextlib
import dataclasses
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from bench import trace as trace_reader
from bench.env import CACHE


@dataclasses.dataclass
class Job:
    """One run of one cell. ``arch`` is the configuration file's ``arch``;
    ``traffic`` the mix's parameters; ``limits`` the comparison's."""
    workload: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float

    @property
    def arch(self) -> Dict[str, Any]:
        return self.config["arch"]


def now() -> float:
    return time.perf_counter()


class SpanSink:
    """A telemetry sink that keeps span records in memory, each with the
    host time at which it closed (``t_end``, ``time.perf_counter``)."""

    def __init__(self):
        self.spans: List[Dict[str, Any]] = []

    def emit(self, rec: Dict[str, Any]) -> None:
        if rec.get("kind") == "span":
            rec = dict(rec, t_end=now())
            rec["t_start"] = rec["t_end"] - rec["dur_us"] / 1e6
            self.spans.append(rec)

    def close(self) -> None:
        pass


@contextlib.contextmanager
def telemetry(on: bool):
    """The program's telemetry, on and read into a ``SpanSink`` when
    ``on``; off (its default, free) otherwise."""
    if not on:
        yield None
        return
    from repro_torch.obs.telemetry import TELEMETRY
    sink = SpanSink()
    with TELEMETRY.enabled_scope(sink=sink):
        yield sink


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profile:
    """The program's process-wide profiler (``repro_torch.obs.profiler``,
    whose annotations mark recon chunks, prefills and decode steps) over a
    region the harness opens and closes, marked ``bench.window``."""

    DIR = CACHE / "trace"

    def __init__(self):
        self._note = None
        self._dir: Optional[Path] = None
        self.summary: Optional[Dict[str, Any]] = None

    def start(self) -> None:
        import torch
        from repro_torch.obs import profiler
        shutil.rmtree(self.DIR, ignore_errors=True)
        _sync(torch)
        if not profiler.start(str(self.DIR)):
            raise SystemExit("bench: the profiler could not start")
        self._note = torch.profiler.record_function(trace_reader.WINDOW)
        self._note.__enter__()

    def stop(self) -> None:
        import torch
        from repro_torch.obs import profiler
        _sync(torch)
        self._note.__exit__(None, None, None)
        self._note = None
        self._dir = Path(profiler.stop())

    def close(self) -> None:
        """Stop the profile if it still runs (a run cut short)."""
        if self._note is not None:
            self.stop()

    def read(self) -> None:
        """Parse the written trace (outside the measured window) and
        delete it."""
        files = sorted(self._dir.glob("*.json"))
        self.summary = trace_reader.read(files[-1])
        shutil.rmtree(self._dir, ignore_errors=True)


def annotate(name: str):
    """A host annotation in the trace while the profiler runs."""
    from repro_torch.obs import profiler
    return profiler.annotate(name)
