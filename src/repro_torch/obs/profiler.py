"""``--profile`` wiring: a perfetto-loadable Chrome trace from
``torch.profiler`` (port of ``repro/obs/profiler.py``).

One process-wide profile: ``start(dir)`` / ``stop()`` bracket the run, with
CPU activity and, where a card is visible, CUDA activity; ``stop()`` writes
``trace-<pid>-<n>.json`` into ``dir`` (``trace-<pid>-<n>.rank<r>.json`` in
a process group of several ranks). The hot loops mark themselves with
:func:`annotate` (``torch.profiler.record_function`` around each recon chunk,
serve prefill and decode step), a no-op ``nullcontext`` while profiling is
off, so instrumented loops pay nothing by default. Load the JSON in perfetto
(ui.perfetto.dev) or chrome://tracing.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from repro_torch.obs.sink import rank_file

_ACTIVE_DIR: Optional[str] = None
_PROFILE = None
_WRITTEN = 0


def active() -> Optional[str]:
    return _ACTIVE_DIR


def start(trace_dir: str) -> bool:
    """Begin the process-wide profile that ``stop()`` writes into
    ``trace_dir``; returns False (with a warning) if the profiler refuses,
    so --profile degrades instead of killing the run."""
    global _ACTIVE_DIR, _PROFILE
    if _ACTIVE_DIR is not None:
        return True
    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
    except RuntimeError as e:  # pragma: no cover - backend-dependent
        print(f"profiler: could not start ({e}); continuing unprofiled")
        return False
    _ACTIVE_DIR, _PROFILE = trace_dir, prof
    return True


def stop() -> Optional[str]:
    """End the profile and write its Chrome trace; returns the trace dir
    (None if no profile was active)."""
    global _ACTIVE_DIR, _PROFILE, _WRITTEN
    if _ACTIVE_DIR is None:
        return None
    d, prof = _ACTIVE_DIR, _PROFILE
    _ACTIVE_DIR = _PROFILE = None
    prof.stop()
    _WRITTEN += 1
    prof.export_chrome_trace(rank_file(os.path.join(
        d, f"trace-{os.getpid()}-{_WRITTEN}.json")))
    return d


@contextlib.contextmanager
def trace(trace_dir: str):
    """Bracket a region with start/stop (the --profile entry point)."""
    started = start(trace_dir)
    try:
        yield
    finally:
        if started:
            stop()


def annotate(name: str, step: Optional[int] = None):
    """Per-iteration marker inside an active profile (recon chunks, serve
    steps): a ``user_annotation`` range named ``name`` on the trace's CPU
    timeline. Free when profiling is off."""
    if _ACTIVE_DIR is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(
        name, None if step is None else str(step))
