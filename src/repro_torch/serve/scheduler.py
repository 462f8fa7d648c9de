"""Host-side scheduler: admission queue + async detokenize thread (port of
``repro/serve/scheduler.py``).

The device loop (``ServeEngine.admit`` / ``.step``) should not wait on
host Python, so everything host-flavored lives here:

* **Admission queue** — requests land in a FIFO backlog and are admitted
  whenever slots free up, up to ``prefill_group`` per prefill call. The
  admission is *straggler-tolerant*: a half-empty group ships immediately
  as dummy-padded rows instead of waiting for the backlog to fill the
  group, so one slow producer cannot stall every other user's first
  token.

* **Async detokenize thread** — emitted token ids go into a
  ``queue.Queue`` drained by a daemon thread that runs the (potentially
  slow, pure-Python) ``detokenize`` callback; the decode loop only ever
  pays a lock-free put. Ordering per request id is preserved (single
  consumer thread). A raising callback does **not** kill the drain loop:
  the first exception is recorded on the scheduler, counted as
  ``detok_errors`` in telemetry, and re-raised from ``pump()``/``run()``/
  ``close()`` — the loop keeps draining so ``queue.join()`` never hangs.

* **Request lifecycle metrics** — ``submit`` stamps the enqueue time, and
  the admitting prefill closes the queue-wait (submit → prefill start)
  and TTFT (submit → first token, which the prefill itself emits) windows
  on the engine's :class:`repro_torch.obs.ServeMetrics`; backlog depth and slot
  occupancy are mirrored as gauges. Drain via ``Scheduler.stats()``.

``run()`` drives the whole lifecycle for an offline batch; ``submit`` +
``pump`` expose the incremental interface for a live loop.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs.serve_metrics import ServeMetrics
from repro_torch.obs.telemetry import TELEMETRY, now


@dataclass
class Request:
    rid: int
    tokens: np.ndarray          # (n,) int prompt
    max_new: int = 16
    detok: List[int] = field(default_factory=list)


_STOP = object()


class Scheduler:
    def __init__(self, engine,
                 detokenize: Optional[Callable[[int, int], None]] = None):
        self.engine = engine
        self.metrics: ServeMetrics = (getattr(engine, "metrics", None)
                                      or ServeMetrics())
        self.backlog: "queue.Queue[Request]" = queue.Queue()
        self.outputs: Dict[int, List[int]] = {}
        self._detok_fn = detokenize
        self._detok_q: "queue.Queue" = queue.Queue()
        self._detok_exc: Optional[BaseException] = None
        self._detok_thread = threading.Thread(target=self._detok_loop,
                                              daemon=True)
        self._detok_thread.start()
        self._pending = 0  # submitted but not yet fully emitted

    # ---------------------------------------------------------- detok side
    def _detok_loop(self):
        while True:
            item = self._detok_q.get()
            try:
                if item is _STOP:
                    return
                rid, tok = item
                self.outputs.setdefault(rid, []).append(tok)
                if self._detok_fn is not None:
                    try:
                        self._detok_fn(rid, tok)
                    except BaseException as e:  # noqa: BLE001 - user code
                        # record + count, keep draining: a poisoned
                        # callback must not strand queue.join() forever
                        if self._detok_exc is None:
                            self._detok_exc = e
                        self.metrics.count_detok_error()
            finally:
                self._detok_q.task_done()

    def _raise_detok(self):
        """Surface the first detokenize-callback exception on the caller's
        thread (cleared once raised — close() after a raising run() must
        not raise the same error twice)."""
        if self._detok_exc is not None:
            exc, self._detok_exc = self._detok_exc, None
            raise exc

    def _emit(self, pairs):
        for rid, tok in pairs:
            self._detok_q.put((rid, tok))

    # --------------------------------------------------------- device side
    def submit(self, req: Request):
        self.metrics.on_submit(req.rid)
        self.backlog.put(req)
        self._pending += 1
        self.metrics.set_backlog(self.backlog.qsize())

    def _admit_some(self):
        """Fill free slots from the backlog — at most one prefill call, at
        most ``prefill_group`` requests, shipped even if the group is
        short (straggler tolerance)."""
        eng = self.engine
        room = min(len(eng.free_slots()), eng.cfg.prefill_group)
        batch = []
        while room > 0 and not self.backlog.empty():
            batch.append(self.backlog.get_nowait())
            room -= 1
        if batch:
            t_admit = now()
            pairs = eng.admit([(r.rid, r.tokens, r.max_new)
                               for r in batch])
            t_first = now()
            bucket = eng.bucket_for(max(len(r.tokens) for r in batch))
            for r in batch:
                self.metrics.on_admitted(r.rid, bucket, t_admit, t_first)
            self._emit(pairs)

    def pump(self) -> bool:
        """One scheduling round: admit, then one decode step across slots.
        Returns False when there is nothing left to do. Re-raises a
        detokenize-callback failure recorded by the drain thread."""
        self._raise_detok()
        eng = self.engine
        with TELEMETRY.span("serve.pump", backlog=self.backlog.qsize()):
            self._admit_some()
            if eng.active:
                self._emit(eng.step())
        for _rid, _toks in eng.drain_finished():
            self._pending -= 1
        self.metrics.set_backlog(self.backlog.qsize())
        return eng.active > 0 or not self.backlog.empty()

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Offline batch: submit everything, pump to completion, join the
        detokenize thread's queue, return per-request token lists."""
        for r in requests:
            self.submit(r)
        while self._pending > 0:
            self.pump()
        self._detok_q.join()  # all handed tokens consumed by the thread
        self._raise_detok()   # a failure in the final drain still surfaces
        return self.outputs

    def stats(self) -> Dict:
        """Engine stats + the per-request lifecycle summaries this
        scheduler fed (queue wait / TTFT percentiles, detok_errors)."""
        st = self.engine.stats() if hasattr(self.engine, "stats") else {}
        st["requests"] = self.metrics.request_summary()
        return st

    def close(self):
        self._detok_q.put(_STOP)
        self._detok_thread.join(timeout=5)
        self._raise_detok()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # don't mask an in-flight exception with the detok re-raise
        if exc and exc[0] is not None:
            self._detok_q.put(_STOP)
            self._detok_thread.join(timeout=5)
            return False
        self.close()
        return False
