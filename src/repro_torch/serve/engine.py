"""Continuous-batching serving engine: bucketed prefill + slot decode, one
CUDA graph per prefill bucket and one for decode (port of
``repro/serve/engine.py``).

* **Bucketed prefill** — a prompt is right-padded to the smallest
  power-of-two bucket that holds it; under the causal mask the padded keys
  contribute nothing at real positions. Each prefill call packs up to
  ``prefill_group`` prompts of different true lengths into one batch; short
  groups are padded with dummy rows (slot id ``slots``, as in the
  reference). The reference drops them by an out-of-range scatter, which
  torch refuses; here each row writes ``where(real, fresh, current)`` into
  its slot in row order (a dummy row writes slot 0's current contents
  back), so the group's fill never changes the shapes and a slot the group
  does not admit stays bit for bit what it was.
* **Slot-based decode** — a fixed ``[slots, max_len]`` KV state stepped by
  one ``decode_step`` over all slots; each slot keeps its own position, and
  finished slots go inactive in place until the next prefill refills them.
* **int8 KV cache by default** (``kv_quant=True``), read without
  dequantizing (:mod:`repro_torch.serve.kv`).

**Static buffers and graphs.** :func:`make_prefill` and :func:`make_decode`
build the fixed-shape bodies; each reads and writes static buffers in
place and never rebinds one: the slot state (``init_state``) and the
per-call inputs and outputs (``init_io``). On a CUDA device ``_build``
warms every body on a side stream (the CUDA libraries build at first use,
the split counters and cuBLAS's workspace are allocated), zeroes the slot
state again and captures one ``torch.cuda.CUDAGraph`` per bucket and one
for decode in one memory pool; ``admit`` and ``step`` copy their host
inputs into the buffers and replay. ``compile_count`` counts the captured
graphs, ``len(buckets) + 1``, and does not change after ``__init__``;
``compile_us`` holds each capture's time under ``prefill_b{b}`` and
``decode``, and each capture is reported to
:mod:`repro_torch.obs.compile_events`. A failed capture or replay raises;
the engine never falls back to eager launches on its own. On the CPU the
same bodies run directly, nothing is captured and ``compile_count`` is 0.
``ServeEngine(..., graphs=False)`` runs the bodies call by call on the card
too: it exists only as the eager side of a comparison (``chip_smoke.py``,
the card tests).

**Launch counts.** A replay makes no Python call, so the kernel wrappers'
counters would not see it: each graph's tally is recorded at its capture
(``kernels.ops.set_aside``) and added to the counters at every replay
(``kernels.ops.add_launches``). Warm-up and capture launch nothing that
the counters keep; they are reported in ``build_launches``.

Greedy decoding with a fixed ``max_new`` per request. Metrics (host-side,
always on): ``engine.metrics`` is a :class:`repro_torch.obs.ServeMetrics`
fed with each prefill's and decode step's wall time (both calls end in a
host sync, so the time includes the device's) and the slot occupancy; with
telemetry enabled the calls also open the spans ``serve.build``,
``serve.prefill`` and ``serve.decode_step``, and under an active
:mod:`repro_torch.obs.profiler` each prefill and decode step is annotated.
The host side (admission queue, detokenize thread) lives in
:mod:`repro_torch.serve.scheduler`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import compile_events, profiler
from repro_torch.obs.serve_metrics import ServeMetrics
from repro_torch.obs.sink import current_manifest
from repro_torch.obs.telemetry import TELEMETRY, Stopwatch
from repro_torch.serve import kv as skv
from repro_torch.serve.smoke import serve_capability

# runs of every body on a side stream before the first capture
WARMUP_RUNS = 2


@dataclass
class EngineConfig:
    slots: int = 4
    max_len: int = 128
    prefill_group: int = 2   # prompts packed into one prefill call
    kv_quant: bool = True    # int8 KV cache (the serving default)
    min_bucket: int = 8
    dtype: Any = None        # fp KV dtype when kv_quant=False

    def buckets(self) -> List[int]:
        """Power-of-two prefill buckets up to the largest <= max_len."""
        out, b = [], self.min_bucket
        while b <= self.max_len:
            out.append(b)
            b *= 2
        if not out:
            raise ValueError(
                f"max_len={self.max_len} below min_bucket={self.min_bucket}")
        return out


@dataclass
class SlotView:
    """Host-side mirror of one device slot."""
    rid: Optional[int] = None
    remaining: int = 0
    emitted: List[int] = field(default_factory=list)


def _greedy(model, params, last: torch.Tensor) -> torch.Tensor:
    return torch.argmax(model.logits(params, last)[:, -1], dim=-1).to(torch.int32)


# ------------------------------------------------------- fixed-shape bodies
def init_state(model, cfg: EngineConfig, device: DeviceLike = None):
    """Zeroed slot state: the KV cache and the per-slot ``tokens``
    (slots, 1), ``pos`` and ``remaining`` (slots,), int32."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "cache": model.init_cache(cfg.slots, cfg.max_len, dtype=cfg.dtype,
                                  kv_quant=cfg.kv_quant, device=dev),
        "tokens": torch.zeros((cfg.slots, 1), **i32),
        "pos": torch.zeros((cfg.slots,), **i32),
        "remaining": torch.zeros((cfg.slots,), **i32),
    }


def init_io(cfg: EngineConfig, device: DeviceLike = None):
    """The bodies' per-call buffers: inputs ``prompt[bucket]`` (G, bucket),
    ``true_len``, ``slot_ids`` (int64) and ``max_new`` (int32), all (G,) but
    the prompt; outputs ``first`` (G,) and ``emitted`` (slots,), int32. A
    row with slot id ``cfg.slots`` is a dummy."""
    dev = resolve_device(device)
    G = cfg.prefill_group
    i64 = dict(dtype=torch.int64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "prompt": {b: torch.zeros((G, b), **i64) for b in cfg.buckets()},
        "true_len": torch.ones((G,), **i64),
        "slot_ids": torch.full((G,), cfg.slots, **i64),
        "max_new": torch.zeros((G,), **i32),
        "first": torch.zeros((G,), **i32),
        "emitted": torch.zeros((cfg.slots,), **i32),
    }


def _row_write(buf: torch.Tensor, dim: int, sid: torch.Tensor,
               keep: torch.Tensor, val: torch.Tensor) -> None:
    """buf[sid] along ``dim`` = val where ``keep`` (0-d bool), else itself."""
    buf.index_copy_(dim, sid, torch.where(keep, val.to(buf.dtype),
                                          buf.index_select(dim, sid)))


def make_prefill(model, ctx, cfg: EngineConfig,
                 bucket: int) -> Callable[[Any, Dict, Dict], None]:
    """One bucket's prefill-insert over static buffers: prefill
    ``io["prompt"][bucket]`` into a fresh (G, bucket) cache, write each
    real row's cache, first token, position and budget into its slot, and
    the first tokens into ``io["first"]``."""
    G = cfg.prefill_group

    def prefill_insert(params, state, io) -> None:
        true_len = io["true_len"]
        fresh = model.init_cache(G, bucket, dtype=cfg.dtype,
                                 kv_quant=cfg.kv_quant, device=true_len.device)
        last, fresh = model.prefill(params, io["prompt"][bucket], fresh, ctx,
                                    true_len=true_len)
        first = _greedy(model, params, last)  # (G,)
        io["first"].copy_(first)
        real = io["slot_ids"] < cfg.slots
        sids = torch.where(real, io["slot_ids"], 0)  # a dummy row: slot 0
        rows = {"tokens": first[:, None], "pos": true_len,
                "remaining": torch.clamp(io["max_new"] - 1, min=0)}
        for r in range(G):  # in row order: a dummy row rewrites what is there
            sid, keep = sids[r:r + 1], real[r]
            for nm, buf in state["cache"].items():
                _row_write(buf[:, :, :bucket], 1, sid, keep,
                           fresh[nm][:, r:r + 1])
            for nm, val in rows.items():
                _row_write(state[nm], 0, sid, keep, val[r:r + 1])
    return prefill_insert


def make_decode(model, ctx, cfg: EngineConfig
                ) -> Callable[[Any, Dict, Dict], None]:
    """The decode step across all slots over static buffers: active slots
    (``remaining > 0``) emit their next token into ``io["emitted"]`` (the
    others -1) and advance; the cache is written in place."""
    def decode(params, state, io) -> None:
        active = state["remaining"] > 0
        logits, _ = model.decode_step(params, state["tokens"], state["cache"],
                                      state["pos"], ctx)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        io["emitted"].copy_(torch.where(active, nxt, -1))
        state["tokens"].copy_(torch.where(active[:, None], nxt[:, None],
                                          state["tokens"]))
        step = active.to(torch.int32)
        state["pos"].add_(step)
        state["remaining"].sub_(step)
    return decode


class ServeEngine:
    """Fixed-capacity continuous-batching engine over one model + ctx.

    ``graphs``: None captures CUDA graphs on a card and runs the bodies
    directly on the CPU; ``False`` runs them directly on a card too (only
    the eager side of a comparison); ``True`` on the CPU raises. Raises
    ``KVQuantUnsupported`` (machine-readable ``reason``) for model families
    the slot layout cannot serve."""

    def __init__(self, model, params, ctx, config: EngineConfig = None,
                 device: DeviceLike = None, graphs: Optional[bool] = None):
        self.cfg = config or EngineConfig()
        ok, reason = serve_capability(model, engine=True,
                                      kv_quant=self.cfg.kv_quant)
        if not ok:
            raise skv.KVQuantUnsupported(reason, f"{model.cfg.name}: cannot "
                                         "build a slot-based serve engine")
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"graphs=True needs a CUDA device, got "
                             f"{self.device}; on the CPU the bodies run "
                             "directly (graphs=None)")
        self.graphs = on_card if graphs is None else graphs
        self.model = model
        self.params = params
        self.ctx = ctx
        self.buckets = self.cfg.buckets()
        self.compile_count = 0
        self.compile_us: Dict[str, float] = {}
        self.build_launches: Dict[str, Dict[str, int]] = {}
        self.prefill_calls: Dict[int, int] = {b: 0 for b in self.buckets}
        self.metrics = ServeMetrics()
        self.decode_steps = 0
        self.tokens_emitted = 0
        self.slots: List[SlotView] = [SlotView() for _ in range(self.cfg.slots)]
        self._finished: List[Tuple[int, List[int]]] = []
        # name -> (CUDA graph, the launches its replay makes)
        self._graphs: Dict[str, Tuple[Any, Dict[str, int]]] = {}
        self._build()

    # ------------------------------------------------------------ capture
    @torch.no_grad()
    def _build(self):
        model, ctx, c = self.model, self.ctx, self.cfg
        with TELEMETRY.span("serve.build", buckets=len(self.buckets)):
            self.state = init_state(model, c, self.device)
            self.io = init_io(c, self.device)
            bodies = {f"prefill_b{b}": make_prefill(model, ctx, c, b)
                      for b in self.buckets}
            bodies["decode"] = make_decode(model, ctx, c)
            self._calls = {name: partial(fn, self.params, self.state, self.io)
                           for name, fn in bodies.items()}
            if self.graphs:
                self._capture()

    def _capture(self) -> None:
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with ops.set_aside() as warm, torch.cuda.stream(stream):
            for _ in range(WARMUP_RUNS):
                for call in self._calls.values():
                    call()
            st = self.state  # the warm-up wrote slot state: zero it again
            for t in (*st["cache"].values(), st["tokens"], st["pos"],
                      st["remaining"]):
                t.zero_()
        torch.cuda.current_stream(dev).wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        captured: Dict[str, int] = {}
        for name, call in self._calls.items():
            graph = torch.cuda.CUDAGraph()
            sw = Stopwatch()
            with ops.set_aside() as tally:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    call()
            dur = sw.elapsed_s()
            self._graphs[name] = (graph, tally)
            self.compile_count += 1
            self.compile_us[name] = dur * 1e6
            compile_events.record_capture(name, dur)
            for k, n in tally.items():
                captured[k] = captured.get(k, 0) + n
        torch.cuda.synchronize(dev)
        self.build_launches = {"warmup": warm, "capture": captured}

    def _launch(self, name: str) -> None:
        """Replay ``name``'s graph and count its launches, or run its body."""
        if name not in self._graphs:
            self._calls[name]()
            return
        graph, tally = self._graphs[name]
        graph.replay()
        ops.add_launches(tally)

    # ------------------------------------------------------------ serving
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.rid is None]

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds the largest bucket "
                         f"{self.buckets[-1]} (max_len={self.cfg.max_len})")

    @torch.no_grad()
    def admit(self, requests: Sequence[Tuple[int, np.ndarray, int]],
              ) -> List[Tuple[int, int]]:
        """Prefill up to ``prefill_group`` requests into free slots.

        ``requests``: (rid, prompt tokens (int 1-D), max_new). Returns the
        (rid, first generated token) pairs: the prefill logits yield token
        #1, so a request costs one prefill and ``max_new - 1`` decode steps.
        One body (one graph replay) whatever the group's fill.
        """
        c = self.cfg
        G = c.prefill_group
        free = self.free_slots()
        if not requests:
            return []
        if len(requests) > min(G, len(free)):
            raise ValueError(f"admit got {len(requests)} requests for "
                             f"{len(free)} free slots, group {G}")
        lens = [len(t) for _, t, _ in requests]
        bucket = self.bucket_for(max(lens))
        tokens = np.zeros((G, bucket), np.int64)
        true_len = np.ones((G,), np.int64)  # dummy rows: gather at index 0
        slot_ids = np.full((G,), c.slots, np.int64)  # dummy rows write nothing
        max_new = np.zeros((G,), np.int32)
        for row, (rid, toks, mn) in enumerate(requests):
            n = lens[row]
            if n + mn > c.max_len:
                mn = c.max_len - n  # clamp: KV writes must stay in range
            tokens[row, :n] = toks
            true_len[row] = n
            slot_ids[row] = free[row]
            max_new[row] = max(mn, 1)
        io = self.io
        sw = Stopwatch()
        with TELEMETRY.span("serve.prefill", bucket=bucket,
                            group=len(requests)), \
                profiler.annotate("serve.prefill", bucket):
            io["prompt"][bucket].copy_(torch.from_numpy(tokens))
            io["true_len"].copy_(torch.from_numpy(true_len))
            io["slot_ids"].copy_(torch.from_numpy(slot_ids))
            io["max_new"].copy_(torch.from_numpy(max_new))
            self._launch(f"prefill_b{bucket}")
            first = io["first"].tolist()  # host sync: first tokens are needed
        self.metrics.observe_prefill(bucket, sw.elapsed_us())
        self.prefill_calls[bucket] += 1
        out = []
        for row, (rid, _, _) in enumerate(requests):
            s = self.slots[free[row]]
            s.rid, s.remaining, s.emitted = rid, int(max_new[row]) - 1, []
            tok = int(first[row])
            s.emitted.append(tok)
            self.tokens_emitted += 1
            out.append((rid, tok))
            if s.remaining == 0:  # max_new=1: the prefill token was it
                self._finished.append((rid, s.emitted))
                self.metrics.on_finished(rid)
                self.slots[free[row]] = SlotView()
        self.metrics.set_occupancy(self.active)
        return out

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One decode step across all slots; returns (rid, token) pairs for
        slots that were active. Frees slots whose budget is exhausted."""
        sw = Stopwatch()
        with TELEMETRY.span("serve.decode_step", active=self.active), \
                profiler.annotate("serve.decode_step", self.decode_steps):
            self._launch("decode")
            emitted = self.io["emitted"].tolist()  # host sync: tokens consumed
        step_us = sw.elapsed_us()
        self.decode_steps += 1
        out = []
        for i, s in enumerate(self.slots):
            if s.rid is None:
                continue
            tok = int(emitted[i])
            s.emitted.append(tok)
            s.remaining -= 1
            self.tokens_emitted += 1
            out.append((s.rid, tok))
            if s.remaining <= 0:
                self._finished.append((s.rid, s.emitted))
                self.metrics.on_finished(s.rid)
                self.slots[i] = SlotView()
        self.metrics.observe_decode(step_us, len(out))
        self.metrics.set_occupancy(self.active)
        return out

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s.rid is not None)

    def drain_finished(self) -> List[Tuple[int, List[int]]]:
        done, self._finished = self._finished, []
        return done

    def hbm_per_slot_bytes(self) -> int:
        """Bytes of KV state one slot pins, from the live cache."""
        return skv.hbm_per_slot_bytes(self.state["cache"], self.cfg.slots)

    def stats(self) -> Dict[str, Any]:
        """Drain point for the engine's metrics. ``prefill_us`` is a
        per-bucket histogram summary ({count, mean, p50, p95, max} over
        every call); ``compile_us`` each capture's microseconds (empty
        without graphs) and ``build_launches`` the launches of the warm-up
        and the captures, which the counters do not keep; ``requests`` the
        per-request lifecycle summaries
        (queue wait, TTFT, decode-step percentiles, occupancy, backlog,
        detok_errors); ``manifest`` stamps the run identity."""
        return {
            "compile_count": self.compile_count,
            "compile_us": dict(self.compile_us),
            "graphs": self.graphs,
            "build_launches": {k: dict(v)
                               for k, v in self.build_launches.items()},
            "buckets": list(self.buckets),
            "prefill_calls": dict(self.prefill_calls),
            "prefill_us": self.metrics.prefill_summary(),
            "decode_steps": self.decode_steps,
            "tokens_emitted": self.tokens_emitted,
            "hbm_per_slot_bytes": self.hbm_per_slot_bytes(),
            "hbm_per_slot_MiB": skv.hbm_per_slot_mib(self.state["cache"],
                                                     self.cfg.slots),
            "kv_quant": self.cfg.kv_quant,
            "requests": self.metrics.request_summary(),
            "manifest": current_manifest().brief(),
        }
