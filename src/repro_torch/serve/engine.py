"""Continuous-batching serving engine: bucketed prefill + slot decode (port
of ``repro/serve/engine.py``).

* **Bucketed prefill** — a prompt is right-padded to the smallest
  power-of-two bucket that holds it; under the causal mask the padded keys
  contribute nothing at real positions. Each prefill call packs up to
  ``prefill_group`` prompts of different true lengths into one batch; short
  groups are padded with dummy rows, which are then filtered out explicitly
  before anything is written to the slot state (the reference drops them by
  an out-of-bounds scatter, which torch refuses).
* **Slot-based decode** — a fixed ``[slots, max_len]`` KV state stepped by
  one ``decode_step`` over all slots; each slot keeps its own position, and
  finished slots go inactive in place until the next prefill refills them.
* **int8 KV cache by default** (``kv_quant=True``), read without
  dequantizing (:mod:`repro_torch.serve.kv`).

The engine runs eagerly: every call launches its kernels directly and the
cache is updated in place. There are no CUDA graphs yet (one per bucket and
one for decode are queued in ROADMAP), so nothing is captured and
``compile_count`` is 0. Greedy decoding with a fixed ``max_new`` per request.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve import kv as skv
from repro_torch.serve.smoke import serve_capability


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


class ServeEngine:
    """Fixed-capacity continuous-batching engine over one model + ctx.

    Raises ``KVQuantUnsupported`` (machine-readable ``reason``) for model
    families the slot layout cannot serve."""

    def __init__(self, model, params, ctx, config: EngineConfig = None,
                 device: DeviceLike = None):
        self.cfg = config or EngineConfig()
        ok, reason = serve_capability(model, engine=True,
                                      kv_quant=self.cfg.kv_quant)
        if not ok:
            raise skv.KVQuantUnsupported(reason, f"{model.cfg.name}: cannot "
                                         "build a slot-based serve engine")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.ctx = ctx
        self.buckets = self.cfg.buckets()
        # eager engine: no CUDA graph is captured (see the module docstring)
        self.compile_count = 0
        self.prefill_calls: Dict[int, int] = {b: 0 for b in self.buckets}
        self.decode_steps = 0
        self.tokens_emitted = 0
        self.slots: List[SlotView] = [SlotView() for _ in range(self.cfg.slots)]
        self._finished: List[Tuple[int, List[int]]] = []
        c = self.cfg
        self.state = {
            "cache": model.init_cache(c.slots, c.max_len, dtype=c.dtype,
                                      kv_quant=c.kv_quant, device=self.device),
            "tokens": torch.zeros((c.slots, 1), dtype=torch.int32,
                                  device=self.device),
            "pos": torch.zeros((c.slots,), dtype=torch.int32, device=self.device),
            "remaining": torch.zeros((c.slots,), dtype=torch.int32,
                                     device=self.device),
        }

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
        max_new = np.zeros((G,), np.int64)
        n_real = len(requests)
        for row, (rid, toks, mn) in enumerate(requests):
            n = lens[row]
            if n + mn > c.max_len:
                mn = c.max_len - n  # clamp: KV writes must stay in range
            tokens[row, :n] = toks
            true_len[row] = n
            max_new[row] = max(mn, 1)
        dev = self.device
        fresh = self.model.init_cache(G, bucket, dtype=c.dtype,
                                      kv_quant=c.kv_quant, device=dev)
        true_len_t = torch.as_tensor(true_len, device=dev)
        last, fresh = self.model.prefill(
            self.params, torch.as_tensor(tokens, device=dev), fresh, self.ctx,
            true_len=true_len_t)
        first = _greedy(self.model, self.params, last)  # (G,)
        # scatter the real rows only (dummy rows are filtered, not dropped
        # by an out-of-range index)
        slot_ids = torch.as_tensor(free[:n_real], device=dev)
        cache = self.state["cache"]
        for nm in fresh:
            cache[nm][:, slot_ids, :bucket] = fresh[nm][:, :n_real].to(cache[nm].dtype)
        self.state["tokens"][slot_ids] = first[:n_real, None]
        self.state["pos"][slot_ids] = true_len_t[:n_real].to(torch.int32)
        self.state["remaining"][slot_ids] = torch.as_tensor(
            np.maximum(max_new[:n_real] - 1, 0), dtype=torch.int32, device=dev)
        first = first.tolist()  # host sync: first tokens are needed
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
                self.slots[free[row]] = SlotView()
        return out

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One decode step across all slots; returns (rid, token) pairs for
        slots that were active. Frees slots whose budget is exhausted."""
        st = self.state
        active = st["remaining"] > 0
        logits, st["cache"] = self.model.decode_step(
            self.params, st["tokens"], st["cache"], st["pos"], self.ctx)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        emitted = torch.where(active, nxt, torch.full_like(nxt, -1))
        st["tokens"] = torch.where(active[:, None], nxt[:, None], st["tokens"])
        st["pos"] = st["pos"] + active.to(torch.int32)
        st["remaining"] = st["remaining"] - active.to(torch.int32)
        emitted = emitted.tolist()  # host sync: tokens are consumed
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
                self.slots[i] = SlotView()
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
        return {
            "compile_count": self.compile_count,
            "buckets": list(self.buckets),
            "prefill_calls": dict(self.prefill_calls),
            "decode_steps": self.decode_steps,
            "tokens_emitted": self.tokens_emitted,
            "hbm_per_slot_bytes": self.hbm_per_slot_bytes(),
            "hbm_per_slot_MiB": self.hbm_per_slot_bytes() / 2**20,
            "kv_quant": self.cfg.kv_quant,
        }
