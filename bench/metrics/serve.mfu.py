"""Whole serving step: share of the card's bf16 peak."""
from __future__ import annotations

from typing import Dict, Optional

from bench import flops
from bench.peaks import CARD_PEAKS


def read(record) -> Optional[float]:
    """The serving step's share of the card's bf16 peak: model flops of the
    prompts prefilled and the tokens decoded in the untraced part of the
    window (linears, attention over each token's real context, the logits
    of each emitted token: ``bench/flops.py``), over the time the engine's
    prefill and decode calls took (host clock, each call ending in a
    sync)."""
    if record.get("kind") != "serve":
        return None
    card = CARD_PEAKS.get(record.get("card"))
    if card is None:
        return None
    lo, hi = record["clean"]
    arch = record["arch"]
    total = busy = 0.0
    for t0, t1, _, lens in record["admits"]:
        if t0 >= lo and t1 <= hi:
            total += sum(flops.prefill_flops(arch, n) for n in lens)
            busy += t1 - t0
    for t0, t1, _ in record["steps"]:
        if t0 >= lo and t1 <= hi:
            busy += t1 - t0
    seen: Dict[int, int] = {}
    for t, rid in record["tokens"]:
        k = seen.get(rid, 0)
        seen[rid] = k + 1
        if k and lo < t <= hi:
            total += flops.decode_flops(arch, record["prompt_of"][rid] + k)
    if busy <= 0:
        return None
    return 100.0 * total / busy / card["bfloat16"]
