"""Kernels K1/K2: share of their roofline."""
from __future__ import annotations

from typing import Dict, Optional

from bench import flops
from bench.peaks import CARD_PEAKS

# the kernels of csrc/dequant_matmul_2d.cu that K1 and K2 launch
K12 = ("dec_kernel", "wg_kernel", "fp32_kernel", "reduce_splits")


def read(record) -> Optional[float]:
    """K1/K2: the least time of every launch in the traced part of the
    window over the device time the trace gives those launches (percent).
    Each launch's (M, K, N, bits) was recorded at its graph's capture; a
    graph counts once per replay in the traced part (decode steps at M =
    slots, prefills at M = group x bucket)."""
    if record.get("kind") != "serve" or not record.get("trace"):
        return None
    card = CARD_PEAKS.get(record.get("card"))
    shapes = record.get("shapes") or {}
    if card is None or not shapes:
        return None
    lo, hi = record["traced"]
    replays: Dict[int, int] = {}
    for t0, t1, bucket, _ in record["admits"]:
        if t0 >= lo and t1 <= hi:
            m = record["group"] * bucket
            replays[m] = replays.get(m, 0) + 1
    steps = sum(1 for t0, t1, _ in record["steps"] if t0 >= lo and t1 <= hi)
    replays[record["slots"]] = replays.get(record["slots"], 0) + steps
    least = 0.0
    for m, n in replays.items():
        for _, M, K, N, bits in shapes.get(m, ()):
            least += n * flops.least_seconds(
                flops.dequant_matmul_ops(M, K, N),
                flops.dequant_matmul_bytes(M, K, N, bits), card)
    device = sum(d for name, _, d in record["trace"]["kernels"]
                 if any(k in name for k in K12)) / 1e6
    if least <= 0 or device <= 0:
        return None
    return 100.0 * least / device
