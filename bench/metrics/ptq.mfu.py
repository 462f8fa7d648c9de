"""The whole reconstruction's share of the card's bf16 peak: model flops
of the steps finished over the untraced part of the window (a step is the
block's forward and backward, 3x the forward, causal attention as the
chunked program computes it: ``bench/flops.py``), over its time."""
from bench import flops
from bench.peaks import CARD_PEAKS


def read(record):
    if record.get("kind") != "ptq" or not record.get("clean"):
        return None
    lo, hi = record["clean"]
    steps = record["clean_steps"]
    if not steps or hi <= lo:
        return None
    tr = record["traffic"]
    per = flops.recon_step_flops(record["arch"], tr["recipe"]["batch_size"],
                                 tr["seq_len"])
    card = CARD_PEAKS.get(record.get("card"))
    if card is None:
        return None
    peak = card["bfloat16"]
    return 100.0 * steps * per / (hi - lo) / peak
