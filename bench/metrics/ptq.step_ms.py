"""Reconstruction engine: mean host time of an Adam step, from the
program's ``recon.chunk`` spans (each ends in a wait on the device) over the
untraced part of the window, over the steps they hold."""
from bench.metrics._read import spans_in


def read(record):
    if record.get("kind") != "ptq" or not record.get("clean"):
        return None
    chunks = spans_in(record, "recon.chunk", record["clean"])
    steps = sum(s["attrs"]["steps"] for s in chunks)
    if not steps:
        return None
    return 1e3 * sum(s["dur_us"] for s in chunks) / 1e6 / steps
