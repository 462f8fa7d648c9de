"""PTQ driver: percent of the window's time outside the engine's
``recon.chunk`` spans (teacher pass, observer, LSQ initialisation, export,
student advance), over the untraced part of the window."""
from bench.metrics._read import spans_in


def read(record):
    if record.get("kind") != "ptq" or not record.get("clean"):
        return None
    lo, hi = record["clean"]
    chunks = spans_in(record, "recon.chunk", record["clean"])
    if not chunks or hi <= lo:
        return None
    return 100.0 * (1.0 - sum(s["dur_us"] for s in chunks) / 1e6 / (hi - lo))
