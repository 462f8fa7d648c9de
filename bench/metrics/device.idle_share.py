"""Device: percent of the traced window in which no kernel, copy or set
ran on the card (``torch.profiler``): in a PTQ cell one whole block after
set-up, in a serving cell the window's first ``trace_s`` seconds. One
reader for every ``device.idle_share.<kind>`` metric, which the metric
it moves splits."""
from bench.metrics._read import idle_share


def read(record):
    return idle_share(record)
