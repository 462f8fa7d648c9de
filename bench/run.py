"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
comparison with the plain reference computed, beside its limit. The same
numbers close standard error. The run needs as many CUDA cards as the cell
asks for and exits non-zero, printing no result, without them, or if JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

from bench import env  # noqa: E402

env.prepare()

from bench import peaks, spec  # noqa: E402
from bench.harness import Job  # noqa: E402


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(bench: Dict[str, Any], workload: str, out: Dict[str, Any],
               traced: bool) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), each read by its own reader; a reader that finds nothing
    leaves its metric out."""
    res = {}
    out["record"]["card"] = out.get("card")
    if not traced:
        for m in spec.end_to_end(bench, workload):
            res[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
        return res
    for m in spec.per_layer(bench, workload):
        val = spec.metric_reader(m["name"]).read(out["record"])
        if val is not None:
            res[m["name"]] = {"value": val, "unit": m["unit"]}
    return res


def correct_of(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def result_of(job: Job, bench: Dict[str, Any], cell: Dict[str, Any],
              out: Dict[str, Any], card: str) -> Dict[str, Any]:
    checks = out["checks"]
    device = {"platform": "gpu", "kind": card, "count": cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    res = {"correct": correct_of(checks), "attempted": int(out["attempted"]),
           "failed": int(out["failed"]),
           "metrics": metrics_of(bench, job.workload, out, job.trace),
           "device": device}
    tr = out["record"].get("trace")
    if job.trace and tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        res["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    res["checks"] = checks
    return res


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    card = torch.cuda.get_device_name(0)
    print(f"bench: card {peaks.power_limit()}", file=sys.stderr, flush=True)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    job = Job(workload=args.workload, config=config, traffic=traffic,
              limits=spec.limits(args.workload), seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace),
              device=torch.device("cuda"), t0=T0)
    out = spec.driver(traffic["kind"]).run(job)
    out["card"] = card
    res = result_of(job, bench, cell, out, card)
    bad = env.forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}, which the port's benchmark may "
              "not load", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
