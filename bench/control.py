"""Readings the limits are set from, on the card at the cell's own size.

    python3 -m bench.control --workload <name> --seeds 11,12,13 [--fault NAME] [--seconds S]

    python3 -m bench.control --workload <serving cell> --seeds 11 --rates 2,3,4

For each seed, in one process: the program's run (a short window: the
readings need none), then the compared numbers, for the program and for
the control, the reference computed with every product's operands in
float8 e4m3 put in the program's place. With ``--fault`` the run has that
fault (``bench/faults.py``) planted underneath, and the program's numbers
are the fault's readings. One JSON line per seed. ``--rates`` sweeps a
serving cell's arrival rate instead (one export, an engine for each rate):
per rate, the tokens per second, the 90th percentile of time to first token
over each half of the window and the backlog left at its end; the highest
rate whose backlog does not grow is the knee.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from bench import env  # noqa: E402

env.prepare()

from bench import faults, spec  # noqa: E402
from bench.harness import Job  # noqa: E402


def readings(job: Job, fault=None) -> dict:
    kind = job.traffic["kind"]
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        out, ctx = spec.driver(kind).program(job)
    if kind == "ptq":
        from bench.compare import ptq as compare
        t = time.perf_counter()
        got = compare.readings(job, *ctx)
        got["reference_s"] = time.perf_counter() - t
        if not fault:
            low = compare.readings(job, *ctx, precision="fp8")
            got.update({f"control.{k}": v for k, v in low.items()})
    else:
        from bench.compare import serve as compare
        got = compare.control(job, *ctx) if not fault else {
            "logit_gap": compare.numbers(job, *ctx)[0]["logit_gap"]["value"]}
    got["e2e"] = out["e2e"]
    return got


def sweep(job: Job, rates) -> None:
    import dataclasses
    from bench import stats
    from bench.drivers import serve
    model, qparams, recipe, astates = serve.prepare(job)
    for rate in rates:
        j = dataclasses.replace(job, traffic=dict(job.traffic, rate=rate))
        out, _ = serve.window(j, model, qparams, recipe, astates)
        rec = out["record"]
        lo, hi = rec["window"]
        t_begin, due = rec["due"]
        first = {}
        for t, rid in rec["tokens"]:
            first.setdefault(rid, t)
        mid = (lo + hi) / 2
        halves = [[first[r] - t_begin - due[r] for r in first
                   if a < first[r] <= b] for a, b in ((lo, mid), (mid, hi))]
        print(json.dumps({"workload": job.workload, "seed": job.seed,
                          "rate": rate, **out["e2e"],
                          "ttft_p90_ms_halves": [1e3 * stats.percentile(h, 90)
                                                 for h in halves if h],
                          "backlog": rec["backlog"], "active": rec["active"],
                          "late_max_s": max(rec["lag"])}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates")
    args = ap.parse_args(argv)
    import torch
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        job = Job(workload=args.workload, config=spec.config(cell["config"]),
                  traffic=spec.traffic(cell["traffic"]),
                  limits=spec.limits(args.workload), seed=seed,
                  seconds=args.seconds, trace=False,
                  device=torch.device("cuda"), t0=time.perf_counter())
        if args.rates:
            sweep(job, [float(r) for r in args.rates.split(",")])
            continue
        got = readings(job, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, **got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
