"""Serving: ``repro_torch.serve``'s ``Scheduler`` over a ``ServeEngine`` of
a quantized model, under an open loop of requests arriving at a rate fixed
in the mix.

Set-up makes the weights from the seed, quantizes them through the port's
own export (``quantize_blocks`` with the mix's ``export`` recipe and no
reconstruction steps), frees the float weights and builds the engine,
which warms and captures every prefill bucket and the decode step. Then
requests arrive for ``ramp_s`` seconds before the window opens, so it
starts from a steady mix of requests in flight.

The requests: ``rate * (ramp_s + seconds)`` of them, whose prompt and
output lengths sit at the midpoints of equal-probability strata of their
log-uniform ranges, and whose gaps between arrivals sit at the midpoints
of the strata of an exponential distribution, scaled so that the last one
is due at the window's end (a mean gap of ``1 / rate``). The mix's
``schedule_seed`` shuffles them (sizes and gaps apart) once: every run
replays the same schedule, as a recorded trace is replayed, because the
order alone moved the 90th percentile of time to first token by a factor
of two between seeds at 4/5 of the knee. The run's seed draws the weights
and the prompt tokens. A request is submitted when it is due.

The benchmark stamps every token the engine hands back (host clock, after
the call's own sync): ``output_tokens_per_s`` is the tokens emitted in the
window over its time, ``ttft_p90_ms`` the 90th percentile over every
request whose first token came in the window, from when it was due, and
``itl_p95_ms`` the 95th percentile of every gap between two consecutive
tokens of a request inside the window.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Dict, List

import numpy as np

from bench import stats, weights
from bench.harness import Job, Profile, annotate, now, telemetry


def pool(traffic: Dict[str, Any], seconds: float):
    """(prompt lengths, output lengths, arrival times from the loop's
    start) of every request that arrives in the ramp and the window:
    ``rate * (ramp_s + seconds)`` of them, the last due at the window's
    end, in the order the mix's ``schedule_seed`` fixes."""
    span = traffic["ramp_s"] + seconds
    n = max(1, round(traffic["rate"] * span))
    rng = np.random.default_rng(traffic["schedule_seed"])
    u = (np.arange(n) + 0.5) / n

    def strata(lo: int, hi: int) -> np.ndarray:
        vals = np.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
        return np.clip(np.rint(vals), lo, hi).astype(np.int64)

    prompts = strata(*traffic["prompt_len"])[rng.permutation(n)]
    outputs = strata(*traffic["output_len"])[rng.permutation(n)]
    gaps = -np.log1p(-u)[rng.permutation(n)]
    return prompts, outputs, np.cumsum(gaps) * (span / gaps.sum())


def prompt_tokens(seed: int, index: int, n: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng([weights.stream_seed(seed, "prompt") % 2**63,
                                 index])
    return rng.integers(0, vocab, size=n, dtype=np.int64)


class _Stamps:
    """The engine as the scheduler sees it, with every token it hands back
    stamped on the host clock, every prefill's prompt lengths, every
    decode step's active slots, and every finished request kept."""

    def __init__(self, engine):
        self._e = engine
        self.tokens: List[tuple] = []   # (t, rid)
        self.admits: List[tuple] = []   # (t0, t1, bucket, [prompt lengths])
        self.steps: List[tuple] = []    # (t0, t1, tokens)
        self.finished: Dict[int, List[int]] = {}

    def __getattr__(self, name):
        return getattr(self._e, name)

    def admit(self, requests):
        t0 = now()
        pairs = self._e.admit(requests)
        t1 = now()
        lens = [len(t) for _, t, _ in requests]
        self.admits.append((t0, t1, self._e.bucket_for(max(lens)), lens))
        self.tokens.extend((t1, rid) for rid, _ in pairs)
        return pairs

    def step(self):
        t0 = now()
        pairs = self._e.step()
        t1 = now()
        self.steps.append((t0, t1, len(pairs)))
        self.tokens.extend((t1, rid) for rid, _ in pairs)
        return pairs

    def drain_finished(self):
        out = self._e.drain_finished()
        for rid, toks in out:
            self.finished[rid] = list(toks)
        return out


def _export(job: Job, model, params):
    """Quantize the float weights through the port's export; returns
    (quantized tree, recipe, activation states)."""
    import torch
    from repro_torch.core.quant_config import QuantRecipe
    from repro_torch.core.reconstruct import quantize_blocks
    ex = job.traffic["export"]
    last = job.arch["n_layers"] - 1
    rules = tuple(f"layers.{last if i < 0 else i}.*:w_bits={ex['wide_bits']}"
                  for i in ex["wide_layers"])
    recipe = QuantRecipe(**ex["recipe"], rules=rules, seed=int(job.seed))
    calib = weights.tokens(job.seed, "calib", (1, ex["calib_len"]),
                           job.arch["vocab"], job.device)
    x0, blocks, assemble = model.quant_blocks(params, calib)
    finalized, astates, _ = quantize_blocks(blocks, recipe, x0)
    qparams = assemble(finalized)
    del x0, blocks, assemble, finalized
    if job.device.type == "cuda":
        torch.cuda.empty_cache()
    return qparams, recipe, astates


def _capture_shapes(shapes: Dict[int, list]):
    """Wrap K1 and K2's entries in the dispatch module so each call made
    while a CUDA graph is being captured records (kernel, M, K, N, bits);
    returns the undo."""
    import torch
    from repro_torch.kernels import ops
    orig = {"dequant_matmul_w4": ops.dequant_matmul_w4,
            "dequant_matmul_w8": ops.dequant_matmul_w8}

    def wrap(name, fn, bits):
        def recorded(x, codes, scale, zero):
            if torch.cuda.is_current_stream_capturing():
                shapes.setdefault(x.shape[0], []).append(
                    (name, x.shape[0], x.shape[1], codes.shape[1], bits))
            return fn(x, codes, scale, zero)
        return recorded

    ops.dequant_matmul_w4 = wrap("dequant_matmul_w4", orig["dequant_matmul_w4"], 4)
    ops.dequant_matmul_w8 = wrap("dequant_matmul_w8", orig["dequant_matmul_w8"], 8)

    def undo():
        ops.dequant_matmul_w4 = orig["dequant_matmul_w4"]
        ops.dequant_matmul_w8 = orig["dequant_matmul_w8"]
    return undo


def run(job: Job) -> Dict[str, Any]:
    """The timed run, then the comparison with the reference."""
    out, ctx = program(job)
    from bench.compare import serve as compare
    checks, failed = compare.numbers(job, *ctx)
    out.update(checks=checks, failed=failed)
    return out


def program(job: Job):
    """The program's run: (outcome, (recipe, the finished requests)), the
    program's state freed."""
    import torch
    model, qparams, recipe, astates = prepare(job)
    out, finished = window(job, model, qparams, recipe, astates)
    del model, qparams, astates
    if job.device.type == "cuda":
        torch.cuda.empty_cache()
    return out, (recipe, finished)


def prepare(job: Job):
    """The served model: (model, quantized weights, recipe, activation
    states); the float weights are freed."""
    from repro_torch.configs import ArchConfig
    from repro_torch.models import build_model
    model = build_model(ArchConfig(**job.arch))
    params = weights.program_params(job.arch, job.seed, job.device)
    qparams, recipe, astates = _export(job, model, params)
    return model, qparams, recipe, astates


def window(job: Job, model, qparams, recipe, astates):
    """Build the engine (its captures warm every shape), run the ramp and
    the window; returns (outcome, {rid: (prompt, served tokens)} of every
    request finished)."""
    import torch
    from repro_torch.core.context import QuantCtx
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.serve.scheduler import Request, Scheduler

    tr, arch, dev = job.traffic, job.arch, job.device
    cuda = dev.type == "cuda"
    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
    ecfg = EngineConfig(slots=tr["slots"], max_len=tr["max_len"],
                        prefill_group=tr["prefill_group"], kv_quant=tr["kv_int8"],
                        min_bucket=tr["min_bucket"])
    shapes: Dict[int, list] = {}
    undo = _capture_shapes(shapes) if job.trace and cuda else None
    try:
        engine = ServeEngine(model, qparams, ctx, ecfg, device=dev)
    finally:
        if undo is not None:
            undo()
    prompts, outputs, due = pool(tr, job.seconds)
    eng = _Stamps(engine)
    lag: List[float] = []   # how late each request was submitted
    sent = 0
    prof = Profile() if job.trace else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    with telemetry(job.trace) as sink, Scheduler(eng) as sched, \
            contextlib.ExitStack() as stack:
        if prof is not None:
            stack.callback(prof.close)
        t_begin = now()
        t_start = t_stop = prof_end = None
        while True:
            t = now()
            while sent < len(due) and t_begin + due[sent] <= t:
                toks = prompt_tokens(job.seed, sent, int(prompts[sent]), arch["vocab"])
                lag.append(now() - t_begin - due[sent])
                sched.submit(Request(rid=sent, tokens=toks,
                                     max_new=int(outputs[sent])))
                sent += 1
            if eng.active or not sched.backlog.empty():
                with annotate("bench.pump"):
                    sched.pump()
            elif sent < len(due):  # nothing to do until the next arrival
                time.sleep(max(0.0, min(t_begin + due[sent] - now(), 0.002)))
            t = now()
            if t_start is None:
                if t >= t_begin + tr["ramp_s"]:
                    if prof is not None:
                        prof.start()
                    t_start = now()
                continue
            if prof is not None and prof_end is None and t >= t_start + tr["trace_s"]:
                prof.stop()
                prof_end = (t, now())
            if t >= t_start + job.seconds:
                t_stop = t
                backlog = sched.backlog.qsize()
                break
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if prof is not None:
        if prof_end is None:
            prof.stop()
            prof_end = (t_stop, now())
        prof.read()
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}
    gaps: List[float] = []
    n_tokens = 0
    for t, rid in eng.tokens:
        if t_start < t <= t_stop:
            n_tokens += 1
            if rid in last and last[rid] > t_start:
                gaps.append(t - last[rid])
        if rid not in first:
            first[rid] = t
        last[rid] = t
    ttft = [first[r] - t_begin - due[r] for r in first if t_start < first[r] <= t_stop]
    window_s = t_stop - t_start
    out = {
        "attempted": len(ttft),
        "e2e": {"output_tokens_per_s": n_tokens / window_s,
                "ttft_p90_ms": 1e3 * stats.percentile(ttft, 90),
                "itl_p95_ms": 1e3 * stats.percentile(gaps, 95),
                "setup_s": t_start - job.t0},
        "memory_peak_bytes": peak,
        "record": {
            "kind": "serve", "workload": job.workload, "arch": arch, "traffic": tr,
            "window": (t_start, t_stop),
            # span metrics are read where the profiler was off
            "clean": (prof_end[1], t_stop) if prof is not None else (t_start, t_stop),
            "traced": (t_start, prof_end[0]) if prof is not None else None,
            "spans": [] if sink is None else sink.spans,
            "trace": None if prof is None else prof.summary,
            "admits": eng.admits, "steps": eng.steps,
            "prompt_of": {r: int(prompts[r]) for r in range(sent)},
            "due": (t_begin, due[:sent].tolist()), "lag": lag,
            "backlog": backlog, "active": engine.active,
            "tokens": eng.tokens, "shapes": shapes,
            "slots": tr["slots"], "group": tr["prefill_group"],
        },
    }
    finished = {r: (prompt_tokens(job.seed, r, int(prompts[r]), arch["vocab"]),
                    toks) for r, toks in eng.finished.items()}
    del engine, eng
    if cuda:
        torch.cuda.empty_cache()
    return out, finished
