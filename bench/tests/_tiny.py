"""Tiny jobs of the real cells for CPU tests: the cell's own traffic and
limits, a configuration cut to a few layers of width 64."""
from __future__ import annotations

import dataclasses
import time

from bench import env

env.prepare()

import torch  # noqa: E402

from bench import spec  # noqa: E402
from bench.harness import Job  # noqa: E402


def tiny_job(workload: str, seed: int = 2**31 + 11, dtype: str = "float32",
             trace: bool = False, seconds: float = 3.0) -> Job:
    from repro_torch.configs import get_config, reduced
    cell = spec.cell(workload)
    name = cell["config"]
    tr = spec.traffic(cell["traffic"])
    if tr["kind"] == "ptq":
        layers = 5
        tr.update(calib_seqs=8, seq_len=32)
        # few steps: at width 64 the two sides' errors after a block's
        # last step walk apart faster than at the cell's width
        tr["recipe"]["iters"] = 8
    else:  # wide enough that the fp8 control's widest gap reads as at size
        layers = 3
        tr.update(rate=40.0, slots=4, max_len=64, prefill_group=2,
                  min_bucket=8, prompt_len=[4, 24], output_len=[4, 24],
                  ramp_s=0.5, trace_s=0.5, check_tokens=200)
        tr["export"]["calib_len"] = 8
    arch = dataclasses.asdict(dataclasses.replace(
        reduced(get_config(name)), n_layers=layers, dtype=dtype))
    if tr["kind"] == "serve":
        arch.update(d_model=256, n_heads=4, n_kv_heads=min(arch["n_kv_heads"], 4),
                    head_dim=64, d_ff=512, vocab=8192)
    return Job(workload=workload, config={"arch": arch, "reference": "dense"},
               traffic=tr,
               limits=spec.limits(workload), seed=seed, seconds=seconds,
               trace=trace, device=torch.device("cpu"), t0=time.perf_counter())
