"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a tiny size (the chip's look skipped): a sound run is
correct, the control reads above every limit it is held to, and each fault
the cell can have, planted underneath, makes ``correct`` false."""
import math

import pytest

from _tiny import tiny_job
from bench import faults, spec
from bench.run import correct_of

PTQ = "olmo-1b.ptq.w4a8"
SERVES = ("qwen2.5-14b.serve.chat", "olmo-1b.serve.longdoc")


def run(job, fault=None):
    drv = spec.driver(job.traffic["kind"])
    if fault is None:
        return drv.run(job)
    with faults.FAULTS[fault]():
        return drv.run(job)


def test_ptq_sound_run_is_correct():
    out = run(tiny_job(PTQ))
    assert correct_of(out["checks"]), out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["e2e"]["ptq_steps_per_s"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_export"])
def test_ptq_fault_is_caught(fault):
    out = run(tiny_job(PTQ), fault)
    assert not correct_of(out["checks"]), out["checks"]
    assert out["failed"] >= 1


def test_ptq_control_fails():
    from bench.compare import ptq as compare
    job = tiny_job(PTQ)
    _, ctx = spec.driver("ptq").program(job)
    low = compare.numbers(job, *ctx, precision="fp8")
    assert not correct_of(low), low


@pytest.mark.parametrize("workload", SERVES)
def test_serve_sound_run_is_correct(workload):
    out = run(tiny_job(workload))
    assert correct_of(out["checks"]), out["checks"]
    e2e = out["e2e"]
    assert e2e["output_tokens_per_s"] > 0
    assert math.isfinite(e2e["ttft_p90_ms"]) and math.isfinite(e2e["itl_p95_ms"])


@pytest.mark.parametrize("workload", SERVES)
def test_serve_altered_token_is_caught(workload):
    out = run(tiny_job(workload), "altered_token")
    assert not correct_of(out["checks"]), out["checks"]


@pytest.mark.parametrize("workload", SERVES)
def test_serve_control_fails(workload):
    from bench.compare import serve as compare
    job = tiny_job(workload)
    _, ctx = spec.driver("serve").program(job)
    got = compare.control(job, *ctx)
    assert got["control_gap"] > job.limits["logit_gap"] >= got["logit_gap"], got
