"""On a card: the tiny jobs through the graphed engines and the CUDA
kernels come out correct, and K1/K2's launches are recorded at capture.
Skips without a card (decided inside the test)."""
import dataclasses

import pytest
import torch

from _tiny import tiny_job
from bench import spec
from bench.run import correct_of


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", ["olmo-1b.ptq.w4a8", "qwen2.5-14b.serve.chat",
                                      "olmo-1b.serve.longdoc"])
def test_tiny_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    job = dataclasses.replace(tiny_job(workload, trace=True,
                                       seconds=6.0),
                              device=torch.device("cuda"))
    out = spec.driver(job.traffic["kind"]).run(job)
    assert correct_of(out["checks"]), out["checks"]
    assert out["record"]["trace"]["busy_s"] > 0
    if job.traffic["kind"] == "serve":
        assert out["record"]["shapes"]
