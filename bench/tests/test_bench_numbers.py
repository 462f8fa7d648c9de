"""The frozen counts at the two configurations' shapes, percentiles over
every sample, and the trace reader."""
import json
import statistics

import numpy as np
import pytest

from bench import flops, spec, stats, trace


def arch(name):
    return spec.config(name)["arch"]


def test_olmo_block_and_step_flops():
    a = arch("olmo-1b")
    lin = 4 * 2048 * 2048 + 3 * 2048 * 8192  # wq wk wv wo + swiglu
    assert flops.layer_linear_params(flops.arch_ns(a))["attn"] + \
        flops.layer_linear_params(flops.arch_ns(a))["mlp"] == lin
    # 2 x 2048 tokens; the chunked causal attention computes 3/4 of S^2
    attn = 2 * 16 * (2048 * 3 / 4) * 256
    fwd = 4096 * (2 * lin + attn)
    assert flops.block_forward_flops(a, 2, 2048) == pytest.approx(fwd)
    assert flops.recon_step_flops(a, 2, 2048) == pytest.approx(3 * fwd)
    assert 1.7e12 < flops.recon_step_flops(a, 2, 2048) < 1.9e12


def test_qwen_serving_flops():
    a = arch("qwen2.5-14b")
    per_layer = 2 * 5120 * 5120 + 2 * 5120 * 1024 + 3 * 5120 * 13824
    assert flops.dense_linear_flops_token(a) == pytest.approx(2 * 48 * per_layer)
    head = 2 * 5120 * 152064
    n = 100
    pair = 48 * 2 * 40 * 2 * 128  # one query against one key, all layers
    want = n * 2 * 48 * per_layer + pair * n * (n + 1) / 2 + head
    assert flops.prefill_flops(a, n) == pytest.approx(want)
    assert flops.decode_flops(a, 101) == pytest.approx(
        2 * 48 * per_layer + pair * 101 + head)


def test_dequant_roofline():
    card = {"bfloat16": 989e12, "hbm_bytes_per_s": 3.35e12}
    M, K, N = 32, 5120, 13824
    b = flops.dequant_matmul_bytes(M, K, N, 4)
    assert b == M * K * 2 + K * N / 2 + 8 * N + M * N * 2
    assert flops.least_seconds(flops.dequant_matmul_ops(M, K, N), b, card) \
        == pytest.approx(b / 3.35e12)  # decode: bound by bytes
    big = flops.dequant_matmul_ops(4096, K, N)
    assert flops.least_seconds(big, flops.dequant_matmul_bytes(4096, K, N, 4),
                               card) == pytest.approx(big / 989e12)


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_over_all_samples(q):
    rng = np.random.default_rng(3)
    xs = rng.lognormal(size=1001).tolist()
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    # a tail of all samples, not a median of chunks' tails
    chunks = [stats.percentile(xs[i:i + 100], q) for i in range(0, 1000, 100)]
    assert stats.percentile(xs, q) != pytest.approx(statistics.median(chunks))


def test_trace_window_busy_and_gaps(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "serve.prefill", "ts": 40, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 80, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 200, "dur": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = trace.read(path)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(50e-6)  # [10, 40) and [80, 100)
    assert r["idle_gaps"][0] == ["serve.prefill", pytest.approx(40e-6)]
    assert ["host.unannotated", pytest.approx(10e-6)] in r["idle_gaps"]
    assert r["device_ops"][0][0] in ("k1", "k2", "copy")
    assert all(k[0] != "outside" for k in r["kernels"])
