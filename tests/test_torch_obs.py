"""The port's observability layer (``repro_torch.obs``) against
``repro.obs``: histogram percentiles, span nesting, the disabled fast path,
the run manifest, and a launcher run's JSONL event stream checked by the
reference's own validator."""
import json

import numpy as np
import pytest
import torch

from repro.obs import sink as jsink
from repro.obs.telemetry import Histogram as JHistogram
from repro_torch.launch import quantize
from repro_torch.obs import serve_metrics, sink, telemetry
from repro_torch.obs.telemetry import TELEMETRY, Histogram

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated_registry():
    TELEMETRY.reset()
    yield
    TELEMETRY.reset()


@pytest.mark.parametrize("samples", [
    [], [5.0], [1.0, 2.0, 3.0, 4.0], [3.0, 3.0, 1.0, 9.0, 9.0],
    list(np.random.default_rng(0).lognormal(3.0, 1.0, 101)),
], ids=["empty", "one", "four", "ties", "lognormal101"])
def test_histogram_percentiles_equal_the_reference(samples):
    h, jh = Histogram("x"), JHistogram("x")
    for v in samples:
        h.observe(v)
        jh.observe(v)
    for q in (0, 25, 50, 95, 99, 100):
        assert h.percentile(q) == jh.percentile(q)
        if samples:
            np.testing.assert_allclose(h.percentile(q),
                                       np.percentile(samples, q), rtol=1e-12)
    assert h.summary() == jh.summary()


def test_spans_nest_and_land_in_the_sink():
    rec = sink.ListSink()
    man = sink.RunManifest.collect(device="cpu")
    with TELEMETRY.enabled_scope(sink=rec, manifest=man):
        with telemetry.span("outer", block="b0") as outer:
            with telemetry.span("inner", sync=torch.zeros(2)):
                assert TELEMETRY.current_span() == "inner"
            outer.annotate(steps=3)
    assert not TELEMETRY.enabled and TELEMETRY.current_span() is None
    kinds = [r["kind"] for r in rec.records]
    assert kinds == ["manifest", "span", "span"]
    inner, outer = rec.records[1], rec.records[2]
    assert (inner["name"], inner["depth"], inner["parent"], inner["synced"]) \
        == ("inner", 1, "outer", True)
    assert (outer["name"], outer["depth"], outer["parent"], outer["synced"]) \
        == ("outer", 0, None, False)
    assert outer["attrs"] == {"block": "b0", "steps": 3}
    assert outer["dur_us"] >= inner["dur_us"] >= 0
    assert all(r["schema"] == sink.SCHEMA_VERSION for r in rec.records)
    snap = telemetry.snapshot()["histograms"]
    assert snap["span.inner"]["count"] == snap["span.outer"]["count"] == 1


def test_disabled_path_reads_no_clock_and_syncs_nothing(monkeypatch):
    def clock():
        raise AssertionError("the disabled path read the clock")

    def synchronize(*a):
        raise AssertionError("the disabled path synchronized a device")

    monkeypatch.setattr(telemetry, "_clock", clock)
    monkeypatch.setattr(telemetry, "_wall", clock)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    assert not TELEMETRY.enabled
    a = telemetry.span("recon.chunk", sync=torch.zeros(1), block="b")
    b = telemetry.span("serve.prefill")
    assert a is b is telemetry._NULL_SPAN
    with a as sp:
        sp.annotate(x=1)
        sp.block_on(torch.zeros(1))
    TELEMETRY.emit({"kind": "span"})  # no sink: dropped
    assert telemetry.snapshot()["histograms"] == {}


def test_block_on_synchronizes_only_cuda_devices(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    telemetry.block_on({"a": [torch.zeros(1), (torch.ones(2),)], "b": None})
    assert synced == []


def test_run_manifest_fields_and_round_trip():
    from repro_torch.core.quant_config import QuantRecipe
    m = sink.RunManifest.collect(backend="torch", device="cpu",
                                 recipe=QuantRecipe(w_bits=4))
    assert (m.device, m.backend, m.torch_version) == ("cpu", "torch",
                                                      torch.__version__)
    assert m.n_devices == torch.cuda.device_count()
    assert m.recipe_digest == sink.digest(QuantRecipe(w_bits=4))
    assert sink.RunManifest.from_dict(dict(m.to_dict(), extra=1)) == m
    assert m.record()["kind"] == "manifest"
    assert m.brief() == {"git_sha": m.git_sha, "schema_version": 1}


def test_launcher_event_stream_passes_the_reference_validator(tmp_path):
    res = quantize.main([
        "--arch", "smollm-135m", "--smoke", "--w-bits", "4", "--a-bits", "8",
        "--iters", "2", "--calib", "4", "--seq", "8", "--device", "cpu",
        "--serve", "--serve-requests", "3", "--serve-max-new", "4",
        "--telemetry", str(tmp_path / "tel"), "--out", str(tmp_path / "q")])
    assert not TELEMETRY.enabled
    path = str(tmp_path / "tel" / "events.jsonl")
    assert jsink.validate_events(path) == []
    assert sink.validate_events(path) == []
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["kind"] == "manifest" and recs[0]["device"] == "cpu"
    assert recs[-1]["kind"] == "snapshot"
    spans = {}
    for r in recs:
        if r["kind"] == "span":
            spans.setdefault(r["name"], []).append(r)
    assert {"recon.block", "recon.chunk", "serve.build", "serve.prefill",
            "serve.decode_step", "serve.pump"} <= set(spans)
    assert len(spans["recon.block"]) == len(spans["recon.chunk"]) == 2
    assert all(r["parent"] == "recon.block" and r["synced"]
               and r["attrs"]["steps"] == 2 for r in spans["recon.chunk"])
    ttft = serve_metrics.percentiles_from_events(recs, "request", "ttft_us")
    assert ttft["count"] == 3
    stats = res.serve["stats"]["requests"]["ttft_us"]
    np.testing.assert_allclose(ttft["max"], stats["max"], atol=1e-3)
