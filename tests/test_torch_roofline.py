"""Port parity: the roofline (``repro_torch/roofline``: ``analytic``,
``analysis``, ``report``) and ``ArchConfig.param_count`` against the
reference.

- ``flops_cell_total``, ``hbm_bytes_cell``, ``cache_bytes``,
  ``model_flops_ideal``, ``model_flops`` and ``param_count`` equal the
  reference's exactly (the same float arithmetic in the same order) for
  every arch x shape x weights x mode x kv x n_dev in {1, 256, 512};
- ``analysis.analyze`` gives the analytic terms of the reference's
  ``analyze_compiled`` exactly (flops and bytes per device, model flops,
  the useful-flops ratio), priced on the card's row: compute and memory
  seconds, the bottleneck and the bound from the H100's published peaks;
- ``report.summary``/``markdown`` of a fixed results list equal the
  reference's, but for the memory line, which names the card's memory;
- an unknown card raises, naming it; no TPU constant is in the port's
  roofline or in ``chip_smoke.py``, which reads the card's peaks from
  ``analysis.CARD_PEAKS``;
- ``analysis.analyze_traced`` adds the collective term on the card's link
  (``link_bytes_per_s``: one 400 Gb/s port per GPU), and the bound, the
  bottleneck and the roofline fraction take all three terms;
  ``roofline.collectives`` counts each functional collective of a traced
  graph once, by the reference's kinds, at its result's bytes (the
  ``wait_tensor`` that follows it not counted), and the report renders
  the collective column for such records.
"""
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.roofline import analysis as janalysis
from repro.roofline import analytic as janalytic
from repro.roofline import report as jreport
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config
from repro_torch.roofline import analysis, analytic, report

H100 = "NVIDIA H100 80GB HBM3"
ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ("bf16", "int8", "int4")
MODES = ("dp", "tp", "fsdp")
KVS = ("bf16", "int8")
N_DEV = (1, 256, 512)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    for name, shape in SHAPES.items():
        js = JSHAPES[name]
        assert analytic.flops_cell_total(cfg, shape) == \
            janalytic.flops_cell_total(jcfg, js)
        for training in (False, True):
            assert analytic.flops_cell(cfg, shape, training) == \
                janalytic.flops_cell(jcfg, js, training)
        assert analytic.cache_bytes(cfg, shape) == \
            janalytic.cache_bytes(jcfg, js)
        assert analytic.model_flops_ideal(cfg, shape) == \
            janalytic.model_flops_ideal(jcfg, js)
        for n in N_DEV:
            assert analysis.model_flops(cfg, shape, n) == \
                janalysis.model_flops(jcfg, js, n)
            for w in WEIGHTS:
                for mode in MODES:
                    for kv in KVS:
                        assert analytic.hbm_bytes_cell(
                            cfg, shape, w, mode=mode, n_dev=n, kv=kv) == \
                            janalytic.hbm_bytes_cell(
                                jcfg, js, w, mode=mode, n_dev=n, kv=kv), \
                            (name, n, w, mode, kv)


def _reference_terms(jcfg, js, n, w, mode, kv):
    """The reference's ``analyze_compiled`` on a stand-in compiled program
    with no collectives (its analytic terms do not read the program)."""
    compiled = types.SimpleNamespace(cost_analysis=lambda: {},
                                     as_text=lambda: "")
    mesh = types.SimpleNamespace(devices=np.empty(n))
    return janalysis.analyze_compiled(compiled, jcfg, js, mesh, weights=w,
                                      mode=mode, kv=kv)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyze_gives_the_reference_terms_on_the_card(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    card = analysis.peaks(H100)
    for name, shape in SHAPES.items():
        for n in N_DEV:
            for w, mode, kv in (("bf16", None, "bf16"), ("int4", "dp", "int8"),
                                ("int8", "fsdp", "bf16")):
                got = analysis.analyze(cfg, shape, n, w, mode, kv, card)
                want = _reference_terms(jcfg, JSHAPES[name], n, w, mode, kv)
                for k in ("flops_per_device", "bytes_per_device",
                          "model_flops_global", "model_flops_per_device",
                          "useful_flops_ratio"):
                    assert got[k] == want[k], (name, n, w, k)
                assert "collective_s" not in got
                assert not any(k.startswith("hlo_raw") for k in got)
                compute = got["flops_per_device"] / 989e12
                memory = got["bytes_per_device"] / 3.35e12
                assert (got["compute_s"], got["memory_s"]) == (compute, memory)
                assert got["step_time_bound_s"] == max(compute, memory)
                assert got["bottleneck"] == ("compute" if compute >= memory
                                             else "memory")
                assert got["card"] == H100


def test_planned_cells_on_the_card():
    """The smollm-135m cells of ``chip_smoke.py`` (batch = global / 16,
    one device): the bounds it reports beside its measurements."""
    cfg = get_config("smollm-135m")
    card = analysis.peaks(H100)
    train = analysis.analyze(cfg, ShapeSpec("train_4k", 4096, 16, "train"),
                             1, card=card)
    assert train["bottleneck"] == "compute"
    assert 1.4e14 < train["flops_per_device"] < 1.5e14
    decode = analysis.analyze(cfg, ShapeSpec("decode_32k", 32768, 8,
                                             "decode"), 1, "bf16", card=card)
    assert decode["bottleneck"] == "memory"
    assert 1.8e-3 < decode["step_time_bound_s"] < 2.0e-3


def _results():
    """A fixed results list in the reference's record format."""
    def ok(cell, peak_gib, c, m, coll, frac, ratio):
        terms = {"compute": c, "memory": m, "collective": coll}
        return {"cell": cell, "status": "ok",
                "memory": {"peak_bytes_per_device": peak_gib * 2**30},
                "analysis": {"compute_s": c, "memory_s": m,
                             "collective_s": coll,
                             "bottleneck": max(terms, key=terms.get),
                             "useful_flops_ratio": ratio,
                             "roofline_fraction": frac}}
    return [ok("smollm-135m|decode_32k|16x16|int8", 2.5, 1e-5, 2e-3, 1e-4,
               0.003, 0.91),
            ok("qwen2.5-14b|train_4k|16x16|bf16", 120.0, 0.9, 0.2, 0.4,
               0.31, 0.72),
            ok("llama4-scout-17b-a16e|prefill_32k|16x16|int4", 95.5, 0.5,
               0.3, 0.8, 0.12, 0.55),
            ok("olmo-1b|decode_32k|2x16x16|int8", 4.0, 2e-5, 4e-3, 1e-2,
               0.0009, 0.88),
            {"cell": "qwen2.5-14b|long_500k|16x16|int8", "status": "skipped",
             "reason": "pure full-attention arch: long_500k requires "
                       "sub-quadratic attention (skip noted in DESIGN.md)"},
            {"cell": "deepseek-v3-671b|train_4k|16x16|bf16",
             "status": "error", "error": "RESOURCE_EXHAUSTED: out of memory"}]


def test_report_renders_as_the_reference(tmp_path):
    path = tmp_path / "results.json"
    path.write_text(json.dumps(_results()))
    cells, jcells = report.load([str(path)]), jreport.load([str(path)])
    assert cells == jcells
    assert report.markdown(cells) == jreport.markdown(jcells)
    card = analysis.peaks(H100)
    got = report.summary(cells, card).splitlines()
    want = jreport.summary(jcells).splitlines()
    i = next(j for j, line in enumerate(want) if "cells over" in line)
    assert got[i] == f"  cells over the {H100}'s 80 GB: 2"
    assert got[:i] + got[i + 1:] == want[:i] + want[i + 1:]
    # the port's own records: no collective term, the card they name
    port = {"x|decode": {"cell": "x|decode", "status": "ok",
                         "memory": {"peak_bytes_per_device": 1e9},
                         "analysis": analysis.analyze(
                             get_config("smollm-135m"), SHAPES["decode_32k"],
                             256, "int8", card=card)}}
    assert "| — |" in report.markdown(port)
    assert "80 GB: 0" in report.summary(port)


def test_unknown_card_raises_naming_it(monkeypatch):
    """No default row: a name outside the table raises, and so does the
    current card's when it has none."""
    with pytest.raises(analysis.UnknownCardError, match="Tesla K80"):
        analysis.peaks("Tesla K80")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "Tesla K80")
    with pytest.raises(analysis.UnknownCardError, match="Tesla K80"):
        analysis.analyze(get_config("smollm-135m"), SHAPES["decode_32k"], 1)
    row = analysis.peaks(H100)
    assert row.ops == {"bfloat16": 989e12, "int8": 1979e12,
                       "float32": 67e12}
    assert (row.hbm_bytes_per_s, row.hbm_bytes) == (3.35e12, 80e9)


def test_dtype_bytes():
    for dt, n in ((torch.int8, 1), ("bfloat16", 2), (torch.float32, 4),
                  ("int4", 0.5), (torch.uint8, 1), (torch.int64, 8)):
        assert analysis.dtype_bytes(dt) == n
    for dt in (torch.float32, torch.bfloat16, torch.int8, torch.int32,
               torch.uint8, torch.float16, torch.bool, torch.int64):
        assert analysis.dtype_bytes(dt) == torch.empty(0, dtype=dt
                                                       ).element_size()
    with pytest.raises(analysis.UnknownDtypeError, match="qint8"):
        analysis.dtype_bytes(torch.qint8)


def test_no_tpu_constant_in_the_port_roofline_or_the_smoke_run():
    tpu = re.compile(r"197e12|819e9|50e9|v5e|\bTPU\b|\bICI\b|LINK_BW")
    for f in sorted((ROOT / "src" / "repro_torch" / "roofline").glob("*.py")):
        assert not tpu.search(f.read_text()), f.name
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "989e12" not in smoke and "3.35e12" not in smoke
    assert "CARD_PEAKS" in smoke or "analysis.peaks" in smoke


def test_card_link_rate():
    assert analysis.peaks(H100).link_bytes_per_s == 400e9 / 8


def _traced_record(card):
    coll = {"all-gather": 20_000_000, "all-reduce": 10_000_000,
            "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    mesh = types.SimpleNamespace(shape=(16, 16),
                                 mesh_dim_names=("data", "model"))
    return coll, analysis.analyze_traced(
        coll, get_config("smollm-135m"), SHAPES["decode_32k"], mesh, "int8",
        card=card)


def test_analyze_traced_adds_the_collective_term():
    card = analysis.peaks(H100)
    coll, got = _traced_record(card)
    base = analysis.analyze(get_config("smollm-135m"), SHAPES["decode_32k"],
                            256, "int8", card=card)
    for k in ("flops_per_device", "bytes_per_device", "compute_s", "memory_s",
              "model_flops_per_device", "useful_flops_ratio"):
        assert got[k] == base[k], k
    assert got["collective_breakdown"] == coll
    assert got["collective_bytes_per_device"] == 30e6
    assert got["collective_s"] == 30e6 / (400e9 / 8)
    terms = {"compute": got["compute_s"], "memory": got["memory_s"],
             "collective": got["collective_s"]}
    assert got["bottleneck"] == max(terms, key=terms.get) == "collective"
    assert got["step_time_bound_s"] == got["collective_s"]
    assert got["roofline_fraction"] == (
        got["model_flops_per_device"] / card.ops["bfloat16"]
        / got["collective_s"])


def test_report_renders_the_collective_column():
    card = analysis.peaks(H100)
    _, traced = _traced_record(card)
    rec = {"cell": "x|decode", "status": "ok",
           "memory": {"peak_bytes_per_device": 1e9}, "analysis": traced}
    row = report.markdown({"x|decode": rec}).splitlines()[-1]
    assert f"| {traced['collective_s']:.2e} | collective |" in row
    assert "—" not in row
    assert "collective-bound: 1 cells" in report.summary({"x|decode": rec})


def test_collectives_counted_once_by_kind():
    """A traced program of four functional collectives on a fake group of
    4 ranks: each counted once at its result's bytes."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.launch import dryrun
    from repro_torch.roofline import collectives

    def prog(x):
        g = dist.group.WORLD
        a = fc.all_reduce(x, "sum", g)                       # (8, 16) f32
        b = fc.all_gather_single(x, 0, g)                    # (32, 16)
        c = fc.reduce_scatter_single(x, "sum", 0, g)         # (2, 16)
        d = fc.all_to_all_single(x.to(torch.bfloat16), None, None, g)
        return a, b, c, d

    with dryrun.fake_world(4):
        gm = make_fx(prog, tracing_mode="fake")(torch.zeros(8, 16))
    assert collectives.collective_counts(gm) == {
        "all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
        "all-to-all": 1}
    assert collectives.collective_bytes(gm) == {
        "all-reduce": 8 * 16 * 4, "all-gather": 32 * 16 * 4,
        "reduce-scatter": 2 * 16 * 4, "all-to-all": 8 * 16 * 2,
        "collective-permute": 0}
    waits = [n for n in gm.graph.nodes if "wait_tensor" in str(n.target)]
    assert waits and not any(collectives.kind_of(n) for n in waits)
