"""BENCHMARK.json against the contract the harness is built to, and every
file it names found by name."""
import json
import re

from bench import env, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench():
    return spec.benchmark()


def test_top_level_keys_and_size():
    b = bench()
    assert set(b) == KEYS
    assert (env.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert b["paths"] == ["bench"]
    assert 1 <= b["run_seconds"] <= 51


def test_names_units_and_keys():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_the_contract_asks():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in spec.end_to_end(b, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per = spec.per_layer(b, w["name"])
        assert per
        for m in per:  # a metric's cells report the metric it moves
            assert m["moves"] in e2e


def test_files_found_by_name():
    b = bench()
    for c in b["configs"]:
        cfg = json.loads((env.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and "arch" in cfg
        assert spec.config(c["name"]) == cfg
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        tr = spec.traffic(w["traffic"])
        assert spec.driver(tr["kind"]).run
        assert spec.limits(w["name"])
        spec.reference(spec.config(w["config"])["reference"])
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_metric_readers_find_nothing_in_an_empty_record():
    b = bench()
    for kind in ("ptq", "serve"):
        rec = {"kind": kind, "spans": [], "trace": None, "window": (0.0, 1.0),
               "clean": (0.0, 1.0), "clean_steps": 0, "admits": [], "steps": [],
               "tokens": [], "shapes": {}, "card": None, "traced": None}
        for m in b["per_layer"]:
            assert spec.metric_reader(m["name"]).read(rec) is None
