"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration is ``bench/configs/<config>.json``, the mix
``bench/traffic/<traffic>.json`` (its ``kind`` picks the general driver
``bench/drivers/<kind>.py``), the limits of the comparison that decides
``correct`` ``bench/limits/<workload>.json``, and each per-layer metric
``bench/metrics/<metric>.py`` (see ``metric_reader``), a module with
``read(record) -> float | None``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

from bench.env import BENCH, ROOT


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Dict[str, Any] = None) -> Dict[str, Any]:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"bench: no workload {name!r} in BENCHMARK.json "
                     f"(have {[w['name'] for w in bench['workloads']]})")


def config(name: str) -> Dict[str, Any]:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> Dict[str, Any]:
    return _json(BENCH / "traffic" / f"{name}.json")


def limits(workload: str) -> Dict[str, float]:
    return _json(BENCH / "limits" / f"{workload}.json")["limits"]


def driver(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def reference(name: str):
    return importlib.import_module(f"bench.reference.{name}")


def metric_reader(name: str):
    """The reader module of per-layer metric ``name``: its own file, or,
    where it has none, the file of its name less the last dotted part, the
    quantity that the metric splits by the end-to-end metric it moves
    (``device.idle_share.ptq`` is read by ``device.idle_share.py``). A file
    name may hold dots, so it is loaded by path."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = BENCH / "metrics" / f"{name.rpartition('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict[str, Any], workload: str,
             e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e_names


def end_to_end(bench: Dict[str, Any], workload: str) -> List[Dict[str, Any]]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer(bench: Dict[str, Any], workload: str) -> List[Dict[str, Any]]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    names = [m["name"] for m in end_to_end(bench, workload)]
    return [m for m in bench["per_layer"] if _applies(m, workload, names)]
