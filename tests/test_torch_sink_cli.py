"""The port's sink CLI (``python -m repro_torch.obs.sink``) against the
reference's (``python -m repro.obs.sink``) on the same files.

One subprocess per package runs the module as ``python -m`` does
(``runpy.run_module(..., run_name="__main__")``) once for each argument
list, with ``sys.argv[0]`` the same in both, and reports each run's exit
code, standard output and the last line of its standard error (runpy's
warning that names the module left out). Both must
print the same ``OK`` and ``error:`` lines and exit with the same code on:
a telemetry JSONL the port writes under ``TELEMETRY.enabled_scope``; a
JSONL with a bad line, with no manifest, with a future schema, with a
record that has no ``kind``, and one with no records; bench JSON stamped
by the port's ``RunManifest.brief()``, unstamped, with no
``git_sha``, with a string ``schema_version``, and an empty list; a
missing file; both flags at once; and no flag (argparse's usage error,
exit 2).
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.obs import check_bench, sink, telemetry
from repro_torch.obs.telemetry import TELEMETRY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVER = r"""
import contextlib, io, json, runpy, sys
mod, cases = sys.argv[1], json.loads(sys.argv[2])
out = []
for argv in cases:
    sys.argv = ["sink.py"] + argv
    so, se = io.StringIO(), io.StringIO()
    rc = 0
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        try:
            runpy.run_module(mod, run_name="__main__", alter_sys=False)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    # runpy's warning names the module: the one line that may differ
    err = [l for l in se.getvalue().strip().splitlines()
           if "RuntimeWarning" not in l]
    out.append({"rc": rc, "out": so.getvalue(),
                "err": err[-1] if err else ""})
print(json.dumps(out))
"""


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)
    return str(path)


def _jsonl(path, recs):
    return _write(path, "".join(json.dumps(r) + "\n" for r in recs))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sink_cli")
    man = sink.RunManifest.collect(device="cpu")
    events = str(d / "events.jsonl")
    TELEMETRY.reset()
    with TELEMETRY.enabled_scope(sink=sink.JsonlSink(events), manifest=man):
        with telemetry.span("recon.block", block="b0"):
            telemetry.counter("recon.steps").inc(3)
    TELEMETRY._sink = None
    TELEMETRY.reset()
    stamp = man.brief()
    good = man.record()
    return {
        "events": events,
        "bad_line": _write(d / "bad_line.jsonl",
                           json.dumps(good) + "\n{not json\n"),
        "no_manifest": _jsonl(d / "no_manifest.jsonl",
                              [{"kind": "span", "schema": 1, "name": "x"}]),
        "future": _jsonl(d / "future.jsonl",
                         [dict(good, schema=sink.SCHEMA_VERSION + 1)]),
        "no_kind": _jsonl(d / "no_kind.jsonl", [good, {"schema": 1}]),
        "empty_jsonl": _write(d / "empty.jsonl", "\n"),
        "bench_stamped": _write(d / "bench_stamped.json", json.dumps(
            [{"name": "decode/w4", "us_per_call": 1.0, "manifest": stamp},
             {"name": "serve/w4", "us_per_call": 2.0, "manifest": stamp}])),
        "bench_unstamped": _write(d / "bench_unstamped.json", json.dumps(
            [{"name": "decode/w4", "us_per_call": 1.0},
             {"us_per_call": 2.0}])),
        "bench_no_sha": _write(d / "bench_no_sha.json", json.dumps(
            [{"name": "a", "manifest": dict(stamp, git_sha="")}])),
        "bench_str_schema": _write(d / "bench_str_schema.json", json.dumps(
            [{"name": "a", "manifest": dict(stamp, schema_version="1")}])),
        "bench_empty": _write(d / "bench_empty.json", "[]"),
        "missing": str(d / "missing.json"),
    }


CASES = {
    "events": ["--validate", "events"],
    "bad_line": ["--validate", "bad_line"],
    "no_manifest": ["--validate", "no_manifest"],
    "future_schema": ["--validate", "future"],
    "no_kind": ["--validate", "no_kind"],
    "empty_jsonl": ["--validate", "empty_jsonl"],
    "missing_events": ["--validate", "missing"],
    "bench_stamped": ["--check-bench", "bench_stamped"],
    "bench_unstamped": ["--check-bench", "bench_unstamped"],
    "bench_no_sha": ["--check-bench", "bench_no_sha"],
    "bench_str_schema": ["--check-bench", "bench_str_schema"],
    "bench_empty": ["--check-bench", "bench_empty"],
    "bench_missing": ["--check-bench", "missing"],
    "both_flags": ["--validate", "events", "--check-bench",
                   "bench_unstamped"],
    "no_flag": [],
}


@pytest.fixture(scope="module")
def runs(files):
    """{case: (port's run, reference's run)}."""
    argvs = [[files.get(a, a) for a in argv] for argv in CASES.values()]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    got = {}
    for mod in ("repro_torch.obs.sink", "repro.obs.sink"):
        proc = subprocess.run(
            [sys.executable, "-c", _DRIVER, mod, json.dumps(argvs)],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        got[mod] = json.loads(proc.stdout.strip().splitlines()[-1])
    return {case: (p, r) for case, p, r in zip(
        CASES, got["repro_torch.obs.sink"], got["repro.obs.sink"])}


@pytest.mark.parametrize("case", CASES)
def test_cli_prints_and_exits_as_the_reference(runs, case):
    port, ref = runs[case]
    assert port == ref
    expect = {"events": 0, "bench_stamped": 0, "no_flag": 2}.get(case, 1)
    assert port["rc"] == expect, port
    if expect == 0:
        assert port["out"].rstrip().endswith(": OK")
    elif expect == 1:
        assert "error: " in port["out"]


def test_check_bench_equals_the_reference_function(files):
    """``check_bench`` (exported from ``repro_torch.obs``) returns the
    reference's error list on every bench file."""
    from repro.obs import sink as jsink
    for key in ("bench_stamped", "bench_unstamped", "bench_no_sha",
                "bench_str_schema", "bench_empty", "missing"):
        assert check_bench(files[key]) == jsink.check_bench(files[key]), key
    assert check_bench(files["bench_stamped"]) == []
