"""quantlint over the port (``repro_torch.analysis``, item 15.1–15.2): the
report and allowlist layer, the AST rules (QL1xx) on seeded torch sources
and on the current tree, the kernel coverage (QL207), the QL304 shape
lattice and plain versions against the reference, and the CLI's exit
codes. Mirrors the reference's ``tests/test_analysis.py`` for these layers.

The QL304 comparison itself (CUDA kernels against their plain versions)
runs on the card only: here ``run_diffcheck`` must raise, and the
``requires_cuda`` cases skip. On the CPU the plain versions are held
against the reference's ``backend="xla"`` dispatch over every cell of the
full lattice of every layout (about 130 cells, a few seconds), on the same
numpy weights and activations, each package RTN-exporting the weight
itself: the codes, scales and zero points bit for bit, the activation grid
bit for bit, and the outputs as ``tests/test_torch_kernels.py`` holds the
plain versions (W8A8 bit-exact, float layouts rtol = atol = 1e-5).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.analysis import ast_rules, layouts
from repro_torch.analysis import lint as tlint
from repro_torch.analysis.allowlist import default_allowlist
from repro_torch.analysis.coverage import FALLBACK, kernel_coverage
from repro_torch.analysis.diffcheck import (EXPECTED_KERNELS, check_parity,
                                            run_diffcheck, shape_lattice)
from repro_torch.analysis.report import AllowEntry, Finding, Report

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch")
LAYOUTS = tuple(EXPECTED_KERNELS)


def _read(rel):
    with open(os.path.join(SRC, rel)) as fh:
        return fh.read()


# ------------------------------------------------------------- report layer
def test_report_allowlist_downgrades_with_reason():
    rep = Report()
    rep.add("QL101", "graph-outside-engine", "error", "src/e.py:3", "graph")
    rep.add("QL101", "graph-outside-engine", "error", "src/other.py:9", "graph")
    out = rep.apply_allowlist([AllowEntry("QL101", "src/e.py*", "by design")])
    assert out.exit_code() == 1  # the unmatched finding still fails
    kept = {f.where: f for f in out}
    assert kept["src/e.py:3"].severity == "info"
    assert kept["src/e.py:3"].allowlisted == "by design"
    assert kept["src/other.py:9"].severity == "error"


def test_finding_rejects_unknown_severity():
    with pytest.raises(ValueError):
        Finding("QL999", "x", "fatal", "a:1", "m")


def test_stale_allowlist_entry_errors_on_full_run():
    rep = Report()
    rep.add("QL101", "graph-outside-engine", "error", "src/e.py:3", "graph")
    entries = [AllowEntry("QL101", "src/e.py*", "by design"),
               AllowEntry("QL104", "src/gone.py*", "kernel long deleted")]
    # partial runs never audit staleness (false positives by construction)
    assert rep.apply_allowlist(entries).by_rule("QL110") == []
    audited = rep.apply_allowlist(entries, report_stale=True)
    stale = audited.by_rule("QL110")
    assert len(stale) == 1 and "QL104" in stale[0].where, audited.pretty(True)
    assert "kernel long deleted" in stale[0].message
    assert audited.exit_code() == 1


# ---------------------------------------------------------------- AST layer
BAD_SRC = '''
import time
import numpy as np
import torch


class Eng:
    def capture(self):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self.step(self.x)

    def step(self, x):
        t = time.time()
        r = np.random.rand()
        m = float(x.max())
        k = float(x.shape[0])
        v = x.sum().item()
        c = torch.as_tensor([1.0], device=x.device)
        return x * m + t + r + v + k + c


def host():
    return time.perf_counter()


@torch.compile
def compiled(x):
    return x
'''

KERNEL_SRC = '''
from repro_torch.kernels.build import CudaLibrary

_LIB = CudaLibrary("k.cu", {})


def entry(x, *, backend="torch"):
    return x


def launch_bad(x):
    _LIB.call("k", x.data_ptr())


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


def launch_checked(x):
    _check(x.dim() == 2, "x must be 2-D")
    _LIB.call("k", x.data_ptr())


def launch_raises(x):
    if x.shape[0] % 8:
        raise ValueError("ragged")
    _LIB.call("k", x.data_ptr())
'''


def _lines(rep, rule):
    return sorted(int(f.where.rsplit(":", 1)[1]) for f in rep.by_rule(rule))


@pytest.mark.parametrize("rule,lines", [
    ("QL101", [9, 10, 27]),        # CUDAGraph, cuda.graph, @torch.compile
    ("QL102", [16, 18, 19]),       # float(x.max()), .item(), as_tensor(device=)
    ("QL103", [14, 15]),           # time.time, np.random.rand in the step
    ("QL106", [24]),               # a bare clock in host code
])
def test_seeded_torch_source_fires(rule, lines):
    rep = ast_rules.lint_source(BAD_SRC, "src/repro_torch/core/bad.py")
    assert _lines(rep, rule) == lines, rep.pretty(True)


@pytest.mark.parametrize("rule,lines", [("QL104", [7]), ("QL105", [11])])
def test_seeded_kernel_source_fires(rule, lines):
    rep = ast_rules.lint_source(KERNEL_SRC,
                                "src/repro_torch/kernels/fake.py")
    assert _lines(rep, rule) == lines, rep.pretty(True)
    # QL104 is a kernel-module rule
    other = ast_rules.lint_source(KERNEL_SRC, "src/repro_torch/serve/fake.py")
    assert other.by_rule("QL104") == []


def test_ql106_quiet_inside_obs():
    src = "import time\nt = time.perf_counter()\n"
    assert ast_rules.lint_source(src, "src/repro_torch/obs/x.py").by_rule(
        "QL106") == []
    assert len(ast_rules.lint_source(src, "src/repro_torch/core/x.py")
               .by_rule("QL106")) == 1
    # an ignore on an obs/ clock (the reference's linter, which lints src/
    # and exempts only repro/obs/, needs it) is not stale
    ignored = src.replace("()\n", "()  # quantlint: ignore[QL106]\n")
    assert len(ast_rules.lint_source(ignored, "src/repro_torch/obs/x.py",
                                     report_stale_ignores=True)) == 0


def test_inline_suppression():
    src = BAD_SRC.replace("m = float(x.max())",
                          "m = float(x.max())  # quantlint: ignore[QL102]")
    rep = ast_rules.lint_source(src, "s.py")
    assert _lines(rep, "QL102") == [18, 19]
    other_rule = BAD_SRC.replace("m = float(x.max())",
                                 "m = float(x.max())  # quantlint: ignore[QL103]")
    assert _lines(ast_rules.lint_source(other_rule, "s.py"), "QL102") == \
        [16, 18, 19]
    above = BAD_SRC.replace("        v = x.sum().item()",
                            "        # quantlint: ignore\n"
                            "        v = x.sum().item()")
    assert _lines(ast_rules.lint_source(above, "s.py"), "QL102") == [16, 20]


def test_stale_inline_ignore_errors_on_full_run():
    src = ("import torch\n"
           "x = 1  # quantlint: ignore[QL101]\n")
    # partial runs never audit staleness (mirrors the allowlist audit)
    assert ast_rules.lint_source(src, "s.py").by_rule("QL110") == []
    rep = ast_rules.lint_source(src, "s.py", report_stale_ignores=True)
    stale = rep.by_rule("QL110")
    assert len(stale) == 1 and ":2" in stale[0].where, rep.pretty(True)
    assert stale[0].name == "stale-inline-ignore"
    # a suppression that actually fired is not stale
    used = ("import torch\n"
            "g = torch.cuda.CUDAGraph()  # quantlint: ignore[QL101]\n")
    audited = ast_rules.lint_source(used, "s.py", report_stale_ignores=True)
    assert audited.by_rule("QL110") == [] and len(audited) == 0


def test_stale_ignore_scan_skips_docstrings():
    src = ('"""Use `# quantlint: ignore[QL101]` to suppress."""\n'
           "x = 1\n")
    rep = ast_rules.lint_source(src, "s.py", report_stale_ignores=True)
    assert len(rep) == 0, rep.pretty(True)


_CAPTURED = '''
import torch


def run(g, x):
    with torch.cuda.graph(g):
        body(x)


def body(x):
{line}
'''


def test_ql102_quiet_on_concrete_values():
    """Host casts of values not data-dependent on the scope's tensors are
    fine (configuration constants, shapes, numel)."""
    for line in ("    eps = float(torch.finfo(torch.float32).eps)\n"
                 "    n = int(x.shape[0]) + int(x.numel())\n"
                 "    return x * eps * n",
                 "    lr = float(1e-3)\n    return x * lr"):
        rep = ast_rules.lint_source(_CAPTURED.format(line=line), "s.py")
        assert rep.by_rule("QL102") == [], rep.pretty(True)


def test_ql102_taint_flows_through_assignment():
    line = ("    y = torch.abs(x)\n"
            "    z = y.sum()\n"
            "    return int(z)")
    flagged = ast_rules.lint_source(_CAPTURED.format(line=line),
                                    "s.py").by_rule("QL102")
    assert len(flagged) == 1 and ":13" in flagged[0].where


@pytest.mark.parametrize("path,body", [
    ("core/reconstruct.py", "_Engine.step"),
    ("allocate/sensitivity.py", "_Probe.body"),
    ("serve/engine.py", "make_prefill.prefill_insert"),
    ("serve/engine.py", "make_decode.decode"),
])
def test_finds_the_captured_bodies(path, body):
    assert body in ast_rules.captured_scopes(_read(path))


def test_ast_rules_clean_on_the_port():
    """The current tree: no error survives the default allowlist, no AST
    allowlist entry (QL1xx; the graph layer's entries match traced graphs,
    which an AST report never holds) and no inline ignore is stale, and
    every QL101 finding is one of the three engine caches'."""
    raw = ast_rules.lint_tree(SRC, rel_to=os.path.dirname(os.path.dirname(SRC)),
                              report_stale_ignores=True)
    ast_entries = [e for e in default_allowlist() if e.rule.startswith("QL1")]
    rep = raw.apply_allowlist(ast_entries, report_stale=True)
    assert rep.errors() == [] and rep.warnings() == [], rep.pretty()
    files = {f.where.rsplit(":", 1)[0] for f in raw.by_rule("QL101")}
    assert files == {"src/repro_torch/core/reconstruct.py",
                     "src/repro_torch/allocate/sensitivity.py",
                     "src/repro_torch/serve/engine.py"}


# ----------------------------------------------------------- QL207 coverage
def test_coverage_names_conv_fallback_sites():
    rep, rows = kernel_coverage(device="cpu")
    by_site = {r.site: r for r in rows}
    for layout, (plain, _) in EXPECTED_KERNELS.items():
        assert by_site[layout].kernel == plain, layout
        assert by_site[layout].regimes == ()  # no launch on the CPU
    conv_sites = [s for s in by_site if ".conv" in s or "patch_embed" in s]
    assert len(conv_sites) == 3
    assert all(by_site[s].kernel == FALLBACK for s in conv_sites)
    flagged = {f.where.split(":", 1)[1] for f in rep.warnings()}
    assert flagged == set(conv_sites)
    assert all(not by_site[r[0]].fallback for r in layouts.MATMUL_LAYOUTS)
    assert rep.errors() == []


# ------------------------------------------------------- QL304 lattice
@pytest.mark.parametrize("layout", LAYOUTS)
def test_shape_lattice_equals_the_reference(layout):
    from repro.analysis import diffcheck as jdiff
    from repro.analysis import trace as jtrace
    assert shape_lattice(layout) == jdiff.shape_lattice(layout)
    assert EXPECTED_KERNELS[layout] == tuple(
        n.replace("pallas", "") for n in jdiff.EXPECTED_KERNELS[layout])
    assert layouts.layout_row(layout) == next(
        r[1:] for r in jtrace.MATMUL_LAYOUTS if r[0] == layout)
    lat = shape_lattice(layout)
    assert len(lat) >= 20
    assert any(k % 128 for _, _, k, _ in lat)


def _reference_cell(layout, w, x):
    """The reference's RTN export of w (eager, as ``trace._export_qt``
    exports), its activation grid and its xla dispatch output (jitted, as
    it serves)."""
    import jax
    import jax.numpy as jnp

    from repro.analysis import trace as jtrace
    from repro.core import rtn as jrtn
    from repro.core.quant_config import QuantConfig as JQuantConfig
    from repro.kernels import ops as jops
    _, bits, batch_dims, with_a = layouts.layout_row(layout)
    qcfg = JQuantConfig(bits=bits, symmetric=False, observer="minmax",
                        granularity="per_channel", batch_dims=batch_dims)
    jw, jx = jnp.asarray(w), jnp.asarray(x)
    qt = jrtn.export(jw, jrtn.init(jw, qcfg), qcfg, dtype=jnp.float32)
    a = jtrace._a_state_for(jx) if with_a else None
    out = jax.jit(lambda v, q, s: jops.qtensor_matmul(
        v, q, a_state=s, backend="xla"))(jx, qt, a)
    return qt, a, np.asarray(out)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_versions_match_the_reference_on_the_lattice(layout):
    from repro_torch.kernels import ops
    _, bits, batch_dims, with_a = layouts.layout_row(layout)
    for i, (e, m, k, n) in enumerate(shape_lattice(layout)):
        rng = np.random.default_rng(100 + i)
        wshape = (e, k, n) if batch_dims else (k, n)
        xshape = (e, m, k) if batch_dims else (m, k)
        w = (rng.standard_normal(wshape) * 0.1).astype(np.float32)
        x = rng.standard_normal(xshape).astype(np.float32)
        jqt, ja, want = _reference_cell(layout, w, x)
        tx = torch.from_numpy(x)
        qt = layouts.export_qt(torch.from_numpy(w), bits,
                               batch_dims=batch_dims)
        cell = f"{layout} {(e, m, k, n)}"
        for name in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(
                getattr(qt, name).numpy(), np.asarray(getattr(jqt, name)),
                err_msg=f"{cell} {name}")
        assert (qt.packed, qt.pack_axis) == (jqt.packed, jqt.pack_axis), cell
        a = layouts._a_state_for(tx) if with_a else None
        if with_a:
            for got_a, want_a in zip(a, ja):
                np.testing.assert_array_equal(got_a.numpy(),
                                              np.asarray(want_a), err_msg=cell)
        got = ops.qtensor_matmul(tx, qt, a_state=a, backend="torch").numpy()
        assert ops.last_kernel == EXPECTED_KERNELS[layout][0], cell
        if layout == "w8a8":
            np.testing.assert_array_equal(got, want, err_msg=cell)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=cell)


def test_run_diffcheck_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA card"):
        run_diffcheck(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        check_parity("w4_packed", 1, 5, 64, 32, device="cpu")


@pytest.mark.requires_cuda
def test_diffcheck_smoke_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the full sweep "
                    "on the card")
    rep, rows = run_diffcheck(smoke=True)
    assert rep.errors() == [], rep.pretty()
    assert len(rows) == 3 * len(LAYOUTS) * 2 and all(r.ok for r in rows)


# ------------------------------------------------------------------- CLI
def test_cli_ast_only_exit_codes(tmp_path, monkeypatch, capsys):
    assert tlint.main(["--device", "cpu", "--ast-only"]) == 0
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "core" / "bad.py").write_text(BAD_SRC)
    monkeypatch.setattr(tlint, "repo_paths",
                        lambda: (str(pkg), str(tmp_path)))
    capsys.readouterr()
    assert tlint.main(["--device", "cpu", "--ast-only"]) == 1
    out = capsys.readouterr().out
    for rule in ("QL101", "QL102", "QL103", "QL106"):
        assert rule in out


def test_cli_cpu_without_ast_only_names_the_card(capsys):
    assert tlint.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "QL304/needs-card" in out and "CUDA card" in out
    assert "QL207/kernel-fallback" in out


def _error_rules(out: str):
    return {line.split()[1].split("/")[0] for line in out.splitlines()
            if line.startswith("ERROR")}


@pytest.mark.parametrize("argv", [["--jaxpr-only"], ["--mem"],
                                  ["--mem-json", "m.json"],
                                  ["--bench-rows", "b.json"],
                                  ["--decode-smoke"],
                                  ["--seed-bug", "a_state_drop"]])
def test_cli_refuses_the_traced_graph_flags(argv, capsys, tmp_path,
                                            monkeypatch):
    """The reference's traced-graph flags run on the CPU since the
    traced-graph layers came (their error there is QL304's need of the
    card; a seeded run skips QL304 and fails on its own rule);
    ``--bench-rows`` is still refused, naming ROADMAP item 3."""
    monkeypatch.chdir(tmp_path)
    if argv[0] == "--bench-rows":
        assert tlint.main(argv + ["--device", "cpu", "--ast-only"]) == 2
        assert "item 3" in capsys.readouterr().err
        return
    extra = [] if argv[0] == "--jaxpr-only" else ["--jaxpr-only"]
    if argv[0] == "--mem-json":
        extra.append("--mem")
    assert tlint.main(argv + extra + ["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    if argv[0] == "--seed-bug":
        assert _error_rules(out) == {"QL201"}, out
    else:
        assert _error_rules(out) == {"QL304"}, out
        assert "QL304/needs-card" in out
    if argv[0] == "--mem-json":
        doc = json.loads((tmp_path / "m.json").read_text())
        assert {r["entry"] for r in doc["entries"]} >= {
            "recon_chunk", "serve_decode[smollm-135m-smoke][bf16-kv]"}


def test_launcher_analyze_names_item_15_3(capsys):
    """``--analyze`` runs quantlint after a CPU launcher run, prints the
    report and exits non-zero on QL304/needs-card alone: no QL2xx-QL4xx
    error."""
    from repro_torch.launch import quantize as launcher
    with pytest.raises(SystemExit) as e:
        launcher.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                       "--iters", "2", "--calib", "8", "--seq", "16",
                       "--analyze"])
    assert "quantlint: error findings" in str(e.value.code)
    out = capsys.readouterr().out
    assert "QL304/needs-card" in out and "kernel coverage:" in out
    assert _error_rules(out) == {"QL304"}, out
