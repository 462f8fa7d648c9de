"""quantlint's traced-graph layer over the port (``repro_torch.analysis``:
``trace``, ``graph_checks``): the entries ``make_fx`` traces, QL201-QL206
and ``no_retrace``. Mirrors the reference's ``tests/test_analysis.py``
(its QL2xx part) and holds the port's findings against live runs of the
reference's entries and analyzers.

Findings compare as sets of (rule, severity, label): the location's tail
when it names a labelled input or a memcheck measure, else ``<op>`` (the
reference names jaxpr primitives where the port names aten ops). The
matmul layouts are traced in both packages on the same numpy weights and
activations, each package RTN-exporting the weight itself (the entries'
own ``matmul_example`` replaced); the other entries draw their own values,
on which their findings do not depend. Known differences, asserted here
and listed in ``CHANGES.md``: the reference's recon chunk scans a dead
``steps`` input (QL201 info) where the port's step reads its counter; the
port proves the W8A8 accumulator (QL301 info) where the reference's proof
fails under jax 0.9.0 (ROADMAP Queue 3).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis import RetraceError, no_retrace
from repro_torch.analysis import graph_checks as gc
from repro_torch.analysis import layouts
from repro_torch.analysis.allowlist import default_allowlist
from repro_torch.analysis import trace as tr
from repro_torch.analysis.report import Report

torch.set_num_threads(2)

LAYOUTS = tuple(r[0] for r in layouts.MATMUL_LAYOUTS)
MEASURES = ("mem", "weights", "kv_cache", "kv-gap")


# ------------------------------------------------------------ comparisons
def finding_keys(rep: Report, labels, drop=()):
    """(rule, severity, label) of every finding (module docstring)."""
    out = set()
    for f in rep:
        tail = f.where.split("#", 1)[1] if "#" in f.where else ""
        if tail not in labels and tail not in MEASURES:
            tail = "<op>"
        key = (f.rule, f.severity, tail)
        if key not in drop:
            out.add(key)
    return out


def numpy_layout(layout, seed=9):
    """(w, x) numpy float32 for one kernel-table layout at its smoke
    shape (x: 5 rows per expert)."""
    shape, _, batch_dims, _ = layouts.layout_row(layout)
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    xshape = (shape[0], 5, shape[1]) if batch_dims else (5, shape[0])
    return w, rng.standard_normal(xshape).astype(np.float32)


def ref_matmul_entry(monkeypatch, layout, **kw):
    """The reference's ``qtensor_matmul_entry`` traced on the numpy
    inputs."""
    import jax.numpy as jnp

    from repro.analysis import trace as jtrace
    from repro.core import rtn as jrtn
    from repro.core.quant_config import QuantConfig as JQuantConfig
    w, x = numpy_layout(layout)
    _, bits, batch_dims, with_a = layouts.layout_row(layout)

    def example(name):
        qcfg = JQuantConfig(bits=bits, symmetric=False, observer="minmax",
                            granularity="per_channel", batch_dims=batch_dims)
        jw, jx = jnp.asarray(w), jnp.asarray(x)
        qt = jrtn.export(jw, jrtn.init(jw, qcfg), qcfg, dtype=jnp.float32)
        return jx, qt, (jtrace._a_state_for(jx) if with_a else None)

    monkeypatch.setattr(jtrace, "matmul_example", example)
    return jtrace.qtensor_matmul_entry(layout, **kw)


def port_matmul_entry(monkeypatch, layout, **kw):
    """The port's ``qtensor_matmul_entry`` traced on the same inputs."""
    w, x = numpy_layout(layout)
    _, bits, batch_dims, with_a = layouts.layout_row(layout)

    def example(name, device="cpu", **_):
        tx = torch.from_numpy(x)
        qt = layouts.export_qt(torch.from_numpy(w), bits,
                               batch_dims=batch_dims)
        return tx, qt, (layouts._a_state_for(tx) if with_a else None)

    monkeypatch.setattr(layouts, "matmul_example", example)
    return tr.qtensor_matmul_entry(layout, device="cpu", **kw)


# -------------------------------------------------------- tracing, labels
@pytest.mark.parametrize("layout", LAYOUTS)
def test_matmul_labels_equal_the_reference(monkeypatch, layout):
    ref = ref_matmul_entry(monkeypatch, layout)
    got = port_matmul_entry(monkeypatch, layout)
    assert got.labels == ref.labels
    assert got.name == ref.name and got.envelope == ref.envelope
    assert [r[0] for r in got.ranges] == [r[0] for r in ref.ranges]


def test_probe_and_flexround_labels_equal_the_reference():
    from repro.analysis import trace as jtrace
    got = tr.flexround_apply_entry(device="cpu")
    assert sorted(got.labels) == sorted(jtrace.flexround_apply_entry().labels)
    probe = tr.probe_entry(device="cpu")
    ref = jtrace.probe_entry()
    # the port's probe reads one gate vector (``_Probe.gate``) where the
    # reference passes a gate per site, and writes its MSE in place
    assert set(probe.labels) - {"gates", "mse"} == {
        lbl for lbl in ref.labels if not lbl.startswith("gates.")}
    assert probe.carry == ("mse",) and probe.donated == frozenset(
        {probe.labels.index("mse")})


def test_trace_entry_names_every_argument():
    w = torch.ones(4)
    with pytest.raises(ValueError, match="name each one"):
        tr.trace_entry(lambda a: a * 2, (w,), name="bad",
                       argnames=("a", "b"))
    e = tr.trace_entry(lambda a, q: a * q["s"], (w, {"s": w.clone()}),
                       name="ok", argnames=("a", "q"))
    assert e.labels == ["a", "q.s"] and len(e.placeholders) == 2


def test_recon_chunk_lifts_the_engine_buffers():
    e = tr.recon_chunk_entry(device="cpu")
    for lbl in ("wopt.mu.~s0.s1.m", "aopt.mu.~s0.step.v", "x_q", "y_fp",
                "idx", "step", "curves.loss", "curves.mse", "corr.w.[0]"):
        assert lbl in e.labels, lbl
    written = {e.labels[i] for i in e.donated}
    # every declared carry is written in place; the frozen zero points
    # ride Adam's foreach copy and are written too
    assert set(e.carry) <= written
    assert {"x_q", "y_fp", "idx", "params.w1"}.isdisjoint(written)
    # the QDrop streams are generator objects, not inputs: their draws
    # trace from the default generator
    assert not any("stream" in lbl for lbl in e.labels)
    ops = {n.target for n in e.closed.graph.nodes if n.op == "call_function"}
    assert torch.ops.aten.rand.default in ops
    assert not any(n.op == "get_attr" and "opaque" in n.target
                   for n in e.closed.graph.nodes)


# -------------------------------------------------- QL201 unused input
def test_unused_input_flags_seeded_a_state_drop(monkeypatch):
    entry = port_matmul_entry(monkeypatch, "w8a8", drop_a_state=True)
    rep = gc.check_unused_inputs(entry)
    wheres = sorted(f.where for f in rep.errors())
    assert len(wheres) == 2, rep.pretty(verbose=True)
    assert all("a_state" in w for w in wheres)
    from repro.analysis import jaxpr_checks as jchecks
    ref = ref_matmul_entry(monkeypatch, "w8a8", drop_a_state=True)
    assert finding_keys(rep, entry.labels) == finding_keys(
        jchecks.check_unused_inputs(ref), ref.labels)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_unused_input_quiet_on_clean_matmul_layouts(monkeypatch, layout):
    from repro.analysis import jaxpr_checks as jchecks
    entry = port_matmul_entry(monkeypatch, layout)
    rep = gc.check_entry(entry).apply_allowlist(default_allowlist())
    assert rep.errors() == [], f"{layout}: {rep.pretty(verbose=True)}"
    ref = ref_matmul_entry(monkeypatch, layout)
    # the W8A8 entry's float64 accumulator is the port's (QL204, excused by
    # the allowlist with its reason); nothing else differs
    drop = {("QL204", "info", "<op>")}
    assert finding_keys(rep, entry.labels, drop) == finding_keys(
        jchecks.check_entry(ref), ref.labels)
    excused = [f for f in rep if f.rule == "QL204"]
    assert (layout == "w8a8") == bool(excused)
    assert all("f64-int-acc/" in f.where and f.allowlisted
               for f in excused)


def test_recon_chunk_and_probe_clean():
    from repro.analysis import jaxpr_checks as jchecks
    from repro.analysis import trace as jtrace
    for entry, ref in ((tr.recon_chunk_entry(device="cpu"),
                        jtrace.recon_chunk_entry()),
                       (tr.probe_entry(device="cpu"), jtrace.probe_entry())):
        rep = gc.check_entry(entry)
        assert rep.errors() == [], f"{entry.name}: {rep.pretty(True)}"
        # the reference scans a dead ``steps`` (allowed, info); the port's
        # step reads its counter, so the allowance matches nothing
        drop = {("QL201", "info", "steps")}
        assert finding_keys(rep, entry.labels) == finding_keys(
            jchecks.check_entry(ref), ref.labels, drop)
        assert entry.allow_unused == ref.allow_unused


def test_unused_input_respects_entry_allowlist(monkeypatch):
    entry = port_matmul_entry(monkeypatch, "w8a8", drop_a_state=True)
    allowed = dataclasses.replace(entry, allow_unused=("a_state*",))
    rep = gc.check_unused_inputs(allowed)
    assert rep.errors() == []
    assert len([f for f in rep if f.severity == "info"]) == 2


def test_unused_input_is_transitive():
    """A leaf read only by a dead computation is dead (the reference's DCE
    over the jaxpr); a leaf read by a write into the caller's state is
    live."""
    def f(a, b, s):
        _ = b * 2            # dead
        s.add_(a)            # state the caller keeps
        return None

    x = torch.ones(4)
    entry = tr.trace_entry(f, (x, x.clone(), x.clone()), name="t",
                           argnames=("a", "b", "s"), carry=("s",))
    errs = gc.check_unused_inputs(entry).errors()
    assert [f.where for f in errs] == ["graph:t#b"]


# ------------------------------------------------------- QL203 aliasing
def test_donation_alias_detected():
    def f(a, b):
        a.add_(1.0)
        b.add_(2.0)

    x = torch.ones(8)
    entry = tr.trace_entry(f, (x, x), name="alias", argnames=("a", "b"),
                           carry=("a", "b"))
    rep = gc.check_donation(entry)
    assert any("shares its storage" in f.message for f in rep.errors()), \
        rep.pretty(verbose=True)
    # a view of the same buffer aliases it too
    entry = tr.trace_entry(f, (x[:4], x[2:]), name="alias_view",
                           argnames=("a", "b"))
    assert gc.check_donation(entry).errors()
    # separate buffers: quiet
    entry = tr.trace_entry(f, (x, x.clone()), name="ok", argnames=("a", "b"))
    assert gc.check_donation(entry).errors() == []


def test_donation_flags_a_returned_written_input():
    def f(a):
        a.mul_(0.5)
        return a[:2]

    entry = tr.trace_entry(f, (torch.ones(4),), name="ret", argnames=("a",))
    errs = gc.check_donation(entry).errors()
    assert len(errs) == 1 and "returned" in errs[0].message


def test_donation_clean_on_dealiased_chunk():
    from repro.analysis import jaxpr_checks as jchecks
    from repro.analysis import trace as jtrace
    entry = tr.recon_chunk_entry(device="cpu")
    assert gc.check_donation(entry).errors() == []
    assert jchecks.check_donation(jtrace.recon_chunk_entry()).errors() == []


# ------------------------------------------------- QL204/QL206 negative
def test_f64_promotion_detected():
    """The reference's case fails under jax 0.9.0 (no oracle): a float64
    value inside a traced body must raise QL204."""
    entry = tr.trace_entry(lambda x: x.double() * 2.0, (torch.ones(4),),
                           name="f64", argnames=("x",))
    errs = gc.check_promotion(entry).errors()
    assert errs and all(f.rule == "QL204" for f in errs)
    assert not any("f64-int-acc" in f.where for f in errs)


def test_f64_integer_accumulator_tagged_and_excused():
    def acc(a, b):
        return torch.matmul(a.double(), b.double()).float()

    a = torch.ones((4, 8), dtype=torch.int8)
    entry = tr.trace_entry(acc, (a, a.t().contiguous()), name="acc",
                           argnames=("a", "b"))
    rep = gc.check_promotion(entry)
    assert {f.where for f in rep} == {"graph:acc#f64-int-acc/_to_copy",
                                      "graph:acc#f64-int-acc/mm"}
    assert rep.apply_allowlist(default_allowlist()).errors() == []
    # float operands contracted in float64 are no integer accumulator
    x = torch.ones((4, 8))
    fl = tr.trace_entry(acc, (x, x.t().contiguous()), name="fl",
                        argnames=("a", "b"))
    assert gc.check_promotion(fl).apply_allowlist(
        default_allowlist()).errors()


def test_weak_types_never_fire():
    entry = tr.trace_entry(lambda x: x * 2, (torch.ones(4),), name="w",
                           argnames=("x",))
    assert not [f for f in gc.check_promotion(entry) if f.rule == "QL205"]


def test_sharding_honesty_negative_control():
    """An unsharded graph that *claims* a mesh must fail QL206."""
    entry = tr.recon_chunk_entry(device="cpu")  # traced without a mesh
    fake = dataclasses.replace(entry, mesh=object(), dp=("data",))
    assert gc.check_sharding(fake).exit_code() == 1


def sharded_worker(out_dir):
    """One rank of the sharded recon entry (2 gloo ranks): the graph
    checks, quantcheck and shard safety, saved as (rule, severity, where,
    message) rows, plus the entry's collectives."""
    from test_torch_mesh import save_rank, start_rank

    from repro_torch.analysis.intervals import check_intervals
    from repro_torch.analysis.shardcheck import check_shard_safety
    from repro_torch.launch import mesh as tmesh
    start_rank()
    mesh = tmesh.make_flat_mesh(2, device_type="cpu")
    entry = tr.recon_chunk_entry(mesh=mesh, device="cpu")
    rows = {}
    for name, rep in (("graph", gc.check_entry(entry)),
                      ("intervals", check_intervals(entry)),
                      ("shard", check_shard_safety(entry))):
        rows[name] = [(f.rule, f.severity, f.where, f.message) for f in rep]
    rows["collectives"] = [(c.op, c.group_size, c.backend, c.data_group)
                           for c in entry.collectives]
    rows["name"] = entry.name
    rows["captured"] = entry.captured
    save_rank(out_dir, rows)
    tmesh.shutdown()


def sharded_rows(tmp_path):
    from test_torch_mesh import spawn_ranks
    return spawn_ranks(2, "test_torch_trace", "sharded_worker", tmp_path)


def test_sharded_chunk_constrains_dp_axes(tmp_path):
    ranks = sharded_rows(tmp_path)
    for rows in ranks:
        assert rows["name"] == "recon_chunk_sharded"
        assert [r for r in rows["graph"] if r[1] == "error"] == [], rows
        # every collective reduces over the 2-rank data group
        assert rows["collectives"] and all(
            c == ("allreduce_", 2, "gloo", True) for c in rows["collectives"])
    assert ranks[0]["graph"] == ranks[1]["graph"]


# -------------------------------------------------------- QL202 retrace
def test_retrace_flat_on_shared_token():
    rep = gc.check_retrace(per_layer=False, device="cpu")
    assert rep.exit_code() == 0, rep.pretty(verbose=True)


def test_retrace_flags_seeded_per_layer():
    """On the CPU ``step_compiles`` stays 0 (nothing is captured); the
    guard still catches the per-layer engines through ``engine_builds``."""
    rep = gc.check_retrace(per_layer=True, device="cpu")
    errs = rep.errors()
    assert len(errs) == 1 and errs[0].rule == "QL202", rep.pretty(True)
    assert "engine_builds grew by 4" in errs[0].message
    assert "step +0" in errs[0].message


def test_no_retrace_guard_raises():
    from repro_torch.core import reconstruct as rec
    block = tr.toy_block(41, "guard", token=None, device="cpu")
    recipe = tr.toy_recipe(iters=2, batch_size=2)
    x = tr._normal((2, 16), 42, "cpu")
    y = tr._normal((2, 16), 43, "cpu")
    with pytest.raises(RetraceError):
        with no_retrace(0):
            rec.reconstruct_block(block, recipe, x, y, 0)
    # a hit of the engine cache stays within budget
    with no_retrace(0):
        rec.reconstruct_block(block, recipe, x, y, 0)


def test_no_retrace_counts_captures(monkeypatch):
    from repro_torch.obs import compile_events
    with pytest.raises(RetraceError, match="captures grew by 1"):
        with no_retrace(0):
            compile_events.record_capture("toy", 0.0)
    with no_retrace(1):
        compile_events.record_capture("toy", 0.0)


# ----------------------------------------------------- seeded lint runs
@pytest.mark.parametrize("bug,rule", [("a_state_drop", "QL201"),
                                      ("per_layer_retrace", "QL202")])
def test_seeded_graph_runs_exit_nonzero(bug, rule):
    from repro_torch.analysis import lint
    rep = lint.run_analysis(jaxpr_only=True, seed_bug=bug, device="cpu",
                            log=lambda *a, **k: None)
    assert rep.exit_code() == 1
    assert {f.rule for f in rep.errors()} == {rule}, rep.pretty(True)


@pytest.mark.requires_cuda
def test_entries_trace_on_the_card():
    """The same entries traced with fake CUDA tensors on the card: the
    same labels and written inputs as on the CPU, no error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py traces the entries "
                    "on the card")
    for build in (tr.recon_chunk_entry, tr.probe_entry):
        cpu, card = build(device="cpu"), build(device="cuda")
        assert card.labels == cpu.labels and card.donated == cpu.donated
        assert gc.check_entry(card).errors() == []
        assert card.captured and not cpu.captured

