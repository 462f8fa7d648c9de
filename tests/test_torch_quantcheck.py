"""quantcheck over the port's traced graphs (``repro_torch.analysis``:
``intervals``, ``shardcheck``): QL301-QL303 and QL305-QL306, held against
live runs of the reference's entries and analyzers where the reference's
own test passes under jax 0.9.0. Where it does not (the W8A8 proof, grid
saturation, the lost psum; ROADMAP Queue 3) these tests assert the stated
outcome itself: the proof bound is 2^14 * k_max, saturation is flagged on
the seeded grid, the lost psum is flagged on a 1 x 1 mesh. Findings
compare as in ``tests/test_torch_trace.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.analysis import layouts
from repro_torch.analysis import trace as tr
from repro_torch.analysis.intervals import (TOP, Interval, check_intervals,
                                            seed_invars)
from repro_torch.analysis.shardcheck import check_shard_safety
from repro_torch.kernels.envelope import get_envelope
from test_torch_trace import (finding_keys, port_matmul_entry,
                              ref_matmul_entry)

torch.set_num_threads(2)

LAYOUTS = tuple(r[0] for r in layouts.MATMUL_LAYOUTS)


# ------------------------------------- QL301/302/303 interval interpreter
def test_intervals_flags_seeded_int16_accumulator():
    from repro.analysis import trace as jtrace
    from repro.analysis.intervals import check_intervals as jcheck
    entry = tr.int8_overflow_entry("cpu")
    rep = check_intervals(entry)
    errs = rep.errors()
    assert errs and all(f.rule == "QL301" for f in errs), rep.pretty(True)
    assert any("int16" in f.message for f in errs)
    ref = jtrace.int8_overflow_entry()
    assert finding_keys(rep, entry.labels) == finding_keys(
        jcheck(ref), ref.labels)


def test_intervals_proves_w8a8_accumulator_fits_envelope(monkeypatch):
    """No oracle (the reference's proof fails under jax 0.9.0): the plain
    W8A8 float64 accumulator is read as K3's int32 sum and proven to fit
    for every K of the envelope, |acc| <= 2^14 * k_max."""
    rep = check_intervals(port_matmul_entry(monkeypatch, "w8a8"))
    assert rep.errors() == [], rep.pretty(True)
    proofs = [f for f in rep if f.rule == "QL301" and f.severity == "info"]
    assert len(proofs) == 1 and "proven" in proofs[0].message
    bound = 2**14 * get_envelope("w8a8").k_max
    assert f"{float(bound):.4g}" in proofs[0].message
    assert "int32" in proofs[0].message and "2^53" in proofs[0].message


def test_intervals_flags_a_float64_accumulator_past_int32():
    """int16 codes contracted in float64 leave the int32 range K3 would
    accumulate in: an error, not a proof."""
    def acc(a, b):
        return torch.matmul(a.double(), b.double()).float()

    a = torch.ones((4, 48), dtype=torch.int16)
    entry = tr.trace_entry(acc, (a, a.t().contiguous()), name="acc16",
                           argnames=("a", "b"), envelope="w8a8")
    errs = check_intervals(entry).errors()
    assert len(errs) == 1 and errs[0].rule == "QL301", errs
    assert "int32" in errs[0].message


def test_intervals_flags_seeded_scale_underflow():
    from repro.analysis import trace as jtrace
    from repro.analysis.intervals import check_intervals as jcheck
    entry = tr.flexround_apply_entry(underflow=True, device="cpu")
    rep = check_intervals(entry)
    errs = rep.errors()
    assert errs and all(f.rule == "QL303" for f in errs), rep.pretty(True)
    # the card's meaning: subnormals are kept, the quotient overflows
    assert "inf" in errs[0].message and "no -ftz" in errs[0].message
    ref = jtrace.flexround_apply_entry(underflow=True)
    assert finding_keys(rep, entry.labels) == finding_keys(
        jcheck(ref), ref.labels)


def test_intervals_quiet_at_the_eps_projection():
    """The healthy contract is ``flexround.EPS``: the product of three
    factors floored at 1e-6 stays normal."""
    from repro_torch.core import flexround
    entry = tr.flexround_apply_entry(device="cpu")
    assert dict((g, lo) for g, lo, _ in entry.ranges)["state.s1*"] == \
        flexround.EPS
    assert check_intervals(entry).errors() == []


def test_intervals_flags_provable_grid_saturation():
    """No oracle (the reference's case fails under jax 0.9.0): a clip whose
    operand lies entirely beyond its upper bound on the seeded range."""
    entry = tr.trace_entry(
        lambda x: torch.clamp(torch.round(x / 2.0), -7.0, 7.0),
        (torch.ones(8),), name="sat", argnames=("x",),
        ranges=(("x", 64.0, 256.0),))
    errs = check_intervals(entry).errors()
    assert errs and all(f.rule == "QL302" for f in errs), errs
    # an ordinary clip (the operand straddles the bound) never fires
    entry = tr.trace_entry(
        lambda x: torch.clamp(torch.round(x / 2.0), -7.0, 7.0),
        (torch.ones(8),), name="clip", argnames=("x",),
        ranges=(("x", -64.0, 256.0),))
    assert check_intervals(entry).errors() == []


def test_intervals_unknown_op_is_top():
    entry = tr.trace_entry(lambda x: torch.erfinv(x).to(torch.int8),
                           (torch.zeros(4),), name="top", argnames=("x",),
                           ranges=(("x", -0.5, 0.5),))
    assert check_intervals(entry).errors() == []
    assert TOP.known is False and not TOP.finite


def test_seed_invars_first_match_wins():
    entry = tr.qtensor_matmul_entry("w8a8", device="cpu")
    seeds = dict(zip(entry.labels, seed_invars(entry)))
    env = get_envelope("w8a8")
    assert seeds["a_state.[1]"] == Interval(0.0, 255.0)
    assert seeds["qt.scale"] == Interval(env.scale_min, env.scale_max)
    assert seeds["qt.codes"] == Interval(0.0, 255.0)  # uint8 dtype bounds


@pytest.mark.parametrize("layout", LAYOUTS)
def test_intervals_quiet_on_clean_matmul_layouts(monkeypatch, layout):
    from repro.analysis.intervals import check_intervals as jcheck
    entry = port_matmul_entry(monkeypatch, layout)
    rep = check_intervals(entry)
    assert rep.errors() == [], f"{layout}: {rep.pretty(True)}"
    ref = ref_matmul_entry(monkeypatch, layout)
    drop = {("QL301", "info", "<op>")} if layout == "w8a8" else set()
    assert finding_keys(rep, entry.labels, drop) == finding_keys(
        jcheck(ref), ref.labels)


def test_intervals_quiet_on_clean_entries():
    from repro.analysis import trace as jtrace
    from repro.analysis.intervals import check_intervals as jcheck
    for entry, ref in ((tr.flexround_apply_entry(device="cpu"),
                        jtrace.flexround_apply_entry()),
                       (tr.recon_chunk_entry(device="cpu"),
                        jtrace.recon_chunk_entry()),
                       (tr.probe_entry(device="cpu"), jtrace.probe_entry())):
        rep = check_intervals(entry)
        assert rep.errors() == [], f"{entry.name}: {rep.pretty(True)}"
        assert finding_keys(rep, entry.labels) == finding_keys(
            jcheck(ref), ref.labels)


# -------------------------------------------- QL305/306 shard safety
def test_shardcheck_flags_seeded_lost_psum():
    """No oracle (the reference's case fails under jax 0.9.0): an
    all-reduce over the model group of a 1 x 1 mesh leaves the loss
    unreduced over the data group."""
    import torch.distributed as dist
    entry = tr.lost_psum_entry(device="cpu")
    assert not dist.is_initialized()  # the entry's own world is gone
    rep = check_shard_safety(entry)
    errs = rep.errors()
    assert errs and all(f.rule == "QL305" for f in errs), rep.pretty(True)
    assert {f.name for f in errs} == {"collective-wrong-axis", "lost-psum"}
    assert [(c.op, c.data_group) for c in entry.collectives] == [
        ("allreduce_", False)]


def test_shardcheck_passes_a_loss_reduced_over_data():
    import torch.distributed as dist
    mesh, started = tr.one_rank_mesh("cpu")
    try:
        data = mesh.get_group("data")

        def loss(x):
            err = torch.mean(x * x)
            dist.all_reduce(err, group=data)
            return err / 2

        entry = tr.trace_entry(loss, (torch.ones(4),), name="ok",
                               argnames=("x",), mesh=mesh, dp=("data",),
                               dp_group=data, loss=("<out>",))
    finally:
        if started:
            dist.destroy_process_group()
    assert check_shard_safety(entry).errors() == []


def test_shardcheck_flags_an_uncapturable_collective():
    """QL306 in its torch meaning: a gloo collective inside a body that
    runs in a CUDA graph."""
    entry = tr.lost_psum_entry(device="cpu")
    assert not [f for f in check_shard_safety(entry) if f.rule == "QL306"]
    captured = dataclasses.replace(entry, captured=True)
    errs = [f for f in check_shard_safety(captured).errors()
            if f.rule == "QL306"]
    assert len(errs) == 1 and "gloo" in errs[0].message
    nccl = dataclasses.replace(captured, collectives=tuple(
        dataclasses.replace(c, backend="nccl") for c in entry.collectives))
    assert not [f for f in check_shard_safety(nccl) if f.rule == "QL306"]


def test_shardcheck_quiet_on_sharded_recon(tmp_path):
    from test_torch_trace import sharded_rows
    for rows in sharded_rows(tmp_path):
        assert [r for r in rows["shard"] if r[1] == "error"] == [], rows
        assert [r for r in rows["intervals"] if r[1] == "error"] == [], rows
        # gloo cannot be captured, so the engine runs this body eagerly
        assert rows["captured"] is False


def test_shardcheck_quiet_on_unsharded_entries():
    for entry in (tr.recon_chunk_entry(device="cpu"),
                  tr.probe_entry(device="cpu")):
        assert check_shard_safety(entry).errors() == []
        assert entry.collectives == ()


# --------------------------------------------- seeded lint-run wiring
@pytest.mark.parametrize("bug,rule", [("int8_overflow", "QL301"),
                                      ("scale_underflow", "QL303"),
                                      ("lost_psum", "QL305")])
def test_seeded_quantcheck_runs_exit_nonzero(bug, rule):
    from repro_torch.analysis import lint
    rep = lint.run_analysis(jaxpr_only=True, seed_bug=bug, device="cpu",
                            log=lambda *a, **k: None)
    assert rep.exit_code() == 1
    assert any(f.rule == rule for f in rep.errors()), rep.pretty(True)
