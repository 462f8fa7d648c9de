"""memcheck over the port's traced graphs (``repro_torch.analysis.memcheck``,
QL401-QL405): the storage liveness walk, the budgets, the carries written
in place, the weight-traffic bytes and the static int8-vs-bf16 KV gap,
held against live runs of the reference's entries and analyzer. The
QL403/QL405 byte counts of the deploy decode and the serving engine's
bodies must equal the reference's exactly. The card case replays the
graphs and holds the caching allocator's peak to the static one.
"""
import json

import pytest
import torch

from repro_torch.analysis import graph_checks as gc
from repro_torch.analysis import trace as tr
from repro_torch.analysis.memcheck import (ALLOC_ROUND, _walk,
                                           check_kv_static_gap, check_memory,
                                           mem_report_json)
from test_torch_trace import finding_keys

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def serve_entries():
    """The deploy decode and serving entries of both packages (the smoke
    LM quantized export-only once per package: the reference's entries
    each quantize it again, so that function is memoized for them)."""
    import functools

    from repro.analysis import trace as jtrace
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrace, "_deploy_smoke_lm",
               functools.lru_cache(maxsize=None)(jtrace._deploy_smoke_lm))
    lm = tr.deploy_smoke_lm(device="cpu")
    port = [tr.deploy_decode_entry(lm=lm, device="cpu"),
            tr.serve_prefill_entry(lm=lm, device="cpu"),
            tr.serve_decode_entry(lm=lm, device="cpu"),
            tr.serve_decode_entry(kv_quant=False, lm=lm, device="cpu")]
    ref = [jtrace.deploy_decode_entry(), jtrace.serve_prefill_entry(),
           jtrace.serve_decode_entry(),
           jtrace.serve_decode_entry(kv_quant=False)]
    mp.undo()
    return port, ref


# ---------------------------------------------------------- liveness model
def test_views_and_in_place_ops_allocate_nothing():
    def f(x, s):
        v = x.view(4, 4)              # a view
        s.add_(v.t().reshape(-1).view(16))  # a copy (strided), then in place
        return (v * 2).sum()          # two new storages, one kept

    entry = tr.trace_entry(f, (torch.ones(16), torch.zeros(16)), name="v",
                           argnames=("x", "s"), carry=("s",))
    live = _walk(entry.closed, 0)
    # the transposed copy, the product and the sum: no view, no in-place
    assert sorted(live.owners.values()) == [4, 64, 64]
    assert live.inputs == (128, 0)
    # the copy is freed once added, the product once summed; the sum stays
    assert live.peak_at(0) == 128 + 64 + 4
    assert live.peak_rounded == 2 * ALLOC_ROUND


def test_values_free_after_their_last_use():
    def chain(x):
        a = x * 2
        b = a * 3
        c = b + 1
        return c

    entry = tr.trace_entry(chain, (torch.ones(256),), name="c",
                           argnames=("x",))
    # never more than two 1 KiB temporaries live at once
    assert _walk(entry.closed, 0).peak_at(0) == 3 * 1024


def test_in_place_carry_counted_once():
    """The port's counterpart of the reference's scan-carry test: a carry
    updated in place for any number of trips costs its bytes once."""
    def make(trips):
        def f(c):
            for _ in range(trips):
                c.mul_(0.5).add_(1.0)
        x = torch.ones((64, 64))
        return tr.trace_entry(f, (x,), name=f"loop{trips}", argnames=("c",),
                              carry=("c",))

    p2 = _walk(make(2).closed, 0).peak_at(0)
    p64 = _walk(make(64).closed, 0).peak_at(0)
    assert p2 == p64 == 64 * 64 * 4


def test_window_buffers_scale_with_the_length():
    e = tr.hbm_blowout_entry("cpu")
    live = _walk(e.closed, 24)
    f, per_tok = live.argmax_at(24)
    # codes.float() and the scaled window: 2 x 256 B per token of 24
    assert per_tok >= 2 * 256 and live.peak_at(8192) > live.peak_at(24)


# -------------------------------------------------- QL402 dead donation
def test_memcheck_flags_seeded_dead_donation():
    from repro.analysis import trace as jtrace
    from repro.analysis.memcheck import check_memory as jcheck
    entry = tr.dead_donation_entry("cpu")
    rep, rec = check_memory(entry)
    errs = rep.errors()
    assert errs and all(f.rule == "QL402" for f in errs), rep.pretty(True)
    assert "no result shares its shape" in errs[0].message
    assert rec["donation_dead"] == 1 and rec["donation_matched"] == 0
    # QL203 must stay quiet on it: the carry is useless, not unsafe
    assert gc.check_donation(entry).errors() == []
    ref = jtrace.dead_donation_entry()
    assert finding_keys(rep, entry.labels) == finding_keys(
        jcheck(ref)[0], ref.labels)


def test_memcheck_flags_donation_lifetime_overlap():
    """The second QL402 shape: a same-shape result exists but is allocated
    fresh while the carry is still read."""
    def f(a):
        b = a * 2.0            # shape/dtype-matching result, fresh storage
        c = torch.sum(a + b)   # ...while ``a`` is still read
        return b, c

    entry = tr.trace_entry(f, (torch.ones((16, 16)),), name="overlap",
                           argnames=("a",), carry=("a",))
    errs = check_memory(entry)[0].errors()
    assert errs and all(f.rule == "QL402" for f in errs), errs
    assert "lifetimes overlap" in errs[0].message


# ------------------------------------------------------ QL401 budgets
def test_memcheck_flags_seeded_hbm_blowout():
    from repro.analysis import trace as jtrace
    from repro.analysis.memcheck import check_memory as jcheck
    entry = tr.hbm_blowout_entry("cpu")
    rep, rec = check_memory(entry)
    errs = rep.errors()
    assert errs and all(f.rule == "QL401" for f in errs), rep.pretty(True)
    # blows the budget both at the traced window and at the envelope
    assert len(errs) == 2
    assert rec["peak_trace_bytes"] > rec["budget_trace_bytes"]
    assert rec["peak_envelope_bytes"] > rec["budget_envelope_bytes"]
    ref = jtrace.hbm_blowout_entry()
    ref_rep, ref_rec = jcheck(ref)
    assert finding_keys(rep, entry.labels) == finding_keys(ref_rep,
                                                           ref.labels)
    # the same contract from the same argument bytes
    for k in ("budget_trace_bytes", "budget_envelope_bytes",
              "window_state_bytes_per_token"):
        assert rec[k] == ref_rec[k], k


def test_memcheck_quiet_on_clean_entries():
    from repro.analysis import trace as jtrace
    from repro.analysis.memcheck import check_memory as jcheck
    pairs = [(tr.recon_chunk_entry(device="cpu"), jtrace.recon_chunk_entry()),
             (tr.probe_entry(device="cpu"), jtrace.probe_entry()),
             (tr.flexround_apply_entry(device="cpu"),
              jtrace.flexround_apply_entry())]
    pairs += list(zip(tr.matmul_entries(device="cpu"),
                      jtrace.matmul_entries()))
    for entry, ref in pairs:
        rep, rec = check_memory(entry)
        assert rep.errors() == [], f"{entry.name}: {rep.pretty(True)}"
        assert finding_keys(rep, entry.labels) == finding_keys(
            jcheck(ref)[0], ref.labels), entry.name
        assert rec["donation_dead"] == 0


# ------------------------------------------- QL403/QL405 against the reference
def test_weight_and_kv_bytes_equal_the_reference(serve_entries):
    from repro.analysis.memcheck import check_memory as jcheck
    port, ref = serve_entries
    for entry, jentry in zip(port, ref):
        rep, rec = check_memory(entry)
        jrep, jrec = jcheck(jentry)
        assert rep.errors() == [], f"{entry.name}: {rep.pretty(True)}"
        assert entry.name == jentry.name
        got = {(r["measure"], r["expected_bytes"], r["static_bytes"])
               for r in rec["expect"]}
        want = {(r["measure"], r["expected_bytes"], r["static_bytes"])
                for r in jrec["expect"]}
        assert got == want, entry.name
        assert rec["window_state_bytes_per_token"] == \
            jrec["window_state_bytes_per_token"], entry.name
        assert {(f.rule, f.severity) for f in rep} == {
            (f.rule, f.severity) for f in jrep}, entry.name


def test_serving_bodies_write_their_state(serve_entries):
    port, _ = serve_entries
    for entry in port:
        rep = gc.check_entry(entry)
        assert rep.errors() == [], f"{entry.name}: {rep.pretty(True)}"
        assert set(entry.carry) <= {entry.labels[i] for i in entry.donated}


def test_memcheck_static_kv_gap_equals_the_reference(serve_entries):
    from repro.analysis.memcheck import check_kv_static_gap as jgap
    port, ref = serve_entries
    rep, jrep = check_kv_static_gap(port), jgap(ref)
    assert rep.errors() == [] and rep.by_rule("QL405"), rep.pretty(True)
    # the same per-token bytes, read off the graphs
    assert [f.message.split(" — ")[0].split(" (")[0] for f in rep] == [
        f.message.split(" — ")[0].split(" (")[0] for f in jrep]


def test_memcheck_static_kv_gap():
    """check_kv_static_gap proves int8-below-bf16 from per-token window
    bytes of the cache inputs alone (and errors on the inverse, and on a
    per-slot count the accessor does not report)."""
    def mk(dtype, tag, expected=None):
        cache = torch.zeros((2, 24, 2, 16), dtype=dtype)
        p = torch.ones((4,))
        nbytes = cache.numel() * cache.element_size()
        mem = tr.mem_contract((p, cache), max_len=24, slots=2, expect=(
            ("kv_cache", "cache*", nbytes if expected is None else expected),))
        return tr.trace_entry(lambda p, c: c.float().sum() + p.sum(),
                              (p, cache), name=f"serve_decode[toy]{tag}",
                              argnames=("params", "cache"), mem=mem)

    int8, bf16 = mk(torch.int8, ""), mk(torch.bfloat16, "[bf16-kv]")
    rep = check_kv_static_gap([int8, bf16])
    assert rep.errors() == [] and rep.by_rule("QL405"), rep.pretty(True)
    # inverse world: the "int8" cache grew past bf16 — must error
    fat = mk(torch.float32, "")
    assert check_kv_static_gap([fat, bf16]).exit_code() == 1
    # an accessor that disagrees with the cache the step reads
    wrong = mk(torch.int8, "", expected=4096)
    assert check_kv_static_gap([wrong, bf16]).exit_code() == 1


def test_mem_report_json(tmp_path):
    recs = [check_memory(tr.hbm_blowout_entry("cpu"))[1]]
    path = tmp_path / "mem.json"
    mem_report_json(recs, str(path), log=lambda *a: None)
    doc = json.loads(path.read_text())
    assert doc["entries"][0]["entry"] == "decode_attention[seeded:hbm_blowout]"
    assert doc["roofline"]["peak_hbm_bytes_envelope"] == \
        recs[0]["peak_envelope_bytes"]


@pytest.mark.parametrize("bug,rule", [("dead_donation", "QL402"),
                                      ("hbm_blowout", "QL401")])
def test_seeded_memcheck_runs_exit_nonzero(bug, rule):
    from repro_torch.analysis import lint
    rep = lint.run_analysis(jaxpr_only=True, mem=True, seed_bug=bug,
                            device="cpu", log=lambda *a, **k: None)
    assert rep.exit_code() == 1
    assert any(f.rule == rule for f in rep.errors()), rep.pretty(True)


@pytest.mark.requires_cuda
def test_replayed_peak_within_the_allocator_rounding():
    """On the card: each graph replayed on its exemplar tensors peaks, in
    the caching allocator, at most at the static walk's peak above the
    inputs in 512-byte blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py replays every entry "
                    "with a budget")
    from repro_torch.analysis.memcheck import replay_peak
    for entry in (tr.probe_entry(device="cuda"),
                  tr.hbm_blowout_entry("cuda")):
        got = replay_peak(entry)
        assert 0 < got["measured_bytes"] <= got["static_rounded_bytes"], \
            (entry.name, got)


def test_multi_output_storages_round_one_by_one():
    """A ``_foreach_*`` op allocates one block per result: the static peak
    in 512-byte blocks rounds each (measured on the card: 12 small Adam
    states took 12 blocks, not one)."""
    def f(a, b):
        return torch._foreach_mul([a, b], 2.0)

    entry = tr.trace_entry(f, (torch.ones(3), torch.ones(5)), name="fe",
                           argnames=("a", "b"))
    live = _walk(entry.closed, 0)
    assert sum(live.owners.values()) == 32
    assert live.peak_rounded == 2 * ALLOC_ROUND
