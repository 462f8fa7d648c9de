"""The port's automatic bit allocation (``repro_torch.allocate``) against
``tests/test_allocate.py``'s contracts and against the reference package.

Inputs are numpy arrays made from seeds and fed to both packages (chains of
two-linear blocks, width 24 and 40, and a prefix-less block, float32 on the
CPU); the reference modules are imported inside the fixtures that use them,
so the card test (``requires_cuda``) also runs on a machine without jax:
``python -m pytest -q -m requires_cuda tests/test_torch_allocate.py``.

Tolerances, stated where they are used:

- ``cost_bytes``, ``numel`` and ``cascade`` are integers or exact; they
  must equal the reference's.
- Probe scores: the RTN grids are the reference's bit for bit (the mse
  observer is), so a probe's weights are identical and only the float32
  sums of the matmuls and of the MSE are ordered differently. ``mse`` is a
  mean of squared differences between two nearly equal block outputs
  (relative 1e-7 noise on outputs of size ~1, differences down to ~5e-3 at
  8 bits), so it is held to relative 1e-4; ``fisher`` sums weight-space
  terms over a captured second moment, relative 1e-5. (Measured here:
  at most 4.8e-6 and 5.3e-7.)
- The solvers run numpy and Python float arithmetic in the reference's
  order, so the same scores give identical bits, cost, predicted score,
  solver and digest, with no tolerance.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.allocate import (AllocationReport, Budget, ProbeResult,
                                  SiteScore, auto_allocate, probe_blocks,
                                  solve_allocation, validate_budget)
from repro_torch.allocate import sensitivity
from repro_torch.checkpoint import load_allocation, load_pytree, save_allocation
from repro_torch.checkpoint.checkpoint import PTQCheckpointer
from repro_torch.core import reconstruct as rc
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant_config import QuantRecipe, exact_site_pattern
from repro_torch.launch import quantize
from repro_torch.obs import compile_events

torch.set_num_threads(2)

D, H = 24, 40
RECIPE_KW = dict(method="flexround", w_bits=4, w_symmetric=True,
                 a_bits=None, iters=40, lr=3e-3, batch_size=8)
RECIPE = QuantRecipe(**RECIPE_KW)
X_NP = np.random.default_rng(1).standard_normal((48, D)).astype(np.float32)
MSE_RTOL, FISHER_RTOL = 1e-4, 1e-5


# ------------------------------------------------------------- test blocks
def chain_weights(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"w1": (rng.standard_normal((D, H)) * D**-0.5).astype(np.float32),
             "w2": (rng.standard_normal((H, D)) * H**-0.5).astype(np.float32)}
            for _ in range(n)]


def prefixless_weights(d=16):
    rng = np.random.default_rng(0)
    return {k: (rng.standard_normal((d, d)) * d**-0.5).astype(np.float32)
            for k in ("embed", "lm_head")}


def make_chain(n, token=None, device="cpu", weights=None):
    blocks = []
    token = (object(),) if token is None else token
    for i, w in enumerate(weights or chain_weights(n)):
        name = f"layers.{i}"
        params = {k: torch.tensor(v, device=device) for k, v in w.items()}

        def apply(p, x, ctx, _n=name):
            z = F.gelu(ctx.linear(f"{_n}.w1", x, p["w1"]), approximate="tanh")
            return ctx.linear(f"{_n}.w2", z, p["w2"]) + x

        sites = {f"{name}.w1": rc.Site(("w1",)), f"{name}.w2": rc.Site(("w2",))}
        blocks.append(rc.BlockHandle(name, params, apply, sites,
                                     apply_key=token))
    return blocks


def make_prefixless_block(device="cpu"):
    params = {k: torch.tensor(v, device=device)
              for k, v in prefixless_weights().items()}

    def apply(p, x, ctx):
        h = ctx.linear("embed", x, p["embed"])
        return ctx.linear("lm_head", F.gelu(h, approximate="tanh"),
                          p["lm_head"])

    sites = {"embed": rc.Site(("embed",)), "lm_head": rc.Site(("lm_head",))}
    return rc.BlockHandle("top", params, apply, sites)


def x_stream(device="cpu"):
    return torch.tensor(X_NP, device=device)


def prefixless_x():
    return np.random.default_rng(2).standard_normal((32, 16)).astype(np.float32)


@pytest.fixture
def fresh():
    rc.clear_engine_cache()
    rc.reset_engine_stats()
    compile_events.reset()
    yield
    rc.clear_engine_cache()
    rc.reset_engine_stats()


# -------------------------------------------------------- the reference
@pytest.fixture(scope="module")
def J():
    """The reference's allocator and the same test blocks built in JAX."""
    import jax
    import jax.numpy as jnp

    from repro import allocate as jalloc
    from repro.allocate import sensitivity as jsens
    from repro.core import reconstruct as jrc
    from repro.core.quant_config import QuantRecipe as JQuantRecipe
    from repro.core.quant_config import exact_site_pattern as jexact

    def chain(n, weights=None):
        token, blocks = (object(),), []
        for i, w in enumerate(weights or chain_weights(n)):
            name = f"layers.{i}"
            params = {k: jnp.asarray(v) for k, v in w.items()}

            def apply(p, x, ctx, _n=name):
                z = jax.nn.gelu(ctx.linear(f"{_n}.w1", x, p["w1"]))
                return ctx.linear(f"{_n}.w2", z, p["w2"]) + x

            sites = {f"{name}.w1": jrc.Site(("w1",)),
                     f"{name}.w2": jrc.Site(("w2",))}
            blocks.append(jrc.BlockHandle(name, params, apply, sites,
                                          apply_key=token))
        return blocks

    def prefixless():
        params = {k: jnp.asarray(v) for k, v in prefixless_weights().items()}

        def apply(p, x, ctx):
            h = ctx.linear("embed", x, p["embed"])
            return ctx.linear("lm_head", jax.nn.gelu(h), p["lm_head"])

        sites = {"embed": jrc.Site(("embed",)),
                 "lm_head": jrc.Site(("lm_head",))}
        return jrc.BlockHandle("top", params, apply, sites)

    return types.SimpleNamespace(
        jnp=jnp, alloc=jalloc, sens=jsens, rc=jrc, exact=jexact,
        recipe=JQuantRecipe(**RECIPE_KW), chain=chain, prefixless=prefixless)


def to_reference(J, probe: ProbeResult):
    """The port's ProbeResult as the reference's (same numbers)."""
    scores = {site: {b: J.sens.SiteScore(**dataclasses.asdict(s))
                     for b, s in per.items()}
              for site, per in probe.scores.items()}
    return J.sens.ProbeResult(scores=scores, steps=probe.steps,
                              seconds=probe.seconds,
                              compile_count=probe.compile_count)


@pytest.fixture(scope="module")
def probes(J):
    """Each package's probe of the 3-block chain and of the prefix-less
    block (the reference's needs its own engine scope and stats)."""
    out = {}
    for tag in ("chain", "prefixless"):
        if tag == "chain":
            pb, jb = make_chain(3), J.chain(3)
            x, jx = x_stream(), J.jnp.asarray(X_NP)
        else:
            pb, jb = [make_prefixless_block()], [J.prefixless()]
            x, jx = torch.tensor(prefixless_x()), J.jnp.asarray(prefixless_x())
        out[tag] = (probe_blocks(pb, RECIPE, x),
                    J.alloc.probe_blocks(jb, J.recipe, jx))
    return out


# ----------------------------------------------------------- site patterns
@pytest.mark.parametrize("name", ["layers.3.mlp.w_up", "w[0]", "a*b?c",
                                  "x[[y]]*", "embed"])
def test_exact_site_pattern_is_the_reference_escape(J, name):
    from repro_torch.core.quant_config import SiteRule
    pat = exact_site_pattern(name)
    assert pat == J.exact(name)
    assert SiteRule.make(pat, w_bits=8).matches(name)


# ------------------------------------------------------------------- probe
def test_probe_scores_monotone_and_cascade_weighted(fresh):
    probe = probe_blocks(make_chain(3), RECIPE, x_stream())
    assert probe.steps == 3 * 2 * 4  # blocks x sites x candidate bits
    assert probe.steps_per_s > 0
    assert probe.init_seconds > 0 and probe.replay_seconds > 0
    for site, per in probe.scores.items():
        assert set(per) == {2, 3, 4, 8}
        assert per[2].mse > per[4].mse > per[8].mse >= 0
        assert per[2].fisher > per[4].fisher > per[8].fisher >= 0
        assert per[4].numel == 960
        # <=4-bit levels nibble-pack: half the code bytes of the 8-bit level
        assert per[8].cost_bytes - per[4].cost_bytes == 960 // 2
    assert probe.scores["layers.0.w1"][4].cascade == 3.0
    assert probe.scores["layers.2.w1"][4].cascade == 1.0


@pytest.mark.parametrize("tag", ["chain", "prefixless"])
def test_probe_scores_match_the_reference(probes, tag):
    got, want = probes[tag]
    assert got.sites() == tuple(sorted(want.scores))
    assert got.steps == want.steps
    for site in got.sites():
        assert sorted(got.scores[site]) == sorted(want.scores[site])
        for b, s in got.scores[site].items():
            w = want.scores[site][b]
            assert (s.site, s.bits, s.cost_bytes, s.numel, s.cascade) == (
                w.site, w.bits, w.cost_bytes, w.numel, w.cascade), (site, b)
            np.testing.assert_allclose(s.mse, w.mse, rtol=MSE_RTOL,
                                       err_msg=f"{site} w{b} mse")
            np.testing.assert_allclose(s.fisher, w.fisher, rtol=FISHER_RTOL,
                                       err_msg=f"{site} w{b} fisher")


def test_probe_compiles_per_apply_key_not_per_site(fresh):
    """Probe bodies scale with distinct apply_keys x candidate bits, flat in
    depth; the port's teacher is eager (0 teacher compiles, where the
    reference compiles 1)."""
    counts = {}
    for n in (2, 6):
        rc.reset_engine_stats()
        probe = probe_blocks(make_chain(n), RECIPE, x_stream())
        st = rc.engine_stats()
        counts[n] = (st.probe_compiles, st.teacher_compiles)
        assert probe.compile_count == sum(counts[n])
        assert probe.steps == n * 2 * 4
        assert st.step_compiles == st.engine_builds == 0
    assert counts[2] == counts[6] == (4, 0), counts
    assert compile_events.captures() == 0  # nothing is captured on the CPU


def test_probe_teacher_is_the_fp_forward_and_refuses_a_mesh(fresh):
    """The teacher is the fp forward. A mesh is no longer refused: under a
    world-1 gloo group's flat mesh the teacher is the same function and
    the probe's scores (whose reductions then run over one rank) equal the
    unsharded pass's bit for bit, with the same bodies."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    from test_torch_mesh import free_port
    block = make_chain(1)[0]
    x = x_stream()
    y = rc.probe_teacher(block, RECIPE)(block.params, x)
    want = block.apply(block.params, x, rc.QuantCtx(mode="fp"))
    assert torch.equal(y, want) and not y.requires_grad
    assert rc.engine_stats().teacher_compiles == 0
    plain = probe_blocks(make_chain(2), RECIPE, x)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = tmesh.make_flat_mesh(1, device_type="cpu")
        y = rc.probe_teacher(block, RECIPE, mesh=mesh)(block.params, x)
        assert torch.equal(y, want)
        sharded = probe_blocks(make_chain(2), RECIPE, x, mesh=mesh)
    finally:
        tmesh.shutdown()
    assert sharded.scores == plain.scores
    assert sharded.compile_count == plain.compile_count


def test_graphed_probe_on_the_cpu_raises(fresh):
    with pytest.raises(ValueError, match="graphs=True needs a CUDA device"):
        probe_blocks(make_chain(1), RECIPE, x_stream(), graphs=True)


def test_probe_releases_its_bodies(fresh, monkeypatch):
    """The probe cache lives inside engine_scope: no body outlives the pass
    and the engine cache holds nothing new."""
    built = []
    real = sensitivity._Probe.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        built.append(self)

    monkeypatch.setattr(sensitivity._Probe, "__init__", init)
    probe_blocks(make_chain(2), RECIPE, x_stream())
    assert len(built) == 4
    assert len(rc._ENGINE_CACHE) == 0 and not rc._SCOPE_STACK


# ------------------------------------------------------------------ solver
def _mk_probe(site_levels, cls=(SiteScore, ProbeResult)):
    """site_levels: {site: {bits: (mse, cost_bytes, numel)}} -> ProbeResult."""
    score_cls, probe_cls = cls
    scores = {site: {b: score_cls(site=site, bits=b, mse=mse, fisher=0.0,
                                  cost_bytes=cb, numel=numel)
                     for b, (mse, cb, numel) in per.items()}
              for site, per in site_levels.items()}
    return probe_cls(scores=scores, steps=1, seconds=1.0, compile_count=0)


CRAFTED = {
    # plain greedy is suboptimal here: B's cheap upgrade blocks A's big one
    "greedy_trap": {"a": {2: (10.0, 2, 100), 8: (1.0, 6, 100)},
                    "b": {2: (6.0, 2, 100), 4: (0.0, 4, 100)}},
    "hot_site": {s: {b: (float(2 ** -b) * (10 if s == "hot" else 1),
                         50 * b, 100) for b in (2, 4, 8)}
                 for s in ("hot", "cold1", "cold2", "cold3")},
}


def test_greedy_and_dp_satisfy_budget_dp_no_worse():
    probe = _mk_probe(CRAFTED["greedy_trap"])
    budget = Budget("weight_bytes", 8)
    got = {}
    for solver in ("greedy", "dp"):
        alloc = solve_allocation(probe, budget, objective="mse", solver=solver)
        assert alloc.cost <= alloc.capacity
        got[solver] = alloc
    assert got["dp"].predicted_score <= got["greedy"].predicted_score
    assert got["dp"].bits == {"a": 8, "b": 2}
    auto = solve_allocation(probe, budget, objective="mse", solver="auto")
    assert auto.solver == "dp"
    assert auto.predicted_score == got["dp"].predicted_score


def test_avg_bits_budget_caps_weighted_average():
    probe = _mk_probe(CRAFTED["hot_site"])
    alloc = solve_allocation(probe, Budget("avg_bits", 4.5), objective="mse")
    assert sum(100 * b for b in alloc.bits.values()) <= 4.5 * 400
    assert alloc.avg_bits <= 4.5
    assert alloc.bits["hot"] == 8


def test_infeasible_budget_and_bad_kinds_raise():
    probe = _mk_probe({"a": {4: (1.0, 100, 100), 8: (0.0, 200, 100)}})
    with pytest.raises(ValueError, match="infeasible"):
        solve_allocation(probe, Budget("weight_bytes", 50))
    with pytest.raises(ValueError, match="infeasible"):
        solve_allocation(probe, Budget("avg_bits", 1.0))
    with pytest.raises(ValueError, match="budget kind"):
        Budget("bits_per_layer", 4)
    with pytest.raises(ValueError, match="must be > 0"):
        Budget("avg_bits", 0)
    with pytest.raises(ValueError, match="objective"):
        solve_allocation(probe, Budget("avg_bits", 8.0), objective="kl")
    with pytest.raises(ValueError, match="solver"):
        solve_allocation(probe, Budget("avg_bits", 8.0), solver="ilp")


BUDGETS = [("avg_bits", 3.0), ("avg_bits", 4.5), ("avg_bits", 6.0),
           ("weight_bytes", 3500), ("weight_bytes", 4500)]


def _same_allocation(a, j):
    assert a.bits == j.bits
    assert (a.solver, a.objective, a.cost, a.capacity, a.avg_bits,
            a.total_bytes) == (j.solver, j.objective, j.cost, j.capacity,
                               j.avg_bits, j.total_bytes)
    assert a.predicted_score == j.predicted_score
    assert [(r.pattern, r.overrides) for r in a.rules()] == \
        [(r.pattern, r.overrides) for r in j.rules()]


@pytest.mark.parametrize("solver", ["greedy", "dp", "auto"])
@pytest.mark.parametrize("kind,value", BUDGETS)
@pytest.mark.parametrize("objective", ["mse", "fisher", "combined"])
def test_solver_picks_the_reference_bits_for_the_same_scores(
        J, probes, solver, kind, value, objective):
    probe = probes["chain"][0]
    a = solve_allocation(probe, Budget(kind, value), objective=objective,
                         solver=solver)
    j = J.alloc.solve_allocation(to_reference(J, probe),
                                 J.alloc.Budget(kind, value),
                                 objective=objective, solver=solver)
    _same_allocation(a, j)


@pytest.mark.parametrize("solver", ["greedy", "dp"])
@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_solver_matches_the_reference_on_crafted_probes(J, case, solver):
    budget = ("weight_bytes", 8) if case == "greedy_trap" else ("avg_bits", 4.5)
    a = solve_allocation(_mk_probe(CRAFTED[case]), Budget(*budget),
                         objective="mse", solver=solver)
    j = J.alloc.solve_allocation(
        _mk_probe(CRAFTED[case], (J.sens.SiteScore, J.sens.ProbeResult)),
        J.alloc.Budget(*budget), objective="mse", solver=solver)
    _same_allocation(a, j)


@pytest.mark.parametrize("value", [4.5, 4, 5.0])
def test_report_document_and_digest_are_the_reference(J, probes, tmp_path,
                                                      value):
    """The same allocation gives the reference's JSON document and digest;
    the budget value keeps its type (4 and 4.0 give other digests, in both
    packages alike). The port's allocation.json is the reference's, byte
    for byte, and each package reads the other's."""
    probe = probes["chain"][0]
    a = solve_allocation(probe, Budget("avg_bits", value))
    ja = J.alloc.solve_allocation(to_reference(J, probe),
                                  J.alloc.Budget("avg_bits", value))
    rep = AllocationReport.build(probe, a)
    jrep = J.alloc.AllocationReport.build(to_reference(J, probe), ja)
    assert rep.digest() == jrep.digest()
    assert json.dumps(rep.to_dict(), sort_keys=True) == \
        json.dumps(jrep.to_dict(), sort_keys=True)
    assert rep.meta() == jrep.meta() and rep.pretty() == jrep.pretty()
    rep.save(str(tmp_path / "port"))
    jrep.save(str(tmp_path / "ref"))
    assert (tmp_path / "port" / "allocation.json").read_bytes() == \
        (tmp_path / "ref" / "allocation.json").read_bytes()
    assert J.alloc.AllocationReport.load(str(tmp_path / "port")).digest() == \
        AllocationReport.load(str(tmp_path / "ref")).digest() == rep.digest()


@pytest.mark.parametrize("kind,value", BUDGETS)
def test_each_package_probes_and_solves_to_the_same_bits(J, probes, kind,
                                                         value):
    """Each package's own probe, then its own solve: the same bits."""
    got, want = probes["chain"]
    a = solve_allocation(got, Budget(kind, value))
    j = J.alloc.solve_allocation(want, J.alloc.Budget(kind, value))
    assert a.bits == j.bits and a.solver == j.solver


# ------------------------------------------------------- rules + round trip
def test_emitted_rules_resolve_to_chosen_bits(fresh):
    report = auto_allocate(make_chain(3), RECIPE, x_stream(),
                           Budget("avg_bits", 4.5))
    assert validate_budget(report)
    recipe = RECIPE.with_rules(*report.rules())
    for site, bits in report.bits().items():
        assert recipe.resolve(site).weight.bits == bits
    user = RECIPE.with_rules("layers.0.*:w_bits=2")
    recipe2 = user.with_rules(*report.rules())
    assert recipe2.resolve("layers.0.w1").weight.bits == \
        report.bits()["layers.0.w1"]


def test_allocator_covers_prefixless_sites(fresh):
    block = make_prefixless_block()
    x = torch.tensor(prefixless_x())
    report = auto_allocate([block], RECIPE, x, Budget("avg_bits", 6.0))
    assert set(report.bits()) == {"embed", "lm_head"}
    recipe = RECIPE.with_rules(*report.rules())
    for site, bits in report.bits().items():
        assert recipe.resolve(site).weight.bits == bits
    fin, _, _ = rc.quantize_blocks([block], dataclasses.replace(recipe,
                                                                iters=2), x)
    got = sorted(v.bits for v in fin[0].values() if isinstance(v, QTensor))
    assert got == sorted(report.bits().values())


def test_report_json_round_trip_and_digest(fresh):
    blocks = make_chain(2)
    report = auto_allocate(blocks, RECIPE, x_stream(), Budget("avg_bits", 4.5))
    clone = AllocationReport.from_dict(report.to_dict())
    assert clone.digest() == report.digest()
    assert clone.bits() == report.bits()
    assert [r.pattern for r in clone.rules()] == \
        [r.pattern for r in report.rules()]
    moved = AllocationReport.from_dict(
        {**report.to_dict(), "probe": {"steps": 0, "seconds": 9.9,
                                       "steps_per_s": 0, "compile_count": 0}})
    assert moved.digest() == report.digest()
    other = auto_allocate(blocks, RECIPE, x_stream(), Budget("avg_bits", 5.0))
    assert other.digest() != report.digest()


def test_auto_beats_uniform_w4_at_matched_budget_slack(fresh):
    """avg_bits=4.5 must strictly beat uniform W4 in aggregate recon MSE."""
    blocks = make_chain(4)
    report = auto_allocate(blocks, RECIPE, x_stream(), Budget("avg_bits", 4.5))
    assert validate_budget(report)
    auto = RECIPE.with_rules(*report.rules())
    _, _, rep_u = rc.quantize_blocks(blocks, RECIPE, x_stream())
    _, _, rep_a = rc.quantize_blocks(blocks, auto, x_stream())
    err_u = sum(r.err_after for r in rep_u)
    err_a = sum(r.err_after for r in rep_a)
    assert err_a < err_u, (err_a, err_u)


# ------------------------------------------------------------- checkpoints
def test_save_allocation_commits_atomically(tmp_path):
    doc = {"name": "a", "sites": {"x": {"bits": 4}}}
    path = save_allocation(str(tmp_path), doc)
    assert load_allocation(str(tmp_path)) == doc
    save_allocation(str(tmp_path), dict(doc, name="b"))
    assert load_allocation(str(tmp_path))["name"] == "b"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["allocation.json"]
    assert path == str(tmp_path / "allocation.json")
    assert load_allocation(str(tmp_path / "none")) is None


def _alloc_setup(tmp_path):
    blocks = make_chain(2)
    base = dataclasses.replace(RECIPE, method="rtn", iters=1)
    report = auto_allocate(blocks, base, x_stream(), Budget("avg_bits", 4.5))
    recipe = base.with_rules(*report.rules())
    rc.quantize_blocks(blocks, recipe, x_stream(),
                       checkpoint_dir=str(tmp_path), allocation=report.meta())
    report.save(str(tmp_path))
    return blocks, base, recipe, report


def test_checkpoint_resume_same_allocation_succeeds(fresh, tmp_path):
    blocks, base, recipe, report = _alloc_setup(tmp_path)
    resumed = PTQCheckpointer(str(tmp_path)).load(
        blocks, recipe, allocation=report.meta(), device="cpu")
    assert resumed is not None and resumed[0] == len(blocks)
    loaded = AllocationReport.load(str(tmp_path))
    assert loaded is not None and loaded.digest() == report.digest()
    fin, _, _ = rc.quantize_blocks(blocks, recipe, x_stream(),
                                   checkpoint_dir=str(tmp_path),
                                   allocation=report.meta())
    assert len(fin) == len(blocks)


def test_checkpoint_mutated_rules_fail_naming_allocation(fresh, tmp_path):
    blocks, base, recipe, report = _alloc_setup(tmp_path)
    flipped = {s: (8 if b != 8 else 4) for s, b in report.bits().items()}
    mutated = base.with_rules(*recipe.rules,
                              *(f"{s}:w_bits={b}" for s, b in flipped.items()))
    with pytest.raises(ValueError, match="emitted by allocation"):
        PTQCheckpointer(str(tmp_path)).load(blocks, mutated,
                                            allocation=report.meta(),
                                            device="cpu")
    with pytest.raises(ValueError, match=report.name):
        rc.quantize_blocks(blocks, mutated, x_stream(),
                           checkpoint_dir=str(tmp_path),
                           allocation=report.meta())


def test_checkpoint_different_allocation_digest_fails(fresh, tmp_path):
    blocks, base, recipe, report = _alloc_setup(tmp_path)
    other = auto_allocate(blocks, base, x_stream(), Budget("avg_bits", 5.5))
    with pytest.raises(ValueError, match="resume mismatch.*allocation"):
        PTQCheckpointer(str(tmp_path)).load(blocks, recipe,
                                            allocation=other.meta(),
                                            device="cpu")
    with pytest.raises(ValueError, match="no allocation"):
        PTQCheckpointer(str(tmp_path)).load(blocks, recipe, allocation=None,
                                            device="cpu")


# ---------------------------------------------------------------- launcher
SMOKE = ["--arch", "smollm-135m", "--smoke", "--calib", "8", "--seq", "16",
         "--iters", "2", "--device", "cpu"]
# the smoke model's 14 sites hold 45,056 serving bytes at 4 bits (including
# the grid) and 57,344 at 8: 50,000 lets the solver lift some of them
LAUNCH_BUDGETS = {"avg_bits": ("4.5", "avg_bits", "4.0"),
                  "bytes": ("50000", "weight_bytes", "48000")}


def _export(path):
    tree, meta = load_pytree(path, device="cpu")
    return tree, meta


def _same_tree(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, QTensor):
        return (a.shape, a.bits, a.packed) == (b.shape, b.bits, b.packed) and \
            all(torch.equal(getattr(a, f), getattr(b, f))
                for f in ("codes", "scale", "zero"))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("budget", sorted(LAUNCH_BUDGETS))
def test_launcher_auto_bits_records_reuses_and_refuses(tmp_path, capsys,
                                                       budget):
    value, kind, other = LAUNCH_BUDGETS[budget]
    d = str(tmp_path / "ckpt")
    argv = SMOKE + ["--auto-bits", value, "--budget", budget, "--resume-dir", d]
    res1 = quantize.main(argv + ["--out", str(tmp_path / "o1")])
    out1 = capsys.readouterr().out
    assert "allocation 'auto" in out1 and "reusing" not in out1
    doc = load_allocation(d)
    report = AllocationReport.from_dict(doc)
    assert report.budget == {"kind": kind, "value": float(value)}
    assert report.objective == "combined" and validate_budget(report)
    assert res1.allocation == report.meta()
    assert "probe=4 " in out1  # 1 apply_key x 4 candidate bits
    for site, b in report.bits().items():
        assert res1.recipe.resolve(site).weight.bits == b
    bits = {qt.bits for layer in res1.qparams["layers"]
            for grp in layer.values() if isinstance(grp, dict)
            for qt in grp.values() if isinstance(qt, QTensor)}
    bits |= {qt.bits for layer in res1.qparams["layers"]
             for qt in layer.values() if isinstance(qt, QTensor)}
    assert bits == set(report.bits().values())

    res2 = quantize.main(argv + ["--out", str(tmp_path / "o2")])
    out2 = capsys.readouterr().out
    assert f"reusing recorded allocation from {d}:" in out2
    assert rc.engine_stats().probe_compiles == 0 and "probe=0 " in out2
    assert res2.resumed_units == 2 and res2.allocation == res1.allocation
    t1, m1 = _export(str(tmp_path / "o1"))
    t2, m2 = _export(str(tmp_path / "o2"))
    assert _same_tree(t1, t2) and m1["rules"] == m2["rules"]

    with pytest.raises(ValueError, match="holds allocation .* but this run "
                                         "requests"):
        quantize.main(SMOKE + ["--auto-bits", other, "--budget", budget,
                               "--resume-dir", d])
    with pytest.raises(ValueError, match="holds allocation"):
        quantize.main(argv + ["--alloc-objective", "mse"])


def test_launcher_allocation_matches_the_reference_launcher(tmp_path):
    """The reference's launcher and the port's, on the reference's weights
    and calibration tokens, record the same bits and the same digest."""
    import jax

    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.data import CalibrationSet as JCalibrationSet
    from repro.data import SyntheticTokens as JSyntheticTokens
    from repro.launch import quantize as jquantize
    from repro.models import build_model as jbuild_model
    from repro_torch import bridge

    jcfg = jget_smoke_config("smollm-135m")
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    calib = np.asarray(JCalibrationSet.build(
        JSyntheticTokens(vocab=jcfg.vocab, seq_len=16, seed=0), 8).tokens)
    flags = ["--arch", "smollm-135m", "--smoke", "--calib", "8", "--seq", "16",
             "--iters", "0", "--auto-bits", "4.5"]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    import sys
    saved = sys.argv
    sys.argv = ["repro.launch.quantize"] + flags + [
        "--resume-dir", jdir, "--out", str(tmp_path / "jo")]
    try:
        jquantize.main()
    finally:
        sys.argv = saved
    args = quantize.build_parser().parse_args(flags + [
        "--resume-dir", tdir, "--out", str(tmp_path / "to"), "--device", "cpu"])
    quantize.run(args, params=bridge.params(jparams, "cpu"),
                 calib_tokens=torch.from_numpy(calib.copy()))
    jrep = AllocationReport.from_dict(load_allocation(jdir))
    rep = AllocationReport.from_dict(load_allocation(tdir))
    assert rep.bits() == jrep.bits() and rep.digest() == jrep.digest()
    assert rep.solver == jrep.solver
    for k, v in rep.summary.items():  # the score sums probe MSEs
        if k == "predicted_score":
            np.testing.assert_allclose(v, jrep.summary[k], rtol=MSE_RTOL)
        else:
            assert v == jrep.summary[k], k
    assert len(set(rep.bits().values())) >= 2


# ----------------------------------------------------------------- on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the graphed "
                    "probe through the launcher on the card")
    return "cuda"


@pytest.mark.requires_cuda
def test_graphed_probe_equals_the_eager_probe_on_a_card(fresh):
    """Every site's MSE replayed from the captured body equals the body run
    call by call, bit for bit; one body (and one capture) per probe key."""
    dev = _card()
    runs = {}
    for graphs in (False, None):
        compile_events.reset()
        rc.reset_engine_stats()
        runs[graphs] = probe_blocks(make_chain(3, device=dev), RECIPE,
                                    x_stream(dev), graphs=graphs)
        st = rc.engine_stats()
        assert st.probe_compiles == 4  # 1 apply_key x 4 bits
        assert len(compile_events.capture_seconds("alloc.probe")) == (
            0 if graphs is False else 4)
    eager, graphed = runs[False], runs[None]
    assert eager.sites() == graphed.sites()
    for site in eager.sites():
        for b, s in eager.scores[site].items():
            assert graphed.scores[site][b] == s, (site, b)
