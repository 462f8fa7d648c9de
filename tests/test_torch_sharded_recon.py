"""Data-parallel calibration: ``repro_torch.core.reconstruct`` and
``repro_torch.allocate`` with ``mesh=``, over 2 and 4 spawned gloo ranks on
the CPU (one spawn per world for the module, one thread per rank), against
the single-process port and the live reference (``repro.core``).

Every rank gets the whole streams and keeps its rows; the minibatch is
assembled on every rank, the loss is a sum over the global count and the
gradients, loss and MSE are all-reduced (``core/reconstruct.py``'s module
docstring). The only permitted difference from a single-process run is
float summation order, and Adam amplifies it where a gradient is near
zero: its first steps move every state by about ``lr * sign(g)``. So:

- Weight-only runs (W4 FlexRound, the reference's minibatch schedule) stay
  within the reference's own tolerances of ``test_torch_recon.py`` over 12
  steps: the loss curve relative 1e-5 (the port against itself 1e-6), the
  states relative 2e-5 plus 2e-4 of the distance 12 steps can move them.
- A8 with QDrop, the reference's minibatches and masks (each rank slices
  its positions of every mask) and the LSQ states held (``lr_lsq=0``):
  the same tolerances. This pins the masks and the A8 forward.
- A8 with LSQ learning: an activation step size sums its gradient over
  every activation of the batch, and where that sum is near zero its sign
  differs between summation orders; Adam's first steps move the step size
  by ``lr_lsq`` in the sign's direction, which moves every code boundary
  (with ``lr_lsq=0`` the same runs agree to 1e-7; checked on the CPU, where
  the learning runs part by up to 8% in the loss within 12 steps). Those
  runs are held by quality at 50 steps: the error after within 10% of the
  single-process run's, and below a factor 1.3 of the reference's own run
  (``test_torch_recon.py``'s long-horizon tolerance).
- Exact, bit for bit: states on every rank; a run whose rows do not divide
  over the ranks (every rank keeps all rows, nothing is reduced) against
  the single-process port; a chain killed after block 0 and resumed at the
  same world size against the unbroken run.
- A chain killed under world 2 (or 4) resumed in one process ends where
  the unbroken run ends: block 0 bit for bit, block 1's codes equal or one
  level apart in at most 1% of the entries.
- Zero-weight samples contribute nothing (relative 1e-5 against the clean
  rows alone), an all-ones weight matches no weight (2e-3), the probe's
  scores match the single-process probe (relative 2e-3) and give the same
  allocation, and compile counts (engines and probe bodies) stay flat.
"""
import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import reconstruct as rc
from repro_torch.core.context import QuantCtx
from repro_torch.core.quant_config import QuantRecipe
from test_torch_mesh import save_rank, spawn_ranks, start_rank

torch.set_num_threads(1)  # the ranks' thread count: equal float sums

N, S, D, H = 64, 4, 24, 40
ITERS, LONG = 12, 50
W4 = dict(method="flexround", w_bits=4, w_granularity="per_channel",
          lr=3e-3, iters=ITERS)
RECIPES = {
    "w_mb": dict(W4, a_bits=None, batch_size=16, setting="qdrop"),
    "a8_mb": dict(W4, a_bits=8, batch_size=16, setting="qdrop",
                  drop_prob=0.5, lr_lsq=0.0),
    "a8_long": dict(W4, a_bits=8, batch_size=16, setting="qdrop",
                    iters=LONG),
    "w_fb": dict(W4, a_bits=None, batch_size=N, setting="brecq"),
    "ada_fb": dict(W4, method="adaround", a_bits=None, batch_size=N,
                   setting="brecq"),
}
CHAIN = dict(W4, a_bits=8, batch_size=16, setting="qdrop", iters=6,
             lr_lsq=0.0)


# ------------------------------------------------------------------ data
def _params(seed, d=D, h=H):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((d, h)) * d**-0.5).astype(np.float32),
            "w2": (rng.standard_normal((h, d)) * h**-0.5).astype(np.float32)}


def _x(seed, n=N):
    return np.random.default_rng(seed).standard_normal((n, S, D)).astype(
        np.float32)


def _block(name="blk", seed=7, token=None):
    p = _params(seed)

    def apply(pp, x, ctx, _n=name):
        h = F.gelu(ctx.linear(f"{_n}.w1", x, pp["w1"]), approximate="tanh")
        return ctx.linear(f"{_n}.w2", h, pp["w2"]) + x

    return rc.BlockHandle(name, {k: torch.from_numpy(v) for k, v in p.items()},
                          apply, {f"{name}.{k}": rc.Site((k,))
                                  for k in ("w1", "w2")}, apply_key=token)


def _jblock(name="blk", seed=7):
    import jax
    import jax.numpy as jnp

    from repro.core import reconstruct as jrc
    p = _params(seed)

    def apply(pp, x, ctx):
        h = jax.nn.gelu(ctx.linear(f"{name}.w1", x, pp["w1"]))
        return ctx.linear(f"{name}.w2", h, pp["w2"]) + x

    return jrc.BlockHandle(name, {k: jnp.asarray(v) for k, v in p.items()},
                           apply, {f"{name}.{k}": jrc.Site((k,))
                                   for k in ("w1", "w2")})


def _chain(n, token):
    return [_block(f"layers.{i}", seed=20 + i, token=token) for i in range(n)]


def _teacher(block, x):
    with torch.no_grad():
        return block.apply(block.params, x, QuantCtx(mode="fp"))


def _np_states(states):
    return {k: {n: t.numpy().copy() for n, t in v.items()}
            for k, v in states.items()}


def _report(rep):
    return {"loss": np.asarray(rep.loss_curve), "mse": np.asarray(rep.mse_curve),
            "err": (rep.err_before, rep.err_after), "engine": rep.engine}


def _recon(tag, mesh, draws=None, **kw):
    """One block's run under RECIPES[tag]; ``draws``: the reference's
    (idx, masks) replayed through a ``Schedule``."""
    b = _block()
    x = torch.from_numpy(_x(8))
    recipe = QuantRecipe(**RECIPES[tag])
    sched = None if draws is None else rc.Schedule(*draws)
    ws, as_, rep = rc.reconstruct_block(b, recipe, x, _teacher(b, x), 3,
                                        schedule=sched, mesh=mesh, **kw)
    return {"ws": _np_states(ws), "as": _np_states(as_), **_report(rep)}


def _finalized(fin):
    out = []
    for params in fin:
        out.append({k: (v.codes.numpy().copy() if hasattr(v, "codes")
                        else v.numpy().copy()) for k, v in params.items()})
    return out


class _Kill(Exception):
    pass


def _chain_run(mesh, ckpt=None, kill_at=None):
    """quantize_blocks over a 2-block chain; ``kill_at``: raise when block
    ``kill_at`` reports (after the checkpoint of the blocks before it)."""
    def progress(msg):
        if kill_at is not None and msg.startswith(f"[{kill_at + 1}/"):
            raise _Kill(msg)
    x = torch.from_numpy(_x(5))
    fin, astates, reps = rc.quantize_blocks(
        _chain(2, ("chain", 2)), QuantRecipe(**CHAIN), x, key=11,
        checkpoint_dir=ckpt, progress=progress, mesh=mesh)
    return {"fin": _finalized(fin), "as": _np_states(astates),
            "reps": [_report(r) for r in reps]}


def _layer_run(mesh):
    """recon='layer': each site's captured input is a stream of the same
    rows, split as the block's."""
    recipe = QuantRecipe(**dict(RECIPES["w_mb"], recon="layer"))
    fin, _, reps = rc.quantize_blocks([_block()], recipe,
                                      torch.from_numpy(_x(8)), key=3,
                                      mesh=mesh)
    return {"fin": _finalized(fin), "reps": [_report(r) for r in reps]}


def _probe(mesh):
    from repro_torch.allocate import Budget, probe_blocks, solve_allocation
    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=None, iters=1,
                         batch_size=8)
    rc.reset_engine_stats()
    rc.clear_engine_cache()
    probe = probe_blocks(_chain(3, ("probe", 3)), recipe,
                         torch.from_numpy(_x(6)), bits=(2, 4, 8), mesh=mesh)
    alloc = solve_allocation(probe, Budget("avg_bits", 4.5))
    return {"scores": {s: {b: (v.mse, v.fisher) for b, v in per.items()}
                       for s, per in probe.scores.items()},
            "bits": dict(alloc.bits), "compiles": probe.compile_count}


def _compile_flat(mesh):
    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=8, iters=4,
                         batch_size=8, lr=3e-3, lr_lsq=0.0)
    rc.reset_engine_stats()
    rc.clear_engine_cache()
    fin, _, _ = rc.quantize_blocks(_chain(4, ("flat", 4)), recipe,
                                   torch.from_numpy(_x(4, 32)), chunk=3,
                                   mesh=mesh)
    st = rc.engine_stats()
    return {"builds": st.engine_builds, "hits": st.engine_hits,
            "compiles": st.compile_count, "fin": _finalized(fin)}


def _weights():
    """Zero-weight garbage rows after 32 clean ones, and all ones."""
    w = np.concatenate([np.ones(32), np.zeros(32)]).astype(np.float32)
    return torch.from_numpy(w), torch.ones(N)


def _zero_weight_run(mesh):
    """Full batch over 32 clean rows and 32 garbage rows at weight 0."""
    b = _block()
    x_clean = torch.from_numpy(_x(8, 32))
    garbage = 100.0 * torch.from_numpy(_x(9, 32))
    x = torch.cat([x_clean, garbage])
    y = torch.cat([_teacher(b, x_clean), torch.zeros_like(x_clean)])
    recipe = QuantRecipe(**dict(RECIPES["w_fb"], batch_size=N))
    ws, _, rep = rc.reconstruct_block(b, recipe, x, y, 3,
                                      sample_weight=_weights()[0], mesh=mesh)
    return {"ws": _np_states(ws), **_report(rep)}


# --------------------------------------------------------------- workers
def recon_worker(out_dir):
    """Every scenario on this rank, under a flat mesh of the world."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    start_rank()
    world = dist.get_world_size()
    mesh = tmesh.make_flat_mesh(world, device_type="cpu")
    draws = dict(np.load(os.path.join(out_dir, "..", "draws.npz"),
                         allow_pickle=True))["draws"].item()
    res = {tag: _recon(tag, mesh, draws.get(tag)) for tag in RECIPES}
    res["ones"] = _recon("w_mb", mesh, draws["w_mb"],
                         sample_weight=_weights()[1])
    res["zero_w"] = _zero_weight_run(mesh)
    b = _block()
    x = torch.from_numpy(_x(8, 63))  # 63 rows divide over no world > 1
    ws, _, rep = rc.reconstruct_block(b, QuantRecipe(**RECIPES["a8_mb"]), x,
                                      _teacher(b, x), 3, mesh=mesh)
    res["replicated"] = {"ws": _np_states(ws), **_report(rep)}
    res["chain"] = _chain_run(mesh)
    ckpt = os.path.join(out_dir, "..", "ckpt")
    try:
        _chain_run(mesh, ckpt, kill_at=1)
        raise AssertionError("the chain was not killed")
    except _Kill:
        pass
    if tmesh.is_writer():  # a copy for the one-process resume
        shutil.copytree(ckpt, os.path.join(out_dir, "..", "ckpt_killed"))
    tmesh.barrier()
    res["resumed"] = _chain_run(mesh, ckpt)
    res["probe"] = _probe(mesh)
    res["flat"] = _compile_flat(mesh)
    res["layer"] = _layer_run(mesh)
    save_rank(out_dir, res)


def _draws():
    """The reference's minibatch indices and QDrop masks of RECIPES' runs
    that replay them, by tag, and the reference's reports."""
    import jax

    from test_torch_recon import _jax_masks
    out = {}
    for tag in ("w_mb", "a8_mb"):
        r = RECIPES[tag]
        out[tag] = _jax_masks(jax.random.key(3), r["iters"], N,
                              r["batch_size"], 0.5 if r["a_bits"] else 0.0,
                              {"blk.w1": (r["batch_size"], S, D),
                               "blk.w2": (r["batch_size"], S, H)})
        if not r["a_bits"]:
            out[tag] = (out[tag][0], None)
    return out


def _spawn(world, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"world{world}")
    np.savez(root / "draws.npz", draws=np.array(_draws(), dtype=object))
    (root / "ranks").mkdir()
    return spawn_ranks(world, "test_torch_sharded_recon", "recon_worker",
                       root / "ranks"), root


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    ranks, root = _spawn(request.param, tmp_path_factory)
    return request.param, ranks, root


@pytest.fixture(scope="module")
def single():
    """The single-process port and the reference, once."""
    draws = _draws()
    out = {tag: _recon(tag, None, draws.get(tag)) for tag in RECIPES}
    out["ones"] = _recon("w_mb", None, draws["w_mb"])
    out["chain"] = _chain_run(None)
    out["probe"] = _probe(None)
    out["flat"] = _compile_flat(None)
    out["layer"] = _layer_run(None)
    b = _block()
    x = torch.from_numpy(_x(8, 63))
    ws, _, rep = rc.reconstruct_block(b, QuantRecipe(**RECIPES["a8_mb"]), x,
                                      _teacher(b, x), 3)
    out["replicated"] = {"ws": _np_states(ws), **_report(rep)}
    b = _block()
    x_clean = torch.from_numpy(_x(8, 32))
    ws, _, rep = rc.reconstruct_block(b, QuantRecipe(**RECIPES["w_fb"]),
                                      x_clean, _teacher(b, x_clean), 3)
    out["clean"] = {"ws": _np_states(ws), **_report(rep)}
    out["ref"] = _reference(draws)
    return out


def _reference(draws):
    import jax
    import jax.numpy as jnp

    from repro.core import reconstruct as jrc
    from repro.core.context import QuantCtx as JQuantCtx
    from repro.core.quant_config import QuantRecipe as JQuantRecipe
    jb = _jblock()
    x = jnp.asarray(_x(8))
    y = jb.apply(jb.params, x, JQuantCtx(mode="fp"))
    out = {}
    for tag in ("w_mb", "a8_mb", "a8_long", "w_fb", "ada_fb"):
        ws, _, rep = jrc.reconstruct_block(jb, JQuantRecipe(**RECIPES[tag]),
                                           x, y, jax.random.key(3))
        out[tag] = {"ws": {k: {n: np.asarray(t) for n, t in v.items()}
                           for k, v in ws.items()},
                    "loss": np.asarray(rep.loss_curve),
                    "err": (rep.err_before, rep.err_after)}
    return out


# ----------------------------------------------------------------- checks
def _states_close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for site in want:
        for k in want[site]:
            np.testing.assert_allclose(got[site][k], want[site][k], rtol=rtol,
                                       atol=atol, err_msg=f"{site}.{k}")


def _states_equal(got, want):
    assert sorted(got) == sorted(want)
    for site in want:
        for k in want[site]:
            np.testing.assert_array_equal(got[site][k], want[site][k],
                                          err_msg=f"{site}.{k}")


def _move(lr, iters):
    return 2e-4 * lr * iters


@pytest.mark.parametrize("tag", ["w_mb", "w_fb", "ada_fb", "a8_mb"])
def test_equals_single_process_and_reference(world, single, tag):
    _, ranks, _ = world
    got, one, ref = ranks[0][tag], single[tag], single["ref"][tag]
    iters = RECIPES[tag]["iters"]
    if tag == "a8_mb":
        _states_close(got["as"], one["as"], 1e-6, 0)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    _states_close(got["ws"], one["ws"], 2e-5, _move(3e-3, iters))
    _states_close(got["ws"], ref["ws"], 2e-5, _move(3e-3, iters))
    np.testing.assert_allclose(got["err"], one["err"], rtol=1e-5)


def test_a8_lsq_learning_quality_at_fifty_steps(world, single):
    """The run's own generators (masks drawn at the global shape and
    sliced), LSQ learning: the first step's loss to 1e-6, then quality."""
    _, ranks, _ = world
    got, one = ranks[0]["a8_long"], single["a8_long"]
    np.testing.assert_allclose(got["loss"][0], one["loss"][0], rtol=1e-6)
    np.testing.assert_allclose(got["err"][0], one["err"][0], rtol=1e-6)
    np.testing.assert_allclose(got["err"][1], one["err"][1], rtol=0.1)
    ref = single["ref"]["a8_long"]["err"][1]
    assert got["err"][1] < 1.3 * ref and np.isfinite(got["loss"]).all()


def test_states_bit_identical_on_every_rank(world):
    _, ranks, _ = world
    for res in ranks[1:]:
        for tag in list(RECIPES) + ["ones", "zero_w", "replicated"]:
            _states_equal(res[tag]["ws"], ranks[0][tag]["ws"])
            np.testing.assert_array_equal(res[tag]["loss"],
                                          ranks[0][tag]["loss"])
            assert res[tag]["err"] == ranks[0][tag]["err"]
        for key in ("chain", "resumed"):
            for a, b in zip(res[key]["fin"], ranks[0][key]["fin"]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
        assert res["probe"] == ranks[0]["probe"]


def test_zero_weight_samples_contribute_nothing(world, single):
    _, ranks, _ = world
    got = ranks[0]["zero_w"]
    _states_close(got["ws"], single["clean"]["ws"], 1e-5, 1e-6)
    assert np.isfinite(got["loss"]).all()


def test_all_ones_weight_matches_no_weight(world, single):
    _, ranks, _ = world
    got = ranks[0]["ones"]
    np.testing.assert_allclose(got["loss"], single["w_mb"]["loss"], rtol=2e-3)
    _states_close(got["ws"], single["w_mb"]["ws"], 2e-3, _move(3e-3, ITERS))


def test_rows_that_do_not_divide_replicate_bit_for_bit(world, single):
    _, ranks, _ = world
    got, want = ranks[0]["replicated"], single["replicated"]
    _states_equal(got["ws"], want["ws"])
    np.testing.assert_array_equal(got["loss"], want["loss"])
    assert got["err"] == want["err"]


def _codes_one_level(got, want):
    """Nibble-packed W4 codes: each nibble equal or one level apart, in at
    most 1% of the bytes."""
    got, want = got.astype(np.int32), want.astype(np.int32)
    lo = np.abs((got & 15) - (want & 15))
    hi = np.abs((got >> 4) - (want >> 4))
    assert max(lo.max(), hi.max()) <= 1 and (got != want).mean() <= 0.01, \
        (lo.max(), hi.max(), (got != want).mean())


def test_chain_equals_single_process(world, single):
    _, ranks, _ = world
    got, one = ranks[0]["chain"], single["chain"]
    for a, b in zip(got["fin"], one["fin"]):
        for k in a:
            _codes_one_level(a[k], b[k])
    for ra, rb in zip(got["reps"], one["reps"]):
        np.testing.assert_allclose(ra["loss"], rb["loss"], rtol=2e-2)


def test_killed_chain_resumes_at_the_same_world_bit_for_bit(world):
    _, ranks, _ = world
    got, want = ranks[0]["resumed"], ranks[0]["chain"]
    for a, b in zip(got["fin"], want["fin"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    _states_equal(got["as"], want["as"])
    for ra, rb in zip(got["reps"], want["reps"]):
        np.testing.assert_array_equal(ra["loss"], rb["loss"])


def test_killed_chain_resumes_in_one_process(world):
    """The checkpoint holds the whole streams: one process resumes it at
    block 1 and ends where the unbroken run of the world ends."""
    from repro_torch.checkpoint import PTQCheckpointer
    _, ranks, root = world
    killed = str(root / "ckpt_killed")
    assert PTQCheckpointer(str(root / "ckpt")).meta()["next_block"] == 2
    assert PTQCheckpointer(killed).meta()["next_block"] == 1
    want = ranks[0]["chain"]
    got = _chain_run(None, killed)
    for k in want["fin"][0]:
        np.testing.assert_array_equal(got["fin"][0][k], want["fin"][0][k])
    for k in want["fin"][1]:
        _codes_one_level(got["fin"][1][k], want["fin"][1][k])


def test_probe_scores_and_allocation_equal_single_process(world, single):
    _, ranks, _ = world
    got, one = ranks[0]["probe"], single["probe"]
    assert got["compiles"] == one["compiles"] == 3 * 1  # one key x 3 widths
    assert got["bits"] == one["bits"]
    for site, per in one["scores"].items():
        for b, (mse, fisher) in per.items():
            np.testing.assert_allclose(got["scores"][site][b], (mse, fisher),
                                       rtol=2e-3, atol=1e-9,
                                       err_msg=f"{site}@{b}")


def test_compile_counts_flat_under_the_mesh(world, single):
    _, ranks, _ = world
    got, one = ranks[0]["flat"], single["flat"]
    assert (got["builds"], got["hits"], got["compiles"]) == \
        (one["builds"], one["hits"], one["compiles"]) == (1, 3, 0)
    for a, b in zip(got["fin"], one["fin"]):
        for k in a:
            _codes_one_level(a[k], b[k])


def test_layerwise_equals_single_process(world, single):
    """Weight-only layer-wise reconstruction: the loss curves of both site
    problems to 1e-6, the codes equal or one level apart."""
    _, ranks, _ = world
    got, one = ranks[0]["layer"], single["layer"]
    assert len(got["reps"]) == len(one["reps"]) == 2
    for ra, rb in zip(got["reps"], one["reps"]):
        np.testing.assert_allclose(ra["loss"], rb["loss"], rtol=1e-6)
    for k in one["fin"][0]:
        _codes_one_level(got["fin"][0][k], one["fin"][0][k])
