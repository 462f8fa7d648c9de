"""A MoE block under a data-parallel mesh computes the global program.

``moe_ffn`` routes its tokens in groups of ``N = _pick_group(T,
min(moe_group, T))`` with a capacity that follows from ``N``
(``repro_torch/models/moe.py``). The reference's GSPMD step sees the global
token count ``T``; a port rank holds only its rows of the batch. So a rank
must pick ``N`` from the global count, and where its rows are not whole
global groups it gathers the MoE input over the data group, routes the
global groups and keeps its own rows (``core/reconstruct.py``'s module
docstring).

The block is one layer of a reduced llama4-scout (4 experts, top-1, one
shared expert) with llama4-scout's own capacity factor (1.25, so tokens
are dropped) and ``moe_group`` = 64 = the minibatch's 4 rows x 16 tokens.
On a 2-rank gloo mesh a rank holds 2 rows (32 tokens) of every 4-row
batch: half a group, so the groups are gathered. With 8 calibration rows
the teacher's rank holds 4 rows = one whole group and nothing is gathered.

Held against the single-process port and a live run of the reference
(``repro.core.reconstruct``, one process: the global program), weights
only, 3 steps (``tests/test_torch_recon.py``: reduced llama4 blocks track
the reference for 3 steps):

- the teacher's output: the port against itself rtol = atol = 1e-6, against
  the reference 1e-5 (``tests/test_torch_moe.py``'s float32 tolerance);
- the first error (``--iters 0``) and the loss curve: the port against
  itself 1e-6, against the reference 1e-5 (``test_torch_sharded_recon.py``'s
  weight-only tolerances);
- the states: 2e-5 relative plus 2e-4 of the distance 3 steps can move
  them, against the port and against the reference;
- a chain through ``quantize_blocks`` (its teacher, steps and deploy
  forward) and the probe's scores against one process (the probe's 2e-3);
- layer-wise reconstruction of such a block refuses with a ValueError that
  names ``moe_group``, the global token count and the data size.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.core import reconstruct as rc
from repro_torch.core.quant_config import QuantRecipe
from test_torch_mesh import save_rank, spawn_ranks, start_rank

torch.set_num_threads(1)  # the ranks' thread count: equal float sums

ARCH = "llama4-scout-17b-a16e"
N_CALIB, S, BS, ITERS, LR = 8, 16, 4, 3, 3e-3
W4 = dict(method="flexround", w_bits=4, a_bits=None,
          w_granularity="per_channel", setting="brecq", lr=LR,
          batch_size=BS, iters=ITERS)


def _cfg(get):
    """The reduced llama4-scout with llama4-scout's capacity factor and
    moe_group = one minibatch's tokens."""
    return dataclasses.replace(get(ARCH), capacity_factor=1.25,
                               moe_group=BS * S)


def _calib():
    return np.random.default_rng(1).integers(0, 128, (N_CALIB, S)).astype(
        np.int64)


def _port_block(params):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    model = build_model(_cfg(get_smoke_config))
    x0, blocks, _ = model.quant_blocks(params, torch.from_numpy(_calib()))
    return x0, blocks[0]


def _np_states(states):
    return {k: {n: t.numpy().copy() for n, t in v.items()}
            for k, v in states.items()}


def _recon(block, x, y, mesh, iters=ITERS, idx=None):
    sched = None if idx is None else rc.Schedule(np.asarray(idx), None)
    ws, _, rep = rc.reconstruct_block(
        block, QuantRecipe(**dict(W4, iters=iters)), x, y, 3, schedule=sched,
        mesh=mesh)
    return {"ws": _np_states(ws), "loss": np.asarray(rep.loss_curve),
            "err": (rep.err_before, rep.err_after)}


def _teacher(block, x, mesh):
    """The probe's teacher over this rank's rows, gathered to the whole
    stream."""
    dp = rc._data_parallel(mesh)
    rows = rc._Rows.of(dp, x.shape[0])
    y = rc.probe_teacher(block, None, mesh, rows=rows)(block.params,
                                                       rows.take(x))
    return rows.gather(y).numpy().copy()


def _chain(block, x, mesh):
    fin, _, reps = rc.quantize_blocks([block], QuantRecipe(**W4), x, key=11,
                                      mesh=mesh)
    return {"codes": {k: v.codes.numpy().copy() for k, v in _qt(fin[0])},
            "loss": np.asarray(reps[0].loss_curve),
            "err": (reps[0].err_before, reps[0].err_after)}


def _qt(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qt(v, f"{prefix}{k}.")
    elif hasattr(tree, "codes"):
        yield prefix[:-1], tree


def _probe(block, x, mesh):
    from repro_torch.allocate import probe_blocks
    recipe = QuantRecipe(**dict(W4, iters=1))
    probe = probe_blocks([block], recipe, x, bits=(4, 8), mesh=mesh)
    return {s: {b: (v.mse, v.fisher) for b, v in per.items()}
            for s, per in probe.scores.items()}


def _layerwise_refusal(block, x, mesh):
    try:
        rc.quantize_blocks([block], QuantRecipe(**dict(W4, recon="layer")),
                           x, key=11, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def _scenarios(block, x0, y4, y8, idx, mesh):
    x4 = x0[:4]
    out = {"teacher8": _teacher(block, x0, mesh),
           "teacher4": _teacher(block, x4, mesh),
           "iters0": _recon(block, x4, y4, mesh, iters=0),
           "fb": _recon(block, x4, y4, mesh),
           "mb": _recon(block, x0, y8, mesh, idx=idx),
           "chain": _chain(block, x4, mesh),
           "probe": _probe(block, x4, mesh)}
    if mesh is not None:
        out["layer"] = _layerwise_refusal(block, x4, mesh)
    return out


# --------------------------------------------------------------- workers
def moe_worker(out_dir):
    from repro_torch.launch import mesh as tmesh
    start_rank()
    data = torch.load(os.path.join(out_dir, "..", "data.pt"))
    x0, block = _port_block(data["params"])
    mesh = tmesh.make_flat_mesh(2, device_type="cpu")
    save_rank(out_dir, _scenarios(block, x0, data["y4"], data["y8"],
                                  data["idx"], mesh))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (one process), the single-process port and the 2-rank
    port on the same weights, streams and minibatch schedule."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.core import reconstruct as jrc
    from repro.core.context import QuantCtx as JQuantCtx
    from repro.core.quant_config import QuantRecipe as JQuantRecipe
    from repro.models import build_model as jbuild_model
    from repro_torch import bridge

    jmodel = jbuild_model(_cfg(jget_smoke_config))
    jparams = jmodel.init(jax.random.key(1))
    jx0, jblocks, _ = jmodel.quant_blocks(jparams, jnp.asarray(_calib()))
    jb = jblocks[0]
    jx4 = jx0[:4]
    jy8 = jb.apply(jb.params, jx0, JQuantCtx(mode="fp"))
    jy4 = jb.apply(jb.params, jx4, JQuantCtx(mode="fp"))
    idx, _ = jrc._batch_schedule(jax.random.key(3), ITERS, N_CALIB, BS)
    idx = np.asarray(idx)

    def jrecon(x, y, iters=ITERS):
        ws, _, rep = jrc.reconstruct_block(
            jb, JQuantRecipe(**dict(W4, iters=iters)), x, y,
            jax.random.key(3))
        return {"ws": {k: {n: np.asarray(t) for n, t in v.items()}
                       for k, v in ws.items()},
                "loss": np.asarray(rep.loss_curve),
                "err": (rep.err_before, rep.err_after)}

    ref = {"teacher8": np.asarray(jy8), "teacher4": np.asarray(jy4),
           "fb": jrecon(jx4, jy4), "mb": jrecon(jx0, jy8)}

    params = bridge.params(jparams, "cpu")
    x0, block = _port_block(params)
    y8 = rc.probe_teacher(block, None)(block.params, x0)
    y4 = y8[:4].clone()
    single = _scenarios(block, x0, y4, y8, idx, None)

    root = tmp_path_factory.mktemp("moe_mesh")
    torch.save({"params": params, "y4": y4, "y8": y8,
                "idx": torch.from_numpy(idx)},
               root / "data.pt")
    (root / "ranks").mkdir()
    ranks = spawn_ranks(2, "test_torch_moe_mesh", "moe_worker",
                        root / "ranks")
    return {"ref": ref, "single": single, "ranks": ranks}


def _move(iters):
    return 2e-4 * LR * iters


def _states_close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for site in want:
        for k in want[site]:
            np.testing.assert_allclose(got[site][k], want[site][k], rtol=rtol,
                                       atol=atol, err_msg=f"{site}.{k}")


# ----------------------------------------------------------------- checks
def test_the_config_drops_tokens_and_splits_a_group():
    """The case this file exists for: the minibatch is one group, half of
    it on each rank, and the capacity drops tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = _cfg(get_smoke_config)
    assert cfg.moe_group == BS * S and (BS // 2) * S % cfg.moe_group
    assert moe._capacity(BS * S, 1, cfg.n_experts, 1.25) < BS * S


@pytest.mark.parametrize("tag", ["teacher8", "teacher4"])
def test_teacher_output_is_the_global_program(runs, tag):
    for got in [r[tag] for r in runs["ranks"]]:
        np.testing.assert_allclose(got, runs["single"][tag], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got, runs["ref"][tag], rtol=1e-5,
                                   atol=1e-5)


def test_first_error_at_iters_zero(runs):
    got = runs["ranks"][0]["iters0"]["err"]
    np.testing.assert_allclose(got, runs["single"]["iters0"]["err"],
                               rtol=1e-6)
    np.testing.assert_allclose(got[0], runs["ref"]["fb"]["err"][0], rtol=1e-5)


@pytest.mark.parametrize("tag", ["fb", "mb"])
def test_trajectory_matches_single_process_and_reference(runs, tag):
    got, one, ref = (runs["ranks"][0][tag], runs["single"][tag],
                     runs["ref"][tag])
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["err"], one["err"], rtol=1e-5)
    _states_close(got["ws"], one["ws"], 2e-5, _move(ITERS))
    _states_close(got["ws"], ref["ws"], 2e-5, _move(ITERS))


def test_ranks_agree_bit_for_bit(runs):
    a, b = runs["ranks"]
    for tag in ("fb", "mb"):
        np.testing.assert_array_equal(a[tag]["loss"], b[tag]["loss"])
        for site in a[tag]["ws"]:
            for k in a[tag]["ws"][site]:
                np.testing.assert_array_equal(a[tag]["ws"][site][k],
                                              b[tag]["ws"][site][k])
    assert a["probe"] == b["probe"]


def test_chain_matches_single_process(runs):
    got, one = runs["ranks"][0]["chain"], runs["single"]["chain"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["err"], one["err"], rtol=1e-5)
    for k, codes in one["codes"].items():
        assert (got["codes"][k] != codes).mean() <= 0.01, k


def test_probe_scores_match_single_process(runs):
    got, one = runs["ranks"][0]["probe"], runs["single"]["probe"]
    for site, per in one.items():
        for b, want in per.items():
            np.testing.assert_allclose(got[site][b], want, rtol=2e-3,
                                       atol=1e-9, err_msg=f"{site}@{b}")


def test_layerwise_refuses_a_gathered_moe(runs):
    msg = runs["ranks"][0]["layer"]
    assert msg is not None, "layer-wise reconstruction regrouped silently"
    for part in ("moe_group=64", "64 tokens", "2 data ranks"):
        assert part in msg, msg
