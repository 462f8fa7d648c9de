"""Port parity for the slice as a whole: export-only FlexRound PTQ, then the
slot-based serving engine over the int8 KV cache.

Both packages quantize the smollm-135m smoke model from the same weights
(reference-initialised, bridged) and the same numpy calibration tokens with
recipe ``w_bits=4, a_bits=8, per_channel`` and rule ``layers.0.*:w_bits=8``,
so layer 0 takes the W8A8 route and layer 1 the W4A8 route during export.
Exported QTensors must be bit-identical (export depends on the weights
only). Activation states and reconstruction errors pass through matmuls and
agree to float32 reduction order: rtol=1e-5 for the LSQ steps and offsets,
rtol=1e-4 for the errors (means of squared differences of those outputs).
Then both engines serve the same requests, the port with the reference's
QTensors and activation states; the greedy tokens must be identical and the
per-slot KV bytes equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.quant_config import QuantRecipe as JQuantRecipe
from repro.core.reconstruct import quantize_blocks as jquantize_blocks
from repro.models import build_model as jbuild_model
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import QTensor, tree_weight_bytes
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.core.reconstruct import quantize_blocks
from repro_torch.models.model import build_model
from repro_torch.serve import kv as skv
from repro_torch.serve.engine import EngineConfig, ServeEngine

torch.set_num_threads(2)

CPU = "cpu"
RULES = ("layers.0.*:w_bits=8",)
RECIPE_KW = dict(method="flexround", w_bits=4, a_bits=8,
                 w_granularity="per_channel", iters=0, batch_size=4)
ENGINE_KW = dict(slots=3, max_len=32, prefill_group=2, kv_quant=True)


@pytest.fixture(scope="module")
def slice_run():
    cfg = get_smoke_config("smollm-135m")
    jmodel, model = jbuild_model(jget_smoke_config("smollm-135m")), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    calib = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    jrecipe = JQuantRecipe(rules=RULES, **RECIPE_KW)
    recipe = QuantRecipe(rules=RULES, **RECIPE_KW)

    jx0, jblocks, jassemble = jmodel.quant_blocks(jparams, jnp.asarray(calib))
    jfin, jast, jreps = jquantize_blocks(jblocks, jrecipe, jx0)

    params = bridge.params(jparams, CPU)
    x0, blocks, assemble = model.quant_blocks(params, torch.from_numpy(calib))
    fin, ast, reps = quantize_blocks(blocks, recipe, x0)
    return dict(cfg=cfg, jmodel=jmodel, model=model, jrecipe=jrecipe,
                recipe=recipe, jfin=jfin, jast=jast, jreps=jreps, fin=fin,
                ast=ast, reps=reps, jq=jassemble(jfin), q=assemble(fin),
                params=params, calib=calib)


def _qtensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, f"{prefix}{k}.")
    elif hasattr(tree, "pack_axis"):
        yield prefix[:-1], tree


def test_export_bit_identical(slice_run):
    routes = set()
    for jf, f in zip(slice_run["jfin"], slice_run["fin"]):
        jq, q = dict(_qtensors(jf)), dict(_qtensors(f))
        assert sorted(jq) == sorted(q) and len(q) == 7
        for name, qt in q.items():
            j = jq[name]
            assert isinstance(qt, QTensor)
            assert (qt.shape, qt.bits, qt.packed, qt.dtype, qt.pack_axis) == (
                j.shape, j.bits, j.packed, j.dtype, j.pack_axis), name
            for fld in ("codes", "scale", "zero"):
                np.testing.assert_array_equal(
                    bridge.to_numpy(getattr(qt, fld)),
                    np.asarray(getattr(j, fld)), err_msg=f"{name}.{fld}")
            routes.add((qt.bits, qt.packed))
    assert routes == {(8, False), (4, True)}
    assert tree_weight_bytes(slice_run["q"]) == sum(
        a.nbytes for a in jax.tree.leaves(slice_run["jq"]))


def test_astates_and_errors_agree(slice_run):
    jast, ast = slice_run["jast"], slice_run["ast"]
    assert sorted(ast) == sorted(jast) and len(ast) == 14
    for site in ast:
        for k in ("step", "beta"):
            np.testing.assert_allclose(bridge.to_numpy(ast[site][k]),
                                       np.asarray(jast[site][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=site)
    for rep, jrep in zip(slice_run["reps"], slice_run["jreps"]):
        assert rep.name == jrep.name and rep.iters == jrep.iters == 0
        for k in ("err_before", "err_after"):
            np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                       rtol=1e-4)
        assert rep.err_before > 0


def test_iters_above_zero_not_ported(slice_run):
    """The Adam loop is ported now: ``iters > 0`` runs (it used to raise)
    and reports one loss and one MSE per step for every block."""
    model = slice_run["model"]
    x0, blocks, _ = model.quant_blocks(slice_run["params"],
                                       torch.from_numpy(slice_run["calib"]))
    recipe = QuantRecipe(rules=RULES, **dict(RECIPE_KW, iters=2))
    fin, _, reps = quantize_blocks(blocks, recipe, x0)
    assert len(fin) == len(reps) == len(blocks)
    for rep in reps:
        assert rep.iters == 2 and rep.loss_curve.shape == (2,)
        assert np.isfinite(rep.loss_curve).all()
        assert np.isfinite([rep.err_before, rep.err_after]).all()


def _serve(engine, requests):
    """Admit FIFO into free slots (up to the prefill group), step until
    every request is done; returns {rid: tokens}."""
    backlog, out = list(requests), {}
    while backlog or engine.active:
        n = min(engine.cfg.prefill_group, len(engine.free_slots()), len(backlog))
        if n:
            for rid, tok in engine.admit(backlog[:n]):
                out.setdefault(rid, []).append(tok)
            backlog = backlog[n:]
        if engine.active:
            for rid, tok in engine.step():
                out[rid].append(tok)
    engine.drain_finished()
    return out


def test_engines_emit_identical_greedy_tokens(slice_run):
    cfg = slice_run["cfg"]
    rng = np.random.default_rng(1)
    lens = [5, 9, 12, 7, 3, 20, 14]  # buckets 8, 16 and 32; slot reuse
    requests = [(i, rng.integers(0, cfg.vocab, n).astype(np.int32), 6)
                for i, n in enumerate(lens)]
    jctx = JQuantCtx(mode="deploy", recipe=slice_run["jrecipe"],
                     astates=slice_run["jast"], backend="xla")
    jeng = JServeEngine(slice_run["jmodel"], slice_run["jq"], jctx,
                        JEngineConfig(**ENGINE_KW))
    ctx = QuantCtx(mode="deploy", recipe=slice_run["recipe"],
                   astates=bridge.astates(slice_run["jast"], CPU))
    eng = ServeEngine(slice_run["model"], bridge.params(slice_run["jq"], CPU),
                      ctx, EngineConfig(**ENGINE_KW), device=CPU)
    want = _serve(jeng, requests)
    got = _serve(eng, requests)
    assert got == want
    assert all(len(v) == 6 for v in got.values())
    assert eng.hbm_per_slot_bytes() == jeng.hbm_per_slot_bytes()
    st = eng.stats()
    assert st["compile_count"] == 0 and st["tokens_emitted"] == 6 * len(lens)
    assert sum(st["prefill_calls"].values()) >= len(lens) / 2


@pytest.mark.parametrize("kv_quant", [True, False])
def test_hbm_per_slot_bytes(slice_run, kv_quant):
    cfg = slice_run["cfg"]
    slots, max_len = 4, 32
    jcache = slice_run["jmodel"].init_cache(slots, max_len, dtype=jnp.bfloat16,
                                            kv_quant=kv_quant)
    cache = slice_run["model"].init_cache(slots, max_len, dtype=torch.bfloat16,
                                          kv_quant=kv_quant, device=CPU)
    got = skv.hbm_per_slot_bytes(cache, slots)
    from repro.serve import kv as jkv
    assert got == jkv.hbm_per_slot_bytes(jcache, slots)
    per_token = (2 * cfg.head_dim + 2 * 4) if kv_quant else 2 * cfg.head_dim * 2
    assert got == max_len * cfg.n_layers * cfg.n_kv_heads * per_token


def test_kv_scales_floored(slice_run):
    codes, scale = skv.kv_quantize(torch.zeros((1, 2, 4)))
    assert float(scale.min()) >= skv.KV_SCALE_MIN
    assert not codes.any()
