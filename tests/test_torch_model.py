"""Port parity: the dense decoder (``repro_torch.models.transformer``) against
``repro.models.transformer`` on the smollm-135m smoke config.

The reference initialises the weights (``jax.random.key(0)``) and exports
them with FlexRound (``quantize_blocks(iters=0)``, W4 body, W8 layer 0, A8);
the port gets both through the bridge. Tolerances: rtol=atol=1e-5 for
float32 hidden states and logits (reduction order); 2e-2 for bfloat16, as
``tests/test_kernels.py`` uses; the int8 KV codes may differ by one step
where a float32 value sits on a rounding boundary.
"""
import dataclasses

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
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.context import QuantCtx
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.models.model import build_model

torch.set_num_threads(2)

CPU = "cpu"
RULES = ("layers.0.*:w_bits=8",)
RECIPE_KW = dict(method="flexround", w_bits=4, a_bits=8,
                 w_granularity="per_channel", iters=0, batch_size=4)
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return bridge.to_numpy(t)


@pytest.fixture(scope="module")
def lm():
    jcfg = jget_smoke_config("smollm-135m")
    cfg = get_smoke_config("smollm-135m")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    params = bridge.params(jparams, CPU)
    calib = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    x0, blocks, assemble = jmodel.quant_blocks(jparams, jnp.asarray(calib))
    jrecipe = JQuantRecipe(rules=RULES, **RECIPE_KW)
    fin, jast, _ = jquantize_blocks(blocks, jrecipe, x0)
    jq = assemble(fin)
    return dict(cfg=cfg, jmodel=jmodel, model=model, jparams=jparams,
                params=params, jq=jq, q=bridge.params(jq, CPU), jfin=fin,
                fin=[bridge.params(f, CPU) for f in fin], jast=jast,
                ast=bridge.astates(jast, CPU), jrecipe=jrecipe,
                recipe=QuantRecipe(rules=RULES, **RECIPE_KW), calib=calib)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _jctx(lm, mode):
    if mode == "fp":
        return JQuantCtx(mode="fp")
    return JQuantCtx(mode="deploy", recipe=lm["jrecipe"], astates=lm["jast"],
                     backend="xla")


def _ctx(lm, mode):
    if mode == "fp":
        return QuantCtx(mode="fp")
    return QuantCtx(mode="deploy", recipe=lm["recipe"], astates=lm["ast"])


def test_bridge_unstacks_layers(lm):
    assert isinstance(lm["params"]["layers"], list)
    assert len(lm["params"]["layers"]) == lm["cfg"].n_layers
    np.testing.assert_array_equal(
        _np(lm["params"]["layers"][1]["attn"]["wq"]),
        np.asarray(lm["jparams"]["layers"]["attn"]["wq"][1]))


@pytest.mark.parametrize("mode", ["fp", "deploy"])
def test_backbone_logits_match(lm, mode):
    """fp weights, and the FlexRound-exported QTensors served through the
    deploy path (W4 body and W8 layer 0, weight-only under the scanned
    forward's site names)."""
    toks = _tokens(lm["cfg"], (3, 12), seed=1)
    jp, p = (lm["jparams"], lm["params"]) if mode == "fp" else (lm["jq"], lm["q"])
    jx, _, _ = lm["jmodel"].backbone(jp, jnp.asarray(toks), _jctx(lm, mode))
    x, _, _ = lm["model"].backbone(p, torch.from_numpy(toks), _ctx(lm, mode))
    np.testing.assert_allclose(_np(x), np.asarray(jx), **F32)
    jlogits = jx @ lm["jmodel"].lm_head(jp).astype(jx.dtype)
    np.testing.assert_allclose(_np(lm["model"].logits(p, x)),
                               np.asarray(jlogits), **F32)


def test_deploy_blocks_with_integer_activation_grids(lm):
    """Block-named sites find their astates: layer 0 runs W8A8 (integer
    matmul), layer 1 W4A8 (static activation grid before the W4 kernel)."""
    toks = lm["calib"]
    jx0, jblocks, _ = lm["jmodel"].quant_blocks(lm["jparams"], jnp.asarray(toks))
    x0, blocks, _ = lm["model"].quant_blocks(lm["params"], torch.from_numpy(toks))
    np.testing.assert_array_equal(_np(x0), np.asarray(jx0))
    jctx, ctx = _jctx(lm, "deploy"), _ctx(lm, "deploy")
    for jb, b, jf, f in zip(jblocks, blocks, lm["jfin"], lm["fin"]):
        assert sorted(b.sites) == sorted(jb.sites)
        jy = jb.apply(jf, jx0, jctx)
        y = b.apply(f, bridge.tensor(jx0, CPU), ctx)
        np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)


@pytest.mark.parametrize("kv_quant", [True, False])
def test_prefill_true_len_and_cache(lm, kv_quant):
    cfg = lm["cfg"]
    toks = _tokens(cfg, (3, 16), seed=2)
    true_len = np.asarray([16, 9, 4], np.int32)
    dtype = None if kv_quant else jnp.bfloat16
    jcache = lm["jmodel"].init_cache(3, 16, dtype=dtype, kv_quant=kv_quant)
    jlast, jcache = lm["jmodel"].prefill(lm["jq"], jnp.asarray(toks), jcache,
                                         _jctx(lm, "deploy"),
                                         true_len=jnp.asarray(true_len))
    cache = lm["model"].init_cache(3, 16, dtype=None if kv_quant else torch.bfloat16,
                                   kv_quant=kv_quant, device=CPU)
    last, cache = lm["model"].prefill(lm["q"], torch.from_numpy(toks), cache,
                                      _ctx(lm, "deploy"),
                                      true_len=torch.from_numpy(true_len))
    np.testing.assert_allclose(_np(last), np.asarray(jlast), **F32)
    assert sorted(cache) == sorted(jcache)
    for nm in cache:
        got, want = _np(cache[nm]), np.asarray(jcache[nm], np.float32)
        assert got.shape == want.shape
        if nm in ("k", "v") and kv_quant:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, nm
        elif kv_quant:
            np.testing.assert_allclose(got, want, **F32)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kv_quant", [True, False])
def test_decode_step_per_slot_positions(lm, kv_quant):
    """One decode step from the same (reference-filled) cache, each slot at
    its own depth, and a uniform scalar position."""
    cfg = lm["cfg"]
    toks = _tokens(cfg, (3, 8), seed=3)
    dtype = None if kv_quant else jnp.bfloat16
    jcache = lm["jmodel"].init_cache(3, 16, dtype=dtype, kv_quant=kv_quant)
    _, jcache = lm["jmodel"].prefill(lm["jq"], jnp.asarray(toks), jcache,
                                     _jctx(lm, "deploy"))
    nxt = _tokens(cfg, (3, 1), seed=4)
    for pos in (np.asarray([8, 5, 3], np.int32), 8):
        cache = {k: bridge.tensor(v, CPU) for k, v in jcache.items()}
        jlogits, jc2 = lm["jmodel"].decode_step(
            lm["jq"], jnp.asarray(nxt), dict(jcache), jnp.asarray(pos),
            _jctx(lm, "deploy"))
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        logits, c2 = lm["model"].decode_step(lm["q"], torch.from_numpy(nxt),
                                             cache, tpos, _ctx(lm, "deploy"))
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **F32)
        for nm in c2:
            got, want = _np(c2[nm]), np.asarray(jc2[nm], np.float32)
            if nm in ("k", "v") and kv_quant:
                assert np.abs(got - want).max() <= 1, nm
            else:
                np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_bf16_model_logits(lm):
    """The same weights in bfloat16 (the full config's dtype)."""
    jcfg = dataclasses.replace(jget_smoke_config("smollm-135m"), dtype="bfloat16")
    cfg = dataclasses.replace(lm["cfg"], dtype="bfloat16")
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    params = bridge.params(jparams, CPU)
    assert params["embed"].dtype == torch.bfloat16
    toks = _tokens(cfg, (2, 10), seed=5)
    jx, _, _ = jmodel.backbone(jparams, jnp.asarray(toks), JQuantCtx(mode="fp"))
    x, _, _ = model.backbone(params, torch.from_numpy(toks), QuantCtx(mode="fp"))
    assert x.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(x), np.asarray(jx, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_init_draws_config_shapes_on_requested_device(lm):
    cfg = lm["cfg"]
    params = lm["model"].init(torch.Generator().manual_seed(0), device=CPU)
    jshapes = jax.tree.map(lambda a: a.shape[1:], lm["jparams"]["layers"])
    layer = params["layers"][0]
    for grp in ("attn", "mlp"):
        for k, v in layer[grp].items():
            assert tuple(v.shape) == tuple(jshapes[grp][k]), (grp, k)
    assert params["embed"].shape == (cfg.vocab, cfg.d_model)
    assert params["embed"].device.type == "cpu"
