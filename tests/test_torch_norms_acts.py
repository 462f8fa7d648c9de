"""Port parity for the norms and activations beyond RMSNorm and SwiGLU:
``layernorm`` (scale ones, bias zeros, eps 1e-5), ``layernorm_nonparam``
(no parameters and no norm keys in the tree), ``gelu`` (no ``w_gate``) and
``geglu`` (gated, gelu in place of silu; jax's tanh approximation), on the
smollm-135m smoke config with ``dataclasses.replace``d ``norm``/``act``.
whisper's encoder-decoder (layernorm + gelu) and recurrentgemma (geglu)
use these pieces before their families are ported.

The reference initialises the weights (``jax.random.key(0)``); the
layernorm scale and bias get N(0, 0.1^2) noise drawn with numpy so that
both take part. Tolerances (float32): hidden states and logits rtol=atol=
1e-5; the loss relative 1e-5 and each gradient leaf max |g - g_ref| <=
1e-5 * max |g_ref| + 1e-7; the quantized sites equal the reference's (a
geglu gate stays fp there: only swiglu's ``w_gate`` is a site) and the
``iters=0`` export is bit-exact.
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
from repro.models import common as jcommon
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.context import QuantCtx
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.core.reconstruct import quantize_blocks
from repro_torch.models import common
from repro_torch.models.model import build_model

torch.set_num_threads(2)

CPU = "cpu"
VARIANTS = [("layernorm", "swiglu"), ("layernorm_nonparam", "swiglu"),
            ("rmsnorm", "gelu"), ("rmsnorm", "geglu"), ("layernorm", "gelu")]
RECIPE_KW = dict(method="flexround", w_bits=4, w_granularity="per_channel",
                 iters=0, batch_size=4)


def _np(t):
    return bridge.to_numpy(t)


def _perturb(jparams, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        keys = {getattr(k, "key", None) for k in path}
        if keys & {"ln1", "ln2", "final_norm"}:
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, jparams)


@pytest.fixture(scope="module", params=VARIANTS, ids=lambda v: "-".join(v))
def lm(request):
    norm, act = request.param
    jcfg = dataclasses.replace(jget_smoke_config("smollm-135m"), norm=norm,
                               act=act)
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), norm=norm,
                              act=act)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = _perturb(jmodel.init(jax.random.key(0)), seed=11)
    return dict(cfg=cfg, jmodel=jmodel, model=model, jparams=jparams,
                params=bridge.params(jparams, CPU))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("norm", ["layernorm", "layernorm_nonparam"])
def test_layernorm_matches_reference(norm):
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, (3, 5, 32)).astype(np.float32)
    jp = jcommon.norm_params(norm, 32, jnp.float32)
    p = common.norm_params(norm, 32, torch.float32, CPU)
    if norm == "layernorm_nonparam":
        assert jp is None and p is None
    else:
        assert sorted(p) == sorted(jp) == ["bias", "scale"]
        assert float(p["scale"].min()) == float(p["scale"].max()) == 1.0
        jp = {k: jnp.asarray(rng.normal(1, 0.1, 32), jnp.float32) for k in jp}
        p = {k: bridge.tensor(v, CPU) for k, v in jp.items()}
    np.testing.assert_allclose(
        _np(common.apply_norm(norm, torch.from_numpy(x), p)),
        np.asarray(jcommon.apply_norm(norm, jnp.asarray(x), jp)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "geglu"])
def test_gelu_is_the_tanh_approximation(act):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2.0, (2, 4, 8)).astype(np.float32)
    jp = jcommon.mlp_params(jax.random.key(1), 8, 16, act, jnp.float32)
    p = {k: bridge.tensor(v, CPU) for k, v in jp.items()}
    assert ("w_gate" in p) == (act == "geglu")
    got = common.mlp(p, torch.from_numpy(x), QuantCtx(mode="fp"), "m", act)
    want = jcommon.mlp(jp, jnp.asarray(x), JQuantCtx(mode="fp"), "m", act)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_forward_matches_reference(lm):
    toks = np.random.default_rng(2).integers(0, lm["cfg"].vocab, (2, 12))
    jx, _, _ = lm["jmodel"].backbone(lm["jparams"], jnp.asarray(toks),
                                     JQuantCtx(mode="fp"))
    x, _, _ = lm["model"].backbone(lm["params"], torch.from_numpy(toks),
                                   QuantCtx(mode="fp"))
    np.testing.assert_allclose(_np(x), np.asarray(jx), rtol=1e-5, atol=1e-5)


def test_loss_and_gradients_match_jax_grad(lm):
    cfg = lm["cfg"]
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 36)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 36)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(
        lambda p: lm["jmodel"].loss(p, jbatch, JQuantCtx(mode="fp"))[0])(
            lm["jparams"])
    params = bridge.params(lm["jparams"], CPU)
    for _, t in _leaves(params):
        t.requires_grad_(True)
    loss, _ = lm["model"].loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        QuantCtx(mode="fp"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = dict(_leaves(bridge.params(jg, CPU)))
    assert sorted(grads) == sorted(dict(_leaves(params)))
    for path, t in _leaves(params):
        g, want = _np(t.grad), _np(grads[path])
        assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max() + 1e-7, path


def test_sites_and_export_match_reference(lm):
    calib = np.random.default_rng(4).integers(0, lm["cfg"].vocab, (4, 16))
    jx0, jblocks, _ = lm["jmodel"].quant_blocks(lm["jparams"],
                                                jnp.asarray(calib))
    jfin, _, _ = jquantize_blocks(jblocks, JQuantRecipe(**RECIPE_KW), jx0)
    x0, blocks, _ = lm["model"].quant_blocks(lm["params"],
                                             torch.from_numpy(calib))
    fin, _, _ = quantize_blocks(blocks, QuantRecipe(**RECIPE_KW), x0)
    for b, jb in zip(blocks, jblocks, strict=True):
        assert sorted(b.sites) == sorted(jb.sites)
        gated = f"{b.name}.mlp.w_gate" in b.sites
        assert gated == (lm["cfg"].act == "swiglu")
    for f, jf in zip(fin, jfin, strict=True):
        jl = dict(_leaves(bridge.params(jf, CPU)))
        for path, leaf in _leaves(f):
            want = jl[path]
            if hasattr(leaf, "codes"):
                for fld in ("codes", "scale", "zero"):
                    assert torch.equal(getattr(leaf, fld), getattr(want, fld))
            else:
                assert torch.equal(leaf, want), path
