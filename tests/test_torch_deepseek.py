"""Port parity: deepseek-v3 (MLA attention, one leading dense layer in front
of the MoE layers, the mtp head) against the reference at
``get_smoke_config("deepseek-v3-671b")``: 1 dense + 1 MoE layer, d_model
64, 4 heads, 4 experts top-2 with a shared expert, dropless capacity
(factor 8), float32.

The reference initialises the weights (``jax.random.key(0)``); the norm
scales, which it initialises to zeros, get N(0, 0.1^2) noise drawn with
numpy, so that they change what both packages compute. The port gets every
array through the bridge (``dense_layers`` and ``layers`` unstacked, the
mtp head as it is). Tolerances:

- configs: field for field equal; parameter trees: the same keys and
  shapes;
- float32 hidden states, latent caches and logits (fp and deploy mode on
  the reference's export): rtol = atol = 1e-5 (reduction order); greedy
  tokens identical;
- ``model.loss`` with ``mtp_ce``: relative 1e-5; every gradient leaf
  against ``jax.grad``: max |g - g_ref| <= 1e-5 * max |g_ref| + 1e-7;
- export at ``iters=0`` (W4 body, W8 layer 0, A8): codes, scale and zero of
  every QTensor bit-exact, activation states relative 1e-5;
- reconstruction, weight-only W4, full batch (no draws): err_before,
  err_after and the loss curve of 3 Adam steps per block within relative
  1e-5. Three steps is the horizon over which a reduced MoE block tracks
  the reference (a code on a rounding boundary may flip in one package
  only later on);
- the launcher at ``--arch deepseek-v3-671b --smoke --device cpu``: the
  export-only run exports the reference launcher's QTensors bit for bit and
  skips the slot engine with the reference's reason; the 2-step run's
  curves agree to relative 1e-5 and its err_after to 1e-3 (one exported
  code on a rounding boundary flips); a run stopped after block 0 and
  resumed equals an unbroken run bit for bit.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs import reduced as jreduced
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.quant_config import QuantRecipe as JQuantRecipe
from repro.core.reconstruct import quantize_blocks as jquantize_blocks
from repro.data import CalibrationSet as JCalibrationSet
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.launch import quantize as jquantize
from repro.models import build_model as jbuild_model
from repro.serve.kv import KVQuantUnsupported as JKVQuantUnsupported
from repro_torch import bridge
from repro_torch.allocate import AllocationReport
from repro_torch.checkpoint import PTQCheckpointer, load_pytree
from repro_torch.configs import get_config, get_smoke_config, reduced
from repro_torch.core import observers
from repro_torch.core import paths as pth
from repro_torch.core import quantizer as qz
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant_config import QuantConfig, QuantRecipe
from repro_torch.core.reconstruct import quantize_blocks
from repro_torch.launch import quantize
from repro_torch.models.model import build_model
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.kv import KVQuantUnsupported
from repro_torch.serve.smoke import serve_capability

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
CPU = "cpu"
RULES = ("layers.0.*:w_bits=8",)
RECIPE_KW = dict(method="flexround", w_bits=4, a_bits=8,
                 w_granularity="per_channel", iters=0, batch_size=4)
F32 = dict(rtol=1e-5, atol=1e-5)
NOISY = ("ln1", "ln2", "final_norm", "q_norm", "kv_norm", "norm")
MLA_SITES = ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")


def _np(t):
    return bridge.to_numpy(t)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _perturb(jparams, seed):
    """N(0, 0.1^2) on the norm scales the reference initialises to zeros."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        keys = {getattr(k, "key", None) for k in path}
        if keys & set(NOISY):
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, jparams)


@pytest.fixture(scope="module")
def lm():
    jcfg, cfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = _perturb(jmodel.init(jax.random.key(0)), seed=7)
    calib = _tokens(cfg, (4, 16), seed=0)
    x0, blocks, assemble = jmodel.quant_blocks(jparams, jnp.asarray(calib))
    jrecipe = JQuantRecipe(rules=RULES, **RECIPE_KW)
    jfin, jast, _ = jquantize_blocks(blocks, jrecipe, x0)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                jparams=jparams, params=bridge.params(jparams, CPU),
                calib=calib, jrecipe=jrecipe,
                recipe=QuantRecipe(rules=RULES, **RECIPE_KW), jblocks=blocks,
                jfin=jfin, jast=jast, jq=assemble(jfin))


def _keys(tree):
    """The key structure of a parameter tree, a run of layers as one
    layer's."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _keys(tree[0])
    return None


def _pairs(a, b, path=""):
    """(path, port leaf, reference leaf) over two trees of the same keys."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


def _qtensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, f"{prefix}{k}.")
    elif hasattr(tree, "pack_axis"):
        yield prefix[:-1], tree


def _same_qtensors(layers, jlayers):
    """Every QTensor of the port's layers equals the reference's (reference
    layers bridged to per-layer dicts): fields and bytes."""
    n = 0
    for tl, jl in zip(layers, jlayers, strict=True):
        q, jq = dict(_qtensors(tl)), dict(_qtensors(jl))
        assert sorted(q) == sorted(jq)
        for name, qt in q.items():
            j = jq[name]
            assert isinstance(qt, QTensor)
            assert (qt.shape, qt.bits, qt.packed, qt.pack_axis) == (
                tuple(j.shape), j.bits, j.packed, j.pack_axis), name
            for fld in ("codes", "scale", "zero"):
                assert torch.equal(getattr(qt, fld), getattr(j, fld)), (
                    name, fld)
            n += 1
    return n


# ------------------------------------------------------------------ configs
def test_configs_match_reference_field_for_field():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(jreduced(jcfg))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(
        jget_smoke_config(ARCH))
    assert (cfg.first_dense, cfg.n_experts, cfg.top_k, cfg.kv_lora_rank,
            cfg.q_lora_rank, cfg.mtp) == (3, 256, 8, 512, 1536, True)


def test_full_and_smoke_configs_build():
    for c in (get_config(ARCH), get_smoke_config(ARCH)):
        model = build_model(c)
        assert model.kind == "moe" and model.cfg is c


def test_param_tree_keys_and_shapes(lm):
    """The port's own init draws the reference's tree: ``dense_layers`` and
    ``layers`` (MLA attention; dense MLP, then MoE), ``mtp`` with ``proj``,
    a full MoE ``layer`` and ``norm``."""
    params = lm["model"].init(torch.Generator().manual_seed(0), device=CPU)
    jtree = jax.tree.map(lambda a: None, lm["jparams"])
    assert _keys(params) == _keys(jtree) == _keys(lm["params"])
    assert sorted(params["layers"][0]["attn"]) == sorted(
        MLA_SITES + ("q_norm", "kv_norm"))
    for seg in ("dense_layers", "layers"):
        assert len(params[seg]) == 1
        jshapes = jax.tree.map(lambda a: a.shape[1:], lm["jparams"][seg])
        for path, t, shp in _pairs(params[seg][0], jshapes):
            assert tuple(t.shape) == tuple(shp), (seg, path)
    jmtp = jax.tree.map(lambda a: a.shape, lm["jparams"]["mtp"])
    for path, t, shp in _pairs(params["mtp"], jmtp):
        assert tuple(t.shape) == tuple(shp), path


def test_bridge_unstacks_both_segments_and_carries_mtp(lm):
    p, jp = lm["params"], lm["jparams"]
    assert isinstance(p["dense_layers"], list) and isinstance(p["layers"], list)
    for seg in ("dense_layers", "layers"):
        jl = jax.tree.map(lambda a: a[0], jp[seg])
        for path, t, j in _pairs(p[seg][0], jl):
            assert np.array_equal(_np(t), np.asarray(j)), (seg, path)
    for path, t, j in _pairs(p["mtp"], jp["mtp"]):
        assert np.array_equal(_np(t), np.asarray(j)), path


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("S", [12, 40])  # 40: two attention chunks of 32
def test_backbone_matches_reference(lm, S):
    toks = _tokens(lm["cfg"], (2, S), seed=1)
    jx, jaux, _ = lm["jmodel"].backbone(lm["jparams"], jnp.asarray(toks),
                                        JQuantCtx(mode="fp"))
    x, aux, _ = lm["model"].backbone(lm["params"], torch.from_numpy(toks),
                                     QuantCtx(mode="fp"))
    np.testing.assert_allclose(_np(x), np.asarray(jx), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _serve_both(lm, jparams, params, jctx, ctx, steps=4):
    """Prefill 10 tokens of 2 rows, then ``steps`` greedy decode steps, in
    both packages; the port follows the reference's tokens. Returns the
    last caches and checks every logits row and greedy token."""
    cfg = lm["cfg"]
    toks = _tokens(cfg, (2, 10), seed=2)
    jcache = lm["jmodel"].init_cache(2, 16)
    cache = lm["model"].init_cache(2, 16, device=CPU)
    assert sorted(cache) == sorted(jcache) == ["ckv", "kr"]
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape
    jh, jcache = lm["jmodel"].prefill(jparams, jnp.asarray(toks), jcache, jctx)
    h, cache = lm["model"].prefill(params, torch.from_numpy(toks), cache, ctx)
    np.testing.assert_allclose(_np(h), np.asarray(jh), **F32)
    tok = toks[:, -1:]
    for i in range(steps):
        jlg, jcache = lm["jmodel"].decode_step(jparams, jnp.asarray(tok),
                                               jcache, jnp.int32(10 + i), jctx)
        lg, cache = lm["model"].decode_step(params, torch.from_numpy(tok),
                                            cache, 10 + i, ctx)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **F32)
        want = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        assert np.array_equal(_np(lg.argmax(-1)).astype(np.int32), want)
        tok = want
    for k in cache:  # both segments' latents, positions 0..13
        np.testing.assert_allclose(_np(cache[k]), np.asarray(jcache[k]), **F32)
    assert not _np(cache["ckv"])[:, :, 10 + steps:].any()


def test_prefill_and_decode_match_reference_fp(lm):
    _serve_both(lm, lm["jparams"], lm["params"], JQuantCtx(mode="fp"),
                QuantCtx(mode="fp"))


def test_prefill_and_decode_match_reference_deploy(lm):
    """Deploy mode on the reference's export (W4 body, W8 layer 0, A8):
    the absorbed decode's ``wkv_b`` dequantized through ``get_weight``,
    the experts through the batched dequant matmul's plain version."""
    jctx = JQuantCtx(mode="deploy", recipe=lm["jrecipe"], astates=lm["jast"],
                     backend="xla")
    ctx = QuantCtx(mode="deploy", recipe=lm["recipe"],
                   astates=bridge.astates(lm["jast"], CPU))
    _serve_both(lm, lm["jq"], bridge.params(lm["jq"], CPU), jctx, ctx)


# --------------------------------------------------------------------- loss
def test_loss_with_mtp_and_gradients_match_jax_grad(lm):
    """``ce + 0.01 aux + 0.3 mtp_ce``; S = 40 is no multiple of the
    reduced xent_chunk (32), so both heads run a padded remainder chunk
    (the mtp head over 39 positions)."""
    cfg = lm["cfg"]
    rng = np.random.default_rng(2)
    batch = {"tokens": _tokens(cfg, (2, 40), seed=3),
             "labels": _tokens(cfg, (2, 40), seed=4),
             "mask": (rng.random((2, 40)) < 0.8).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: lm["jmodel"].loss(p, jbatch, JQuantCtx(mode="fp")),
        has_aux=True))(lm["jparams"])
    params = bridge.params(lm["jparams"], CPU)
    for _, t, _ in _pairs(params, params):
        t.requires_grad_(True)
    loss, m = lm["model"].loss(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()},
                               QuantCtx(mode="fp"))
    loss.backward()
    assert sorted(m) == sorted(jm) == ["aux", "ce", "mtp_ce"]
    for k in m:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = float((m["ce"] + 0.01 * m["aux"] + 0.3 * m["mtp_ce"]).detach())
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-6)
    grads = bridge.params(jg, CPU)
    for path, t, g_ref in _pairs(params, grads):
        g, want = _np(t.grad), _np(g_ref)
        bound = 1e-5 * np.abs(want).max() + 1e-7
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(),
                                                 bound)
    assert np.abs(_np(params["mtp"]["proj"].grad)).max() > 0


# ---------------------------------------------------------------- PTQ plan
def test_quant_blocks_names_sites_and_apply_keys(lm):
    """Blocks ``layers.0`` (dense) and ``layers.1`` (MoE) with the
    reference's site names; one call token, kinds in the apply keys, so the
    two kinds get separate engines; the mtp head is no block."""
    x0, blocks, assemble = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(lm["calib"]))
    assert [b.name for b in blocks] == [b.name for b in lm["jblocks"]] == [
        "layers.0", "layers.1"]
    for b, jb in zip(blocks, lm["jblocks"]):
        assert {n: tuple(s.path) for n, s in b.sites.items()} == {
            n: tuple(s.path) for n, s in jb.sites.items()}
    assert len(blocks[0].sites) == 8 and len(blocks[1].sites) == 11
    assert [b.apply_key[1] for b in blocks] == ["dense", "moe"]
    assert blocks[0].apply_key[0] is blocks[1].apply_key[0]
    assert all("mtp" not in n for b in blocks for n in b.sites)
    with torch.no_grad():
        x1 = blocks[0].apply(blocks[0].params, x0, QuantCtx(mode="fp"))
        jx1 = lm["jblocks"][0].apply(lm["jblocks"][0].params,
                                     jnp.asarray(_np(x0)), JQuantCtx(mode="fp"))
    np.testing.assert_allclose(_np(x1), np.asarray(jx1), **F32)
    out = assemble(["d", "m"])
    assert out["dense_layers"] == ["d"] and out["layers"] == ["m"]
    assert out["mtp"] is lm["params"]["mtp"]


def test_export_is_bit_exact(lm):
    x0, blocks, assemble = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(lm["calib"]))
    fin, ast, reps = quantize_blocks(blocks, lm["recipe"], x0)
    q = assemble(fin)
    jq = bridge.params(lm["jq"], CPU)
    assert _same_qtensors(q["dense_layers"] + q["layers"],
                          jq["dense_layers"] + jq["layers"]) == 19
    assert {qt.bits for _, qt in _qtensors(q["dense_layers"][0])} == {8}
    assert {qt.bits for _, qt in _qtensors(q["layers"][0])} == {4}
    assert not list(_qtensors(q["mtp"]))  # the mtp head stays fp
    assert sorted(ast) == sorted(lm["jast"])
    for site in ast:
        for k in ("step", "beta"):
            np.testing.assert_allclose(_np(ast[site][k]),
                                       np.asarray(lm["jast"][site][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=site)
    assert all(r.iters == 0 and np.isfinite(r.err_after) for r in reps)


def test_rtn_rule_on_the_experts_exports_flexround_codes(lm):
    """At iters 0 FlexRound's state is s2 = s3 = 1, so its export rounds as
    RTN with the same s1 (the mse observer's): the rule
    ``layers.1.experts.*:method=rtn``, which spares the card a float32 s2
    per expert weight, changes no exported byte."""
    x0, blocks, _ = lm["model"].quant_blocks(lm["params"],
                                             torch.from_numpy(lm["calib"]))
    fr, _, _ = quantize_blocks(blocks, lm["recipe"], x0)
    rtn_recipe = QuantRecipe(rules=RULES + ("layers.1.experts.*:method=rtn",),
                             **RECIPE_KW)
    assert rtn_recipe.resolve("layers.1.experts.w_up",
                              blocks[1].sites["layers.1.experts.w_up"]
                              ).method.name == "rtn"
    rt, _, _ = quantize_blocks(blocks, rtn_recipe, x0)
    n = 0
    for a, b in zip(fr, rt, strict=True):
        qa, qb = dict(_qtensors(a)), dict(_qtensors(b))
        assert sorted(qa) == sorted(qb)
        for name in qa:
            for fld in ("codes", "scale", "zero"):
                assert torch.equal(getattr(qa[name], fld),
                                   getattr(qb[name], fld)), (name, fld)
            n += 1
    assert n == 19


def test_reconstruction_first_steps_match_reference(lm):
    """Weight-only W4, 3 iterations, minibatch = the whole calibration set
    (no draws): per block err_before, err_after and the loss curve."""
    kw = dict(method="flexround", w_bits=4, a_bits=None,
              w_granularity="per_channel", iters=3, batch_size=4)
    calib = lm["calib"]
    jx0, jblocks, _ = lm["jmodel"].quant_blocks(lm["jparams"],
                                                jnp.asarray(calib))
    _, _, jreps = jquantize_blocks(jblocks, JQuantRecipe(**kw), jx0)
    x0, blocks, _ = lm["model"].quant_blocks(lm["params"],
                                             torch.from_numpy(calib))
    _, _, reps = quantize_blocks(blocks, QuantRecipe(**kw), x0)
    assert len(reps) == len(jreps) == 2
    for rep, jrep in zip(reps, jreps):
        assert rep.name == jrep.name and rep.iters == 3
        for k in ("err_before", "err_after"):
            np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                       rtol=1e-5)
        np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                                   rtol=1e-5)
        assert rep.err_after < rep.err_before


# ------------------------------------------------------------ the refusals
def test_vector_positions_are_refused_as_the_reference_does(lm):
    cfg = lm["cfg"]
    tok = _tokens(cfg, (2, 1), seed=5)
    jcache = lm["jmodel"].init_cache(2, 8)
    with pytest.raises(JKVQuantUnsupported) as jei:
        lm["jmodel"].decode_step(lm["jparams"], jnp.asarray(tok), jcache,
                                 jnp.asarray([3, 4]), JQuantCtx(mode="fp"))
    cache = lm["model"].init_cache(2, 8, device=CPU)
    with pytest.raises(KVQuantUnsupported) as ei:
        lm["model"].decode_step(lm["params"], torch.from_numpy(tok), cache,
                                torch.tensor([3, 4]), QuantCtx(mode="fp"))
    assert ei.value.reason == jei.value.reason == "kv_quant_unsupported:mla"


def test_int8_latent_cache_is_refused(lm):
    with pytest.raises(KVQuantUnsupported) as ei:
        lm["model"].init_cache(2, 16, kv_quant=True, device=CPU)
    assert ei.value.reason == "kv_quant_unsupported:mla"
    assert isinstance(ei.value, ValueError)


def test_serve_capability_reasons(lm):
    """As the reference's ``test_engine_capability_reasons``: the slot
    engine refuses MLA, so does an int8 cache; the uniform-batch decode
    (``--serve-smoke``) is fine."""
    model = lm["model"]
    assert serve_capability(model, engine=True) == (False,
                                                    "unsupported_layout:mla")
    assert serve_capability(model, kv_quant=True) == (
        False, "kv_quant_unsupported:mla")
    assert serve_capability(model) == (True, "ok")
    with pytest.raises(KVQuantUnsupported) as ei:
        ServeEngine(model, lm["params"], QuantCtx(mode="fp"),
                    EngineConfig(slots=2, max_len=16, kv_quant=False),
                    device=CPU)
    assert ei.value.reason == "unsupported_layout:mla"


# -------------------------------------------------- observer and quantizer
@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_mse_observer_in_chunks_equals_one_pass(monkeypatch, granularity,
                                               symmetric):
    """A stacked weight walked one expert at a time (``MSE_CHUNK_ELEMS``
    below one expert) and three at a time gives the scales and zeros of
    the whole stack at once, bit for bit; expert 2 is all zero (80
    ties)."""
    qcfg = QuantConfig(bits=4, symmetric=symmetric, granularity=granularity,
                       observer="mse", batch_dims=1)
    w = torch.from_numpy(np.random.default_rng(11).normal(
        0, 0.05, (7, 24, 16)).astype(np.float32)).to(torch.bfloat16)
    w[2] = 0
    s, z = observers.mse_scale(w, qcfg)  # one chunk: 2688 elements
    for chunk in (1, 3 * 24 * 16):
        monkeypatch.setattr(observers, "MSE_CHUNK_ELEMS", chunk)
        sc, zc = observers.mse_scale(w, qcfg)
        assert torch.equal(sc, s) and torch.equal(zc, z), chunk
    assert tuple(s.shape) == ((7, 1, 16) if granularity == "per_channel"
                              else (7, 1, 1))


@pytest.mark.parametrize("symmetric", [False, True])
def test_export_codes_rounded_in_slabs_equal_one_pass(monkeypatch, symmetric):
    """``from_codes`` rounds its float codes a slab of the first axis at a
    time; slabs of one expert give the bytes of one slab over the stack."""
    from repro_torch.core import qtensor
    qcfg = QuantConfig(bits=4, symmetric=symmetric, batch_dims=1)
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.uniform(qcfg.qmin, qcfg.qmax, (5, 12, 6)
                                     ).astype(np.float32)).round()
    s, z = torch.ones((5, 1, 6)), torch.zeros((5, 1, 6))
    whole = qtensor.from_codes(q, s, z, qcfg)
    monkeypatch.setattr(qtensor, "_SLAB_ELEMS", 1)
    slabs = qtensor.from_codes(q, s, z, qcfg)
    assert whole.packed and torch.equal(whole.codes, slabs.codes)
    assert torch.equal(qtensor.dequantize_qtensor(slabs).float(),
                       qtensor.dequantize_qtensor(whole).float())


@pytest.mark.parametrize("ste", [True, False])
def test_quantize_without_autograd_is_bit_identical(ste):
    """``quantize`` and ``fake_quant`` without autograd (in place on one
    float32 copy) equal the differentiable forward bit for bit, and leave
    the weight alone."""
    qcfg = QuantConfig(bits=4, granularity="per_channel", batch_dims=1)
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.normal(0, 1, (3, 20, 8)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.05, 0.3, (3, 1, 8)).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, 16, (3, 1, 8)).astype(np.float32))
    keep = w.clone()
    for dtype in (torch.float32, torch.bfloat16):
        wd = w.to(dtype)
        with torch.enable_grad():
            q = qz.quantize(wd, s, z, qcfg, ste=ste)
            f = qz.fake_quant(wd, s, z, qcfg, ste=ste)
        with torch.no_grad():
            assert torch.equal(qz.quantize(wd, s, z, qcfg, ste=ste), q)
            got = qz.fake_quant(wd, s, z, qcfg, ste=ste)
        assert got.dtype == dtype and torch.equal(got, f)
    assert torch.equal(w, keep)


# ------------------------------------------------------------ the launcher
SMOKE = ["--arch", ARCH, "--smoke", "--calib", "8", "--seq", "16"]
LAUNCHES = {
    "export": SMOKE + ["--w-bits", "4", "--a-bits", "8", "--rule",
                       "layers.0.*:w_bits=8", "--iters", "0", "--serve-smoke",
                       "--serve"],
    "train": SMOKE + ["--w-bits", "4", "--iters", "2"],
}


def _reference_launch(argv, out):
    """The reference launcher under ``argv``: (tree, meta, reports,
    printed lines), the reports captured from ``quantize_blocks``."""
    got = {}
    real_qb = jquantize.quantize_blocks

    def quantize_blocks(*a, **k):
        res = real_qb(*a, **k)
        got["reports"] = res[2]
        return res

    saved_argv = sys.argv
    jquantize.quantize_blocks = quantize_blocks
    sys.argv = ["repro.launch.quantize"] + argv + ["--out", out]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jquantize.main()
    finally:
        sys.argv = saved_argv
        jquantize.quantize_blocks = real_qb
    tree, meta = jload_pytree(out)
    return tree, meta, got["reports"], buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    d = tmp_path_factory.mktemp("deepseek_launch")
    jcfg = jget_smoke_config(ARCH)
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    calib = np.asarray(JCalibrationSet.build(
        JSyntheticTokens(vocab=jcfg.vocab, seq_len=16, seed=0), 8).tokens)
    out = {}
    for tag, argv in LAUNCHES.items():
        jtree, jmeta, jreports, jlines = _reference_launch(
            argv, str(d / f"j_{tag}"))
        args = quantize.build_parser().parse_args(
            argv + ["--out", str(d / f"t_{tag}"), "--device", "cpu"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = quantize.run(args, params=bridge.params(jparams, CPU),
                               calib_tokens=torch.from_numpy(calib.copy()))
        tree, meta = load_pytree(str(d / f"t_{tag}"), device=CPU)
        out[tag] = dict(jtree=jtree, jmeta=jmeta, jreports=jreports,
                        jlines=jlines, tree=tree, meta=meta, res=res,
                        lines=buf.getvalue().splitlines())
    return out


def test_launcher_export_matches_the_reference(launches):
    r = launches["export"]
    params = r["tree"]["params"]
    jparams = bridge.params(r["jtree"]["params"], CPU)
    assert _keys(params) == _keys(jparams)
    assert _same_qtensors(params["dense_layers"] + params["layers"],
                          jparams["dense_layers"] + jparams["layers"]) == 19
    for path, t, j in _pairs(params["mtp"], jparams["mtp"]):
        assert not isinstance(t, QTensor) and torch.equal(t, j), path
    ast, jast = r["tree"]["astates"], r["jtree"]["astates"]
    assert sorted(ast) == sorted(jast)
    for site in ast:
        for k in ("step", "beta"):
            np.testing.assert_allclose(_np(ast[site][k]),
                                       np.asarray(jast[site][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=site)
    for k in ("arch", "method", "w_bits", "a_bits", "rules"):
        assert r["meta"][k] == r["jmeta"][k], k
    assert r["meta"]["arch"] == "deepseek-v3-671b-smoke"


def test_launcher_serves_through_the_absorbed_decode_and_skips_the_engine(
        launches):
    """``--serve-smoke`` runs the uniform-batch decode (a finite us/step);
    ``--serve`` prints the reference's skip line and serves nothing."""
    r = launches["export"]
    assert np.isfinite(r["res"].serve_smoke_us) and r["res"].serve is None
    skip = "serve: skipped arch=deepseek-v3-671b-smoke reason=unsupported_layout:mla"
    assert skip in r["lines"] and skip in r["jlines"]
    assert any(ln.startswith("serve-smoke[auto]: ") for ln in r["lines"])


def test_launcher_two_step_reports_match(launches):
    """The curves and err_before within relative 1e-5. After two steps one
    code of the export lies on a rounding boundary and rounds the other way
    in one package (the float32 sums of the step differ in their last
    bits), so err_after, which is measured on the exported grid, is held
    to relative 1e-3 and the exports may differ in at most 2 codes."""
    r = launches["train"]
    reps, jreps = r["res"].reports, r["jreports"]
    assert [x.name for x in reps] == [x.name for x in jreps] == [
        "layers.0", "layers.1"]
    for rep, jrep in zip(reps, jreps):
        assert rep.iters == jrep.iters == 2
        np.testing.assert_allclose(rep.err_before, jrep.err_before, rtol=1e-5)
        np.testing.assert_allclose(rep.err_after, jrep.err_after, rtol=1e-3)
        np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                                   rtol=1e-5)
    p = r["tree"]["params"]
    jp = bridge.params(r["jtree"]["params"], CPU)
    flips = sum(int((qa.codes != qb.codes).sum())
                for la, lb in zip(p["dense_layers"] + p["layers"],
                                  jp["dense_layers"] + jp["layers"])
                for (_, qa), (_, qb) in zip(_qtensors(la), _qtensors(lb)))
    assert flips <= 2


def test_launcher_resume_after_block_0_equals_an_unbroken_run(tmp_path):
    """QDrop with A8 over both segments: stopped right after block 0's
    checkpoint, then run again; the export equals an unbroken run's."""
    argv = ["--arch", ARCH, "--smoke", "--seq", "16", "--w-bits", "4",
            "--a-bits", "8", "--iters", "3", "--calib", "6", "--device",
            "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        quantize.main(argv + ["--out", str(tmp_path / "a")])

    class Stop(Exception):
        pass

    real_save = PTQCheckpointer.save

    def save(self, next_block, *a, **k):
        real_save(self, next_block, *a, **k)
        raise Stop

    ckpt = str(tmp_path / "ckpt")
    PTQCheckpointer.save = save
    try:
        with pytest.raises(Stop), contextlib.redirect_stdout(io.StringIO()):
            quantize.main(argv + ["--resume-dir", ckpt,
                                  "--out", str(tmp_path / "b")])
    finally:
        PTQCheckpointer.save = real_save
    assert PTQCheckpointer(ckpt).meta()["next_block"] == 1
    with contextlib.redirect_stdout(io.StringIO()):
        res = quantize.main(argv + ["--resume-dir", ckpt,
                                    "--out", str(tmp_path / "b")])
    assert res.resumed_units == 1
    a, _ = load_pytree(str(tmp_path / "a"), device=CPU)
    b, _ = load_pytree(str(tmp_path / "b"), device=CPU)
    pa, pb = a["params"], b["params"]
    n = 0
    for la, lb in zip(pa["dense_layers"] + pa["layers"],
                      pb["dense_layers"] + pb["layers"], strict=True):
        for (name, qa), (_, qb) in zip(_qtensors(la), _qtensors(lb),
                                       strict=True):
            for fld in ("codes", "scale", "zero"):
                assert torch.equal(getattr(qa, fld), getattr(qb, fld)), name
            n += 1
    assert n == 19
    assert sorted(a["astates"]) == sorted(b["astates"])
    for site in a["astates"]:
        for k in ("step", "beta"):
            assert torch.equal(a["astates"][site][k], b["astates"][site][k])


def test_auto_bits_probes_the_mla_sites(tmp_path):
    """``--auto-bits`` probes MLA's five sites in both blocks through the
    allocator's probe context (``mla_forward`` calls only ``ctx.linear``)
    and every exported QTensor carries its allocated bits."""
    argv = SMOKE + ["--w-bits", "4", "--iters", "0", "--auto-bits", "4.5",
                    "--resume-dir", str(tmp_path / "ck"), "--device", "cpu",
                    "--out", str(tmp_path / "q")]
    with contextlib.redirect_stdout(io.StringIO()):
        res = quantize.main(argv)
    bits = AllocationReport.load(str(tmp_path / "ck")).bits()
    for i in (0, 1):
        assert all(f"layers.{i}.{n}" in bits for n in MLA_SITES)
    _, blocks, _ = res.model.quant_blocks(res.qparams,
                                          torch.zeros((1, 4), dtype=torch.long))
    assert sorted(bits) == sorted(n for b in blocks for n in b.sites)
    for b in blocks:
        for name, site in b.sites.items():
            assert pth.get_path(b.params, site.path).bits == bits[name], name
