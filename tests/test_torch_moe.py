"""Port parity: the MoE family (``repro_torch.models.moe`` inside
``repro_torch.models.transformer``) against the reference on
``get_smoke_config("llama4-scout-17b-a16e")``: 4 experts, top-1, one shared
expert, dropless capacity (factor 8), float32.

The reference initialises the weights (``jax.random.key(0)``) and quantizes
them export-only (``quantize_blocks(iters=0)``: W4 body, W8 rule on layer 0,
A8, per-channel, mse observer); the port gets the weights through the
bridge and quantizes them itself. Tolerances: routing, dispatch masks,
exported codes, packed bytes, scales, zero points, byte counts and greedy
tokens are exact; float32 hidden states, expert outputs and logits within
rtol = atol = 1e-5 (reduction order); the aux loss within 1e-6.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.qtensor import tree_weight_bytes as jtree_weight_bytes
from repro.core.quant_config import QuantRecipe as JQuantRecipe
from repro.core.reconstruct import init_wstates as jinit_wstates
from repro.core.reconstruct import quantize_blocks as jquantize_blocks
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import QTensor, tree_weight_bytes
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.core.reconstruct import init_wstates, quantize_blocks
from repro_torch.kernels import ref
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.serve import kv as skv
from repro_torch.serve.engine import EngineConfig, ServeEngine

torch.set_num_threads(2)

ARCH = "llama4-scout-17b-a16e"
CPU = "cpu"
RULES = ("layers.0.*:w_bits=8",)
RECIPE_KW = dict(method="flexround", w_bits=4, a_bits=8,
                 w_granularity="per_channel", iters=0, batch_size=4)
ENGINE_KW = dict(slots=3, max_len=32, prefill_group=2, kv_quant=True)
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return bridge.to_numpy(t)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def lm():
    jcfg, cfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    params = bridge.params(jparams, CPU)
    calib = _tokens(cfg, (4, 16), seed=0)
    jrecipe = JQuantRecipe(rules=RULES, **RECIPE_KW)
    recipe = QuantRecipe(rules=RULES, **RECIPE_KW)
    jx0, jblocks, jassemble = jmodel.quant_blocks(jparams, jnp.asarray(calib))
    jfin, jast, jreps = jquantize_blocks(jblocks, jrecipe, jx0)
    x0, blocks, assemble = model.quant_blocks(params, torch.from_numpy(calib))
    fin, ast, reps = quantize_blocks(blocks, recipe, x0)
    return dict(cfg=cfg, jmodel=jmodel, model=model, jparams=jparams,
                params=params, calib=calib, jrecipe=jrecipe, recipe=recipe,
                jblocks=jblocks, blocks=blocks, jfin=jfin, fin=fin, jast=jast,
                ast=ast, jreps=jreps, reps=reps, jq=jassemble(jfin),
                q=assemble(fin))


def _jctx(lm, mode):
    if mode == "fp":
        return JQuantCtx(mode="fp")
    return JQuantCtx(mode="deploy", recipe=lm["jrecipe"], astates=lm["jast"],
                     backend="xla")


def _ctx(lm, mode):
    if mode == "fp":
        return QuantCtx(mode="fp")
    return QuantCtx(mode="deploy", recipe=lm["recipe"],
                    astates=bridge.astates(lm["jast"], CPU))


def _reference_routing(monkeypatch):
    """Record the reference moe_ffn's top-k indices and its dispatch and
    combine masks (the first arguments of its two einsums)."""
    seen = {"einsum": [], "top_k": []}

    def top_k(x, k):
        out = jax.lax.top_k(x, k)
        seen["top_k"].append(out[1])
        return out

    def einsum(spec, a, b):
        seen["einsum"].append(a)
        return jnp.einsum(spec, a, b)

    fake_jax = types.SimpleNamespace(
        nn=jax.nn, lax=types.SimpleNamespace(top_k=top_k))
    fake_jnp = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                        if not k.startswith("__")})
    fake_jnp.einsum = einsum
    monkeypatch.setattr(jmoe, "jax", fake_jax)
    monkeypatch.setattr(jmoe, "jnp", fake_jnp)
    return seen


def test_configs_match_reference():
    for get, jget in ((get_config, jget_config),
                      (get_smoke_config, jget_smoke_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    cfg = get_smoke_config(ARCH)
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff, cfg.capacity_factor) == (
        4, 1, 64, 8.0)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_routing_and_output(lm, monkeypatch, top_k):
    """One MoE FFN on the same hidden input: identical routing indices,
    expert counts and dispatch/combine masks, with capacity drops (factor
    0.5); y within float32 reduction order; the Switch aux loss."""
    jcfg = dataclasses.replace(jget_smoke_config(ARCH), top_k=top_k,
                               capacity_factor=0.5)
    cfg = dataclasses.replace(lm["cfg"], top_k=top_k, capacity_factor=0.5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 24, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], lm["jparams"]["layers"]["mlp"])
    p = lm["params"]["layers"][1]["mlp"]
    seen = _reference_routing(monkeypatch)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, JQuantCtx(mode="fp"),
                            "layers")
    N = moe._pick_group(72, min(cfg.moe_group, 72))
    assert N == 36  # two groups
    xt = torch.from_numpy(x).reshape(72 // N, N, cfg.d_model)
    _, idx, dispatch, combine = moe.route(p, xt, cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(seen["top_k"][0]))
    np.testing.assert_array_equal(dispatch.numpy(),
                                  np.asarray(seen["einsum"][0]))
    np.testing.assert_allclose(combine.numpy(), np.asarray(seen["einsum"][1]),
                               rtol=1e-6, atol=0)
    counts = dispatch.sum(dim=(1, 3))
    assert counts.max() <= moe._capacity(N, top_k, cfg.n_experts, 0.5)
    assert counts.sum() < 72 * top_k  # capacity 0.5 drops tokens here
    y, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg, QuantCtx(mode="fp"),
                         "layers")
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.asarray([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]],
                       np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    v, i = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_capacity_and_group_match_reference():
    """``_pick_group`` over the range ``tests/test_property.py:118``
    samples, and ``_capacity`` over group sizes, top-k, experts and
    factors."""
    rng = np.random.default_rng(0)
    for tokens, target in zip(rng.integers(1, 4097, 400),
                              rng.integers(1, 2049, 400)):
        assert moe._pick_group(int(tokens), int(target)) == jmoe._pick_group(
            int(tokens), int(target))
    for n in (1, 3, 4, 24, 64, 512, 1024, 4096):
        for k in (1, 2, 8):
            for e in (4, 16, 256):
                for f in (1.0, 1.25, 2.0, 8.0):
                    assert moe._capacity(n, k, e, f) == jmoe._capacity(n, k, e, f)
    assert moe._capacity(512, 1, 16, 1.25) == 40  # the llama4 export pass
    assert moe._capacity(4, 1, 16, 1.25) == 4     # the llama4 decode step


@pytest.mark.parametrize("mode", ["fp", "deploy"])
def test_backbone_logits_and_aux_match(lm, mode):
    """fp weights, and the reference's exported QTensors (expert stacks
    through the per-expert kernel's plain version) in deploy mode."""
    toks = _tokens(lm["cfg"], (3, 12), seed=1)
    jp, p = (lm["jparams"], lm["params"]) if mode == "fp" else (
        lm["jq"], bridge.params(lm["jq"], CPU))
    jx, jaux, _ = lm["jmodel"].backbone(jp, jnp.asarray(toks), _jctx(lm, mode))
    x, aux, _ = lm["model"].backbone(p, torch.from_numpy(toks), _ctx(lm, mode))
    np.testing.assert_allclose(_np(x), np.asarray(jx), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    jlogits = jx @ lm["jmodel"].lm_head(jp).astype(jx.dtype)
    np.testing.assert_allclose(_np(lm["model"].logits(p, x)),
                               np.asarray(jlogits), **F32)


def test_deploy_experts_take_the_batched_kernel(lm, monkeypatch):
    calls = []
    real = ref.dequant_matmul_batched_ref

    def spy(x, codes, scale, zero, packed, out_dtype=None):
        calls.append((tuple(x.shape), tuple(codes.shape), packed))
        return real(x, codes, scale, zero, packed, out_dtype)

    monkeypatch.setattr(ref, "dequant_matmul_batched_ref", spy)
    toks = torch.from_numpy(_tokens(lm["cfg"], (2, 8), seed=2))
    lm["model"].backbone(lm["q"], toks, _ctx(lm, "deploy"))
    E, F, D = lm["cfg"].n_experts, lm["cfg"].moe_d_ff, lm["cfg"].d_model
    C = moe._capacity(16, 1, E, 8.0)
    # layer 0 exports W8 (one code per byte), layer 1 W4 (packed along K)
    assert calls == [((E, C, D), (E, D, F), False),
                     ((E, C, D), (E, D, F), False),
                     ((E, C, F), (E, F, D), False),
                     ((E, C, D), (E, D // 2, F), True),
                     ((E, C, D), (E, D // 2, F), True),
                     ((E, C, F), (E, F // 2, D), True)]


def test_prefill_then_decode_matches_full_forward(lm):
    """prefill(t[:-1]) + decode_step(t[-1]) agrees with the full forward, in
    the port and against the reference's decode logits
    (``tests/test_models_smoke.py:55``)."""
    cfg, model = lm["cfg"], lm["model"]
    toks = _tokens(cfg, (2, 10), seed=3)
    ctx = QuantCtx(mode="fp")
    cache = model.init_cache(2, 14, device=CPU)
    _, cache = model.prefill(lm["params"], torch.from_numpy(toks[:, :-1]),
                             cache, ctx)
    logits, _ = model.decode_step(lm["params"], torch.from_numpy(toks[:, -1:]),
                                  cache, 9, ctx)
    x, _, _ = model.backbone(lm["params"], torch.from_numpy(toks), ctx)
    full = model.logits(lm["params"], x[:, -1:])
    np.testing.assert_allclose(_np(logits), _np(full), **F32)
    jcache = lm["jmodel"].init_cache(2, 14)
    _, jcache = lm["jmodel"].prefill(lm["jparams"], jnp.asarray(toks[:, :-1]),
                                     jcache, JQuantCtx(mode="fp"))
    jlogits, _ = lm["jmodel"].decode_step(lm["jparams"],
                                          jnp.asarray(toks[:, -1:]), jcache,
                                          jnp.int32(9), JQuantCtx(mode="fp"))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **F32)


def _qtensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, f"{prefix}{k}.")
    elif hasattr(tree, "pack_axis"):
        yield prefix[:-1], tree


def test_export_bit_identical(lm):
    """Export-only quantize_blocks with the W8 rule on layer 0: the flexround
    states (s1 per expert), then every QTensor's codes, packed bytes, scale
    and zero point are bit-identical; the expert stacks keep pack_axis 1."""
    for jb, b in zip(lm["jblocks"], lm["blocks"]):
        assert list(b.sites) == list(jb.sites)
        assert {n: s.batch_dims for n, s in b.sites.items()} == {
            n: s.batch_dims for n, s in jb.sites.items()}
        jst = jinit_wstates(jb, lm["jrecipe"])
        st = init_wstates(b, lm["recipe"])
        for name in st:
            for k in ("s1", "zero", "s3"):
                np.testing.assert_array_equal(_np(st[name][k]),
                                              np.asarray(jst[name][k]),
                                              err_msg=f"{name}.{k}")
    routes = set()
    for jf, f in zip(lm["jfin"], lm["fin"]):
        jq, q = dict(_qtensors(jf)), dict(_qtensors(f))
        assert sorted(jq) == sorted(q) and len(q) == 10
        for name, qt in q.items():
            j = jq[name]
            assert isinstance(qt, QTensor)
            assert (qt.shape, qt.bits, qt.packed, qt.dtype, qt.pack_axis) == (
                j.shape, j.bits, j.packed, j.dtype, j.pack_axis), name
            for fld in ("codes", "scale", "zero"):
                np.testing.assert_array_equal(
                    _np(getattr(qt, fld)), np.asarray(getattr(j, fld)),
                    err_msg=f"{name}.{fld}")
            routes.add((len(qt.shape), qt.bits, qt.packed, qt.pack_axis))
    assert routes == {(2, 8, False, 0), (2, 4, True, 0), (3, 8, False, 1),
                      (3, 4, True, 1)}


def test_astates_and_errors_agree(lm):
    jast, ast = lm["jast"], lm["ast"]
    assert sorted(ast) == sorted(jast) and len(ast) == 2 * 10
    for site in ast:
        for k in ("step", "beta"):
            np.testing.assert_allclose(_np(ast[site][k]),
                                       np.asarray(jast[site][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=site)
    for rep, jrep in zip(lm["reps"], lm["jreps"]):
        assert rep.name == jrep.name
        np.testing.assert_allclose(rep.err_before, jrep.err_before, rtol=1e-4)


def _serve(engine, requests):
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


def test_engines_emit_identical_greedy_tokens(lm):
    cfg = lm["cfg"]
    rng = np.random.default_rng(1)
    lens = [5, 9, 12, 7, 3, 14]  # buckets 8 and 16; slot reuse
    requests = [(i, rng.integers(0, cfg.vocab, n).astype(np.int32), 6)
                for i, n in enumerate(lens)]
    jeng = JServeEngine(lm["jmodel"], lm["jq"], _jctx(lm, "deploy"),
                        JEngineConfig(**ENGINE_KW))
    eng = ServeEngine(lm["model"], bridge.params(lm["jq"], CPU),
                      _ctx(lm, "deploy"), EngineConfig(**ENGINE_KW),
                      device=CPU)
    want = _serve(jeng, requests)
    got = _serve(eng, requests)
    assert got == want
    assert all(len(v) == 6 for v in got.values())
    assert eng.hbm_per_slot_bytes() == jeng.hbm_per_slot_bytes()


def test_byte_counts_match_reference(lm):
    assert tree_weight_bytes(lm["q"]) == jtree_weight_bytes(lm["jq"])
    assert tree_weight_bytes(lm["params"]) == jtree_weight_bytes(lm["jparams"])
    cfg = lm["cfg"]
    cache = lm["model"].init_cache(4, 32, kv_quant=True, device=CPU)
    jcache = lm["jmodel"].init_cache(4, 32, kv_quant=True)
    from repro.serve import kv as jkv
    got = skv.hbm_per_slot_bytes(cache, 4)
    assert got == jkv.hbm_per_slot_bytes(jcache, 4)
    assert got == 32 * cfg.n_layers * cfg.n_kv_heads * (2 * cfg.head_dim + 2 * 4)


def test_bridge_unstacks_uniform_expert_qtensors(lm):
    """Without a rule every layer exports the same QTensor layout, so the
    reference restacks them: codes (L, E, K/2, N) while ``shape`` keeps the
    per-layer (E, K, N). The bridge hands the port (E, K/2, N) per layer,
    pack_axis 1, and the port serves them as the reference does."""
    jrecipe = JQuantRecipe(**RECIPE_KW)
    jx0, jblocks, jassemble = lm["jmodel"].quant_blocks(
        lm["jparams"], jnp.asarray(lm["calib"]))
    jfin, jast, _ = jquantize_blocks(jblocks, jrecipe, jx0)
    jq = jassemble(jfin)
    cfg = lm["cfg"]
    E, D, F, L = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.n_layers
    jw = jq["layers"]["mlp"]["experts"]["w_up"]
    assert jw.shape == (E, D, F) and jw.codes.shape == (L, E, D // 2, F)
    assert jw.pack_axis == 1 and jw.scale.shape == (L, E, 1, F)
    q = bridge.params(jq, CPU)
    assert isinstance(q["layers"], list) and len(q["layers"]) == L
    for i, layer in enumerate(q["layers"]):
        w = layer["mlp"]["experts"]["w_up"]
        assert w.shape == (E, D, F) and w.pack_axis == 1 and w.packed
        assert tuple(w.codes.shape) == (E, D // 2, F)
        np.testing.assert_array_equal(_np(w.codes), np.asarray(jw.codes[i]))
        np.testing.assert_array_equal(_np(w.scale), np.asarray(jw.scale[i]))
        assert tuple(layer["mlp"]["router"].shape) == (D, E)
    toks = _tokens(cfg, (2, 9), seed=4)
    jctx = JQuantCtx(mode="deploy", recipe=jrecipe, astates=jast,
                     backend="xla")
    ctx = QuantCtx(mode="deploy", recipe=QuantRecipe(**RECIPE_KW),
                   astates=bridge.astates(jast, CPU))
    jx, _, _ = lm["jmodel"].backbone(jq, jnp.asarray(toks), jctx)
    x, _, _ = lm["model"].backbone(q, torch.from_numpy(toks), ctx)
    np.testing.assert_allclose(_np(x), np.asarray(jx), **F32)


def test_deepseek_layouts_on_the_moe_config_match_the_reference():
    """deepseek's layouts on llama4-scout's smoke config (they raised
    before deepseek-v3 was ported): one leading dense layer in front of the
    MoE layer (``dense_layers`` and ``layers``), and MLA attention. The
    hidden states equal the reference's on the same weights (float32,
    rtol = atol = 1e-5)."""
    mla_dims = dict(use_mla=True, q_lora_rank=32, kv_lora_rank=32,
                    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, head_dim=24)
    for change in (dict(first_dense=1), mla_dims):
        jcfg = dataclasses.replace(jget_smoke_config(ARCH), **change)
        cfg = dataclasses.replace(get_smoke_config(ARCH), **change)
        jmodel, model = jbuild_model(jcfg), build_model(cfg)
        jparams = jmodel.init(jax.random.key(0))
        params = bridge.params(jparams, CPU)
        segs = [k for k in ("dense_layers", "layers") if k in params]
        assert segs == (["dense_layers", "layers"] if "first_dense" in change
                        else ["layers"])
        assert [len(params[k]) for k in segs] == (
            [1, 1] if "first_dense" in change else [2])
        toks = _tokens(cfg, (2, 9), seed=6)
        jx, _, _ = jmodel.backbone(jparams, jnp.asarray(toks),
                                   JQuantCtx(mode="fp"))
        x, _, _ = model.backbone(params, torch.from_numpy(toks),
                                 QuantCtx(mode="fp"))
        np.testing.assert_allclose(_np(x), np.asarray(jx), **F32)
