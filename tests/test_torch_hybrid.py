"""Port parity: recurrentgemma-2b, the hybrid family (``GriffinLM``: RG-LRU
recurrent blocks and ring-buffer local attention in the pattern RRA)
against the reference at ``get_smoke_config("recurrentgemma-2b")``: 3
layers (R, R, A), d_model 64, lru_width 64, 4 query heads and 1 KV head of
16, geglu d_ff 128, local window 16, float32.

The reference initialises the weights (``jax.random.key(0)``); the leaves
it sets to constants (norm scales, ``b_a``, ``b_i``, ``conv_b``) get
N(0, 0.1^2) noise drawn with numpy, so that they change what both packages
compute. The port gets every array through the bridge. Tolerances:

- configs: field for field equal; parameter trees: the same keys, shapes
  and dtypes (``lam``, ``b_a``, ``b_i`` float32 in a bfloat16 tree), the
  port's ``lam`` within relative 1e-5 of the reference's;
- float32 hidden states, logits, recurrent states and rings (fp, and deploy
  mode on the reference's export through the port's plain versions against
  the reference's ``xla`` backend): rtol = atol = 1e-5 (reduction order);
  greedy tokens identical; the ``kpos`` rings equal;
- the port's decode against its own full forward over the same tokens
  (the window binds and the ring wraps): rtol = atol = 1e-5;
- ``loss``: relative 1e-5; every gradient leaf against ``jax.grad``:
  max |g - g_ref| <= 1e-5 * max |g_ref| + 1e-7;
- export at ``iters=0`` (W4 body, W8 layer 0, A8): codes, scale and zero
  of every QTensor bit-exact, activation states relative 1e-5;
- reconstruction of one R and one A block over the whole calibration set:
  weight-only W4, 12 Adam steps, errors and loss curve within relative
  1e-5; W4A8 with QDrop and the reference's masks replayed, 4 steps: the
  first step's loss within relative 1e-5, the rest within 2%, the repo's
  bound for A8 runs (ROADMAP Queue 3: an STE-rounded activation on a
  rounding boundary flips in one package; in these blocks from the second
  step on);
- the launcher at ``--arch recurrentgemma-2b --smoke --device cpu``: the
  export-only run exports the reference launcher's QTensors bit for bit
  and prints its skip line; the 2-step run's curves and errors agree to
  relative 1e-5.
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
from repro.core import reconstruct as jrc
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.context import site_key as jsite_key
from repro.core.quant_config import QuantRecipe as JQuantRecipe
from repro.core.reconstruct import quantize_blocks as jquantize_blocks
from repro.data import CalibrationSet as JCalibrationSet
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.launch import quantize as jquantize
from repro.models import build_model as jbuild_model
from repro.serve.kv import KVQuantUnsupported as JKVQuantUnsupported
from repro_torch import bridge
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import get_config, get_smoke_config, reduced
from repro_torch.core import reconstruct as rc
from repro_torch.core.context import QuantCtx
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.core.reconstruct import quantize_blocks
from repro_torch.launch import quantize
from repro_torch.models import rglru
from repro_torch.models.model import build_model
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.kv import KVQuantUnsupported
from repro_torch.serve.smoke import serve_capability

torch.set_num_threads(2)

ARCH = "recurrentgemma-2b"
CPU = "cpu"
RULES = ("layers.0.*:w_bits=8",)
RECIPE_KW = dict(method="flexround", w_bits=4, a_bits=8,
                 w_granularity="per_channel", iters=0, batch_size=4)
F32 = dict(rtol=1e-5, atol=1e-5)
NOISY = ("ln", "final_norm", "b_a", "b_i", "conv_b")
R_SITES = ["mix.rglru.w_a", "mix.rglru.w_i", "mix.w_gate", "mix.w_o",
           "mix.w_x"]
A_SITES = ["mix.wk", "mix.wo", "mix.wq", "mix.wv"]
MLP_SITES = ["ffn.mlp.w_down", "ffn.mlp.w_gate", "ffn.mlp.w_up"]


def _np(t):
    return bridge.to_numpy(t)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def _perturb(jparams, seed):
    """N(0, 0.1^2) on the leaves the reference initialises to constants."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        keys = {getattr(k, "key", None) for k in path}
        if keys & set(NOISY):
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, jparams)


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


def _same_qtensors(layers, jlayers, kinds):
    n = 0
    for tl, jl, kind in zip(layers, jlayers, kinds, strict=True):
        q, jq = dict(_qtensors(tl)), dict(_qtensors(jl))
        want = sorted((R_SITES if kind == "R" else A_SITES) + MLP_SITES)
        assert sorted(q) == sorted(jq) == want
        for name, qt in q.items():
            j = jq[name]
            assert (qt.shape, qt.bits, qt.packed) == (tuple(j.shape), j.bits,
                                                      j.packed), name
            for fld in ("codes", "scale", "zero"):
                assert torch.equal(getattr(qt, fld), getattr(j, fld)), (
                    name, fld)
            n += 1
    return n


def _same_astates(ast, jast):
    assert sorted(ast) == sorted(jast)
    for site in ast:
        for k in ("step", "beta"):
            np.testing.assert_allclose(_np(ast[site][k]),
                                       np.asarray(jast[site][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=site)


@pytest.fixture(scope="module")
def lm():
    jcfg, cfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = _perturb(jmodel.init(jax.random.key(0)), seed=7)
    calib = _tokens(cfg, (4, 32), seed=0)
    x0, blocks, assemble = jmodel.quant_blocks(jparams, jnp.asarray(calib))
    jrecipe = JQuantRecipe(rules=RULES, **RECIPE_KW)
    jfin, jast, _ = jquantize_blocks(blocks, jrecipe, x0)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                jparams=jparams, params=bridge.params(jparams, CPU),
                calib=calib, jrecipe=jrecipe,
                recipe=QuantRecipe(rules=RULES, **RECIPE_KW), jblocks=blocks,
                jq=assemble(jfin), jast=jast)


# ------------------------------------------------------------------ configs
def test_configs_match_reference_field_for_field():
    """The full config, ``reduced`` and the smoke config; the pattern puts
    8 attention blocks at layers 2, 5, ..., 23 among 18 recurrent ones; the
    parameter count is ~3.55 G (7.10 GB in bf16), 2.24 G of it in the
    quantized sites (the embedding and the head, 0.655 G each, are not
    sites)."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(
        jreduced(jcfg))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(
        jget_smoke_config(ARCH))
    model = build_model(cfg)
    assert [i for i, k in enumerate(model.kinds) if k == "A"] == list(
        range(2, 26, 3))
    assert model.kinds.count("R") == 18
    D, R, F, V = cfg.d_model, cfg.lru_width, cfg.d_ff, cfg.vocab
    qkv = D * cfg.n_heads * cfg.head_dim * 2 + D * cfg.head_dim * 2
    sites = 18 * (2 * D * R + R * D + 2 * R * R) + 8 * qkv + 26 * 3 * D * F
    other = 18 * (4 * R + R + 3 * R + D) + 8 * D + 26 * D + D
    assert round(sites / 1e9, 2) == 2.24 and V * D == 655_360_000
    assert round((sites + other + 2 * V * D) / 1e9, 2) == 3.55


def test_full_and_smoke_configs_build():
    for c in (get_config(ARCH), get_smoke_config(ARCH)):
        model = build_model(c)
        assert isinstance(model, rglru.GriffinLM) and model.cfg is c
    assert build_model(get_smoke_config(ARCH)).kinds == ["R", "R", "A"]


def test_param_tree_keys_shapes_and_dtypes(lm):
    """The port's own init draws the reference's tree; in a bfloat16 config
    ``lam``, ``b_a`` and ``b_i`` stay float32, as there, and ``lam`` is the
    reference's (a in (0.9, 0.999)) within relative 1e-5: ``jnp.linspace``
    and ``torch.linspace`` round a few points an ulp apart, which
    ``log(expm1(.))`` amplifies ~30x."""
    cfg = dataclasses.replace(lm["cfg"], dtype="bfloat16")
    jcfg = dataclasses.replace(lm["jcfg"], dtype="bfloat16")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device=CPU)
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    n = 0
    for path, t, j in _pairs(params, jparams):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
        n += 1
    assert n == 4 + 2 * (4 + 5 + 3 + 2) + (5 + 3 + 2)
    rg = params["layers"][0]["mix"]["rglru"]
    assert {rg[k].dtype for k in ("lam", "b_a", "b_i")} == {torch.float32}
    np.testing.assert_allclose(_np(rg["lam"]),
                               np.asarray(jparams["layers"][0]["mix"]["rglru"]
                                          ["lam"]), rtol=1e-5)


# ------------------------------------------------------------------ forward
def test_backbone_matches_reference(lm):
    """40 tokens: past the window of 16 and over two attention chunks."""
    toks = _tokens(lm["cfg"], (2, 40), seed=1)
    jx, jst = jax.jit(lambda p, t: lm["jmodel"].backbone(
        p, t, JQuantCtx(mode="fp"), collect=True))(lm["jparams"],
                                                   jnp.asarray(toks))
    x, st = lm["model"].backbone(lm["params"], torch.from_numpy(toks),
                                 QuantCtx(mode="fp"), collect=True)
    np.testing.assert_allclose(_np(x), np.asarray(jx), **F32)
    for (h, tail), (jh, jtail) in zip(st[:2], jst[:2]):
        np.testing.assert_allclose(_np(h), np.asarray(jh), **F32)
        np.testing.assert_allclose(_np(tail), np.asarray(jtail), **F32)
    for t, j in zip(st[2], jst[2]):
        np.testing.assert_allclose(_np(t), np.asarray(j), **F32)
    x2, none = lm["model"].backbone(lm["params"], torch.from_numpy(toks),
                                    QuantCtx(mode="fp"))
    assert torch.equal(x2, x) and none == [None] * 3


def test_loss_and_gradients_match_jax_grad(lm):
    """S = 40; xent over 2 chunks of 32 (the second padded)."""
    cfg = lm["cfg"]
    rng = np.random.default_rng(9)
    batch = {"tokens": _tokens(cfg, (2, 40), seed=10),
             "labels": _tokens(cfg, (2, 40), seed=11),
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
    assert sorted(m) == sorted(jm) == ["ce"]
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = bridge.params(jg, CPU)
    n = 0
    for path, t, g_ref in _pairs(params, grads):
        g, want = _np(t.grad), _np(g_ref)
        assert np.isfinite(g).all(), path
        bound = 1e-5 * np.abs(want).max() + 1e-7
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(),
                                                 bound)
        n += 1
    assert n == 4 + 2 * (4 + 5 + 3 + 2) + (5 + 3 + 2)
    lam = params["layers"][0]["mix"]["rglru"]["lam"]
    assert np.abs(_np(lam.grad)).max() > 0


# ------------------------------------------------------------------ serving
def test_decode_past_the_window_agrees_with_the_full_forward(lm):
    """Prefill 12 tokens, then 20 teacher-forced decode steps (positions
    12-31; the ring of 16 slots wraps at 16): each step's logits equal the
    full forward's over the 32 tokens at its position, where the window
    drops the same keys."""
    model, params = lm["model"], lm["params"]
    toks = torch.from_numpy(_tokens(lm["cfg"], (2, 32), seed=6))
    ctx = QuantCtx(mode="fp")
    full = model.logits(params, model.backbone(params, toks, ctx)[0])
    cache = model.init_cache(2, 40, device=CPU)
    assert cache["layers"][2]["k"].shape[1] == 16
    h, cache = model.prefill(params, toks[:, :12], cache, ctx)
    np.testing.assert_allclose(_np(model.logits(params, h)),
                               _np(full[:, 11:12]), **F32)
    for i in range(20):
        lg, cache = model.decode_step(params, toks[:, 12 + i:13 + i], cache,
                                      12 + i, ctx)
        np.testing.assert_allclose(_np(lg), _np(full[:, 12 + i:13 + i]),
                                   **F32)
    assert sorted(_np(cache["layers"][2]["kpos"]).tolist()) == list(
        range(16, 32))


def _serve_both(lm, jparams, params, jctx, ctx, prompt=10, steps=9):
    """Prefill ``prompt`` tokens and ``steps`` greedy decode steps in both
    packages (positions 10-18: the ring of 16 wraps): hidden, logits,
    greedy tokens and every cache entry after each step (the reference's
    decode step jitted once, the position traced)."""
    cfg = lm["cfg"]
    toks = _tokens(cfg, (2, prompt), seed=8)
    max_len = prompt + steps + 1
    jcache = lm["jmodel"].init_cache(2, max_len)
    cache = lm["model"].init_cache(2, max_len, device=CPU)
    for c, jc in zip(cache["layers"], jcache["layers"], strict=True):
        assert sorted(c) == sorted(jc)
        for k in c:
            assert tuple(c[k].shape) == jc[k].shape, k
            assert str(c[k].dtype).replace("torch.", "") == str(jc[k].dtype)
    jh, jcache = lm["jmodel"].prefill(jparams, jnp.asarray(toks), jcache, jctx)
    h, cache = lm["model"].prefill(params, torch.from_numpy(toks), cache, ctx)
    np.testing.assert_allclose(_np(h), np.asarray(jh), **F32)
    tok = np.asarray(jnp.argmax(jh @ jparams["lm_head"], -1)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: lm["jmodel"].decode_step(p, t, c, pos,
                                                                  jctx))
    for i in range(steps):
        jlg, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                            jnp.int32(prompt + i))
        lg, cache = lm["model"].decode_step(params, torch.from_numpy(tok),
                                            cache, prompt + i, ctx)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **F32)
        want = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        assert np.array_equal(_np(lg.argmax(-1)).astype(np.int32), want)
        tok = want
        for c, jc in zip(cache["layers"], jcache["layers"]):
            for k in c:
                if k == "kpos":
                    assert np.array_equal(_np(c[k]), np.asarray(jc[k]))
                else:
                    np.testing.assert_allclose(_np(c[k]), np.asarray(jc[k]),
                                               err_msg=k, **F32)


def test_prefill_and_decode_match_reference_fp(lm):
    _serve_both(lm, lm["jparams"], lm["params"], JQuantCtx(mode="fp"),
                QuantCtx(mode="fp"))


def test_prefill_and_decode_match_reference_deploy(lm):
    """Deploy mode on the reference's export (W4 body, W8 layer 0, A8):
    the sites carry their layer index here, so the activation states apply
    (W8A8 through the integer product, W4A8 on the snapped grid). The
    port's plain versions against the reference's ``xla`` backend; the
    full-sequence deploy forward as well."""
    jctx = JQuantCtx(mode="deploy", recipe=lm["jrecipe"], astates=lm["jast"],
                     backend="xla")
    ctx = QuantCtx(mode="deploy", recipe=lm["recipe"],
                   astates=bridge.astates(lm["jast"], CPU))
    qparams = bridge.params(lm["jq"], CPU)
    _serve_both(lm, lm["jq"], qparams, jctx, ctx)
    toks = _tokens(lm["cfg"], (2, 40), seed=12)
    jx, _ = lm["jmodel"].backbone(lm["jq"], jnp.asarray(toks), jctx)
    x, _ = lm["model"].backbone(qparams, torch.from_numpy(toks), ctx)
    np.testing.assert_allclose(_np(x), np.asarray(jx), **F32)


def test_int8_cache_and_the_engine_are_refused(lm):
    """``init_cache(kv_quant=True)`` raises ``kv_quant_unsupported:hybrid``
    in both packages; the slot engine refuses the family; the uniform-batch
    decode is fine."""
    with pytest.raises(JKVQuantUnsupported) as jei:
        lm["jmodel"].init_cache(2, 8, kv_quant=True)
    with pytest.raises(KVQuantUnsupported) as ei:
        lm["model"].init_cache(2, 8, kv_quant=True, device=CPU)
    assert ei.value.reason == jei.value.reason == "kv_quant_unsupported:hybrid"
    model = lm["model"]
    assert serve_capability(model) == (True, "ok")
    assert serve_capability(model, kv_quant=True) == (
        False, "kv_quant_unsupported:hybrid")
    assert serve_capability(model, engine=True) == (
        False, "unsupported_family:hybrid")
    with pytest.raises(KVQuantUnsupported) as ei:
        ServeEngine(model, lm["params"], QuantCtx(mode="fp"),
                    EngineConfig(slots=2, max_len=16, kv_quant=False),
                    device=CPU)
    assert ei.value.reason == "unsupported_family:hybrid"


# ---------------------------------------------------------------- PTQ plan
def test_quant_blocks_names_sites_and_apply_keys(lm):
    """Per layer one block; an R block's sites are the MLP's three (geglu's
    gate is a site here) and ``w_x``, ``w_gate``, ``w_o``,
    ``rglru.{w_a,w_i}``; the A block's the MLP's and ``wq``-``wo``. Two
    apply keys, one per kind, so the reconstruction builds two engines."""
    x0, blocks, assemble = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(lm["calib"]))
    jblocks = lm["jblocks"]
    assert [b.name for b in blocks] == [b.name for b in jblocks] == [
        "layers.0", "layers.1", "layers.2"]
    for b, jb in zip(blocks, jblocks):
        assert {n: tuple(s.path) for n, s in b.sites.items()} == {
            n: tuple(s.path) for n, s in jb.sites.items()}
        assert list(b.sites) == list(jb.sites)
    assert sorted(blocks[0].sites) == sorted(
        f"layers.0.{s.split('.', 1)[1]}" if s.startswith("mix.") else
        f"layers.0.{s.split('.', 1)[1]}" for s in R_SITES + MLP_SITES)
    assert blocks[0].apply_key == blocks[1].apply_key != blocks[2].apply_key
    assert [b.apply_key[1] for b in blocks] == ["R", "R", "A"]
    assert blocks[0].apply_key[0] is blocks[2].apply_key[0]
    with torch.no_grad():
        for b, jb in zip(blocks, jblocks):
            y = b.apply(b.params, x0, QuantCtx(mode="fp"))
            jy = jb.apply(jb.params, jnp.asarray(_np(x0)),
                          JQuantCtx(mode="fp"))
            np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    assert assemble(["a", "b", "c"])["layers"] == ["a", "b", "c"]


def test_export_is_bit_exact(lm):
    x0, blocks, assemble = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(lm["calib"]))
    fin, ast, reps = quantize_blocks(blocks, lm["recipe"], x0)
    q = assemble(fin)
    jq = bridge.params(lm["jq"], CPU)
    assert _same_qtensors(q["layers"], jq["layers"], "RRA") == 23
    assert {qt.bits for _, qt in _qtensors(q["layers"][0])} == {8}
    assert {qt.bits for _, qt in _qtensors(q["layers"][2])} == {4}
    for k in ("lam", "b_a", "b_i"):  # fp leaves cross unchanged
        assert torch.equal(q["layers"][1]["mix"]["rglru"][k],
                           jq["layers"][1]["mix"]["rglru"][k])
    _same_astates(ast, lm["jast"])
    assert all(r.iters == 0 and np.isfinite(r.err_after) for r in reps)


def _masks(key, iters, block, x):
    """The reference's QDrop draws for ``block`` at full batch: per step
    and site, bernoulli(fold_in(step key, crc32(site))) over the site's
    input shape (from a capture run of the block)."""
    ctx = QuantCtx(mode="capture")
    with torch.no_grad():
        block.apply(block.params, torch.from_numpy(x), ctx)
    shapes = {n: tuple(v[0].shape) for n, v in ctx.records.items()}
    assert sorted(shapes) == sorted(block.sites)
    idx, k2s = jrc._batch_schedule(key, iters, x.shape[0], x.shape[0])
    assert idx is None
    return [{n: np.array(jax.random.bernoulli(jsite_key(k2s[t], n), p=0.5,
                                              shape=s))
             for n, s in shapes.items()} for t in range(iters)]


def _recon_both(lm, index, iters, **kw):
    """Block ``index`` reconstructed by both packages from the same random
    input (its fp output as the target); with ``setting="qdrop"`` the port
    replays the reference's QDrop masks (``reconstruct.Schedule``).
    Returns (port report, reference report)."""
    recipe = dict(method="flexround", w_bits=4, w_granularity="per_channel",
                  iters=iters, lr=3e-3, batch_size=4, **kw)
    calib = lm["calib"]
    _, jblocks, _ = lm["jmodel"].quant_blocks(lm["jparams"],
                                              jnp.asarray(calib))
    x0, blocks, _ = lm["model"].quant_blocks(lm["params"],
                                             torch.from_numpy(calib))
    x = np.random.default_rng(index).normal(0, 1, _np(x0).shape).astype(
        np.float32)
    jb, b = jblocks[index], blocks[index]
    jy = np.array(jb.apply(jb.params, jnp.asarray(x), JQuantCtx(mode="fp")))
    key = jax.random.key(4)
    masks = (_masks(key, iters, b, x) if recipe.get("setting") == "qdrop"
             else None)
    _, _, jrep = jrc.reconstruct_block(jb, JQuantRecipe(**recipe),
                                       jnp.asarray(x), jnp.asarray(jy), key)
    _, _, rep = rc.reconstruct_block(b, QuantRecipe(**recipe),
                                     torch.from_numpy(x), torch.from_numpy(jy),
                                     schedule=rc.Schedule(masks=masks))
    assert rep.iters == iters and len(set(rep.loss_curve.tolist())) > 1
    return rep, jrep


@pytest.mark.parametrize("index", [1, 2], ids=["R", "A"])
def test_weight_only_steps_follow_the_reference(lm, index):
    """FlexRound W4 (weights only), 12 Adam steps at lr 3e-3 over the whole
    calibration set: errors and the loss curve within relative 1e-5."""
    rep, jrep = _recon_both(lm, index, 12, a_bits=None, setting="brecq")
    for k in ("err_before", "err_after"):
        np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                   rtol=1e-5)
    np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                               rtol=1e-5)


@pytest.mark.parametrize("index", [1, 2], ids=["R", "A"])
def test_w4a8_qdrop_steps_follow_the_reference(lm, index):
    """FlexRound W4A8 with QDrop (drop 0.5), 4 Adam steps, the reference's
    masks replayed: the first step's loss within relative 1e-5, the curve
    and both errors within 2% (the A8 bound of ``test_torch_recon.py``).
    Here an STE-rounded activation on a rounding boundary flips in one
    package from the second step on (on this CPU: 5e-5 of the loss at step
    1 of the R block, 4e-3 at step 3; err_before, without the masks,
    already 5e-5 apart on the A block); the weight-only run above tracks
    to 2e-6 over 12 steps."""
    rep, jrep = _recon_both(lm, index, 4, a_bits=8, setting="qdrop",
                            drop_prob=0.5)
    np.testing.assert_allclose(rep.loss_curve[0], jrep.loss_curve[0],
                               rtol=1e-5)
    np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                               rtol=2e-2)
    for k in ("err_before", "err_after"):
        np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                   rtol=2e-2)


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
    d = tmp_path_factory.mktemp("hybrid_launch")
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
    assert _same_qtensors(params["layers"], jparams["layers"], "RRA") == 23
    _same_astates(r["tree"]["astates"], r["jtree"]["astates"])
    for k in ("arch", "method", "w_bits", "a_bits", "rules"):
        assert r["meta"][k] == r["jmeta"][k], k
    assert r["meta"]["arch"] == "recurrentgemma-2b-smoke"


def test_launcher_serve_smoke_decodes_and_serve_prints_the_skip_line(launches):
    """``--serve-smoke`` runs ``decode_step`` (a finite us/step);
    ``--serve`` prints the reference's skip line and serves nothing."""
    r = launches["export"]
    assert np.isfinite(r["res"].serve_smoke_us) and r["res"].serve is None
    skip = ("serve: skipped arch=recurrentgemma-2b-smoke "
            "reason=unsupported_family:hybrid")
    assert skip in r["lines"] and skip in r["jlines"]
    assert any(ln.startswith("serve-smoke[auto]: ") for ln in r["lines"])
    assert any(ln.startswith("serve-smoke[auto]: ") for ln in r["jlines"])


def test_launcher_two_step_reports_match(launches):
    """Weight-only W4, the whole calibration set per step (no draws):
    two engines (R and A), the reference's two compiled step keys."""
    r = launches["train"]
    reps, jreps = r["res"].reports, r["jreports"]
    assert [x.name for x in reps] == [x.name for x in jreps] == [
        "layers.0", "layers.1", "layers.2"]
    for rep, jrep in zip(reps, jreps):
        assert rep.iters == jrep.iters == 2
        for k in ("err_before", "err_after"):
            np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                       rtol=1e-5)
        np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                                   rtol=1e-5)
    assert any("engines 2 built, 1 reused" in ln for ln in r["lines"])
    assert any("step=2" in ln for ln in r["jlines"])
