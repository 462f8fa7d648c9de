"""Port parity: mamba2-130m (the ssm family: the chunked SSD scan, the
depthwise causal conv, the O(1)-state recurrent decode) against the
reference at ``get_smoke_config("mamba2-130m")``: 2 layers, d_model 64,
d_inner 128 in 8 heads of 16, SSM state 16, conv 4, chunk 32, float32.

The reference initialises the weights (``jax.random.key(0)``); the norm
scales, the conv bias, ``dt_bias`` and ``d_skip``, which it initialises to
constants, get N(0, 0.1^2) noise drawn with numpy, so that they change
what both packages compute. The port gets every array through the bridge.
Tolerances:

- configs: field for field equal; parameter trees: the same keys, shapes
  and dtypes (``a_log``, ``dt_bias``, ``d_skip`` float32);
- float32 scan outputs, states, hidden states and logits (fp, and deploy
  mode on the reference's export): rtol = atol = 1e-5 (reduction order);
  greedy tokens identical;
- ``loss``: relative 1e-5; every gradient leaf against ``jax.grad``:
  max |g - g_ref| <= 1e-5 * max |g_ref| + 1e-7, and finite;
- export at ``iters=0`` (W4 body, W8 layer 0, A8): codes, scale and zero of
  every QTensor bit-exact, activation states relative 1e-5;
- reconstruction, weight-only W4, full batch: err_before, err_after and
  the loss curve of 3 Adam steps per block within relative 1e-5;
- the launcher at ``--arch mamba2-130m --smoke --device cpu``: the
  export-only run (A8, ``--serve-smoke --serve``) exports the reference
  launcher's QTensors bit for bit and prints its skip line; the 2-step
  run's curves and errors agree to relative 1e-5; a run stopped after block
  0 and resumed equals an unbroken run bit for bit.
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
from repro.models import ssm as jssm
from repro.serve.kv import KVQuantUnsupported as JKVQuantUnsupported
from repro_torch import bridge
from repro_torch.allocate import AllocationReport
from repro_torch.checkpoint import PTQCheckpointer, load_pytree
from repro_torch.configs import get_config, get_smoke_config, reduced
from repro_torch.core import paths as pth
from repro_torch.core.context import QuantCtx
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.core.reconstruct import quantize_blocks
from repro_torch.launch import quantize
from repro_torch.models import ssm
from repro_torch.models.model import build_model
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.kv import KVQuantUnsupported
from repro_torch.serve.smoke import serve_capability

torch.set_num_threads(2)

ARCH = "mamba2-130m"
CPU = "cpu"
RULES = ("layers.0.*:w_bits=8",)
RECIPE_KW = dict(method="flexround", w_bits=4, a_bits=8,
                 w_granularity="per_channel", iters=0, batch_size=4)
F32 = dict(rtol=1e-5, atol=1e-5)
NOISY = ("ln", "gate_norm", "final_norm", "conv_b", "dt_bias", "d_skip")


def _np(t):
    return bridge.to_numpy(t)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


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


def _same_qtensors(layers, jlayers):
    n = 0
    for tl, jl in zip(layers, jlayers, strict=True):
        q, jq = dict(_qtensors(tl)), dict(_qtensors(jl))
        assert sorted(q) == sorted(jq) == ["in_proj", "out_proj"]
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
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(jreduced(jcfg))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(
        jget_smoke_config(ARCH))
    assert (cfg.ssm_state, cfg.ssm_headdim, cfg.attn_chunk) == (128, 64, 256)
    d_inner, n_heads, conv_dim = ssm._dims(cfg)
    assert (d_inner, n_heads, conv_dim) == jssm._dims(jcfg) == (1536, 24, 1792)
    assert 2 * d_inner + 2 * cfg.ssm_state + n_heads == 3352  # in_proj width


def test_full_and_smoke_configs_build():
    for c in (get_config(ARCH), get_smoke_config(ARCH)):
        model = build_model(c)
        assert isinstance(model, ssm.MambaLM) and model.cfg is c


def test_param_tree_keys_shapes_and_dtypes(lm):
    """The port's own init draws the reference's tree; in a bfloat16 config
    ``a_log``, ``dt_bias`` and ``d_skip`` stay float32, as there."""
    cfg = dataclasses.replace(lm["cfg"], dtype="bfloat16")
    jcfg = dataclasses.replace(lm["jcfg"], dtype="bfloat16")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device=CPU)
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    assert sorted(params) == sorted(jparams)
    assert len(params["layers"]) == 2
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])
    for path, t, j in _pairs(params["layers"][0], jl):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
    assert params["layers"][0]["a_log"].dtype == torch.float32
    np.testing.assert_allclose(_np(params["layers"][0]["a_log"]),
                               np.asarray(jl["a_log"]), **F32)
    for path, t, j in _pairs({k: params[k] for k in ("embed", "lm_head",
                                                    "final_norm")},
                             {k: jparams[k] for k in ("embed", "lm_head",
                                                      "final_norm")}):
        assert tuple(t.shape) == j.shape, path


# ------------------------------------------------------------ the SSD scan
def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dA = -rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    Bm = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    Cm = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    st = rng.normal(0, 1, (b, h, p, n)).astype(np.float32)
    return x, dA, Bm, Cm, st


@pytest.mark.parametrize("s", [16, 64])  # one chunk of 16; four chunks
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(s, with_state):
    x, dA, Bm, Cm, st = _ssd_inputs(s + with_state, 2, s, 3, 4, 5)
    init = st if with_state else None
    jy, jst = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(dA),
                               jnp.asarray(Bm), jnp.asarray(Cm), 16,
                               None if init is None else jnp.asarray(init))
    y, fst = ssm.ssd_chunked(torch.from_numpy(x), torch.from_numpy(dA),
                             torch.from_numpy(Bm), torch.from_numpy(Cm), 16,
                             None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    np.testing.assert_allclose(_np(fst), np.asarray(jst), **F32)


def test_ssd_chunked_equals_the_recurrence_and_refuses_ragged_lengths():
    """The chunked scan (four chunks, an initial state) against the
    token-by-token recurrence h' = exp(dA) h + x B^T, y = h C, float64
    reference; its backward is finite (the -inf above the diagonal is set
    before ``exp``). A length that is no chunk multiple is refused."""
    x, dA, Bm, Cm, st = _ssd_inputs(3, 2, 64, 3, 4, 5)
    h = st.astype(np.float64)
    ys = []
    for t in range(64):
        h = (np.exp(dA[:, t])[..., None, None] * h
             + np.einsum("bhp,bn->bhpn", x[:, t], Bm[:, t]))
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    tx = torch.from_numpy(x).requires_grad_(True)
    tdA = torch.from_numpy(dA).requires_grad_(True)
    y, fst = ssm.ssd_chunked(tx, tdA, torch.from_numpy(Bm),
                             torch.from_numpy(Cm), 16, torch.from_numpy(st))
    np.testing.assert_allclose(_np(y), np.stack(ys, 1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(fst), h, rtol=1e-4, atol=1e-4)
    (y.sum() + fst.sum()).backward()
    assert torch.isfinite(tx.grad).all() and torch.isfinite(tdA.grad).all()
    with pytest.raises(AssertionError):
        ssm.ssd_chunked(tx[:, :40], tdA[:, :40], torch.from_numpy(Bm[:, :40]),
                        torch.from_numpy(Cm[:, :40]), 16)


@pytest.mark.parametrize("with_init", [False, True])
def test_layer_forward_tail_and_state_match_reference(lm, with_init):
    """One layer over 32 tokens: the output, the raw (pre-conv) tail of
    K-1 = 3 inputs and the final state; with ``conv_init`` and
    ``init_state`` (a continuation) too."""
    cfg = lm["cfg"]
    rng = np.random.default_rng(4)
    u = rng.normal(0, 1, (2, 32, cfg.d_model)).astype(np.float32)
    d_inner, n_heads, conv_dim = ssm._dims(cfg)
    kw, jkw = {}, {}
    if with_init:
        ci = rng.normal(0, 1, (2, 3, conv_dim)).astype(np.float32)
        st = rng.normal(0, 1, (2, n_heads, 16, 16)).astype(np.float32)
        kw = dict(conv_init=torch.from_numpy(ci), init_state=torch.from_numpy(st))
        jkw = dict(conv_init=jnp.asarray(ci), init_state=jnp.asarray(st))
    jl = jax.tree.map(lambda a: a[0], lm["jparams"]["layers"])
    jy, (jtail, jst) = jssm.layer_forward(jl, jnp.asarray(u), lm["jcfg"],
                                          JQuantCtx(mode="fp"), "layers", **jkw)
    y, (tail, st) = ssm.layer_forward(lm["params"]["layers"][0],
                                      torch.from_numpy(u), cfg,
                                      QuantCtx(mode="fp"), "layers", **kw)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    np.testing.assert_allclose(_np(tail), np.asarray(jtail), **F32)
    np.testing.assert_allclose(_np(st), np.asarray(jst), **F32)
    assert tuple(tail.shape) == (2, 3, conv_dim)


def test_layer_decode_four_steps_match_reference(lm):
    cfg = lm["cfg"]
    rng = np.random.default_rng(5)
    d_inner, n_heads, conv_dim = ssm._dims(cfg)
    conv = rng.normal(0, 1, (2, 3, conv_dim)).astype(np.float32)
    st = rng.normal(0, 1, (2, n_heads, 16, 16)).astype(np.float32)
    jconv, jst = jnp.asarray(conv), jnp.asarray(st)
    tconv, tst = torch.from_numpy(conv), torch.from_numpy(st)
    jl = jax.tree.map(lambda a: a[1], lm["jparams"]["layers"])
    for i in range(4):
        u = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
        jy, jconv, jst = jssm.layer_decode(jl, jnp.asarray(u), lm["jcfg"],
                                           JQuantCtx(mode="fp"), "layers",
                                           jconv, jst)
        y, tconv, tst = ssm.layer_decode(lm["params"]["layers"][1],
                                         torch.from_numpy(u), cfg,
                                         QuantCtx(mode="fp"), "layers", tconv,
                                         tst)
        np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
        np.testing.assert_allclose(_np(tconv), np.asarray(jconv), **F32)
        np.testing.assert_allclose(_np(tst), np.asarray(jst), **F32)


# ------------------------------------------------------------------ serving
def test_prefill_then_decode_agrees_with_the_chunked_backbone(lm):
    """Prefill 32 tokens (one chunk), then 8 teacher-forced decode steps:
    each step's logits equal those of the chunked forward over 64 tokens
    (two chunks) at its position, within 1e-4 (the recurrence and the
    chunked sums associate differently)."""
    model, params = lm["model"], lm["params"]
    toks = torch.from_numpy(_tokens(lm["cfg"], (2, 64), seed=6))
    ctx = QuantCtx(mode="fp")
    full = model.logits(params, model.backbone(params, toks, ctx))
    cache = model.init_cache(2, 40, device=CPU)
    h, cache = model.prefill(params, toks[:, :32], cache, ctx)
    np.testing.assert_allclose(_np(model.logits(params, h)),
                               _np(full[:, 31:32]), **F32)
    for i in range(8):
        lg, cache = model.decode_step(params, toks[:, 32 + i:33 + i], cache,
                                      32 + i, ctx)
        np.testing.assert_allclose(_np(lg), _np(full[:, 32 + i:33 + i]),
                                   rtol=1e-4, atol=1e-4)


def _serve_both(lm, jparams, params, jctx, ctx, steps=4):
    cfg = lm["cfg"]
    toks = _tokens(cfg, (2, 32), seed=8)
    jcache = lm["jmodel"].init_cache(2, 40)
    cache = lm["model"].init_cache(2, 40, device=CPU)
    assert sorted(cache) == sorted(jcache) == ["conv", "ssm"]
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape
        assert cache[k].dtype == torch.float32
    jh, jcache = lm["jmodel"].prefill(jparams, jnp.asarray(toks), jcache, jctx)
    h, cache = lm["model"].prefill(params, torch.from_numpy(toks), cache, ctx)
    np.testing.assert_allclose(_np(h), np.asarray(jh), **F32)
    tok = toks[:, -1:]
    for i in range(steps):
        jlg, jcache = lm["jmodel"].decode_step(jparams, jnp.asarray(tok),
                                               jcache, jnp.int32(32 + i), jctx)
        lg, cache = lm["model"].decode_step(params, torch.from_numpy(tok),
                                            cache, 32 + i, ctx)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **F32)
        want = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        assert np.array_equal(_np(lg.argmax(-1)).astype(np.int32), want)
        tok = want
    for k in cache:
        np.testing.assert_allclose(_np(cache[k]), np.asarray(jcache[k]), **F32)


def test_prefill_and_decode_match_reference_fp(lm):
    _serve_both(lm, lm["jparams"], lm["params"], JQuantCtx(mode="fp"),
                QuantCtx(mode="fp"))


def test_prefill_and_decode_match_reference_deploy(lm):
    """Deploy mode on the reference's export (W4 body, W8 layer 0, A8;
    the ``layers.*`` serving names match no activation state)."""
    jctx = JQuantCtx(mode="deploy", recipe=lm["jrecipe"], astates=lm["jast"],
                     backend="xla")
    ctx = QuantCtx(mode="deploy", recipe=lm["recipe"],
                   astates=bridge.astates(lm["jast"], CPU))
    _serve_both(lm, lm["jq"], bridge.params(lm["jq"], CPU), jctx, ctx)


def test_int8_cache_and_the_engine_are_refused(lm):
    """``init_cache(kv_quant=True)`` raises ``kv_quant_unsupported:ssm`` in
    both packages; the slot engine refuses the family; the uniform-batch
    decode is fine."""
    with pytest.raises(JKVQuantUnsupported) as jei:
        lm["jmodel"].init_cache(2, 8, kv_quant=True)
    with pytest.raises(KVQuantUnsupported) as ei:
        lm["model"].init_cache(2, 8, kv_quant=True, device=CPU)
    assert ei.value.reason == jei.value.reason == "kv_quant_unsupported:ssm"
    model = lm["model"]
    assert serve_capability(model) == (True, "ok")
    assert serve_capability(model, kv_quant=True) == (
        False, "kv_quant_unsupported:ssm")
    assert serve_capability(model, engine=True) == (
        False, "unsupported_family:ssm")
    with pytest.raises(KVQuantUnsupported) as ei:
        ServeEngine(model, lm["params"], QuantCtx(mode="fp"),
                    EngineConfig(slots=2, max_len=16, kv_quant=False),
                    device=CPU)
    assert ei.value.reason == "unsupported_family:ssm"


# --------------------------------------------------------------------- loss
def test_loss_and_gradients_match_jax_grad(lm):
    """S = 64: two chunks of the scan; xent over 2 chunks of 32."""
    cfg = lm["cfg"]
    rng = np.random.default_rng(9)
    batch = {"tokens": _tokens(cfg, (2, 64), seed=10),
             "labels": _tokens(cfg, (2, 64), seed=11),
             "mask": (rng.random((2, 64)) < 0.8).astype(np.float32)}
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
    assert n == 3 + 2 * 9  # embed, final_norm, head; 9 leaves per layer
    assert np.abs(_np(params["layers"][0]["a_log"].grad)).max() > 0


# ---------------------------------------------------------------- PTQ plan
def test_quant_blocks_names_sites_and_apply_keys(lm):
    x0, blocks, assemble = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(lm["calib"]))
    jblocks = lm["jblocks"]
    assert [b.name for b in blocks] == [b.name for b in jblocks] == [
        "layers.0", "layers.1"]
    for i, (b, jb) in enumerate(zip(blocks, jblocks)):
        assert {n: tuple(s.path) for n, s in b.sites.items()} == {
            n: tuple(s.path) for n, s in jb.sites.items()} == {
            f"layers.{i}.in_proj": ("in_proj",),
            f"layers.{i}.out_proj": ("out_proj",)}
    assert len(blocks[0].apply_key) == 1
    assert blocks[0].apply_key[0] is blocks[1].apply_key[0]
    with torch.no_grad():
        y = blocks[0].apply(blocks[0].params, x0, QuantCtx(mode="fp"))
    jy = jblocks[0].apply(jblocks[0].params, jnp.asarray(_np(x0)),
                          JQuantCtx(mode="fp"))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    assert assemble(["a", "b"])["layers"] == ["a", "b"]


def test_export_is_bit_exact(lm):
    x0, blocks, assemble = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(lm["calib"]))
    fin, ast, reps = quantize_blocks(blocks, lm["recipe"], x0)
    q = assemble(fin)
    jq = bridge.params(lm["jq"], CPU)
    assert _same_qtensors(q["layers"], jq["layers"]) == 4
    assert {qt.bits for _, qt in _qtensors(q["layers"][0])} == {8}
    assert {qt.bits for _, qt in _qtensors(q["layers"][1])} == {4}
    for k in ("a_log", "conv_w", "d_skip"):  # fp leaves cross unchanged
        assert torch.equal(q["layers"][1][k], jq["layers"][1][k])
    _same_astates(ast, lm["jast"])
    assert all(r.iters == 0 and np.isfinite(r.err_after) for r in reps)


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
    d = tmp_path_factory.mktemp("mamba_launch")
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
    assert _same_qtensors(params["layers"], jparams["layers"]) == 4
    _same_astates(r["tree"]["astates"], r["jtree"]["astates"])
    for k in ("arch", "method", "w_bits", "a_bits", "rules"):
        assert r["meta"][k] == r["jmeta"][k], k
    assert r["meta"]["arch"] == "mamba2-130m-smoke"


def test_launcher_serve_smoke_decodes_and_serve_prints_the_skip_line(launches):
    """``--serve-smoke`` runs ``decode_step`` (a finite us/step);
    ``--serve`` prints the reference's skip line and serves nothing."""
    r = launches["export"]
    assert np.isfinite(r["res"].serve_smoke_us) and r["res"].serve is None
    skip = "serve: skipped arch=mamba2-130m-smoke reason=unsupported_family:ssm"
    assert skip in r["lines"] and skip in r["jlines"]
    assert any(ln.startswith("serve-smoke[auto]: ") for ln in r["lines"])


def test_launcher_two_step_reports_match(launches):
    r = launches["train"]
    reps, jreps = r["res"].reports, r["jreports"]
    assert [x.name for x in reps] == [x.name for x in jreps] == [
        "layers.0", "layers.1"]
    for rep, jrep in zip(reps, jreps):
        assert rep.iters == jrep.iters == 2
        for k in ("err_before", "err_after"):
            np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                       rtol=1e-5)
        np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                                   rtol=1e-5)


def test_launcher_resume_after_block_0_equals_an_unbroken_run(tmp_path):
    """QDrop with A8: stopped right after block 0's checkpoint, then run
    again; the export equals an unbroken run's bit for bit."""
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
    for path, x, y in _pairs(a, b):
        if hasattr(x, "codes"):
            for fld in ("codes", "scale", "zero"):
                assert torch.equal(getattr(x, fld), getattr(y, fld)), path
        else:
            assert torch.equal(x, y), path
    assert _same_qtensors(a["params"]["layers"], b["params"]["layers"]) == 4


def test_auto_bits_probes_in_proj_and_out_proj(tmp_path):
    """``--auto-bits`` probes both sites of both blocks through the
    allocator's probe context and every exported QTensor carries its
    allocated bits."""
    argv = SMOKE + ["--w-bits", "4", "--iters", "0", "--auto-bits", "4.5",
                    "--resume-dir", str(tmp_path / "ck"), "--device", "cpu",
                    "--out", str(tmp_path / "q")]
    with contextlib.redirect_stdout(io.StringIO()):
        res = quantize.main(argv)
    bits = AllocationReport.load(str(tmp_path / "ck")).bits()
    assert sorted(bits) == [f"layers.{i}.{n}" for i in (0, 1)
                            for n in ("in_proj", "out_proj")]
    _, blocks, _ = res.model.quant_blocks(res.qparams,
                                          torch.zeros((1, 4), dtype=torch.long))
    for b in blocks:
        for name, site in b.sites.items():
            assert pth.get_path(b.params, site.path).bits == bits[name], name
