"""Port parity: whisper-medium (the encdec family: a non-causal encoder over
precomputed frame embeddings, a decoder with causal self-attention and
cross-attention, int8 self and cross caches) against the reference at
``get_smoke_config("whisper-medium")``: 2 encoder and 2 decoder layers,
d_model 64, 4 heads, attention chunk 32, float32.

The reference initialises the weights (``jax.random.key(0)``); the
LayerNorm scales and biases and the projection biases, which it initialises
to constants, get N(0, 0.1^2) noise drawn with numpy, so that they change
what both packages compute. Frames and tokens are drawn with numpy; the
port gets every array through the bridge (``enc_layers`` and
``dec_layers`` unstacked). Tolerances:

- configs: field for field equal; parameter trees: the same keys and
  shapes;
- float32 hidden states, caches and logits (fp and deploy mode on the
  reference's export): rtol = atol = 1e-5 (reduction order); greedy
  tokens identical. With int8 or bfloat16 caches a float32 value on a
  rounding boundary may round the other way in one package: such entries
  (at most 16) lie one grid step apart, and the logits of a step that
  reads one are held to atol 1e-3; the int8 scales rtol = atol = 1e-5;
- ``loss``: relative 1e-5; every gradient leaf against ``jax.grad``:
  max |g - g_ref| <= 1e-5 * max |g_ref| + 1e-7;
- export at ``iters=0`` (W4 body, W8 layer 0, A8): codes, scale and zero of
  every QTensor bit-exact, activation states relative 1e-5;
- reconstruction, weight-only W4 at full batch (the only batch the
  reference's baked encoder output allows): err_before, err_after and the
  loss curve of 3 Adam steps per block within relative 1e-5.
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

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs import reduced as jreduced
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.quant_config import QuantRecipe as JQuantRecipe
from repro.core.reconstruct import quantize_blocks as jquantize_blocks
from repro.launch import quantize as jquantize
from repro.launch.specs import WHISPER_CROSS_LEN as JWHISPER_CROSS_LEN
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, reduced
from repro_torch.configs.whisper_medium import WHISPER_CROSS_LEN
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.core.reconstruct import quantize_blocks
from repro_torch.launch import quantize
from repro_torch.models import encdec
from repro_torch.models.model import build_model
from repro_torch.serve import kv as skv
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.kv import KVQuantUnsupported
from repro_torch.serve.smoke import serve_capability

torch.set_num_threads(2)

ARCH = "whisper-medium"
CPU = "cpu"
RULES = ("layers.0.*:w_bits=8",)
RECIPE_KW = dict(method="flexround", w_bits=4, a_bits=8,
                 w_granularity="per_channel", iters=0, batch_size=4)
F32 = dict(rtol=1e-5, atol=1e-5)
NOISY = ("ln1", "ln2", "ln_x", "enc_norm", "dec_norm", "bq", "bv", "bo",
         "b_up", "b_down")
N_CALIB, S_CALIB, S_ENC = 4, 16, 40  # 40 frames: one full chunk + 8
SITES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "xattn.wq", "xattn.wk",
         "xattn.wv", "xattn.wo", "mlp.w_up", "mlp.w_down")


def _np(t):
    return bridge.to_numpy(t)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _frames(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _perturb(jparams, seed):
    """N(0, 0.1^2) on the leaves the reference initialises to constants."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        keys = {getattr(k, "key", None) for k in path}
        if keys & set(NOISY):
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, jparams)


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


@pytest.fixture(scope="module")
def lm():
    jcfg, cfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = _perturb(jmodel.init(jax.random.key(0)), seed=7)
    calib = _tokens(cfg, (N_CALIB, S_CALIB), seed=0)
    frames = _frames((N_CALIB, S_ENC, cfg.d_model), seed=1)
    x0, blocks, assemble = jmodel.quant_blocks(jparams, jnp.asarray(calib),
                                               jnp.asarray(frames))
    jrecipe = JQuantRecipe(rules=RULES, **RECIPE_KW)
    jfin, jast, _ = jquantize_blocks(blocks, jrecipe, x0)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                jparams=jparams, params=bridge.params(jparams, CPU),
                calib=calib, frames=frames, jrecipe=jrecipe,
                recipe=QuantRecipe(rules=RULES, **RECIPE_KW), jblocks=blocks,
                jfin=jfin, jast=jast, jq=assemble(jfin))


# ------------------------------------------------------------------ configs
def test_configs_match_reference_field_for_field():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(jreduced(jcfg))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(
        jget_smoke_config(ARCH))
    assert (cfg.n_layers, cfg.enc_layers, cfg.d_model, cfg.vocab) == (
        24, 24, 1024, 51865)
    assert WHISPER_CROSS_LEN == JWHISPER_CROSS_LEN == 1504


def test_full_and_smoke_configs_build():
    for c in (get_config(ARCH), get_smoke_config(ARCH)):
        model = build_model(c)
        assert isinstance(model, encdec.EncDecLM) and model.cfg is c


def test_param_tree_keys_and_shapes(lm):
    """The port's own init draws the reference's tree: ``enc_layers`` and
    ``dec_layers`` (``ln_x`` and ``xattn`` in the decoder), biased
    projections without ``bk``, the gelu MLP with ``b_up``/``b_down``."""
    params = lm["model"].init(torch.Generator().manual_seed(0), device=CPU)
    jtree = jax.tree.map(lambda a: None, lm["jparams"])
    assert _keys(params) == _keys(jtree) == _keys(lm["params"])
    assert sorted(params["dec_layers"][0]["xattn"]) == [
        "bo", "bq", "bv", "wk", "wo", "wq", "wv"]
    for seg, n in (("enc_layers", 2), ("dec_layers", 2)):
        assert len(params[seg]) == n
        jshapes = jax.tree.map(lambda a: a.shape[1:], lm["jparams"][seg])
        for path, t, shp in _pairs(params[seg][0], jshapes):
            assert tuple(t.shape) == tuple(shp), (seg, path)
    for k in ("embed", "lm_head"):
        assert tuple(params[k].shape) == lm["jparams"][k].shape


def test_bridge_unstacks_encoder_and_decoder_layers(lm):
    p, jp = lm["params"], lm["jparams"]
    for seg in ("enc_layers", "dec_layers"):
        assert isinstance(p[seg], list) and len(p[seg]) == 2
        for i in range(2):
            jl = jax.tree.map(lambda a, i=i: a[i], jp[seg])
            for path, t, j in _pairs(p[seg][i], jl):
                assert np.array_equal(_np(t), np.asarray(j)), (seg, i, path)


# ------------------------------------------------------------------ forward
def test_sinusoids_match_reference():
    """torch.pow and XLA's pow round 4 of whisper-medium's 512 timescales
    1 ulp apart, which moves the angle at position p by up to p * 2^-23
    rad: the tolerance is 2 p 2^-23, at least 1e-5."""
    np.testing.assert_allclose(_np(encdec._sinusoid(50, 64, CPU)),
                               np.asarray(jencdec._sinusoid(50, 64)), **F32)
    for pos in (0, 7, 1503):
        np.testing.assert_allclose(
            _np(encdec._sinusoid_at(pos, 1024, CPU)),
            np.asarray(jencdec._sinusoid_at(jnp.int32(pos), 1024)), rtol=0,
            atol=max(1e-5, 2 * pos * 2.0**-23))


@pytest.mark.parametrize("S", [S_ENC, 20])  # 40: a chunk of 32 + a padded one
def test_encode_matches_reference(lm, S):
    frames = _frames((2, S, lm["cfg"].d_model), seed=2)
    je = lm["jmodel"].encode(lm["jparams"], jnp.asarray(frames),
                             JQuantCtx(mode="fp"))
    e = lm["model"].encode(lm["params"], torch.from_numpy(frames),
                           QuantCtx(mode="fp"))
    np.testing.assert_allclose(_np(e), np.asarray(je), **F32)


def test_decode_full_with_collect_matches_reference(lm):
    """Hidden states and, per layer, the self-attention K/V and the
    cross-attention K/V over the encoder output."""
    frames = _frames((2, S_ENC, lm["cfg"].d_model), seed=3)
    toks = _tokens(lm["cfg"], (2, 12), seed=4)
    jctx, ctx = JQuantCtx(mode="fp"), QuantCtx(mode="fp")
    je = lm["jmodel"].encode(lm["jparams"], jnp.asarray(frames), jctx)
    e = lm["model"].encode(lm["params"], torch.from_numpy(frames), ctx)
    jx, jkvs = lm["jmodel"].decode_full(lm["jparams"], jnp.asarray(toks), je,
                                        jctx, collect=True)
    x, kvs = lm["model"].decode_full(lm["params"], torch.from_numpy(toks), e,
                                     ctx, collect=True)
    np.testing.assert_allclose(_np(x), np.asarray(jx), **F32)
    assert len(kvs) == 2
    (jsk, jsv), (jxk, jxv) = jkvs
    for li, ((sk, sv), (xk, xv)) in enumerate(kvs):
        for t, j in ((sk, jsk), (sv, jsv), (xk, jxk), (xv, jxv)):
            np.testing.assert_allclose(_np(t), np.asarray(j)[li], **F32)
    assert tuple(xk.shape) == (2, S_ENC, 4, 16)
    x2, none = lm["model"].decode_full(lm["params"], torch.from_numpy(toks), e,
                                       ctx)
    assert none is None and torch.equal(x2, x)


def test_loss_and_gradients_match_jax_grad(lm):
    """S = 40 is no multiple of the reduced xent_chunk (32); the encoder
    runs over 20 frames. Every leaf, the encoder's included."""
    cfg = lm["cfg"]
    rng = np.random.default_rng(5)
    batch = {"tokens": _tokens(cfg, (2, 40), seed=6),
             "labels": _tokens(cfg, (2, 40), seed=7),
             "mask": (rng.random((2, 40)) < 0.8).astype(np.float32),
             "frames": _frames((2, 20, cfg.d_model), seed=8)}
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
        bound = 1e-5 * np.abs(want).max() + 1e-7
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(),
                                                 bound)
        n += 1
    assert n == 6 + 2 * 15 + 2 * 24  # embed, head, norms; enc; dec layers
    assert np.abs(_np(params["enc_layers"][0]["attn"]["wq"].grad)).max() > 0


# -------------------------------------------------------------------- serve
def _flips(cache, jcache):
    """Cache entries that differ between the packages; each must lie one
    step of its grid apart (an int8 code by 1, a bfloat16 value by one
    ulp: a float32 value on a rounding boundary rounds the other way in
    one package). Scales and float32 caches are compared elsewhere."""
    n = 0
    for k, t in cache.items():
        if t.dtype not in (torch.int8, torch.bfloat16):
            continue
        got = _np(t).astype(np.float64)
        ref = np.asarray(jcache[k]).astype(np.float64)
        bad = got != ref
        step = 1.0 if t.dtype == torch.int8 else 2.0**-7 * np.abs(ref[bad])
        assert (np.abs(got - ref)[bad] <= step).all(), k
        n += int(bad.sum())
    return n


def _serve_both(lm, jparams, params, jctx, ctx, cache_kind, steps=4):
    """Prefill 10 tokens of 2 rows over 40 frames, then ``steps`` greedy
    decode steps, in both packages; the port follows the reference's
    tokens. ``cache_kind``: ``float`` (the config's float32), ``bf16`` or
    ``int8`` (self and cross caches). Checks every logits row, greedy
    token and the caches: with rounded (bf16, int8) caches, at most 16
    entries of the 28,672 may lie one grid step apart; once one does, a
    step's logits are held to atol 1e-3 (one int8 step is ~1% of its
    token's largest entry), else to rtol = atol = 1e-5."""
    cfg = lm["cfg"]
    toks = _tokens(cfg, (2, 10), seed=9)
    frames = _frames((2, S_ENC, cfg.d_model), seed=10)
    kw = dict(kv_quant=cache_kind == "int8")
    if cache_kind == "bf16":
        jcache = lm["jmodel"].init_cache(2, 16, enc_len=S_ENC,
                                         dtype=jnp.bfloat16)
        cache = lm["model"].init_cache(2, 16, S_ENC, dtype=torch.bfloat16,
                                       device=CPU)
    else:
        jcache = lm["jmodel"].init_cache(2, 16, enc_len=S_ENC, **kw)
        cache = lm["model"].init_cache(2, 16, S_ENC, device=CPU, **kw)
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape, k
        assert str(cache[k].dtype).replace("torch.", "") == str(
            jcache[k].dtype), k
    jh, jcache = lm["jmodel"].prefill(jparams, jnp.asarray(toks),
                                      jnp.asarray(frames), jcache, jctx)
    h, cache = lm["model"].prefill(params, torch.from_numpy(toks),
                                   torch.from_numpy(frames), cache, ctx)
    np.testing.assert_allclose(_np(h), np.asarray(jh), **F32)
    tok = toks[:, -1:]
    jstep = jax.jit(lambda p, t, c, pos: lm["jmodel"].decode_step(p, t, c, pos,
                                                                  jctx))
    for i in range(steps):
        jlg, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                            jnp.int32(10 + i))
        lg, cache = lm["model"].decode_step(params, torch.from_numpy(tok),
                                            cache, 10 + i, ctx)
        flips = _flips(cache, jcache)
        assert flips <= 16
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), rtol=1e-5,
                                   atol=1e-3 if flips else 1e-5)
        want = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        assert np.array_equal(_np(lg.argmax(-1)).astype(np.int32), want)
        tok = want
    for k in cache:
        if cache[k].dtype in (torch.int8, torch.bfloat16):
            continue
        np.testing.assert_allclose(_np(cache[k]), np.asarray(jcache[k]),
                                   **F32, err_msg=k)
    assert not _np(cache["k"])[:, :, 10 + steps:].any()
    return cache


@pytest.mark.parametrize("cache_kind", ["float", "bf16", "int8"])
def test_prefill_and_decode_match_reference_fp(lm, cache_kind):
    _serve_both(lm, lm["jparams"], lm["params"], JQuantCtx(mode="fp"),
                QuantCtx(mode="fp"), cache_kind)


@pytest.mark.parametrize("cache_kind", ["float", "int8"])
def test_prefill_and_decode_match_reference_deploy(lm, cache_kind):
    """Deploy mode on the reference's export (W4 body, W8 layer 0, A8; the
    ``dec.*`` serving names match no activation state, as in the
    reference); the encoder stays fp."""
    jctx = JQuantCtx(mode="deploy", recipe=lm["jrecipe"], astates=lm["jast"],
                     backend="xla")
    ctx = QuantCtx(mode="deploy", recipe=lm["recipe"],
                   astates=bridge.astates(lm["jast"], CPU))
    params = bridge.params(lm["jq"], CPU)
    assert isinstance(params["dec_layers"][1]["xattn"]["wk"], QTensor)
    _serve_both(lm, lm["jq"], params, jctx, ctx, cache_kind)


def test_int8_caches_are_smaller_and_the_cross_cache_is_fully_valid(lm):
    """The int8 self and cross caches take fewer bytes than the float32
    ones; after prefill every cross-cache position holds an entry."""
    model = lm["model"]
    c8 = model.init_cache(2, 16, S_ENC, kv_quant=True, device=CPU)
    cf = model.init_cache(2, 16, S_ENC, device=CPU)
    cb = model.init_cache(2, 16, S_ENC, dtype=torch.bfloat16, device=CPU)
    assert skv.cache_bytes(c8) < skv.cache_bytes(cb) < skv.cache_bytes(cf)
    toks = torch.from_numpy(_tokens(lm["cfg"], (2, 10), seed=11))
    frames = torch.from_numpy(_frames((2, S_ENC, lm["cfg"].d_model), seed=12))
    _, c8 = model.prefill(lm["params"], toks, frames, c8, QuantCtx(mode="fp"))
    assert bool((c8["xk_scale"] > skv.KV_SCALE_MIN).all())
    assert bool((c8["k_scale"][:, :, 10:] == 0).all())


def test_serve_capability_and_engine_refusal(lm):
    """As the reference: the uniform-batch decode serves encdec (int8
    caches included); the slot engine refuses the family."""
    model = lm["model"]
    assert serve_capability(model) == (True, "ok")
    assert serve_capability(model, kv_quant=True) == (True, "ok")
    assert serve_capability(model, engine=True) == (
        False, "unsupported_family:encdec")
    with pytest.raises(KVQuantUnsupported) as ei:
        ServeEngine(model, lm["params"], QuantCtx(mode="fp"),
                    EngineConfig(slots=2, max_len=16), device=CPU)
    assert ei.value.reason == "unsupported_family:encdec"


# ---------------------------------------------------------------- PTQ plan
def test_quant_blocks_names_sites_and_apply_keys(lm):
    """Decoder blocks ``layers.0``/``layers.1`` with ten sites each, the
    reference's names and paths; one fresh call token; the encoder is no
    block; x0 is the embedded tokens plus their sinusoids."""
    calib, frames = lm["calib"], lm["frames"]
    x0, blocks, assemble = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(calib), torch.from_numpy(frames))
    jx0, jblocks, _ = lm["jmodel"].quant_blocks(
        lm["jparams"], jnp.asarray(calib), jnp.asarray(frames))
    np.testing.assert_allclose(_np(x0), np.asarray(jx0), **F32)
    assert [b.name for b in blocks] == [b.name for b in jblocks] == [
        "layers.0", "layers.1"]
    for i, (b, jb) in enumerate(zip(blocks, jblocks)):
        assert {n: tuple(s.path) for n, s in b.sites.items()} == {
            n: tuple(s.path) for n, s in jb.sites.items()}
        assert sorted(b.sites) == sorted(f"layers.{i}.{s}" for s in SITES)
    assert len(blocks[0].apply_key) == 1
    assert blocks[0].apply_key[0] is blocks[1].apply_key[0]
    _, again, _ = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(calib), torch.from_numpy(frames))
    assert again[0].apply_key != blocks[0].apply_key  # fresh per call
    with torch.no_grad():
        y = blocks[1].apply(blocks[1].params, x0, QuantCtx(mode="fp"))
    jy = jblocks[1].apply(jblocks[1].params, jnp.asarray(_np(x0)),
                          JQuantCtx(mode="fp"))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    out = assemble(["a", "b"])
    assert out["dec_layers"] == ["a", "b"]
    assert out["enc_layers"] is lm["params"]["enc_layers"]


def test_export_is_bit_exact(lm):
    x0, blocks, assemble = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(lm["calib"]),
        torch.from_numpy(lm["frames"]))
    fin, ast, reps = quantize_blocks(blocks, lm["recipe"], x0)
    q = assemble(fin)
    jq = bridge.params(lm["jq"], CPU)
    n = 0
    for tl, jl in zip(q["dec_layers"], jq["dec_layers"], strict=True):
        a, b = dict(_qtensors(tl)), dict(_qtensors(jl))
        assert sorted(a) == sorted(b) == sorted(SITES)
        for name, qt in a.items():
            j = b[name]
            assert (qt.shape, qt.bits, qt.packed) == (tuple(j.shape), j.bits,
                                                      j.packed), name
            for fld in ("codes", "scale", "zero"):
                assert torch.equal(getattr(qt, fld), getattr(j, fld)), (
                    name, fld)
            n += 1
    assert n == 20
    assert {qt.bits for _, qt in _qtensors(q["dec_layers"][0])} == {8}
    assert {qt.bits for _, qt in _qtensors(q["dec_layers"][1])} == {4}
    assert not list(_qtensors(q["enc_layers"]))  # the encoder stays fp
    assert sorted(ast) == sorted(lm["jast"])
    for site in ast:
        for k in ("step", "beta"):
            np.testing.assert_allclose(_np(ast[site][k]),
                                       np.asarray(lm["jast"][site][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=site)
    assert all(r.iters == 0 and np.isfinite(r.err_after) for r in reps)


def test_reconstruction_first_steps_match_reference(lm):
    """Weight-only W4, 3 iterations, minibatch = the whole calibration set
    (no draws): per block err_before, err_after and the loss curve."""
    kw = dict(method="flexround", w_bits=4, a_bits=None,
              w_granularity="per_channel", iters=3, batch_size=N_CALIB)
    calib, frames = lm["calib"], lm["frames"]
    jx0, jblocks, _ = lm["jmodel"].quant_blocks(
        lm["jparams"], jnp.asarray(calib), jnp.asarray(frames))
    _, _, jreps = jquantize_blocks(jblocks, JQuantRecipe(**kw), jx0)
    x0, blocks, _ = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(calib), torch.from_numpy(frames))
    _, _, reps = quantize_blocks(blocks, QuantRecipe(**kw), x0)
    assert len(reps) == len(jreps) == 2
    for rep, jrep in zip(reps, jreps):
        assert rep.name == jrep.name and rep.iters == 3
        for k in ("err_before", "err_after"):
            np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                       rtol=1e-5)
        np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                                   rtol=1e-5)


# ------------------------------------------------------------ the refusals
def test_minibatch_below_the_calibration_set_is_refused(lm):
    """``batch_size`` 2 of 4 samples: the reference fails inside the
    cross-attention (its K/V keep all 4 rows of the baked encoder output,
    q has 2: a reshape error); the port raises a ValueError naming the
    limit."""
    kw = dict(method="flexround", w_bits=4, iters=1, batch_size=2)
    calib, frames = lm["calib"], lm["frames"]
    jx0, jblocks, _ = lm["jmodel"].quant_blocks(
        lm["jparams"], jnp.asarray(calib), jnp.asarray(frames))
    with pytest.raises(TypeError, match="reshape"):
        jquantize_blocks(jblocks[:1], JQuantRecipe(**kw), jx0)
    x0, blocks, _ = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(calib), torch.from_numpy(frames))
    with pytest.raises(ValueError, match=r"batch_size >= 4"):
        quantize_blocks(blocks[:1], QuantRecipe(**kw), x0)


def test_launcher_refuses_the_encdec_family(monkeypatch):
    """The launcher has no frames source: it exits before any work (no
    device is resolved: no card is visible here), naming the missing frames
    and the reference launcher's own failure, which the reference shows on
    the same command."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", ARCH, "--smoke", "--iters", "0", "--calib", "4",
            "--seq", "8"]
    with pytest.raises(SystemExit) as ei:
        quantize.main(argv)
    msg = str(ei.value.code)
    assert "frame embeddings" in msg and "repro/launch/quantize.py:189" in msg
    with pytest.raises(SystemExit):
        quantize.main(["--arch", ARCH, "--iters", "0"])  # full config too
    saved = sys.argv
    sys.argv = ["repro.launch.quantize"] + argv
    try:
        with pytest.raises(TypeError, match="frames"), \
                contextlib.redirect_stdout(io.StringIO()):
            jquantize.main()
    finally:
        sys.argv = saved
