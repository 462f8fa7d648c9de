"""Port parity: Multi-head Latent Attention (``repro_torch.models.mla``)
against the reference's ``repro.models.mla`` on
``get_smoke_config("deepseek-v3-671b")`` (d_model 64, 4 heads, q rank 32,
kv rank 32, qk_nope 16, qk_rope 8, v_head 16), float32.

The reference draws the weights (``mla_params`` from ``jax.random.key(0)``);
the q/kv RMSNorm scales, which it initialises to zeros, get N(0, 0.1^2)
noise drawn with numpy; the port gets every array through the bridge.
Tolerances: float32 outputs, latents and logits within rtol = atol = 1e-5
(reduction order), deploy mode on the reference's exported QTensors
included; the absorbed decode against the expanded forward's position
within rtol = atol = 1e-5 (the same sums in another association).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.quant_config import QuantRecipe as JQuantRecipe
from repro.core.reconstruct import BlockHandle as JBlockHandle
from repro.core.reconstruct import quantize_blocks as jquantize_blocks
from repro.models import common as jcommon
from repro.models import mla as jmla
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.models import common, mla

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
CPU = "cpu"
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return bridge.to_numpy(t)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = jmla.mla_params(jax.random.key(0), jcfg, jnp.float32)
    rng = np.random.default_rng(3)
    for nm in ("q_norm", "kv_norm"):
        sc = jp[nm]["scale"]
        jp[nm]["scale"] = sc + jnp.asarray(rng.normal(0, 0.1, sc.shape),
                                           jnp.float32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, p=bridge.tree(jp, CPU))


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


def _rope(cfg, pos):
    """(reference sin/cos, port sin/cos) at integer positions (B, S)."""
    js, jc = jcommon.rope_sin_cos(jnp.asarray(pos), cfg.qk_rope_dim,
                                  cfg.rope_theta)
    ts, tc = common.rope_sin_cos(torch.from_numpy(pos), cfg.qk_rope_dim,
                                 cfg.rope_theta)
    return (js, jc), (ts, tc)


def _positions(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).copy()


def test_params_keys_and_shapes(setup):
    cfg = setup["cfg"]
    p = mla.mla_params(torch.Generator().manual_seed(0), cfg, torch.float32,
                       CPU)
    jp = setup["jp"]
    assert sorted(p) == sorted(jp)
    for k in p:
        if isinstance(p[k], dict):
            assert tuple(p[k]["scale"].shape) == jp[k]["scale"].shape, k
        else:
            assert tuple(p[k].shape) == jp[k].shape, k
    H = cfg.n_heads
    assert tuple(p["wq_b"].shape) == (32, H * (16 + 8))
    assert tuple(p["wkv_a"].shape) == (64, 32 + 8)
    assert tuple(p["wkv_b"].shape) == (32, H * (16 + 16))


def test_sites_name_the_five_projections(setup):
    sites = mla.mla_sites("layers.3", setup["cfg"])
    assert sorted(sites) == sorted(f"layers.3.{n}" for n in (
        "wq_a", "wq_b", "wkv_a", "wkv_b", "wo"))
    assert all(s.path == ("attn", s.path[1]) and s.batch_dims == 0
               for s in sites.values())
    assert {n: s.path for n, s in sites.items()} == {
        n: tuple(s.path) for n, s in jmla.mla_sites("layers.3",
                                                    setup["jcfg"]).items()}


@pytest.mark.parametrize("S", [5, 40])  # 40 > attn_chunk (32): two chunks
def test_forward_output_and_latents_match_reference(setup, S):
    cfg = setup["cfg"]
    x = _x(cfg, 2, S, seed=1)
    (js, jc), (ts, tc) = _rope(cfg, _positions(2, S))
    jout, (jckv, jkr) = jmla.mla_forward(setup["jp"], jnp.asarray(x),
                                         setup["jcfg"], JQuantCtx(mode="fp"),
                                         "layers", js, jc)
    out, (ckv, kr) = mla.mla_forward(setup["p"], torch.from_numpy(x), cfg,
                                     QuantCtx(mode="fp"), "layers", ts, tc)
    assert tuple(ckv.shape) == (2, S, cfg.kv_lora_rank)
    assert tuple(kr.shape) == (2, S, cfg.qk_rope_dim)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **F32)
    np.testing.assert_allclose(_np(ckv), np.asarray(jckv), **F32)
    np.testing.assert_allclose(_np(kr), np.asarray(jkr), **F32)


def _caches(cfg, B, Smax, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Smax, cfg.kv_lora_rank)).astype(np.float32),
            rng.normal(0, 1, (B, Smax, cfg.qk_rope_dim)).astype(np.float32))


@pytest.mark.parametrize("pos", [0, 6, 11])
def test_absorbed_decode_matches_reference(setup, pos):
    """One token against a random latent cache of 12 slots: the entries
    past ``pos`` are masked in both packages."""
    cfg = setup["cfg"]
    x = _x(cfg, 3, 1, seed=2)
    ckv, kr = _caches(cfg, 3, 12, seed=4)
    (js, jc), (ts, tc) = _rope(cfg, np.full((3, 1), pos))
    jout = jmla.mla_decode(setup["jp"], jnp.asarray(x), setup["jcfg"],
                           JQuantCtx(mode="fp"), "layers", js, jc,
                           jnp.asarray(ckv), jnp.asarray(kr), jnp.int32(pos))
    out = mla.mla_decode(setup["p"], torch.from_numpy(x), cfg,
                         QuantCtx(mode="fp"), "layers", ts, tc,
                         torch.from_numpy(ckv), torch.from_numpy(kr), pos)
    assert tuple(out.shape) == (3, 1, cfg.d_model)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **F32)


@pytest.mark.parametrize("S", [1, 9])
def test_absorbed_decode_equals_the_expanded_forward(setup, S):
    """The weight-absorbed decode of the last token over the latents the
    forward produced equals the forward's output at that position: the
    key/value expansion and the absorption are the same sums."""
    cfg = setup["cfg"]
    x = torch.from_numpy(_x(cfg, 2, S, seed=5))
    _, (ts, tc) = _rope(cfg, _positions(2, S))
    ctx = QuantCtx(mode="fp")
    out, (ckv, kr) = mla.mla_forward(setup["p"], x, cfg, ctx, "layers", ts,
                                     tc)
    Smax = S + 3  # slots past the token stay zero and are masked
    ckv_c = torch.zeros((2, Smax, cfg.kv_lora_rank))
    kr_c = torch.zeros((2, Smax, cfg.qk_rope_dim))
    ckv_c[:, :S], kr_c[:, :S] = ckv, kr
    dec = mla.mla_decode(setup["p"], x[:, -1:], cfg, ctx, "layers",
                         ts[:, -1:], tc[:, -1:], ckv_c, kr_c, S - 1)
    np.testing.assert_allclose(_np(dec), _np(out[:, -1:]), **F32)


def _exported(setup):
    """The reference's export-only FlexRound of one MLA block (W4, per
    channel): (reference QTensor params, the port's through the bridge)."""
    jcfg = setup["jcfg"]
    s, c = jcommon.rope_sin_cos(jnp.arange(8)[None], jcfg.qk_rope_dim,
                                jcfg.rope_theta)

    def apply(p, x, ctx):
        return jmla.mla_forward(p["attn"], x, jcfg, ctx, "b", s, c)[0]

    block = JBlockHandle(name="b", params={"attn": setup["jp"]}, apply=apply,
                         sites=jmla.mla_sites("b", jcfg))
    x0 = jnp.asarray(_x(jcfg, 4, 8, seed=6))
    recipe = JQuantRecipe(method="flexround", w_bits=4,
                          w_granularity="per_channel", iters=0)
    fin, _, _ = jquantize_blocks([block], recipe, x0)
    return fin[0]["attn"], bridge.tree(fin[0]["attn"], CPU)


def test_deploy_decode_dequantizes_wkv_b_through_get_weight(setup):
    """Deploy mode on the reference's exported QTensors: ``wkv_b`` enters
    the absorbed einsums through ``ctx.get_weight`` (dequantized), the
    other four sites through the dequant matmul's plain version."""
    cfg = setup["cfg"]
    jq, q = _exported(setup)
    assert all(isinstance(q[n], QTensor) and q[n].bits == 4
               for n in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"))
    x = _x(cfg, 2, 1, seed=7)
    ckv, kr = _caches(cfg, 2, 10, seed=8)
    (js, jc), (ts, tc) = _rope(cfg, np.full((2, 1), 7))
    jctx = JQuantCtx(mode="deploy", recipe=JQuantRecipe(), backend="xla")
    jout = jmla.mla_decode(jq, jnp.asarray(x), setup["jcfg"], jctx, "layers",
                           js, jc, jnp.asarray(ckv), jnp.asarray(kr),
                           jnp.int32(7))
    out = mla.mla_decode(q, torch.from_numpy(x), cfg,
                         QuantCtx(mode="deploy", recipe=QuantRecipe()),
                         "layers", ts, tc, torch.from_numpy(ckv),
                         torch.from_numpy(kr), 7)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **F32)
    # and the expanded forward on the same QTensors
    xs = _x(cfg, 2, 6, seed=9)
    (js, jc), (ts, tc) = _rope(cfg, _positions(2, 6))
    jo, _ = jmla.mla_forward(jq, jnp.asarray(xs), setup["jcfg"], jctx,
                             "layers", js, jc)
    o, _ = mla.mla_forward(q, torch.from_numpy(xs), cfg,
                           QuantCtx(mode="deploy", recipe=QuantRecipe()),
                           "layers", ts, tc)
    np.testing.assert_allclose(_np(o), np.asarray(jo), **F32)
