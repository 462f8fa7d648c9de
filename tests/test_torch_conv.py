"""Port parity for the conv sites: ``QuantCtx.conv2d`` (x NHWC, w HWIO) in
every mode, XLA's asymmetric "SAME" padding, the deploy dequantize with its
one warning per site, FlexRound's per-input-channel ``s4`` on a rank-4
weight, a layer-wise reconstruction of a toy conv block and the
allocator's gated ``_ProbeCtx.conv2d`` — each against the reference.

Inputs are numpy arrays made from a seed, fed to both packages; states the
reference initialises cross through the bridge. Tolerances (float32):

- convolution outputs: rtol=atol=1e-5 (the two libraries sum the kh x kw x
  cin products in different orders);
- FlexRound: ``init`` (s1 and zero from both observers) and the exported
  codes bit-exact; ``apply`` equal to 1e-6 (an exact function of the same
  float32 values); gradients of each state leaf within 1e-5 of the largest
  reference gradient of that leaf (s3 and s4 sum over the broadcast axes in
  another order);
- the layer-wise run (10 Adam steps, full batch, weights only): err_before
  and the loss curves relative 1e-5, the exported codes equal, as
  ``test_torch_recon.py`` holds the linear case.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.allocate import sensitivity as jsens
from repro.core import flexround as jflexround
from repro.core import lsq as jlsq
from repro.core import observers as jobservers
from repro.core import reconstruct as jrc
from repro.core import rtn as jrtn
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.qtensor import tree_weight_bytes as jbytes
from repro.core.quant_config import QuantConfig as JQuantConfig
from repro.core.quant_config import QuantRecipe as JQuantRecipe
from repro_torch import bridge
from repro_torch.allocate import sensitivity
from repro_torch.core import context, flexround, observers, rtn
from repro_torch.core import reconstruct as rc
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import dequantize_qtensor
from repro_torch.core.quant_config import QuantConfig, QuantRecipe

torch.set_num_threads(2)

CPU = "cpu"
F32 = dict(rtol=1e-5, atol=1e-5)
SITE = "stem.conv"
W_SHAPE = (3, 3, 4, 8)  # kh, kw, cin, cout
X_SHAPE = (2, 7, 6, 4)  # N, H, W, cin


def _np(t):
    return bridge.to_numpy(t)


def _arrays(seed=0, w_shape=W_SHAPE, x_shape=X_SHAPE):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(w_shape) * 0.3).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    b = (rng.standard_normal(w_shape[-1]) * 0.1).astype(np.float32)
    return w, x, b


def _jconv(x, w, stride=(1, 1), padding="SAME"):
    return jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=stride,
        padding=padding, dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("k,stride", [(1, (1, 1)), (2, (1, 1)), (3, (1, 1)),
                                      (2, (2, 2)), (3, (2, 2)), (4, (2, 2)),
                                      (4, (3, 2)), (5, (2, 1))])
def test_same_padding_matches_xla(k, stride):
    """Even k or stride > 1 pad one more row after than before (XLA), which
    torch's padding="same" does not do (it also refuses stride > 1)."""
    w, x, _ = _arrays(1, w_shape=(k, k, 4, 8))
    got = context.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                              stride, "SAME")
    want = _jconv(x, w, stride, "SAME")
    assert tuple(got.shape) == want.shape == (
        2, -(-7 // stride[0]), -(-6 // stride[1]), 8)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("padding", ["VALID", ((1, 0), (2, 1))])
def test_valid_and_explicit_padding_match_xla(padding):
    w, x, _ = _arrays(2)
    got = context.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                              (2, 1), padding)
    np.testing.assert_allclose(_np(got),
                               np.asarray(_jconv(x, w, (2, 1), padding)), **F32)


def _recipe_pair(**kw):
    kw = dict(dict(w_bits=4, a_bits=8, w_granularity="per_channel",
                   setting="brecq"), **kw)
    return JQuantRecipe(**kw), QuantRecipe(**kw)


def _states(jr, w, x):
    """The reference's FlexRound state for the conv weight (s2, s3 and s4
    moved off 1) and its LSQ state over x's range."""
    plan = jr.resolve(SITE)
    st = jflexround.init(jnp.asarray(w), plan.weight)
    rng = np.random.default_rng(3)
    for k in ("s2", "s3", "s4"):
        st[k] = st[k] * jnp.asarray(
            np.exp(0.05 * rng.standard_normal(st[k].shape)), jnp.float32)
    ast = jlsq.init(jnp.asarray([x.min(), x.max()], jnp.float32), plan.act)
    return st, ast


@pytest.mark.parametrize("mode", ["fp", "calib", "capture", "recon", "deploy"])
def test_conv2d_every_mode_matches_reference(mode, monkeypatch):
    w, x, b = _arrays(4)
    jr, tr = _recipe_pair()
    jst, jast = _states(jr, w, x)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jkw, tkw = {}, {}
    if mode == "recon":
        jkw = dict(wstates={SITE: jst}, astates={SITE: jast})
        tkw = dict(wstates={SITE: bridge.tree(jst, CPU)},
                   astates=bridge.astates({SITE: jast}, CPU))
    if mode == "deploy":
        jw = jflexround.export(jw, jst, jr.resolve(SITE).weight,
                               dtype=jnp.float32)
        tw = bridge.qtensor(jw, CPU)
        jkw, tkw = dict(astates={SITE: jast}), dict(
            astates=bridge.astates({SITE: jast}, CPU))
        monkeypatch.setattr(context, "_CONV_FALLBACK_WARNED", set())
    jctx = JQuantCtx(mode=mode, recipe=jr, backend="xla", **jkw)
    ctx = QuantCtx(mode=mode, recipe=tr, **tkw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jy = jctx.conv2d(SITE, jnp.asarray(x), jw, jnp.asarray(b),
                         stride=(2, 2))
        y = ctx.conv2d(SITE, torch.from_numpy(x), tw, torch.from_numpy(b),
                       stride=(2, 2))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    if mode == "calib":
        np.testing.assert_allclose(ctx.records[SITE], jctx.records[SITE])
    if mode == "capture":
        assert len(ctx.records[SITE]) == 1
        np.testing.assert_array_equal(_np(ctx.records[SITE][0]), x)
    if mode in ("recon", "deploy"):  # both operands were quantized
        y_fp = QuantCtx().conv2d(SITE, torch.from_numpy(x),
                                 torch.from_numpy(w), torch.from_numpy(b),
                                 stride=(2, 2))
        assert not torch.allclose(y, y_fp, rtol=1e-3, atol=1e-3)


def test_deploy_conv_dequantizes_and_warns_once_per_site(monkeypatch):
    monkeypatch.setattr(context, "_CONV_FALLBACK_WARNED", set())
    w, x, _ = _arrays(5)
    qcfg = QuantConfig(bits=4)
    st = flexround.init(torch.from_numpy(w), qcfg)
    qt = flexround.export(torch.from_numpy(w), st, qcfg, dtype=torch.float32)
    assert qt.shape == W_SHAPE and not qt.packed  # kh = 3: one code a byte
    ctx = QuantCtx(mode="deploy")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        y = ctx.conv2d("a.conv", torch.from_numpy(x), qt)
        ctx.conv2d("a.conv", torch.from_numpy(x), qt)
        ctx.conv2d("b.conv", torch.from_numpy(x), qt)
    msgs = [str(r.message) for r in rec if r.category is RuntimeWarning]
    assert len(msgs) == 2
    assert "'a.conv'" in msgs[0] and "'b.conv'" in msgs[1]
    assert "(3, 3, 4, 8)" in msgs[0] and "4-bit" in msgs[0]
    jqt = jflexround.export(jnp.asarray(w),
                            jflexround.init(jnp.asarray(w), JQuantConfig(bits=4)),
                            JQuantConfig(bits=4), dtype=jnp.float32)
    assert f"{jbytes(jqt)} bytes" in msgs[0]
    want = QuantCtx().conv2d("a.conv", torch.from_numpy(x),
                             dequantize_qtensor(qt))
    assert torch.equal(y, want)


# -------------------------------------------------------- FlexRound's s4
@pytest.mark.parametrize("observer", ["minmax", "mse"])
@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_observers_reduce_over_every_axis_but_cout(observer, granularity,
                                                   symmetric):
    w, _, _ = _arrays(6)
    kw = dict(bits=4, observer=observer, granularity=granularity,
              symmetric=symmetric)
    js, jz = jobservers.init_scale(jnp.asarray(w), JQuantConfig(**kw))
    s, z = observers.init_scale(torch.from_numpy(w), QuantConfig(**kw))
    shape = (1, 1, 1, 8) if granularity == "per_channel" else (1, 1, 1, 1)
    assert tuple(s.shape) == js.shape == shape
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    np.testing.assert_array_equal(_np(z), np.asarray(jz))


@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
def test_flexround_s4_init_apply_gradients_export(granularity):
    w, _, _ = _arrays(7)
    kw = dict(bits=4, granularity=granularity, observer="mse")
    jq, tq = JQuantConfig(**kw), QuantConfig(**kw)
    jst = jflexround.init(jnp.asarray(w), jq)
    st = flexround.init(torch.from_numpy(w), tq)
    assert sorted(st) == sorted(jst) == ["s1", "s2", "s3", "s4", "zero"]
    assert tuple(st["s4"].shape) == jst["s4"].shape == (1, 1, 4, 1)
    assert tuple(st["s3"].shape) == jst["s3"].shape == (1, 1, 1, 8)
    for k in st:
        np.testing.assert_array_equal(_np(st[k]), np.asarray(jst[k]), err_msg=k)
    rng = np.random.default_rng(8)
    for k in ("s2", "s3", "s4"):
        jst[k] = jst[k] * jnp.asarray(
            np.exp(0.1 * rng.standard_normal(jst[k].shape)), jnp.float32)
    st = bridge.tree(jst, CPU)
    r = rng.standard_normal(W_SHAPE).astype(np.float32)

    def jloss(s):
        return jnp.sum(jflexround.apply(jnp.asarray(w), s, jq) * r)

    jg = jax.grad(jloss)(jst)
    leaves = {k: v.clone().requires_grad_(k != "zero") for k, v in st.items()}
    out = flexround.apply(torch.from_numpy(w), leaves, tq)
    np.testing.assert_allclose(_np(out), np.asarray(
        jflexround.apply(jnp.asarray(w), jst, jq)), rtol=1e-6, atol=1e-6)
    torch.sum(out * torch.from_numpy(r)).backward()
    for k in ("s1", "s2", "s3", "s4"):
        g, want = _np(leaves[k].grad), np.asarray(jg[k])
        assert g.shape == want.shape
        assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max() + 1e-7, k
    assert np.abs(np.asarray(jg["s4"])).max() > 0
    proj = flexround.project(dict(st, s4=st["s4"] - 2.0))
    jproj = jflexround.project(dict(jst, s4=jst["s4"] - 2.0))
    np.testing.assert_array_equal(_np(proj["s4"]), np.asarray(jproj["s4"]))
    qt = flexround.export(torch.from_numpy(w), st, tq, dtype=torch.float32)
    jqt = jflexround.export(jnp.asarray(w), jst, jq, dtype=jnp.float32)
    assert (qt.shape, qt.bits, qt.packed, qt.pack_axis) == (
        tuple(jqt.shape), jqt.bits, jqt.packed, jqt.pack_axis)
    for fld in ("codes", "scale", "zero"):
        np.testing.assert_array_equal(_np(getattr(qt, fld)),
                                      np.asarray(getattr(jqt, fld)))


# ------------------------------------------------ layer-wise conv block
N_IMG = 8


def _conv_blocks(seed=9):
    """A toy frontend block: a 3x3 conv (HWIO), gelu, then a linear over the
    channels, with a conv site and a linear site."""
    rng = np.random.default_rng(seed)
    p = {"c1": (rng.standard_normal((3, 3, 4, 8)) * (36 ** -0.5)).astype(np.float32),
         "w2": (rng.standard_normal((8, 8)) * (8 ** -0.5)).astype(np.float32)}

    def japply(pp, x, ctx):
        h = jax.nn.gelu(ctx.conv2d("blk.c1", x, pp["c1"]))
        return ctx.linear("blk.w2", h, pp["w2"])

    def tapply(pp, x, ctx):
        h = F.gelu(ctx.conv2d("blk.c1", x, pp["c1"]), approximate="tanh")
        return ctx.linear("blk.w2", h, pp["w2"])

    jsites = {"blk.c1": jrc.Site(("c1",), kind="conv"),
              "blk.w2": jrc.Site(("w2",))}
    tsites = {"blk.c1": rc.Site(("c1",), kind="conv"),
              "blk.w2": rc.Site(("w2",))}
    jb = jrc.BlockHandle("blk", {k: jnp.asarray(v) for k, v in p.items()},
                         japply, jsites)
    tb = rc.BlockHandle("blk", {k: torch.from_numpy(v.copy())
                                for k, v in p.items()}, tapply, tsites)
    x = np.random.default_rng(seed + 1).standard_normal(
        (N_IMG, 6, 6, 4)).astype(np.float32)
    return jb, tb, x


def test_layerwise_conv_block_matches_reference():
    jb, tb, x = _conv_blocks()
    kw = dict(method="flexround", w_bits=4, w_symmetric=True, a_bits=None,
              iters=10, lr=3e-3, batch_size=N_IMG, setting="brecq",
              recon="layer")
    jfin, _, jreps = jrc.quantize_blocks([jb], JQuantRecipe(**kw),
                                         jnp.asarray(x))
    fin, _, reps = rc.quantize_blocks([tb], QuantRecipe(**kw),
                                      torch.from_numpy(x))
    assert [r.name for r in reps] == [r.name for r in jreps] == [
        "blk/blk.c1", "blk/blk.w2"]
    for rep, jrep in zip(reps, jreps):
        np.testing.assert_allclose(rep.err_before, jrep.err_before, rtol=1e-5)
        np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                                   rtol=1e-5)
        np.testing.assert_allclose(rep.err_after, jrep.err_after, rtol=1e-5)
    assert fin[0]["c1"].shape == (3, 3, 4, 8)
    for k in ("c1", "w2"):
        np.testing.assert_array_equal(_np(fin[0][k].codes),
                                      np.asarray(jfin[0][k].codes))


def test_rename_ctx_forwards_conv_sites():
    seen = []

    class Spy:
        def conv2d(self, name, *a, **k):
            seen.append(name)

    rc._RenameCtx(Spy(), {"blk.c1": "~s0"}).conv2d("blk.c1", None, None)
    rc._RenameCtx(Spy(), {}).conv2d("other", None, None)
    assert seen == ["~s0", "other"]


# ------------------------------------------------------- the probe's ctx
@pytest.mark.parametrize("gate", [True, False])
def test_probe_ctx_conv2d_matches_reference(gate):
    """The gated weight: the RTN fake-quant when the site's gate is on, the
    raw weight when off; activations stay fp."""
    w, x, b = _arrays(10)
    qcfg_kw = dict(bits=3, granularity="per_channel")
    jcfg, tcfg = JQuantConfig(**qcfg_kw), QuantConfig(**qcfg_kw)
    jst = jrtn.init(jnp.asarray(w), jcfg)
    st = rtn.init(torch.from_numpy(w), tcfg)
    jctx = jsens._ProbeCtx({SITE: jcfg}, {SITE: jst},
                           {SITE: jnp.asarray(gate)})
    ctx = sensitivity._ProbeCtx({SITE: tcfg}, {SITE: st},
                                {SITE: torch.tensor(gate)})
    jy = jctx.conv2d(SITE, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=(2, 2))
    y = ctx.conv2d(SITE, torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), stride=(2, 2))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    raw = QuantCtx().conv2d(SITE, torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), stride=(2, 2))
    assert torch.equal(y, raw) == (not gate)
