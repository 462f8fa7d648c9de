"""Port parity: the quantization core of ``repro_torch`` against ``repro.core``.

Observers, FlexRound init/export and LSQ init/deploy_astate see the same
numpy inputs in both packages. Codes, packed bytes, scales and zero points
must be bit-identical: every step is elementwise float32 math that both
frameworks round the same way, except the mse observer's per-candidate error
sums, whose reduction order differs and could only matter at an exact tie.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flexround as jfr
from repro.core import lsq as jlsq
from repro.core import observers as jobs
from repro.core.quant_config import QuantConfig as JQuantConfig
from repro.core.quant_config import QuantRecipe as JQuantRecipe
from repro_torch import bridge
from repro_torch.core import flexround, lsq, observers
from repro_torch.core.qtensor import (dequantize_qtensor, from_codes,
                                      tree_weight_bytes, _pack_nibbles,
                                      _unpack_nibbles)
from repro_torch.core.quant_config import QuantConfig, QuantRecipe, SiteRule

torch.set_num_threads(2)

CPU = "cpu"


def _weight(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _cfgs(**kw):
    return JQuantConfig(**kw), QuantConfig(**kw)


def _np(t):
    return bridge.to_numpy(t)


def test_mse_factor_table_is_jnp_linspace():
    want = np.asarray(jnp.linspace(0.2, 1.0, 80, dtype=jnp.float32))
    got = np.asarray(observers.MSE_FACTORS, np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_argmin_takes_first_index_at_ties():
    errs = torch.tensor([[3.0, 1.0], [1.0, 1.0], [1.0, 0.5]])
    assert torch.argmin(errs, dim=0).tolist() == [1, 2]
    assert int(np.argmin(np.asarray(jnp.asarray([3.0, 1.0, 1.0])))) == 1


@pytest.mark.parametrize("observer", ["minmax", "mse"])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
@pytest.mark.parametrize("bits", [4, 8])
def test_observer_and_flexround_export_bit_identical(observer, symmetric,
                                                     granularity, bits):
    jq, tq = _cfgs(bits=bits, symmetric=symmetric, granularity=granularity,
                   observer=observer)
    w = _weight((64, 48), seed=bits * 7 + symmetric)
    js, jz = jobs.init_scale(jnp.asarray(w), jq)
    ts, tz = observers.init_scale(torch.from_numpy(w), tq)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_np(tz), np.asarray(jz))

    jst = jfr.init(jnp.asarray(w), jq)
    tst = flexround.init(torch.from_numpy(w), tq)
    for k in jst:
        np.testing.assert_array_equal(_np(tst[k]), np.asarray(jst[k]), err_msg=k)
    jqt = jfr.export(jnp.asarray(w), jst, jq, dtype=jnp.float32)
    tqt = flexround.export(torch.from_numpy(w), tst, tq, dtype=torch.float32)
    assert (tqt.shape, tqt.bits, tqt.packed, tqt.dtype, tqt.pack_axis) == (
        jqt.shape, jqt.bits, jqt.packed, jqt.dtype, jqt.pack_axis)
    np.testing.assert_array_equal(_np(tqt.codes), np.asarray(jqt.codes))
    np.testing.assert_array_equal(_np(tqt.scale), np.asarray(jqt.scale))
    np.testing.assert_array_equal(_np(tqt.zero), np.asarray(jqt.zero))
    np.testing.assert_array_equal(_np(dequantize_qtensor(tqt)),
                                  np.asarray(jfr.apply(jnp.asarray(w), jst, jq)))


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_mse_candidates_one_at_a_time_on_expert_stack(granularity, symmetric):
    """The mse observer walks its 80 candidates one at a time (peak memory
    O(weight), not O(80 x weight)) and still picks the reference's scale
    and zero on a stacked (E, K, N) expert weight with per-expert scales.
    Channel (1, :, 2) is scaled so far down that every candidate's scale
    clamps at the 1e-8 floor: those candidates tie exactly, and the first
    of them must win; channel (2, :, 5) is all zero (all 80 tie)."""
    jq, tq = _cfgs(bits=4, symmetric=symmetric, granularity=granularity,
                   observer="mse", batch_dims=1)
    w = _weight((3, 16, 8), seed=21)
    w[1, :, 2] *= 1e-7
    w[2, :, 5] = 0.0
    js, jz = jobs.init_scale(jnp.asarray(w), jq)
    ts, tz = observers.init_scale(torch.from_numpy(w), tq)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_np(tz), np.asarray(jz))
    if granularity == "per_channel":
        assert ts.shape == (3, 1, 8)
        assert float(ts[1, 0, 2]) == np.float32(1e-8)
        assert float(ts[2, 0, 5]) == np.float32(1e-8)
    jst = jfr.init(jnp.asarray(w), jq)
    tst = flexround.init(torch.from_numpy(w), tq)
    jqt = jfr.export(jnp.asarray(w), jst, jq, dtype=jnp.float32)
    tqt = flexround.export(torch.from_numpy(w), tst, tq, dtype=torch.float32)
    assert tqt.pack_axis == jqt.pack_axis == 1 and tqt.packed and jqt.packed
    for fld in ("codes", "scale", "zero"):
        np.testing.assert_array_equal(_np(getattr(tqt, fld)),
                                      np.asarray(getattr(jqt, fld)))
    assert tuple(tst["s3"].shape) == (3, 1, 8)


def test_mse_peak_memory_does_not_grow_with_candidates(monkeypatch):
    """Every tensor the observer makes is at most the weight's size: the
    candidate axis is never materialized."""
    from repro_torch.core import quantizer as qz
    biggest = []
    real = qz.fake_quant

    def spy(w, scale, zero, qcfg, ste=True):
        out = real(w, scale, zero, qcfg, ste=ste)
        biggest.append(max(out.numel(), scale.numel()))
        return out

    monkeypatch.setattr(qz, "fake_quant", spy)
    w = torch.from_numpy(_weight((4, 32, 16), seed=3))
    observers.mse_scale(w, QuantConfig(bits=4, granularity="per_channel",
                                       observer="mse", batch_dims=1))
    assert len(biggest) == len(observers.MSE_FACTORS)
    assert max(biggest) == w.numel()


@pytest.mark.parametrize("observer", ["minmax", "mse"])
@pytest.mark.parametrize("bits", [4, 3])
def test_odd_k_exports_unpacked(observer, bits):
    """Odd K cannot nibble-pack: codes stay one per byte, in both packages."""
    jq, tq = _cfgs(bits=bits, granularity="per_channel", observer=observer)
    w = _weight((33, 24), seed=5)
    jqt = jfr.export(jnp.asarray(w), jfr.init(jnp.asarray(w), jq), jq)
    tqt = flexround.export(torch.from_numpy(w),
                           flexround.init(torch.from_numpy(w), tq), tq)
    assert not tqt.packed and not jqt.packed and tqt.dtype == jqt.dtype
    np.testing.assert_array_equal(_np(tqt.codes), np.asarray(jqt.codes))
    np.testing.assert_array_equal(_np(tqt.zero), np.asarray(jqt.zero))


def test_bf16_weight_export_and_bytes():
    """bfloat16 weights cross the bridge bit-exactly and export the same
    codes; ``tree_weight_bytes`` counts the same serving bytes."""
    from repro.core.qtensor import tree_weight_bytes as jbytes
    jq, tq = _cfgs(bits=4, granularity="per_channel", observer="mse")
    wj = jnp.asarray(_weight((64, 40), seed=9)).astype(jnp.bfloat16)
    wt = bridge.tensor(np.asarray(wj), CPU)
    assert wt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(wt), np.asarray(wj, np.float32))
    jqt = jfr.export(wj, jfr.init(wj, jq), jq, dtype=wj.dtype)
    tqt = flexround.export(wt, flexround.init(wt, tq), tq, dtype=wt.dtype)
    assert tqt.dtype == jqt.dtype == "bfloat16"
    np.testing.assert_array_equal(_np(tqt.codes), np.asarray(jqt.codes))
    tree_j = {"w": jqt, "b": jnp.zeros((40,), jnp.float32)}
    tree_t = {"w": tqt, "b": torch.zeros((40,))}
    assert tree_weight_bytes(tree_t) == jbytes(tree_j)


def test_nibble_pack_roundtrip_matches_reference():
    from repro.core.qtensor import _pack_nibbles as jpack
    rng = np.random.default_rng(3)
    q = rng.integers(0, 16, size=(3, 10, 7)).astype(np.uint8)
    for axis in (0, 1):
        jp = np.asarray(jpack(jnp.asarray(q), axis=axis)) if q.shape[axis] % 2 == 0 else None
        if jp is None:
            continue
        tp = _pack_nibbles(torch.from_numpy(q), axis=axis)
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(_unpack_nibbles(tp, axis=axis).numpy(), q)


def test_from_codes_symmetric_shift():
    jq, tq = _cfgs(bits=4, symmetric=True, granularity="per_channel",
                   observer="minmax")
    from repro.core.qtensor import from_codes as jfrom
    rng = np.random.default_rng(4)
    qf = rng.integers(-7, 8, size=(8, 6)).astype(np.float32)
    s = np.full((1, 6), 0.1, np.float32)
    z = np.zeros((1, 6), np.float32)
    jqt = jfrom(jnp.asarray(qf), jnp.asarray(s), jnp.asarray(z), jq)
    tqt = from_codes(torch.from_numpy(qf), torch.from_numpy(s),
                     torch.from_numpy(z), tq)
    np.testing.assert_array_equal(tqt.codes.numpy(), np.asarray(jqt.codes))
    np.testing.assert_array_equal(tqt.zero.numpy(), np.asarray(jqt.zero))


@pytest.mark.parametrize("symmetric", [False, True])
def test_lsq_init_deploy_astate_and_apply(symmetric):
    jq, tq = _cfgs(bits=8, symmetric=symmetric, granularity="per_tensor",
                   observer="minmax")
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((6, 32)) * 2.0 + 0.3).astype(np.float32)
    sample = np.asarray([x.min(), x.max()], np.float32)
    jst = jlsq.init(jnp.asarray(sample), jq)
    tst = lsq.init(torch.from_numpy(sample), tq)
    for k in ("step", "beta"):
        np.testing.assert_array_equal(_np(tst[k]), np.asarray(jst[k]))
    ja = jlsq.deploy_astate(jst, jq)
    ta = lsq.deploy_astate(tst, tq)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # the fake-quant forward differs from round-to-grid only by float ulps
    np.testing.assert_allclose(_np(lsq.apply(torch.from_numpy(x), tst, tq)),
                               np.asarray(jlsq.apply(jnp.asarray(x), jst, jq)),
                               rtol=1e-5, atol=1e-5)
    assert lsq.deploy_astate(tst, dataclasses.replace(tq, bits=4)) is None


@pytest.mark.parametrize("text", ["layers.0.*:w_bits=8",
                                  "*.w_up:a_bits=none,w_symmetric=yes",
                                  "layers.1?.mlp.*:lr=0.01,w_granularity=per_channel"])
def test_site_rule_parse_matches_reference(text):
    from repro.core.quant_config import SiteRule as JSiteRule
    assert SiteRule.parse(text).overrides == JSiteRule.parse(text).overrides
    assert SiteRule.parse(text).pattern == JSiteRule.parse(text).pattern


@pytest.mark.parametrize("site", ["layers.0.wq", "layers.0.mlp.w_up",
                                  "layers.29.mlp.w_down", "layers.3.wk",
                                  "layers.wq", "w_up"])
def test_recipe_resolve_matches_reference(site):
    rules = ("layers.0.*:w_bits=8", "layers.29.*:w_bits=8",
             "*.w_up:a_bits=none", "layers.3.*:w_symmetric=true,lr=0.5")
    kw = dict(w_bits=4, a_bits=8, w_granularity="per_channel", iters=0)
    jp = JQuantRecipe(rules=rules, **kw).resolve(site)
    tp = QuantRecipe(rules=rules, **kw).resolve(site)
    assert tp.summary() == jp.summary()
    assert (tp.weight.qmin, tp.weight.qmax) == (jp.weight.qmin, jp.weight.qmax)


def test_rule_errors():
    with pytest.raises(ValueError, match="not of the form"):
        SiteRule.parse("layers.0.*")
    with pytest.raises(ValueError, match="unknown recipe fields"):
        SiteRule.parse("layers.0.*:bogus=1")
    with pytest.raises(ValueError, match="not registered"):
        QuantRecipe(method="bogus")
