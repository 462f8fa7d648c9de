"""The reference's public names that the port lacked, held against the
reference on the same numpy inputs.

- ``serve``: the package exports ``repro.serve``'s names (the ``kv``
  names directly, the engine's through a lazy ``__getattr__``);
  ``kv_dequantize`` equals the reference's bit for bit (float32, bf16);
  ``quantized_cache`` and ``hbm_per_slot_mib`` agree on the reference's
  caches and the port's (smollm-135m's smoke config, bf16 and int8 KV), and
  the engine's ``hbm_per_slot_MiB`` is ``hbm_per_slot_mib`` of its cache.
- ``models``: ``build_model`` is exported.
- ``models.attention.attention_full``: within rtol = atol = 1e-5 (the
  float32 policy of ``test_torch_model.py``) of the reference's over
  causal or not, a sliding window, ``q_offset`` and ``kv_len``, with
  grouped-query heads.
- ``core.quantizer.ste_clip``: the reference's values bit for bit and a
  gradient of 1 everywhere, inside, at and beyond the bounds (``clip``
  keeps its half gradient at a bound); ``scale_shape`` over per-tensor,
  per-channel (either axis) and ``batch_dims=1``.
- ``core.context``: ``FP_CTX`` and ``fp()`` are full-precision contexts.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.configs import get_smoke_config as jsmoke
from repro.core import quantizer as jq
from repro.core.quant_config import QuantConfig as JQuantConfig
from repro.models import build_model as jbuild_model
from repro.models import attention as jattn
from repro.serve import kv as jkv
from repro_torch.configs import get_smoke_config
from repro_torch.core import context, quantizer
from repro_torch.core.quant_config import QuantConfig
from repro_torch.models import attention
from repro_torch.serve import kv

torch.set_num_threads(2)
F32 = dict(rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- exports
def _public(mod):
    """Public names of a package, its submodules left out (importing one
    elsewhere adds it to the package's namespace)."""
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_serve_exports_the_reference_names():
    import repro_torch.serve as serve
    assert _public(serve) == _public(jserve)
    assert set(serve._LAZY) == set(jserve._LAZY)
    from repro_torch.serve import (EngineConfig, Request, Scheduler,
                                   ServeEngine, serve_capability)
    from repro_torch.serve.engine import ServeEngine as Engine
    from repro_torch.serve.scheduler import Scheduler as Sched
    from repro_torch.serve.smoke import serve_capability as cap
    assert (ServeEngine, Scheduler, serve_capability) == (Engine, Sched, cap)
    assert EngineConfig.__module__ == "repro_torch.serve.engine"
    assert Request.__module__ == "repro_torch.serve.scheduler"
    assert serve.kv_dequantize is kv.kv_dequantize
    with pytest.raises(AttributeError, match="no attribute 'Nope'"):
        serve.Nope


def test_models_export_build_model():
    from repro_torch.models import build_model
    from repro_torch.models.model import build_model as inner
    assert build_model is inner


def test_fp_context():
    assert context.FP_CTX.mode == "fp"
    ctx = context.fp()
    assert ctx.mode == "fp" and ctx is not context.fp()


# ---------------------------------------------------------------------- kv
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_dequantize_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    codes = rng.integers(-127, 128, (2, 5, 3, 8)).astype(np.int8)
    scale = (rng.random((2, 5, 3, 1)) * 0.05 + kv.KV_SCALE_MIN).astype(
        np.float32)
    want = np.asarray(jkv.kv_dequantize(jnp.asarray(codes),
                                        jnp.asarray(scale),
                                        getattr(jnp, dtype)))
    got = kv.kv_dequantize(torch.from_numpy(codes), torch.from_numpy(scale),
                           getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert np.array_equal(got, want.astype(np.float32))


def test_kv_round_trip_within_half_a_step():
    """``kv_dequantize(kv_quantize(t))`` is within half a grid step of t."""
    t = torch.randn(2, 6, 3, 8, generator=torch.Generator().manual_seed(0))
    codes, scale = kv.kv_quantize(t)
    back = kv.kv_dequantize(codes, scale, torch.float32)
    assert (back - t).abs().le(scale / 2 + 1e-7).all()


@pytest.fixture(scope="module")
def caches():
    """{kv_quant: (reference cache, port cache)} of smollm-135m's smoke
    config, batch 4 x 32 positions."""
    jmodel = jbuild_model(jsmoke("smollm-135m"))
    from repro_torch.models import build_model
    model = build_model(get_smoke_config("smollm-135m"))
    return {q: (jmodel.init_cache(4, 32, kv_quant=q),
                model.init_cache(4, 32, kv_quant=q, device="cpu"))
            for q in (False, True)}


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("slots", [1, 4])
def test_hbm_per_slot_mib_equals_the_reference(caches, kv_quant, slots):
    jcache, cache = caches[kv_quant]
    want = jkv.hbm_per_slot_mib(jcache, slots)
    assert kv.hbm_per_slot_mib(cache, slots) == want
    assert kv.hbm_per_slot_mib(cache, slots) == \
        kv.hbm_per_slot_bytes(cache, slots) / 2**20


@pytest.mark.parametrize("kv_quant", [False, True])
def test_quantized_cache_on_both_kinds(caches, kv_quant):
    jcache, cache = caches[kv_quant]
    assert kv.quantized_cache(cache) == jkv.quantized_cache(jcache) == kv_quant
    assert not kv.quantized_cache([cache])


def test_engine_reports_hbm_per_slot_mib():
    """The engine's ``hbm_per_slot_MiB`` is ``hbm_per_slot_mib`` of its
    live cache, the one definition both read."""
    from repro_torch.models import build_model
    from repro_torch.serve import EngineConfig, ServeEngine
    cfg = get_smoke_config("smollm-135m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(model, params, context.fp(),
                      EngineConfig(slots=2, max_len=16), device="cpu")
    st = eng.stats()
    assert st["hbm_per_slot_MiB"] == kv.hbm_per_slot_mib(
        eng.state["cache"], 2) > 0


# --------------------------------------------------------------- attention
CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=5),
    "offset": dict(causal=True, q_offset=7),
    "kv_len": dict(causal=False, kv_len=9),
    "offset_window_kv_len": dict(causal=True, window=6, q_offset=4,
                                 kv_len=12),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (6, 1)])
def test_attention_full_matches_the_reference(case, heads):
    Hq, Hkv = heads
    rng = np.random.default_rng(1)
    B, Sq, Sk, D = 2, 9, 14, 16
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    kw = CASES[case]
    want = np.asarray(jattn.attention_full(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), **kw))
    got = attention.attention_full(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_attention_full_is_the_chunked_paths_oracle():
    """The chunked online-softmax path agrees with its oracle."""
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 16, 4, 8, generator=gen)
    k = torch.randn(2, 16, 2, 8, generator=gen)
    v = torch.randn(2, 16, 2, 8, generator=gen)
    for kw in (dict(causal=True), dict(causal=True, window=4),
               dict(causal=False, kv_len=11)):
        torch.testing.assert_close(
            attention.attention(q, k, v, chunk=4, **kw),
            attention.attention_full(q, k, v, **kw), **F32)


# --------------------------------------------------------------- quantizer
def test_ste_clip_values_and_identity_gradient():
    x = np.array([-3.0, -2.0, -1.5, 0.0, 0.25, 1.0, 2.0, 7.5], np.float32)
    lo, hi = -2.0, 1.0
    want = np.asarray(jq.ste_clip(jnp.asarray(x), lo, hi))
    jgrad = np.asarray(jax.grad(lambda t: jnp.sum(jq.ste_clip(t, lo, hi)))(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    y = quantizer.ste_clip(t, lo, hi)
    assert np.array_equal(y.detach().numpy(), want)
    (g,) = torch.autograd.grad(y.sum(), t)
    assert np.array_equal(g.numpy(), jgrad)
    assert np.array_equal(g.numpy(), np.ones_like(x))
    # clip (the quantizer's) keeps JAX's half gradient at a bound
    (g_clip,) = torch.autograd.grad(quantizer.clip(t, lo, hi).sum(), t)
    assert g_clip[1] == 0.5 and g_clip[0] == 0.0


@pytest.mark.parametrize("qcfg", [
    dict(granularity="per_tensor"),
    dict(granularity="per_channel"),
    dict(granularity="per_channel", channel_axis=0),
    dict(granularity="per_channel", batch_dims=1),
    dict(granularity="per_tensor", batch_dims=1),
], ids=["per_tensor", "per_channel", "per_channel_axis0",
        "per_channel_batch1", "per_tensor_batch1"])
@pytest.mark.parametrize("shape", [(6, 10), (3, 6, 10)])
def test_scale_shape_equals_the_reference(qcfg, shape):
    if qcfg.get("batch_dims") and len(shape) < 3:
        shape = (1,) + shape
    want = jq.scale_shape(shape, JQuantConfig(bits=4, **qcfg))
    got = quantizer.scale_shape(shape, QuantConfig(bits=4, **qcfg))
    assert got == want
    assert all(got[i] == 1 for i in quantizer.reduce_axes(
        shape, QuantConfig(bits=4, **qcfg)))
