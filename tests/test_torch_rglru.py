"""Port parity: the RG-LRU pieces of recurrentgemma-2b (``models/rglru.py``)
against the reference's, at ``get_smoke_config("recurrentgemma-2b")``:
d_model 64, lru_width 64, 4 query heads and 1 KV head of 16, local window
16, attention chunk 32, float32.

Weights: the reference's init (``jax.random.key(0)``) with N(0, 0.1^2)
noise on the leaves it sets to constants (norm scales, ``b_a``, ``b_i``,
``conv_b``), so that they change what both packages compute; inputs are
numpy draws. "Relative r" below means max |port - reference| <= r * max
|reference| over the tensor. Tolerances:

- every piece against the reference's: relative 8e-6, the bound the repo
  keeps for float32 sums that associate differently. The scan is one of
  them: the port's Hillis-Steele levels and the reference's
  ``associative_scan`` tree multiply and add the same terms in another
  order (each h_t is a sum of up to S products of decays); at these sizes
  they differ by at most 5e-7 of the largest state;
- the scan against a float64 token-by-token recurrence: relative 1e-5, and
  its backward against the loop's backward: relative 1e-5 (the scan must
  stay differentiable, training goes through it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.context import QuantCtx as JQuantCtx
from repro.models import build_model as jbuild_model
from repro.models import rglru as jrg
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.context import QuantCtx
from repro_torch.models import common
from repro_torch.models import rglru

torch.set_num_threads(2)

ARCH = "recurrentgemma-2b"
CPU = "cpu"
NOISY = ("ln", "final_norm", "b_a", "b_i", "conv_b")
REL = 8e-6


def _np(t):
    return bridge.to_numpy(t)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _perturb(jparams, seed):
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
    jparams = _perturb(jbuild_model(jcfg).init(jax.random.key(0)), seed=3)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=bridge.params(jparams, CPU))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


# ---------------------------------------------------------------- RG-LRU
def test_gates_match_reference(lm):
    """a = exp(log_a), b = sqrt(max(1 - exp(2 log_a), 1e-9)) (i x) with
    log_a = -8 softplus(lam) r, in float32."""
    x = _x((2, 12, 64), 1)
    jp = lm["jparams"]["layers"][0]["mix"]["rglru"]
    p = lm["params"]["layers"][0]["mix"]["rglru"]
    ja, jb = jrg._rglru_gates(jp, jnp.asarray(x), JQuantCtx(mode="fp"), "r")
    a, b = rglru._rglru_gates(p, torch.from_numpy(x), QuantCtx(mode="fp"), "r")
    assert a.dtype == b.dtype == torch.float32
    _close(_np(a), ja, REL, "a")
    _close(_np(b), jb, REL, "b")
    assert (_np(a) > 0).all() and (_np(a) < 1).all()


@pytest.mark.parametrize("S", [1, 7, 40])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_reference(lm, S, with_h0):
    """The scan's output and final state (one step, a ragged length and one
    past the smoke window), with and without an initial state folded into
    step 0."""
    x = _x((2, S, 64), S + with_h0)
    h0 = _x((2, 64), 9) if with_h0 else None
    jp = lm["jparams"]["layers"][1]["mix"]["rglru"]
    p = lm["params"]["layers"][1]["mix"]["rglru"]
    jy, jh = jrg.rglru_scan(jp, jnp.asarray(x), JQuantCtx(mode="fp"), "r",
                            None if h0 is None else jnp.asarray(h0))
    y, h = rglru.rglru_scan(p, torch.from_numpy(x), QuantCtx(mode="fp"), "r",
                            None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(_np(y), jy, REL, "y")
    _close(_np(h), jh, REL, "h")


def test_linear_scan_is_the_recurrence_and_differentiable():
    """``linear_scan`` over 37 steps (not a power of two) against the float64
    loop h_t = a_t h_{t-1} + b_t; the gradient of a weighted sum of its
    outputs against the loop's, through autograd in float64 too."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 1.0, (2, 37, 8))
    b = rng.normal(0, 1, (2, 37, 8))
    w = rng.normal(0, 1, (2, 37, 8))

    def loop(ta, tb):
        h = torch.zeros_like(tb[:, 0])
        out = []
        for t in range(ta.shape[1]):
            h = ta[:, t] * h + tb[:, t]
            out.append(h)
        return torch.stack(out, 1)

    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    want = loop(ta, tb)
    (want * torch.from_numpy(w)).sum().backward()
    ga, gb = ta.grad.clone(), tb.grad.clone()
    sa = torch.tensor(a, dtype=torch.float32, requires_grad=True)
    sb = torch.tensor(b, dtype=torch.float32, requires_grad=True)
    got = rglru.linear_scan(sa, sb)
    (got * torch.from_numpy(w).float()).sum().backward()
    _close(_np(got), want.detach().numpy(), 1e-5, "h")
    _close(_np(sa.grad), ga.numpy(), 1e-5, "da")
    _close(_np(sb.grad), gb.numpy(), 1e-5, "db")


def test_step_matches_reference(lm):
    x = _x((2, 1, 64), 2)
    h_prev = _x((2, 64), 3)
    jp = lm["jparams"]["layers"][0]["mix"]["rglru"]
    p = lm["params"]["layers"][0]["mix"]["rglru"]
    jy, jh = jrg.rglru_step(jp, jnp.asarray(x), JQuantCtx(mode="fp"), "r",
                            jnp.asarray(h_prev))
    y, h = rglru.rglru_step(p, torch.from_numpy(x), QuantCtx(mode="fp"), "r",
                            torch.from_numpy(h_prev))
    _close(_np(y), jy, REL, "y")
    _close(_np(h), jh, REL, "h")


@pytest.mark.parametrize("with_init", [False, True])
def test_causal_conv_matches_reference(lm, with_init):
    x = _x((2, 10, 64), 4)
    init = _x((2, 3, 64), 6) if with_init else None
    jp = lm["jparams"]["layers"][0]["mix"]
    p = lm["params"]["layers"][0]["mix"]
    jy = jrg._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                          None if init is None else jnp.asarray(init))
    y = rglru._causal_conv(torch.from_numpy(x), p["conv_w"], p["conv_b"],
                           None if init is None else torch.from_numpy(init))
    _close(_np(y), jy, REL)


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("S", [2, 24])  # a prefill shorter than the tail
def test_recurrent_block_and_its_state_match_reference(lm, S):
    """Output, final recurrent state and the raw (pre-conv) tail of the
    last min(3, S) inputs; with ``h0`` and ``conv_init`` too (a
    continuation)."""
    cfg, jcfg = lm["cfg"], lm["jcfg"]
    x = _x((2, S, 64), 10 + S)
    h0, ci = _x((2, 64), 11), _x((2, 3, 64), 12)
    jp = lm["jparams"]["layers"][0]["mix"]
    p = lm["params"]["layers"][0]["mix"]
    for kw in ({}, {"h0": h0, "conv_init": ci}):
        jy, (jh, jtail) = jrg.recurrent_block(
            jp, jnp.asarray(x), jcfg, JQuantCtx(mode="fp"), "layers.0",
            return_state=True, **{k: jnp.asarray(v) for k, v in kw.items()})
        y, (h, tail) = rglru.recurrent_block(
            p, torch.from_numpy(x), cfg, QuantCtx(mode="fp"), "layers.0",
            return_state=True,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        _close(_np(y), jy, REL, f"y {sorted(kw)}")
        _close(_np(h), jh, REL, f"h {sorted(kw)}")
        assert tuple(tail.shape) == (2, min(3, S), 64)
        _close(_np(tail), jtail, REL, f"tail {sorted(kw)}")
        assert torch.equal(rglru.recurrent_block(
            p, torch.from_numpy(x), cfg, QuantCtx(mode="fp"), "layers.0",
            **{k: torch.from_numpy(v) for k, v in kw.items()}), y)


def test_recurrent_block_steps_match_reference(lm):
    """Four decode steps from a random state and conv window: the output,
    the state and the shifted window of raw inputs."""
    cfg, jcfg = lm["cfg"], lm["jcfg"]
    jp = lm["jparams"]["layers"][1]["mix"]
    p = lm["params"]["layers"][1]["mix"]
    h, conv = _x((2, 64), 20), _x((2, 3, 64), 21)
    jh, jconv = jnp.asarray(h), jnp.asarray(conv)
    th, tconv = torch.from_numpy(h), torch.from_numpy(conv)
    for i in range(4):
        x = _x((2, 1, 64), 22 + i)
        jy, jh, jconv = jrg.recurrent_block_step(
            jp, jnp.asarray(x), jcfg, JQuantCtx(mode="fp"), "layers.1", jh,
            jconv)
        y, th, tconv = rglru.recurrent_block_step(
            p, torch.from_numpy(x), cfg, QuantCtx(mode="fp"), "layers.1", th,
            tconv)
        _close(_np(y), jy, REL, f"y {i}")
        _close(_np(th), jh, REL, f"h {i}")
        _close(_np(tconv), jconv, REL, f"conv {i}")


def test_local_attention_block_matches_reference(lm):
    """MQA over a window of 16 on 40 tokens (the window binds; two KV
    chunks of 32, the second padded), with the K/V it returns."""
    cfg, jcfg = lm["cfg"], lm["jcfg"]
    x = _x((2, 40, 64), 30)
    pos = np.broadcast_to(np.arange(40)[None], (2, 40))
    jsin, jcos = jax.tree.map(np.asarray, jbuild_model(jcfg)._rope(2, 40))
    sin, cos = common.rope_sin_cos(torch.from_numpy(pos.copy()), 16, 1e4)
    np.testing.assert_allclose(_np(sin), jsin, rtol=1e-6, atol=1e-6)
    jp = lm["jparams"]["layers"][2]["mix"]
    p = lm["params"]["layers"][2]["mix"]
    jy, (jk, jv) = jrg.local_attn_block(jp, jnp.asarray(x), jcfg,
                                        JQuantCtx(mode="fp"), "layers.2",
                                        jnp.asarray(jsin), jnp.asarray(jcos),
                                        return_kv=True)
    y, (k, v) = rglru.local_attn_block(p, torch.from_numpy(x), cfg,
                                       QuantCtx(mode="fp"), "layers.2", sin,
                                       cos, return_kv=True)
    _close(_np(y), jy, REL, "y")
    _close(_np(k), jk, REL, "k")
    _close(_np(v), jv, REL, "v")


def test_ring_decode_steps_wrap_and_match_reference(lm):
    """A ring of W = 16 slots, 20 decode steps from position 0: the ring
    wraps after 16; output, ring, and the ``kpos`` ring (int32, -1 for an
    empty slot) after each step. ``pos`` is a Python int in the port."""
    cfg, jcfg = lm["cfg"], lm["jcfg"]
    jp = lm["jparams"]["layers"][2]["mix"]
    p = lm["params"]["layers"][2]["mix"]
    W = 16
    jk = jnp.zeros((2, W, 1, 16), jnp.float32)
    jv, jkp = jk, jnp.full((W,), -1, jnp.int32)
    k = torch.zeros((2, W, 1, 16))
    v, kp = k.clone(), torch.full((W,), -1, dtype=torch.int32)
    for pos in range(20):
        x = _x((2, 1, 64), 40 + pos)
        parr = np.full((2, 1), pos)
        jsin, jcos = jax.tree.map(
            np.asarray, common_rope_ref(parr))
        sin, cos = common.rope_sin_cos(torch.from_numpy(parr), 16, 1e4)
        jy, jk, jv, jkp = jrg.local_attn_block_step(
            jp, jnp.asarray(x), jcfg, JQuantCtx(mode="fp"), "layers.2",
            jnp.asarray(jsin), jnp.asarray(jcos), jk, jv, jkp, jnp.int32(pos))
        y, k, v, kp = rglru.local_attn_block_step(
            p, torch.from_numpy(x), cfg, QuantCtx(mode="fp"), "layers.2",
            sin, cos, k, v, kp, pos)
        _close(_np(y), jy, REL, f"y {pos}")
        _close(_np(k), jk, REL, f"k {pos}")
        _close(_np(v), jv, REL, f"v {pos}")
        assert kp.dtype == torch.int32
        assert np.array_equal(_np(kp), np.asarray(jkp)), pos
    assert sorted(_np(kp).tolist()) == list(range(4, 20))  # wrapped


def common_rope_ref(positions):
    from repro.models import common as jcommon
    return jcommon.rope_sin_cos(jnp.asarray(positions), 16, 1e4)
