"""Port parity: ``repro_torch.optim.adam`` against ``repro.optim.adam``.

The same numpy parameters and gradients go through three consecutive
``adam_update`` calls in both packages, for each moment dtype, plain and
with ``grad_clip``, ``weight_decay`` and a per-leaf ``lr_scale`` tree. The
tree has a per-channel row, a full matrix whose size is no multiple of the
int8 block (128), a leaf whose gradient is zero (a non-trainable leaf rides
Adam unchanged) and two scalars, as the reconstruction loop hands it.

Tolerances, on the parameters after each update (an Adam step moves a
parameter by about lr, so a parameter that lands near 0 is held to the
step's size):

- float32 moments: relative 8e-6 (``analysis/diffcheck.py``'s float
  tolerance). The arithmetic is the reference's, op for op; only the
  global norm's reduction order differs, which moves the clip factor by an
  ulp. The stored first moment b1 m + (1 - b1) g can cancel, so moments
  are held to 8e-6 of their leaf's largest entry.
- bfloat16 moments: the moments are stored rounded to bfloat16 (2^-8
  relative). Where the two float32 moments straddle a bfloat16 rounding
  boundary the stored values differ by one bfloat16 step, which moves that
  element's next update by at most 2^-7 of its size; so parameters agree
  within lr * 2^-7 (times its lr scale) after each update, and the stored
  moments within one bfloat16 step.
- int8 moments: a block's codes are round(value / scale); where a float32
  value sits within an ulp of a half-level the codes differ by one level,
  which moves that element's moment by one level of its block (1/127 of
  the block's absmax) and its next update by about 2/127 of the update's
  size; so parameters agree within lr * 2/127 (times its lr scale), and at
  most one code in a thousand differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro_torch import bridge
from repro_torch.optim import adam

torch.set_num_threads(2)

SHAPES = {"site.a": {"s1": (1, 48), "s2": (67, 48), "s3": (1, 48),
                     "zero": (1, 48)},
          "site.b": {"beta": (), "step": ()}}
LR_SCALE = {"site.a": {"s1": 3e-3, "s2": 1e-3, "s3": 3e-3, "zero": 3e-3},
            "site.b": {"beta": 2.0, "step": 0.5}}


def _tree(seed, scale=1.0, zero_leaf=False):
    rng = np.random.default_rng(seed)
    out = {}
    for site, leaves in SHAPES.items():
        out[site] = {}
        for k, shp in leaves.items():
            a = np.asarray(rng.standard_normal(shp) * scale, dtype=np.float32)
            if zero_leaf and k == "zero":
                a = np.zeros(shp, np.float32)
            out[site][k] = a
    return out


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {s: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
            for s, d in tree.items()}


def _np(t):
    return bridge.to_numpy(t)


CASES = {
    "plain": dict(lr=1e-2),
    "grad_clip": dict(lr=1e-2, grad_clip=0.5),
    "weight_decay": dict(lr=1e-2, weight_decay=0.1),
    "lr_scale_tree": dict(lr=1.0),
}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_adam_update_matches_reference(moment_dtype, case):
    kw = CASES[case]
    jcfg = jadam.AdamConfig(moment_dtype=moment_dtype, **kw)
    cfg = adam.AdamConfig(moment_dtype=moment_dtype, **kw)
    scale_tree = LR_SCALE if case == "lr_scale_tree" else 1.0
    params = _tree(0, 0.1)
    jp, tp = _j(params), _t(params)
    jst, tst = jadam.adam_init(jp, jcfg), adam.adam_init(tp, cfg)
    step_lr = kw["lr"] * (max(v for d in LR_SCALE.values() for v in d.values())
                          if case == "lr_scale_tree" else 1.0)
    if moment_dtype == "float32":  # of the parameter or of one step's size
        rtol, atol = 8e-6, 8e-6 * step_lr
    elif moment_dtype == "bfloat16":
        rtol, atol = 8e-6, step_lr * 2.0**-7
    else:
        rtol, atol = 8e-6, step_lr * 2.0 / 127
    for i in range(3):
        grads = _tree(10 + i, 10.0 ** -i, zero_leaf=True)
        jp, jst, jn = jadam.adam_update(_j(grads), jst, jp, jcfg,
                                        lr_scale=scale_tree)
        with torch.no_grad():
            tp, tst, tn = adam.adam_update(_t(grads), tst, tp, cfg,
                                           lr_scale=scale_tree)
        assert tst["count"] == int(jst["count"]) == i + 1
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for site, leaves in SHAPES.items():
            for k in leaves:
                got, want = _np(tp[site][k]), np.asarray(jp[site][k])
                assert got.shape == want.shape and tp[site][k].dtype == torch.float32
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                           err_msg=f"{site}.{k} step {i}")
                if k == "zero" and not cfg.weight_decay:  # zero gradient
                    np.testing.assert_array_equal(got, params[site][k])
                _check_moments(tst["mu"][site][k], jst["mu"][site][k],
                               moment_dtype)


def _check_moments(mu, jmu, moment_dtype):
    for part in ("m", "v"):
        got, want = mu[part], jmu[part]
        if moment_dtype == "int8":
            q = _np(got["q"]).astype(np.int32)
            jq = np.asarray(want["q"]).astype(np.int32)
            assert got["q"].dtype == torch.int8 and q.shape == jq.shape
            assert np.abs(q - jq).max() <= 1
            assert (q != jq).mean() <= 1e-3
            np.testing.assert_allclose(_np(got["s"]), np.asarray(want["s"]),
                                       rtol=1e-5, atol=1e-12)
        elif moment_dtype == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                       rtol=2.0**-7, atol=1e-30)
        else:  # b1 m + (1 - b1) g can cancel: 8e-6 of the leaf's largest
            want = np.asarray(want)
            np.testing.assert_allclose(_np(got), want, rtol=8e-6,
                                       atol=8e-6 * np.abs(want).max())


def test_global_norm_matches_reference():
    tree = _tree(3)
    np.testing.assert_allclose(float(adam.global_norm(_t(tree))),
                               float(jadam.global_norm(_j(tree))), rtol=1e-6)


def test_int8_moments_round_trip_padding():
    """A 67 x 48 leaf fills 26 blocks of 128 (the last one padded); the
    sqrt-domain second moment keeps small values away from 0."""
    x = torch.from_numpy(np.abs(_tree(4)["site.a"]["s2"]) ** 4)
    enc = adam._encode(x, "int8", second=True)
    assert enc["q"].shape == (26, 128) and enc["s"].shape == (26, 1)
    dec = adam._decode(enc, "int8", x.shape, second=True)
    jenc = jadam._encode_moment(jnp.asarray(x.numpy()), "int8", second=True)
    np.testing.assert_array_equal(_np(enc["q"]), np.asarray(jenc["q"]))
    np.testing.assert_allclose(_np(dec), np.asarray(jadam._decode_moment(
        jenc, "int8", x.shape, second=True)), rtol=1e-6)
