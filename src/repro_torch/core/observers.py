"""Scale/zero-point initialization ("observers"), port of
``repro/core/observers.py``.

- ``minmax``: scale spans the full tensor (or channel) range.
- ``mse``:    grid search over 80 range-shrink factors p in [0.2, 1]
              minimizing ‖W - Ŵ‖².

The reference evaluates the mse candidates inside a compiled ``lax.map``
(one candidate at a time; the port loops the same way),
where XLA rewrites a division by a constant (the level count) into a
multiplication by its float32 reciprocal; eager (minmax) calls divide. The
port computes each path the way the reference's compiled code does, so
``s1`` is bit-identical.

The 80 factors are a literal float32 table: ``torch.linspace`` (and
``np.linspace`` cast to float32, ``start + step*i``, lerp) differ from the
reference's ``jnp.linspace(0.2, 1.0, 80, float32)`` in some of the 80 values,
and a different factor changes ``s1`` and with it the exported codes.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizer as qz
from repro_torch.core.quant_config import QuantConfig

_EPS = 1e-8
# elements of a stacked weight the mse observer takes at a time (1 GiB of
# float32 per temporary)
MSE_CHUNK_ELEMS = 2**28

# jnp.linspace(0.2, 1.0, 80, dtype=float32), value for value (each literal is
# the exact float32 value written in decimal, so float32(literal) is exact)
MSE_FACTORS = (
    0.20000000298023224, 0.2101265788078308, 0.22025316953659058,
    0.23037974536418915, 0.2405063360929489, 0.2506329119205475,
    0.26075950264930725, 0.270886093378067, 0.2810126543045044,
    0.29113924503326416, 0.3012658357620239, 0.3113924264907837,
    0.32151898741722107, 0.33164557814598083, 0.3417721688747406,
    0.351898729801178, 0.36202532052993774, 0.3721519112586975,
    0.3822784721851349, 0.39240506291389465, 0.4025316536426544,
    0.4126582443714142, 0.42278480529785156, 0.43291139602661133,
    0.4430379867553711, 0.45316454768180847, 0.46329113841056824,
    0.473417729139328, 0.48354431986808777, 0.49367091059684753,
    0.5037974715232849, 0.5139240622520447, 0.5240506529808044,
    0.5341772437095642, 0.544303834438324, 0.554430365562439,
    0.5645569562911987, 0.5746835470199585, 0.5848101377487183,
    0.594936728477478, 0.6050633192062378, 0.6151899099349976,
    0.6253164410591125, 0.6354430317878723, 0.6455696225166321,
    0.6556962132453918, 0.6658228039741516, 0.6759493947029114,
    0.6860759854316711, 0.6962025165557861, 0.7063291072845459,
    0.7164556980133057, 0.7265822887420654, 0.7367088794708252,
    0.746835470199585, 0.7569620609283447, 0.7670886516571045,
    0.7772151827812195, 0.7873417735099792, 0.797468364238739,
    0.8075949549674988, 0.8177215456962585, 0.8278481364250183,
    0.8379747271537781, 0.8481012582778931, 0.8582278490066528,
    0.8683544397354126, 0.8784810304641724, 0.8886076211929321,
    0.8987342119216919, 0.9088608026504517, 0.9189873337745667,
    0.9291139245033264, 0.9392405152320862, 0.949367105960846,
    0.9594936966896057, 0.9696202874183655, 0.9797468781471252,
    0.9898734092712402, 1.0,
)


def _range_stats(w: torch.Tensor, qcfg: QuantConfig):
    axes = qz.reduce_axes(tuple(w.shape), qcfg)
    wmin = torch.amin(w, dim=axes, keepdim=True)
    wmax = torch.amax(w, dim=axes, keepdim=True)
    return wmin.float(), wmax.float()


def _per_level(x: torch.Tensor, levels: int, compiled: bool) -> torch.Tensor:
    """x / levels, or x * float32(1 / levels) as XLA compiles it."""
    if compiled:
        return x * float(1.0 / torch.tensor(float(levels), dtype=torch.float32))
    return x / levels


def _scale_zero_from_range(wmin, wmax, qcfg: QuantConfig, compiled=False):
    if qcfg.symmetric:
        amax = torch.maximum(wmin.abs(), wmax.abs())
        scale = torch.clamp(_per_level(amax, qcfg.qmax, compiled), min=_EPS)
        zero = torch.zeros_like(scale)
    else:
        wmin = torch.clamp(wmin, max=0.0)
        wmax = torch.clamp(wmax, min=0.0)
        scale = torch.clamp(_per_level(wmax - wmin, qcfg.qmax - qcfg.qmin,
                                       compiled), min=_EPS)
        zero = torch.clamp(torch.round(-wmin / scale) + qcfg.qmin,
                           qcfg.qmin, qcfg.qmax)
    return scale, zero


def minmax_scale(w: torch.Tensor, qcfg: QuantConfig):
    wmin, wmax = _range_stats(w, qcfg)
    return _scale_zero_from_range(wmin, wmax, qcfg)


def mse_scale(w: torch.Tensor, qcfg: QuantConfig):
    """Grid-search range shrinking: candidates p*[wmin, wmax].

    The candidates are evaluated one at a time, as the reference's
    ``lax.map`` does, so peak memory is a few copies of the weight and not
    80 (one (16, 5120, 8192) expert stack is 2.7 GB in float32). A
    candidate replaces the best so far only when its error is strictly
    smaller: the first index wins at a tie, as ``jnp.argmin`` does.

    A stacked weight (``batch_dims`` >= 1) larger than ``MSE_CHUNK_ELEMS``
    elements is walked in chunks along its first axis, each chunk through
    all 80 candidates: the axis is kept by every reduction, so each
    sub-tensor's scale and zero depend on its own elements only, and a
    float32 copy of one deepseek-v3 expert stack (256 x 7168 x 2048, 15 GB)
    is never made."""
    n = w.shape[0] if qcfg.batch_dims else 1
    step = max(1, MSE_CHUNK_ELEMS // max(1, w[0].numel())) if n > 1 else n
    if step >= n:
        return _mse_scale(w, qcfg)
    parts = [_mse_scale(w[i:i + step], qcfg) for i in range(0, n, step)]
    return (torch.cat([s for s, _ in parts]),
            torch.cat([z for _, z in parts]))


def _mse_scale(w: torch.Tensor, qcfg: QuantConfig):
    w32 = w.float()
    wmin, wmax = _range_stats(w32, qcfg)
    axes = qz.reduce_axes(tuple(w.shape), qcfg)
    ps = torch.tensor(MSE_FACTORS, dtype=torch.float32, device=w.device)
    best_err = scale = zero = None
    for p in ps:
        s, z = _scale_zero_from_range(wmin * p, wmax * p, qcfg, compiled=True)
        what = qz.fake_quant(w32, s, z, qcfg, ste=False)
        with torch.no_grad():  # (what - w)^2 in place: no third copy
            err = torch.sum(what.detach().sub_(w32).square_(), dim=axes,
                            keepdim=True)
        del what
        if best_err is None:
            best_err, scale, zero = err, s, z
            continue
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        scale = torch.where(better, s, scale)
        zero = torch.where(better, z, zero)
    return scale, zero


def init_scale(w: torch.Tensor, qcfg: QuantConfig):
    """Dispatch on qcfg.observer. Returns (scale, zero) broadcastable to w."""
    if qcfg.observer == "minmax":
        return minmax_scale(w, qcfg)
    if qcfg.observer == "mse":
        return mse_scale(w, qcfg)
    raise ValueError(f"unknown observer {qcfg.observer!r}")
