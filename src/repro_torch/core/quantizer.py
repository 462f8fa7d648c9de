"""Uniform affine quantization primitives with straight-through estimators
(port of ``repro/core/quantizer.py``).

- quantize:   q = clip(round(w / s) + z, qmin, qmax)       (integer code)
- dequantize: ŵ = s * (q - z)
- ``s`` broadcasts against ``w``; per-channel scales have shape 1 everywhere
  except the channel axis. All quant math runs in float32; fake-quant
  returns the input dtype. ``torch.round`` rounds half to even, as
  ``jnp.round`` does.
- Every clip that a gradient passes through is ``clip`` below, not
  ``torch.clamp``: at an exact tie (x == lo or x == hi) ``jnp.clip`` passes
  half the gradient, because ``lax.max`` and ``lax.min`` split ties, while
  ``torch.clamp`` passes all of it. Observer grids put each channel's
  extremes exactly on qmin/qmax and STE-rounded codes are integers, so
  ties are common.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quant_config import QuantConfig


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with identity gradient (straight-through)."""
    return x + (torch.round(x) - x).detach()


class _Clip(torch.autograd.Function):
    """``torch.clamp`` forward; the gradient of ``jnp.clip``, i.e. of
    ``minimum(maximum(x, lo), hi)``: 1 inside, 1/2 at a bound, 0 outside."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = (x > ctx.lo) & (x < ctx.hi)
        tie = (x == ctx.lo) | (x == ctx.hi)
        return torch.where(inside, g, torch.where(tie, g * 0.5, 0.0)), None, None


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """Clip to [lo, hi] (python numbers) with JAX's tie gradient."""
    return _Clip.apply(x, lo, hi)


def grad_scale(x: torch.Tensor, g) -> torch.Tensor:
    """Forward identity; scales the gradient by ``g`` (LSQ trick). Written
    term for term as the reference so the forward rounds identically."""
    return x * g + (x - x * g).detach()


def reduce_axes(shape: Tuple[int, ...], qcfg: QuantConfig) -> Tuple[int, ...]:
    """Axes to reduce over when computing per-scale statistics."""
    keep = set(range(qcfg.batch_dims))
    if qcfg.granularity == "per_channel":
        keep.add(qcfg.channel_axis % len(shape))
    return tuple(i for i in range(len(shape)) if i not in keep)


def quantize(w: torch.Tensor, scale, zero, qcfg: QuantConfig,
             ste: bool = True) -> torch.Tensor:
    """Float integer codes in [qmin, qmax]; differentiable via STE if asked.
    Without autograd the same operations run in place on one float32 copy
    of ``w`` (the STE round's forward is the round's, exactly), so a
    3.76 G-element expert stack takes 15 GB and not 45."""
    if not torch.is_grad_enabled():
        q = w.to(torch.float32, copy=True).div_(scale).round_().add_(zero)
        return q.clamp_(qcfg.qmin, qcfg.qmax)
    rnd = ste_round if ste else torch.round
    q = rnd(w.float() / scale) + zero
    return clip(q, qcfg.qmin, qcfg.qmax)


def dequantize(q: torch.Tensor, scale, zero) -> torch.Tensor:
    return scale * (q.float() - zero)


def fake_quant(w: torch.Tensor, scale, zero, qcfg: QuantConfig,
               ste: bool = True) -> torch.Tensor:
    q = quantize(w, scale, zero, qcfg, ste=ste)
    if not torch.is_grad_enabled():  # q is quantize's own copy
        return q.sub_(zero).mul_(scale).to(w.dtype)
    return dequantize(q, scale, zero).to(w.dtype)
