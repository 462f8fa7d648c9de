"""Uniform affine quantization primitives with straight-through estimators
(port of ``repro/core/quantizer.py``).

- quantize:   q = clip(round(w / s) + z, qmin, qmax)       (integer code)
- dequantize: ŵ = s * (q - z)
- ``s`` broadcasts against ``w``; per-channel scales have shape 1 everywhere
  except the channel axis. All quant math runs in float32; fake-quant
  returns the input dtype. ``torch.round`` rounds half to even, as
  ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quant_config import QuantConfig


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with identity gradient (straight-through)."""
    return x + (torch.round(x) - x).detach()


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
    """Float integer codes in [qmin, qmax]; differentiable via STE if asked."""
    rnd = ste_round if ste else torch.round
    q = rnd(w.float() / scale) + zero
    return torch.clamp(q, qcfg.qmin, qcfg.qmax)


def dequantize(q: torch.Tensor, scale, zero) -> torch.Tensor:
    return scale * (q.float() - zero)


def fake_quant(w: torch.Tensor, scale, zero, qcfg: QuantConfig,
               ste: bool = True) -> torch.Tensor:
    q = quantize(w, scale, zero, qcfg, ste=ste)
    return dequantize(q, scale, zero).to(w.dtype)
