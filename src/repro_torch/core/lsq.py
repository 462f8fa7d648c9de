"""LSQ/LSQ+ activation quantizer (Esser et al., 2020), port of
``repro/core/lsq.py``.

    x̂ = s * clip( round( (x - β) / s ), qmin, qmax ) + β

``s`` (step) and ``β`` (offset) carry the LSQ gradient scale
g = 1 / sqrt(numel * qmax) through the forward-identity trick.
"""
from __future__ import annotations

import sys
from typing import Dict

import torch

from repro_torch.core import method_api
from repro_torch.core import quantizer as qz
from repro_torch.core.quant_config import QuantConfig

EPS = 1e-8


def init(x_sample: torch.Tensor, qcfg: QuantConfig) -> Dict[str, torch.Tensor]:
    x32 = x_sample.float()
    if qcfg.symmetric:
        step = torch.clamp(x32.abs().max() / qcfg.qmax, min=EPS)
        beta = torch.zeros((), dtype=torch.float32, device=x32.device)
    else:
        lo = torch.clamp(x32.min(), max=0.0)
        hi = torch.clamp(x32.max(), min=0.0)
        step = torch.clamp((hi - lo) / (qcfg.qmax - qcfg.qmin), min=EPS)
        beta = lo
    return {"step": step.reshape(()), "beta": beta.float().reshape(())}


def apply(x: torch.Tensor, state: Dict[str, torch.Tensor],
          qcfg: QuantConfig) -> torch.Tensor:
    # g in float32 on the host, as the reference: 1 / sqrt(f32(numel) * qmax)
    g = float(1.0 / torch.sqrt(torch.tensor(float(x.numel()),
                                            dtype=torch.float32) * qcfg.qmax))
    s = qz.grad_scale(state["step"], g)
    b = qz.grad_scale(state["beta"], g)
    q = qz.clip(qz.ste_round((x.float() - b) / s), qcfg.qmin, qcfg.qmax)
    return (s * q + b).to(x.dtype)


def deploy_astate(state: Dict[str, torch.Tensor], qcfg: QuantConfig):
    """Static int8 activation grid ``(a_scale, a_zero)`` for the deploy
    kernels, with ``a_zero`` the unsigned zero point on [0, 255]; None when
    the grid has no exact 8-bit integer form (bits != 8). β is snapped to
    the step grid (z = round(-β/s)); symmetric grids centre at 128."""
    if qcfg.bits != 8:
        return None
    step = torch.as_tensor(state["step"], dtype=torch.float32)
    if qcfg.symmetric:
        zero = torch.full((), 128.0, dtype=torch.float32, device=step.device)
    else:
        beta = torch.as_tensor(state["beta"], dtype=torch.float32)
        zero = torch.clamp(torch.round(-beta / step), 0.0, 255.0)
    return step, zero


def trainable(state: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    return {"step": True, "beta": True}


def project(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(state)
    out["step"] = torch.clamp(out["step"], min=EPS)
    return out


method_api.register_method("lsq", kind="activation")(sys.modules[__name__])
