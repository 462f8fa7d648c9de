"""FlexRound (the paper's contribution, Eq. 2), port of
``repro/core/flexround.py``.

    Ŵ = s1 * ( clip( round( W / (s1 ⊙ S2 ⊙ s3 [⊙ s4]) ) + z, qmin, qmax ) - z )

- ``s1``  grid size; scalar (per-tensor) or per-output-channel. Learnable.
- ``s2``  element-wise division factor, same shape as W, init 1. Learnable.
- ``s3``  per-output-channel factor, init 1. Learnable.
- ``s4``  per-input-channel factor (rank-4 convolutions only), init 1.
- ``z``   integer zero point from the observer, fixed.

Positivity of the scales is enforced by ``project`` (clamp at EPS) after each
optimizer step. Layouts: linear ``W[d_in, d_out]`` -> s3 ``(1, d_out)``.
"""
from __future__ import annotations

import sys
from typing import Dict

import torch

from repro_torch.core import method_api, observers, qtensor
from repro_torch.core import quantizer as qz
from repro_torch.core.quant_config import QuantConfig

EPS = 1e-6


def _s3_shape(shape, qcfg: QuantConfig):
    bd = qcfg.batch_dims
    return tuple(shape[:bd]) + (1,) * (len(shape) - bd - 1) + (shape[-1],)


def _is_conv(shape, qcfg: QuantConfig) -> bool:
    return len(shape) - qcfg.batch_dims == 4


def init(w: torch.Tensor, qcfg: QuantConfig, key=None) -> Dict[str, torch.Tensor]:
    """State such that apply(w, state) == RTN fake-quant of w."""
    scale, zero = observers.init_scale(w, qcfg)
    shape = tuple(w.shape)
    st = {
        "s1": scale.float(),
        "zero": zero.float(),
        "s2": torch.ones(shape, dtype=torch.float32, device=w.device),
        "s3": torch.ones(_s3_shape(shape, qcfg), dtype=torch.float32,
                         device=w.device),
    }
    if _is_conv(shape, qcfg):
        bd = qcfg.batch_dims
        s4_shape = shape[:bd] + (1, 1, shape[bd + 2], 1)
        st["s4"] = torch.ones(s4_shape, dtype=torch.float32, device=w.device)
    return st


def divisor(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    d = state["s1"] * state["s2"] * state["s3"]
    if "s4" in state:
        d = d * state["s4"]
    return d


def codes(w: torch.Tensor, state: Dict[str, torch.Tensor], qcfg: QuantConfig,
          ste: bool = True) -> torch.Tensor:
    """Float integer codes (incl. zero offset), clipped to the grid."""
    rnd = qz.ste_round if ste else torch.round
    q = rnd(w.float() / divisor(state)) + state["zero"]
    return qz.clip(q, qcfg.qmin, qcfg.qmax)


def apply(w: torch.Tensor, state: Dict[str, torch.Tensor],
          qcfg: QuantConfig) -> torch.Tensor:
    """Differentiable fake-quant Ŵ (Eq. 2)."""
    q = codes(w, state, qcfg, ste=True)
    return (state["s1"] * (q - state["zero"])).to(w.dtype)


def loss_extra(state, qcfg, step, recipe) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=state["s1"].device)


def trainable(state: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    return {k: (k != "zero") for k in state}


def project(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(state)
    for k in ("s1", "s2", "s3", "s4"):
        if k in out:
            out[k] = torch.clamp(out[k], min=EPS)
    return out


def export(w: torch.Tensor, state: Dict[str, torch.Tensor], qcfg: QuantConfig,
           dtype=torch.bfloat16) -> qtensor.QTensor:
    q = codes(w, state, qcfg, ste=False)
    return qtensor.from_codes(q, state["s1"], state["zero"], qcfg, dtype=dtype)


method_api.register_method("flexround")(sys.modules[__name__])
