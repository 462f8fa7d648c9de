"""Round-to-nearest (RTN), the no-learning PTQ baseline (port of
``repro/core/rtn.py``).

    Ŵ = s1 * ( clip( round(W / s1) + z, qmin, qmax ) - z )

with s1/z from the observer. Nothing is learnable.
"""
from __future__ import annotations

import sys
from typing import Dict

import torch

from repro_torch.core import method_api, observers, qtensor
from repro_torch.core import quantizer as qz
from repro_torch.core.quant_config import QuantConfig


def init(w: torch.Tensor, qcfg: QuantConfig, key=None) -> Dict[str, torch.Tensor]:
    scale, zero = observers.init_scale(w, qcfg)
    return {"s1": scale.float(), "zero": zero.float()}


def codes(w: torch.Tensor, state: Dict[str, torch.Tensor], qcfg: QuantConfig,
          ste: bool = True) -> torch.Tensor:
    return qz.quantize(w, state["s1"], state["zero"], qcfg, ste=ste)


def apply(w: torch.Tensor, state: Dict[str, torch.Tensor],
          qcfg: QuantConfig) -> torch.Tensor:
    return qz.fake_quant(w, state["s1"], state["zero"], qcfg, ste=True)


def trainable(state: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    return {k: False for k in state}


def project(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return state


def export(w: torch.Tensor, state: Dict[str, torch.Tensor], qcfg: QuantConfig,
           dtype=torch.bfloat16) -> qtensor.QTensor:
    q = qz.quantize(w, state["s1"], state["zero"], qcfg, ste=False)
    return qtensor.from_codes(q, state["s1"], state["zero"], qcfg, dtype=dtype)


method_api.register_method("rtn")(sys.modules[__name__])
