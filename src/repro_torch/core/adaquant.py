"""AdaQuant baseline (Hubara et al., 2021), additive perturbation plus a
learnable s1 (port of ``repro/core/adaquant.py``).

    Ŵ = s1 * ( clip( round( (W + V) / s1 ) + z, qmin, qmax ) - z )

``V`` (init 0) and ``s1`` are both learned (STE through round).
"""
from __future__ import annotations

import sys
from typing import Dict

import torch

from repro_torch.core import method_api, observers, qtensor
from repro_torch.core import quantizer as qz
from repro_torch.core.quant_config import QuantConfig

EPS = 1e-6


def init(w: torch.Tensor, qcfg: QuantConfig, key=None) -> Dict[str, torch.Tensor]:
    scale, zero = observers.init_scale(w, qcfg)
    return {"s1": scale.float(), "zero": zero.float(),
            "v": torch.zeros(tuple(w.shape), dtype=torch.float32,
                             device=w.device)}


def _codes(w, state, qcfg, ste: bool):
    rnd = qz.ste_round if ste else torch.round
    q = rnd((w.float() + state["v"]) / state["s1"]) + state["zero"]
    return qz.clip(q, qcfg.qmin, qcfg.qmax)


def codes(w: torch.Tensor, state: Dict[str, torch.Tensor], qcfg: QuantConfig,
          ste: bool = True) -> torch.Tensor:
    return _codes(w, state, qcfg, ste=ste)


def apply(w: torch.Tensor, state: Dict[str, torch.Tensor],
          qcfg: QuantConfig) -> torch.Tensor:
    q = _codes(w, state, qcfg, ste=True)
    return (state["s1"] * (q - state["zero"])).to(w.dtype)


def trainable(state: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    return {k: (k in ("v", "s1")) for k in state}


def project(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(state)
    out["s1"] = torch.clamp(out["s1"], min=EPS)
    return out


def export(w: torch.Tensor, state: Dict[str, torch.Tensor], qcfg: QuantConfig,
           dtype=torch.bfloat16) -> qtensor.QTensor:
    q = _codes(w, state, qcfg, ste=False)
    return qtensor.from_codes(q, state["s1"], state["zero"], qcfg, dtype=dtype)


method_api.register_method("adaquant")(sys.modules[__name__])
