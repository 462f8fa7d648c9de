"""AdaRound baseline (Nagel et al., 2020), additive learnable rounding (port
of ``repro/core/adaround.py``).

    Ŵ = s1 * ( clip( floor(W / s1) + h(V) + z, qmin, qmax ) - z )
    h(V) = clip( sigmoid(V) * (ζ - γ) + γ, 0, 1 ),  ζ = 1.1, γ = -0.1

``s1`` is fixed; only ``V`` is learned, under the annealed rounding
regularizer

    f_reg = λ Σ (1 - |2 h(V) - 1|^β),   β: 20 → 2 (cosine), after warmup.

At export, rounding is hardened: h(V) >= 0.5 rounds up. The two clips that
gradients pass through carry JAX's tie gradient (``quantizer.clip``); the
one in ``init`` runs outside autograd.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import method_api, observers, qtensor
from repro_torch.core import quantizer as qz
from repro_torch.core.quant_config import QuantConfig

ZETA = 1.1
GAMMA = -0.1


def rectified_sigmoid(v: torch.Tensor) -> torch.Tensor:
    return qz.clip(torch.sigmoid(v) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def init(w: torch.Tensor, qcfg: QuantConfig, key=None) -> Dict[str, torch.Tensor]:
    scale, zero = observers.init_scale(w, qcfg)
    w32 = w.float()
    frac = w32 / scale - torch.floor(w32 / scale)
    # inverse rectified sigmoid so that h(V) == frac at init (soft-exact start)
    p = torch.clamp((frac - GAMMA) / (ZETA - GAMMA), 1e-4, 1 - 1e-4)
    v = torch.log(p / (1 - p))
    return {"s1": scale.float(), "zero": zero.float(), "v": v}


def _codes(w, state, qcfg, hard: bool):
    w32 = w.float()
    h = rectified_sigmoid(state["v"])
    if hard:
        h = (h >= 0.5).float()
    q = torch.floor(w32 / state["s1"]) + h + state["zero"]
    return qz.clip(q, qcfg.qmin, qcfg.qmax)


def codes(w: torch.Tensor, state: Dict[str, torch.Tensor], qcfg: QuantConfig,
          ste: bool = True) -> torch.Tensor:
    """Hardened integer codes (h(V) >= 0.5 rounds up); ``ste`` routes
    gradients through the soft relaxation."""
    hard = _codes(w, state, qcfg, hard=True)
    if ste:
        soft = _codes(w, state, qcfg, hard=False)
        return soft + (hard - soft).detach()
    return hard


def apply(w: torch.Tensor, state: Dict[str, torch.Tensor],
          qcfg: QuantConfig) -> torch.Tensor:
    q = _codes(w, state, qcfg, hard=False)
    return (state["s1"] * (q - state["zero"])).to(w.dtype)


def _beta(step: int, recipe):
    """(β, in warmup) at ``step``, in float32 as the reference computes
    them from its int32 step."""
    f32 = np.float32
    total = f32(recipe.iters)
    warm = f32(total * f32(recipe.ada_warmup))
    t = f32(np.clip((f32(step) - warm) / max(total - warm, f32(1.0)),
                    f32(0.0), f32(1.0)))
    cos = f32(np.cos(f32(t * f32(math.pi))))
    beta = f32(f32(recipe.ada_beta_end)
               + f32(0.5 * (recipe.ada_beta_start - recipe.ada_beta_end))
               * f32(f32(1.0) + cos))
    return float(beta), bool(f32(step) < warm)


# (schedule fields, device) -> (β, warm-up) tables. Kept for the life of the
# process (a few floats each): a captured step reads them by address.
_TABLES: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def beta_tables(recipe, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iters,) float32 β and boolean warm-up tables on ``device``, entry
    t from ``_beta(t, recipe)``."""
    device = torch.device(device)
    key = (recipe.iters, recipe.ada_warmup, recipe.ada_beta_start,
           recipe.ada_beta_end, device)
    got = _TABLES.get(key)
    if got is None:
        rows = [_beta(t, recipe) for t in range(recipe.iters)]
        got = _TABLES[key] = (
            torch.tensor([b for b, _ in rows], dtype=torch.float32,
                         device=device),
            torch.tensor([w for _, w in rows], dtype=torch.bool,
                         device=device))
    return got


def loss_extra(state, qcfg, step, recipe) -> torch.Tensor:
    """Annealed rounding regularizer pushing h(V) to {0, 1}; ``step`` is
    the step index as a (1,) int64 tensor on the state's device. β and the
    warm-up flag are read from ``beta_tables`` on the device, and the
    warm-up is the reference's ``where()``: zero, with zero gradient."""
    beta_t, warm_t = beta_tables(recipe, state["v"].device)
    beta = beta_t.index_select(0, step).reshape(())
    warm = warm_t.index_select(0, step).reshape(())
    h = rectified_sigmoid(state["v"])
    reg = recipe.ada_lambda * torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** beta)
    return torch.where(warm, torch.zeros_like(reg), reg)


def trainable(state: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    return {k: (k == "v") for k in state}


def project(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return state


def export(w: torch.Tensor, state: Dict[str, torch.Tensor], qcfg: QuantConfig,
           dtype=torch.bfloat16) -> qtensor.QTensor:
    q = _codes(w, state, qcfg, hard=True)
    return qtensor.from_codes(q, state["s1"], state["zero"], qcfg, dtype=dtype)


method_api.register_method("adaround")(sys.modules[__name__])
