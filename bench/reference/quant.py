"""Plain quantizers of the paper's procedure, float32 throughout.

- weights: asymmetric uniform grids per output channel (the last axis of
  ``W[d_in, d_out]``), from the range (``minmax``) or from 80 shrink factors
  of it minimising the squared error (``mse``);
- FlexRound (Eq. 2): ``s1 * (clip(round(W / (s1 * S2 * s3)) + z) - z)``,
  round with a straight-through gradient;
- LSQ activations: ``s * clip(round((x - b) / s), 0, 255) + b`` with LSQ's
  gradient scale ``1 / sqrt(numel * qmax)``; at deployment ``b`` is snapped
  to the grid (zero point ``round(-b / s)``);
- QDrop: where a uniform draw is below the drop probability an element
  keeps its full-precision value;
- Adam with bias correction, per-leaf learning rates;
- ``fp8``: a tensor rounded to float8 e4m3 with a per-row absmax scale (the
  precision below bfloat16, for the controls).

Clips are ``minimum(maximum(.))``, whose gradient is 1/2 where the input
sits on a bound.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

MSE_FACTORS = 80


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return x + (torch.round(x) - x).detach()


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _grid_from_range(lo: torch.Tensor, hi: torch.Tensor, bits: int):
    levels = 2 ** bits - 1
    lo = torch.clamp(lo, max=0.0)
    hi = torch.clamp(hi, min=0.0)
    scale = torch.clamp((hi - lo) / levels, min=1e-8)
    zero = torch.clamp(torch.round(-lo / scale), 0, levels)
    return scale, zero


def minmax_grid(w: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero), each (1, N), of ``w`` (K, N) per output channel."""
    w = w.float()
    return _grid_from_range(w.amin(0, keepdim=True), w.amax(0, keepdim=True),
                            bits)


def mse_grid(w: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid of the shrink factor p in linspace(0.2, 1, 80) whose
    round-to-nearest weight is closest to ``w`` per channel (the first
    factor wins a tie)."""
    w = w.float()
    lo, hi = w.amin(0, keepdim=True), w.amax(0, keepdim=True)
    levels = 2 ** bits - 1
    best = scale = zero = None
    for i in range(MSE_FACTORS):
        p = 0.2 + 0.8 * i / (MSE_FACTORS - 1)
        s, z = _grid_from_range(lo * p, hi * p, bits)
        q = torch.clamp(torch.round(w / s) + z, 0, levels)
        err = torch.sum(torch.square(s * (q - z) - w), dim=0, keepdim=True)
        if best is None:
            best, scale, zero = err, s, z
            continue
        better = err < best
        best = torch.where(better, err, best)
        scale = torch.where(better, s, scale)
        zero = torch.where(better, z, zero)
    return scale, zero


def grid(w: torch.Tensor, bits: int, observer: str):
    return (mse_grid if observer == "mse" else minmax_grid)(w, bits)


def dequant(codes: torch.Tensor, scale: torch.Tensor,
            zero: torch.Tensor) -> torch.Tensor:
    return scale * (codes.float() - zero)


def rtn_weight(w: torch.Tensor, bits: int, observer: str) -> torch.Tensor:
    """Round-to-nearest weight on the observer's grid, float32."""
    s, z = grid(w, bits, observer)
    q = torch.clamp(torch.round(w.float() / s) + z, 0, 2 ** bits - 1)
    return dequant(q, s, z)


def flexround_init(w: torch.Tensor, bits: int, observer: str) -> Dict[str, torch.Tensor]:
    s1, z = grid(w, bits, observer)
    return {"s1": s1, "s2": torch.ones_like(w, dtype=torch.float32),
            "s3": torch.ones_like(s1), "zero": z}


def flexround_weight(w: torch.Tensor, st: Dict[str, torch.Tensor],
                     bits: int) -> torch.Tensor:
    q = clip(ste_round(w.float() / (st["s1"] * st["s2"] * st["s3"]))
             + st["zero"], 0.0, 2.0 ** bits - 1)
    return st["s1"] * (q - st["zero"])


def lsq_init(lo: float, hi: float, bits: int = 8) -> Dict[str, torch.Tensor]:
    lo, hi = min(lo, 0.0), max(hi, 0.0)
    step = max((hi - lo) / (2 ** bits - 1), 1e-8)
    return {"step": torch.tensor(step), "beta": torch.tensor(lo)}


def lsq_act(x: torch.Tensor, st: Dict[str, torch.Tensor],
            bits: int = 8) -> torch.Tensor:
    qmax = 2 ** bits - 1
    g = 1.0 / math.sqrt(x.numel() * qmax)
    s = st["step"] * g + (st["step"] - st["step"] * g).detach()
    b = st["beta"] * g + (st["beta"] - st["beta"] * g).detach()
    return s * clip(ste_round((x - b) / s), 0.0, float(qmax)) + b


def deploy_act(x: torch.Tensor, st: Dict[str, torch.Tensor],
               bits: int = 8) -> torch.Tensor:
    """The static activation grid of deployment: the zero point
    ``round(-b / s)`` on [0, 2^bits - 1]."""
    qmax = 2 ** bits - 1
    s = st["step"].float()
    z = torch.clamp(torch.round(-st["beta"].float() / s), 0, qmax)
    return s * (torch.clamp(torch.round(x / s) + z, 0, qmax) - z)


def qdrop(x_fp: torch.Tensor, x_q: torch.Tensor, gen: torch.Generator,
          keep_prob: float) -> torch.Tensor:
    keep = torch.rand(x_fp.shape, generator=gen, device=x_fp.device) < keep_prob
    return torch.where(keep, x_fp, x_q)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-row absmax scale (448 at
    the row's largest magnitude), back in float32; the gradient passes
    straight through."""
    with torch.no_grad():
        amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
        s = amax / 448.0
        q = (x / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


class Adam:
    """Adam over a list of float32 leaves with per-leaf learning rates."""

    def __init__(self, leaves, lrs, b1=0.9, b2=0.999, eps=1e-8):
        self.leaves, self.lrs = leaves, lrs
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v, lr in zip(self.leaves, grads, self.m, self.v, self.lrs):
            g = torch.zeros_like(p) if g is None else g
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
