"""Shared model components: norms, RoPE, the SwiGLU MLP, embeddings (port
of ``repro/models/common.py``). The reference's ``stack_layers`` /
``scan_layers`` become a plain Python loop over a list of per-layer dicts in
the models."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.context import QuantCtx


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())  # gamma stored zero-centred
    return y.to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, p: Optional[dict]) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"] if p else None)
    raise ValueError(f"norm {kind!r} is not ported yet, see ROADMAP")


def norm_params(kind: str, d: int, dtype, device) -> Optional[dict]:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(f"norm {kind!r} is not ported yet, see ROADMAP")


def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> sin/cos (..., head_dim/2) in float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); sin/cos: (B or 1, S, D/2). Rotate-half convention."""
    x32 = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    s = sin[:, :, None, :]
    c = cos[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def mlp(p: dict, x: torch.Tensor, ctx: QuantCtx, name: str,
        act: str = "swiglu", batch_dims: int = 0) -> torch.Tensor:
    """SwiGLU MLP; every matmul quantizable via ctx. ``batch_dims=1``: the
    weights are stacked experts (E, d_in, d_out) and x is (..., E, n, d_in)."""
    if act != "swiglu":
        raise ValueError(f"act {act!r} is not ported yet, see ROADMAP")
    g = ctx.linear(f"{name}.w_gate", x, p["w_gate"], batch_dims=batch_dims)
    u = ctx.linear(f"{name}.w_up", x, p["w_up"], batch_dims=batch_dims)
    h = F.silu(g.float()).to(x.dtype) * u
    return ctx.linear(f"{name}.w_down", h, p["w_down"], batch_dims=batch_dims)


def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, dtype,
               device, lead: tuple = ()) -> dict:
    """SwiGLU weights; ``lead=(E,)`` stacks E experts in front."""
    std_in = d_model**-0.5
    std_out = d_ff**-0.5
    return {
        "w_up": normal(gen, lead + (d_model, d_ff), std_in, dtype, device),
        "w_down": normal(gen, lead + (d_ff, d_model), std_out, dtype, device),
        "w_gate": normal(gen, lead + (d_model, d_ff), std_in, dtype, device),
    }


def normal(gen: torch.Generator, shape, std: float, dtype, device):
    """N(0, std^2) drawn on the generator's device, then moved."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * std
    return t.to(device=device, dtype=dtype)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 mult: float = 1.0) -> torch.Tensor:
    return embed[tokens] * mult
