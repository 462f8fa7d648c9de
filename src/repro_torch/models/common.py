"""Shared model components: norms, RoPE, MLPs, embeddings and the chunked
cross entropy (port of ``repro/models/common.py``). The reference's
``stack_layers`` / ``scan_layers`` become a plain Python loop over a list of
per-layer dicts in the models."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.context import QuantCtx


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())  # gamma stored zero-centred
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()  # stored as ones, not zero-centred
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, p: Optional[dict]) -> torch.Tensor:
    """kind: rmsnorm | layernorm | layernorm_nonparam (OLMo)."""
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"] if p else None)
    if kind == "layernorm":
        return layernorm(x, p.get("scale") if p else None,
                         p.get("bias") if p else None)
    if kind == "layernorm_nonparam":
        return layernorm(x, None, None)
    raise ValueError(f"unknown norm {kind!r}")


def norm_params(kind: str, d: int, dtype, device) -> Optional[dict]:
    """The norm's parameters; None for ``layernorm_nonparam``, whose key the
    models then leave out of the tree, as the reference does."""
    if kind == "rmsnorm":  # gamma, applied as (1 + gamma)
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm_nonparam":
        return None
    raise ValueError(kind)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation, torch's gelu to erf
    return F.gelu(x, approximate="tanh")


def mlp(p: dict, x: torch.Tensor, ctx: QuantCtx, name: str,
        act: str = "swiglu", batch_dims: int = 0) -> torch.Tensor:
    """SwiGLU, GeGLU or GELU MLP; every matmul quantizable via ctx.
    ``batch_dims=1``: the weights are stacked experts (E, d_in, d_out) and x
    is (..., E, n, d_in)."""
    if act in ("swiglu", "geglu"):
        g = ctx.linear(f"{name}.w_gate", x, p["w_gate"], batch_dims=batch_dims)
        u = ctx.linear(f"{name}.w_up", x, p["w_up"], batch_dims=batch_dims)
        nl = F.silu if act == "swiglu" else gelu
        h = nl(g.float()).to(x.dtype) * u
    elif act == "gelu":
        h = ctx.linear(f"{name}.w_up", x, p["w_up"], p.get("b_up"),
                       batch_dims=batch_dims)
        h = gelu(h.float()).to(x.dtype)
    else:
        raise ValueError(f"unknown act {act!r}")
    return ctx.linear(f"{name}.w_down", h, p["w_down"], p.get("b_down"),
                      batch_dims=batch_dims)


def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype,
               device, lead: tuple = ()) -> dict:
    """MLP weights; ``w_gate`` only for the gated acts (swiglu, geglu);
    ``lead=(E,)`` stacks E experts in front."""
    std_in = d_model**-0.5
    std_out = d_ff**-0.5
    p = {
        "w_up": normal(gen, lead + (d_model, d_ff), std_in, dtype, device),
        "w_down": normal(gen, lead + (d_ff, d_model), std_out, dtype, device),
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = normal(gen, lead + (d_model, d_ff), std_in, dtype,
                             device)
    return p


def normal(gen: torch.Generator, shape, std: float, dtype, device):
    """N(0, std^2) drawn on the generator's device, then moved."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * std
    return t.to(device=device, dtype=dtype)


def remat_call(enabled: bool, fn, *args):
    """``fn(*args)``; when ``enabled`` and autograd records, through
    ``torch.utils.checkpoint`` (non-reentrant): the activations inside
    ``fn`` are recomputed in the backward instead of kept, the reference's
    ``jax.checkpoint`` under ``cfg.remat``. Values and gradients are
    unchanged."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 mult: float = 1.0) -> torch.Tensor:
    """The rows of ``embed`` at ``tokens`` times ``mult``. Through
    ``F.embedding``, whose backward sums each row's gradients in a fixed
    order on the CPU; indexing's backward (``index_put_`` with
    ``accumulate=True``) adds them with atomics there, so a training run
    and its resumed copy would differ in the last bits."""
    return F.embedding(tokens, embed) * mult


def _chunk_loss(xb: torch.Tensor, lb: torch.Tensor, mb: torch.Tensor,
                w_out: torch.Tensor, logit_scale: float):
    logits = (xb.float() @ w_out.float()) * logit_scale
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb[..., None])[..., 0]
    return torch.sum((lse - gold) * mb), torch.sum(mb)


def fused_cross_entropy(x: torch.Tensor, w_out: torch.Tensor,
                        labels: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, chunk: int = 512,
                        logit_scale: float = 1.0) -> torch.Tensor:
    """Mean next-token CE without materializing (B, S, V) logits.

    Loops over sequence chunks of ``chunk`` positions (a remainder becomes
    one extra chunk, padded, with mask 0); each chunk is recomputed in the
    backward pass (``torch.utils.checkpoint``), so peak memory is
    O(B * chunk * V) instead of O(B * S * V)."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    n_chunks = S // chunk
    rem = S - n_chunks * chunk
    mask = (torch.ones((B, S), dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    if rem:  # fold the remainder into one extra masked chunk via padding
        pad = chunk - rem
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        n_chunks += 1
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        l, n = checkpoint(_chunk_loss, x[:, sl], labels[:, sl].long(),
                          mask[:, sl], w_out, logit_scale,
                          use_reentrant=False)
        tot = tot + l
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
