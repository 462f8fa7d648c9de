"""Mixture-of-Experts FFN, GShard/Switch-style einsum dispatch (port of
``repro/models/moe.py``).

Capacity-based top-k routing with group-local position assignment: tokens
are viewed as (G groups, N tokens), and each expert takes at most C tokens
of a group (``_capacity``); the rest are dropped. The router stays full
precision (float32); the expert weights are quantizable through
``ctx.linear`` with ``batch_dims=1`` (per-expert FlexRound scales). In
deploy mode the stacked (E, d_in, d_out) QTensor experts go to the
per-expert dequant-matmul kernel (K5), so the stack is never dequantized in
device memory.

The reference's mesh placement (``shard_hint`` and the expert-axis choice)
has no counterpart here. The dispatch stays the reference's dense one-hot
einsum.

**Under data parallelism** (``ctx.rows``, a ``core.context.BatchRows``:
this rank holds rows [lo, hi) of a global batch) the reference's GSPMD
program routes the global batch's tokens, so the group size ``N`` is
picked from the global token count. Where this rank's rows are whole
global groups, it routes them as they are. Where they are not, it gathers
the MoE input over the data group (the other ranks' rows exact and
without gradient, its own rows live), routes the global groups and keeps
its own rows of the output. A row's output then depends on the other rows
only through the discrete dispatch, so the ranks' gradients sum to one
process's. QDrop draws of the expert sites are then made at the global
shape (``qdrop.whole_batch``). In ``capture`` mode the gathered expert
inputs are the global batch's on every rank; the layer-wise
reconstruction refuses them (``context.GATHERED``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import qdrop
from repro_torch.core.context import GATHERED, QuantCtx
from repro_torch.core.reconstruct import Site
from repro_torch.models import common


def moe_params(gen: torch.Generator, cfg, dtype, device) -> dict:
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": common.normal(gen, (D, E), D**-0.5, torch.float32, device),
        "experts": common.mlp_params(gen, D, Fd, cfg.act, dtype, device,
                                      lead=(E,)),
    }
    if cfg.n_shared_experts:
        p["shared"] = common.mlp_params(gen, D, Fd * cfg.n_shared_experts,
                                        cfg.act, dtype, device)
    return p


def _capacity(n: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(n * top_k * factor / n_experts)
    return max(4, ((c + 3) // 4) * 4)


def _pick_group(tokens: int, target: int) -> int:
    """Largest divisor of ``tokens`` that is <= target (group size)."""
    for n in range(target, 0, -1):
        if tokens % n == 0:
            return n
    return 1


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, ties
    broken toward the lower index as ``jax.lax.top_k`` does (a stable
    descending sort; ``torch.topk`` promises no order among equals)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, xt: torch.Tensor, cfg):
    """Router of one group batch xt (G, N, D): returns (probs (G, N, E),
    top-k indices (G, N, K), dispatch and combine masks (G, N, E, C) in
    float32)."""
    G, N, _ = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(N, K, E, cfg.capacity_factor)
    logits = (xt.float() @ p["router"].float()).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)  # renormalize top-k

    counts = torch.zeros((G, E), dtype=torch.int32, device=xt.device)
    dispatch = torch.zeros((G, N, E, C), dtype=torch.float32, device=xt.device)
    combine = torch.zeros_like(dispatch)
    for j in range(K):  # K is small and static (1..8)
        onehot = F.one_hot(idx[..., j], E).to(torch.int32)  # (G, N, E)
        pos = counts[:, None, :] + torch.cumsum(onehot, dim=1,
                                                dtype=torch.int32) - onehot
        within = (pos < C) & (onehot > 0)
        # one_hot of the out-of-range index C is all zeros, as in jax
        pos_oh = F.one_hot(torch.where(within, pos, C).long(),
                           C + 1)[..., :C].float()
        d_j = torch.where(within[..., None], pos_oh, 0.0)  # (G, N, E, C)
        dispatch = dispatch + d_j
        combine = combine + d_j * gate_vals[..., j][..., None, None]
        counts = counts + onehot.sum(dim=1, dtype=torch.int32)
    return probs, idx, dispatch, combine


def _routed(p: dict, x: torch.Tensor, N: int, cfg, ctx: QuantCtx,
            name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts over x (B, S, D) in groups of N tokens: (y, aux)."""
    B, S, D = x.shape
    E = cfg.n_experts
    xt = x.reshape(B * S // N, N, D)
    probs, _, dispatch, combine = route(p, xt, cfg)

    xd = x.dtype
    xe = torch.einsum("gnec,gnd->gecd", dispatch.to(xd), xt)  # (G, E, C, D)
    ye = common.mlp(p["experts"], xe, ctx, f"{name}.experts", cfg.act,
                    batch_dims=1)
    y = torch.einsum("gnec,gecd->gnd", combine.to(xd), ye).reshape(B, S, D)

    # auxiliary load-balance loss (Switch eq. 4)
    me = torch.mean(probs, dim=(0, 1))  # (E,)
    fe = torch.mean(dispatch.sum(-1), dim=(0, 1))  # fraction dispatched
    return y, E * torch.sum(me * fe)


def moe_ffn(p: dict, x: torch.Tensor, cfg, ctx: QuantCtx,
            name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), Switch auxiliary load-balance loss).
    Under ``ctx.rows`` the groups are the global batch's (module
    docstring)."""
    B, S, D = x.shape
    rows = getattr(ctx, "rows", None)
    T = (B if rows is None else rows.total) * S  # the global program's
    N = _pick_group(T, min(cfg.moe_group, T))
    if rows is not None and B != rows.hi - rows.lo:
        raise ValueError(f"{name}: {B} rows, but ctx.rows holds rows "
                         f"[{rows.lo}, {rows.hi})")
    if rows is None or (rows.lo * S % N == 0 and B * S % N == 0):
        y, aux = _routed(p, x, N, cfg, ctx, name)
    else:  # this rank's rows split a global group: route the global batch
        if ctx.mode == "capture":
            ctx.records.setdefault(GATHERED, []).append(
                f"{name}: moe_group={cfg.moe_group} over {T} tokens groups "
                f"{N} tokens, which the {rows.dp.size} data ranks' "
                f"{B * S} tokens each do not divide")
        with qdrop.whole_batch():
            y, aux = _routed(p, rows.gather(x), N, cfg, ctx, name)
        y = y[rows.lo:rows.hi]

    if "shared" in p:
        y = y + common.mlp(p["shared"], x, ctx, f"{name}.shared", cfg.act)
    return y, aux


def moe_sites(prefix: str, cfg) -> dict:
    """Quantizable leaves of one MoE layer: the stacked experts (per-expert
    scales, ``batch_dims=1``) and the shared expert."""
    base = ("mlp", "experts")
    names = ["w_up", "w_down"] + (["w_gate"] if cfg.act == "swiglu" else [])
    sites = {f"{prefix}.experts.{n}": Site(base + (n,), batch_dims=1)
             for n in names}
    if cfg.n_shared_experts:
        sites.update({f"{prefix}.shared.{n}": Site(("mlp", "shared", n))
                      for n in names})
    return sites
