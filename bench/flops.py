"""Operations and bytes, frozen with the benchmark.

``layer_linear_params`` and ``attn_flops_token`` are copies of
``repro_torch/roofline/analytic.py`` (``_layer_linear_params``,
``_attn_flops_token``) as they stood when the benchmark was defined, so a
later change to the program's arithmetic cannot move the ``mfu`` metrics.
They take any object with the configuration's fields as attributes
(``arch_ns`` makes one from a configuration file's ``arch``).
The dequant-matmul functions count what K1 and K2 need: each input byte
read once, each output byte written once.
"""
from __future__ import annotations

import types
from typing import Any, Dict


def arch_ns(arch: Dict[str, Any]) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(**arch)
    if not getattr(ns, "head_dim", 0):
        ns.head_dim = ns.d_model // ns.n_heads
    ns.is_moe = getattr(ns, "n_experts", 0) > 0
    return ns


def layer_linear_params(cfg) -> Dict[str, float]:
    """Per-layer linear param counts: attention, dense-mlp, moe (active,
    incl. capacity padding), shared, router."""
    D, F, Dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.use_mla:
        rq, r = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        attn = (D * rq + rq * H * (dn + dr) + D * (r + dr)
                + r * H * (dn + dv) + H * dv * D)
    elif cfg.family == "ssm":
        d_inner = cfg.ssm_expand * D
        mlp = D * (2 * d_inner + 2 * cfg.ssm_state
                   + d_inner // cfg.ssm_headdim) + d_inner * D
        return {"attn": 0.0, "mlp": mlp, "moe_active": 0.0, "router": 0.0}
    else:
        attn = D * H * Dh * 2 + D * Hkv * Dh * 2
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    mlp = mult * D * F
    out = {"attn": attn, "mlp": mlp, "moe_active": 0.0, "router": 0.0}
    if cfg.is_moe:
        out["moe_active"] = (cfg.top_k * cfg.capacity_factor
                             * mult * D * cfg.moe_d_ff
                             + cfg.n_shared_experts * mult * D * cfg.moe_d_ff)
        out["router"] = D * cfg.n_experts
    return out


def attn_flops_token(cfg, s_ctx: float, qchunked: bool = True) -> float:
    """Attention score+value flops per token at context length s_ctx.
    qchunked: causal q-chunk KV truncation applies (train/prefill only;
    decode always reads the whole cache)."""
    if cfg.family == "ssm":
        Q = cfg.attn_chunk
        H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
        P, N = cfg.ssm_headdim, cfg.ssm_state
        return 2 * Q * N + 2 * Q * H * P + 4 * N * H * P
    Dh_qk = (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.use_mla else cfg.head_dim
    Dh_v = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
    if cfg.local_window:
        s_eff = min(s_ctx, cfg.local_window)
    elif qchunked and s_ctx > cfg.attn_chunk:
        n = min(4 if s_ctx <= 8192 else 2, int(s_ctx) // cfg.attn_chunk)
        s_eff = s_ctx * (n + 1) / (2 * n)
    else:
        s_eff = s_ctx
    per_layer = 2 * cfg.n_heads * s_eff * (Dh_qk + Dh_v)
    if cfg.family == "hybrid":
        return per_layer / 3.0
    return per_layer


# ------------------------------------------------------- whole-model counts
def dense_linear_flops_token(arch: Dict[str, Any]) -> float:
    """Matmul flops of one token through every layer's linears (dense)."""
    p = layer_linear_params(arch_ns(arch))
    return 2.0 * arch["n_layers"] * (p["attn"] + p["mlp"])


def block_forward_flops(arch: Dict[str, Any], batch: int, seq: int) -> float:
    """One layer's forward over ``batch`` sequences of ``seq`` tokens, its
    causal attention counted as the chunked program computes it."""
    ns = arch_ns(arch)
    p = layer_linear_params(ns)
    tokens = batch * seq
    return tokens * (2.0 * (p["attn"] + p["mlp"])
                     + attn_flops_token(ns, float(seq), qchunked=True))


def recon_step_flops(arch: Dict[str, Any], batch: int, seq: int) -> float:
    """A reconstruction step: the block's forward and its backward, 3x the
    forward."""
    return 3.0 * block_forward_flops(arch, batch, seq)


def attn_flops_context(arch: Dict[str, Any], n_ctx: int) -> float:
    """Score and value flops of one token attending to ``n_ctx`` keys, all
    layers."""
    ns = arch_ns(arch)
    return arch["n_layers"] * attn_flops_token(ns, float(n_ctx), qchunked=False)


def head_flops(arch: Dict[str, Any]) -> float:
    return 2.0 * arch["d_model"] * arch["vocab"]


def prefill_flops(arch: Dict[str, Any], n: int) -> float:
    """A prompt of ``n`` tokens: every token's linears and its causal
    attention over the real prefix, and the logits of the last position."""
    ns = arch_ns(arch)
    attn_pair = arch["n_layers"] * 2 * ns.n_heads * 2 * ns.head_dim
    return (n * dense_linear_flops_token(arch) + attn_pair * n * (n + 1) / 2
            + head_flops(arch))


def decode_flops(arch: Dict[str, Any], n_ctx: int) -> float:
    """One generated token at context ``n_ctx`` (itself included)."""
    return (dense_linear_flops_token(arch) + attn_flops_context(arch, n_ctx)
            + head_flops(arch))


# ------------------------------------------------------------ kernels K1/K2
def dequant_matmul_ops(M: int, K: int, N: int) -> float:
    return 2.0 * M * K * N


def dequant_matmul_bytes(M: int, K: int, N: int, bits: int,
                         x_bytes: int = 2) -> float:
    """x (M, K) read, codes (K, N) at ``bits`` read, per-channel float32
    scale and zero read, out (M, N) written in x's dtype."""
    return M * K * x_bytes + K * N * bits / 8.0 + 2 * N * 4 + M * N * x_bytes


def least_seconds(ops: float, nbytes: float, card: Dict[str, float],
                  in_type: str = "bfloat16") -> float:
    return max(ops / card[in_type], nbytes / card["hbm_bytes_per_s"])
