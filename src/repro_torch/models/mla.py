"""Multi-head Latent Attention (DeepSeek-V2/V3), port of
``repro/models/mla.py``.

Train/prefill expand the compressed latent into full per-head K/V; decode uses
the weight-absorbed form so the KV cache is only (kv_lora_rank + qk_rope_dim)
per token — the memory-term win that makes deepseek long-context decode cheap.
"""
from __future__ import annotations

import torch

from repro_torch.core.context import QuantCtx
from repro_torch.core.reconstruct import Site
from repro_torch.models import attention as attn
from repro_torch.models import common


def mla_params(gen: torch.Generator, cfg, dtype, device) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    s = D**-0.5
    normal = common.normal
    return {
        "wq_a": normal(gen, (D, rq), s, dtype, device),
        "q_norm": common.norm_params("rmsnorm", rq, dtype, device),
        "wq_b": normal(gen, (rq, H * (dn + dr)), rq**-0.5, dtype, device),
        "wkv_a": normal(gen, (D, rkv + dr), s, dtype, device),
        "kv_norm": common.norm_params("rmsnorm", rkv, dtype, device),
        "wkv_b": normal(gen, (rkv, H * (dn + dv)), rkv**-0.5, dtype, device),
        "wo": normal(gen, (H * dv, D), (H * dv) ** -0.5, dtype, device),
    }


def _q_proj(p, x, cfg, ctx, name, sin, cos):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = common.keep_placement(ctx.linear(f"{name}.wq_a", x, p["wq_a"]))
    cq = common.rmsnorm(cq, p["q_norm"]["scale"])
    q = ctx.linear(f"{name}.wq_b", cq, p["wq_b"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, common.apply_rope(q_rope, sin, cos)


def _kv_latent(p, x, cfg, ctx, name, sin, cos):
    """x (B, S, D) -> the normed latent ckv (B, S, rkv) and the shared
    roped key k_rope (B, S, dr): what the decode cache holds."""
    rkv = cfg.kv_lora_rank
    ckv_full = ctx.linear(f"{name}.wkv_a", x, p["wkv_a"])
    ckv, k_rope = ckv_full[..., :rkv], ckv_full[..., rkv:]
    ckv = common.rmsnorm(ckv, p["kv_norm"]["scale"])
    k_rope = common.apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0]
    return ckv, k_rope


def mla_forward(p, x, cfg, ctx: QuantCtx, name, sin, cos):
    """Full-sequence MLA (train / teacher). Returns (out, (ckv, k_rope))."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _q_proj(p, x, cfg, ctx, name, sin, cos)
    ckv, k_rope = _kv_latent(p, x, cfg, ctx, name, sin, cos)

    kv = ctx.linear(f"{name}.wkv_b", ckv, p["wkv_b"]).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attn.attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    out = ctx.linear(f"{name}.wo", common.merge_heads(o), p["wo"])
    return out, (ckv, k_rope)


def mla_decode(p, x, cfg, ctx: QuantCtx, name, sin, cos, ckv_cache, kr_cache,
               pos):
    """Absorbed single-token decode against the latent cache.

    ckv_cache: (B, Smax, rkv) with the current token already inserted;
    kr_cache:  (B, Smax, dr); ``pos`` the current token's index (scalar).
    ``wkv_b`` is never applied to the cache: its key half folds into the
    query and its value half into the output, in float32.
    """
    B = x.shape[0]
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    rkv = cfg.kv_lora_rank
    q_nope, q_rope = _q_proj(p, x, cfg, ctx, name, sin, cos)  # (B,1,H,*)
    q_nope, q_rope = attn.batch_only(q_nope), attn.batch_only(q_rope)

    wkv_b = ctx.get_weight(f"{name}.wkv_b", p["wkv_b"]).reshape(rkv, H, dn + dv)
    w_kb, w_vb = wkv_b[..., :dn].float(), wkv_b[..., dn:].float()
    # absorb the key projection into q: (B,1,H,dn)x(r,H,dn)->(B,1,H,r)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_kb)
    ckv32 = ckv_cache.float()
    scale = (dn + dr) ** -0.5
    s = (common.einsum("bqhr,bsr->bhqs", q_abs, ckv32)
         + common.einsum("bqhd,bsd->bhqs", q_rope.float(),
                         kr_cache.float())) * scale
    valid = attn.pos_mask(pos, B, ckv_cache.shape[1], 0, x.device)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, attn.NEG_INF))
    pr = attn.softmax_last(s)
    o_lat = common.einsum("bhqs,bsr->bqhr", pr, ckv32)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, w_vb)
    return ctx.linear(f"{name}.wo", o.reshape(B, 1, H * dv).to(x.dtype),
                      p["wo"])


def mla_sites(prefix: str, cfg) -> dict:
    names = ["wq_a", "wq_b", "wkv_a", "wkv_b", "wo"]
    return {f"{prefix}.{n}": Site(("attn", n)) for n in names}
