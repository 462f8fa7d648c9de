"""Analytic FLOP/byte model per (arch x shape x weights) cell (a copy of
``repro/roofline/analytic.py``, which holds no framework code).

The counts follow the program as implemented, not an ideal one. The port
computes what the reference computes, so its counts carry over unchanged:
its chunked attention (``models/attention.py``) splits causal queries as
the reference does (at most 4 query chunks up to 8k, 2 beyond, each
against its causal KV prefix; the full S^2 of each chunk's prefix is
computed, no block skipping), in float32, as the reference's einsums are.

Conventions (documented constants, conservative):
- matmul flops = 2*m*n*k; training multiplies matmul work by BWD_MULT=3
  (fwd + 2x bwd) plus REMAT_EXTRA=1 extra fwd when cfg.remat (full-remat
  policy) => 4x fwd total. MODEL_FLOPS (6*N*D) / analytic then exposes the
  remat + attention + MoE-capacity overheads as a ratio < 1.
- activation HBM traffic: ACT_RW tensor read/writes of (T_loc x width) per
  layer; fwd-only ACT_RW=6, training ACT_RW=14 (fwd write+bwd read of
  boundaries + remat recompute traffic).

Where the port's eager program moves more than this model counts (the
model is then a bound the eager program cannot reach, not a fault):
- decode reads the cache once here; the port's decode attention makes a
  float32 copy of each layer's K and V first (``attention.decode_attention``;
  ``serve/kv.int8_decode_attention`` of an int8 cache's codes), so it reads
  the cache, writes a float32 copy (2x a bf16 cache's bytes, 4x int8
  codes') and reads that again;
- the float32 attention einsums run at the card's float32 rate (TF32 is
  off, ``device.resolve_device``), while ``roofline.analysis`` prices every
  flop at the bf16 peak, as the reference prices it;
- the int8/int4 weight kernels stream their codes once (this model's
  weight bytes), but the plain versions (``backend="torch"``) dequantize
  each weight to bf16 first.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.shapes import ShapeSpec

BWD_MULT = 3.0
REMAT_EXTRA = 1.0
ACT_RW_FWD = 6.0
ACT_RW_TRAIN = 14.0

_WBYTES = {"bf16": 2.0, "int8": 1.0, "int4": 0.5}


def _layer_linear_params(cfg) -> Dict[str, float]:
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
        attn = 0.0
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


def _weight_bytes_total(cfg, wmode: str) -> float:
    """Total weight bytes (embeddings/norms bf16; linear sites in wmode)."""
    p = _layer_linear_params(cfg)
    D = cfg.d_model
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    wb = _WBYTES[wmode]
    lin = 0.0
    if cfg.is_moe:
        n_moe = cfg.n_layers - cfg.first_dense
        lin += cfg.first_dense * (p["attn"] + p["mlp"])
        lin += n_moe * (p["attn"] + cfg.n_experts * mult * D * cfg.moe_d_ff
                        + cfg.n_shared_experts * mult * D * cfg.moe_d_ff)
    else:
        n_attn = cfg.n_layers + cfg.enc_layers
        lin += n_attn * (p["attn"] + p["mlp"])
        if cfg.enc_layers:
            lin += cfg.n_layers * p["attn"]  # cross attention
    emb = cfg.vocab * D * (1 if cfg.tie_embeddings else 2) * 2.0  # bf16
    return lin * wb + emb


def _attn_flops_token(cfg, s_ctx: float, qchunked: bool = True) -> float:
    """Attention score+value flops per token at context length s_ctx.
    qchunked: causal q-chunk KV truncation applies (train/prefill only;
    decode always reads the whole cache)."""
    if cfg.family == "ssm":
        # SSD: intra-chunk quadratic + state passing
        Q = cfg.attn_chunk
        H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
        P, N = cfg.ssm_headdim, cfg.ssm_state
        return 2 * Q * N + 2 * Q * H * P + 4 * N * H * P
    Dh_qk = (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.use_mla else cfg.head_dim
    Dh_v = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
    if cfg.local_window:
        s_eff = min(s_ctx, cfg.local_window)
    elif qchunked and s_ctx > cfg.attn_chunk:
        # causal q-chunking truncates each chunk's KV prefix (4 chunks up to
        # 8k, 2 beyond, as models/attention.py does)
        n = min(4 if s_ctx <= 8192 else 2, int(s_ctx) // cfg.attn_chunk)
        s_eff = s_ctx * (n + 1) / (2 * n)
    else:
        s_eff = s_ctx
    per_layer = 2 * cfg.n_heads * s_eff * (Dh_qk + Dh_v)
    if cfg.family == "hybrid":
        # attention only in 1/3 of layers (RRA pattern); RG-LRU is linear
        return per_layer / 3.0
    return per_layer


def flops_cell(cfg, shape: ShapeSpec, training: bool) -> float:
    """Global FLOPs for one step, as implemented."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        T = B * S
        s_ctx = float(S)  # chunked impl computes full S^2
    elif shape.kind == "prefill":
        T = B * S
        s_ctx = float(S)
    else:
        T = B  # one token per sequence
        s_ctx = float(S)
    p = _layer_linear_params(cfg)
    per_tok_lin = 0.0
    if cfg.is_moe:
        n_moe = cfg.n_layers - cfg.first_dense
        per_tok_lin += cfg.first_dense * (p["attn"] + p["mlp"])
        per_tok_lin += n_moe * (p["attn"] + p["moe_active"] + p["router"])
        # dispatch + combine einsums: 2 x 2*E*C_frac*D per token
        c_frac = cfg.top_k * cfg.capacity_factor
        per_tok_lin += n_moe * 2 * 2 * c_frac * cfg.d_model
    else:
        per_tok_lin += (cfg.n_layers + cfg.enc_layers) * (p["attn"] + p["mlp"])
        if cfg.enc_layers:
            per_tok_lin += cfg.n_layers * p["attn"]  # cross attn projections
    head = 2 * cfg.d_model * cfg.vocab if shape.kind != "prefill" else 0
    qch = shape.kind != "decode"
    attn = cfg.n_layers * _attn_flops_token(cfg, s_ctx, qchunked=qch)
    if cfg.enc_layers:
        attn += cfg.enc_layers * _attn_flops_token(cfg, s_ctx,
                                                   qchunked=False)  # bidir
        attn += cfg.n_layers * 2 * cfg.n_heads * 1504 * 2 * cfg.head_dim
    fwd = T * (2 * per_tok_lin + attn) + (T * head if training else B * head)
    if training and cfg.mtp:
        fwd *= (cfg.n_layers + 1) / cfg.n_layers  # MTP extra block + head
    return fwd


def flops_cell_total(cfg, shape: ShapeSpec) -> float:
    f = flops_cell(cfg, shape, training=(shape.kind == "train"))
    if shape.kind == "train":
        mult = BWD_MULT + (REMAT_EXTRA if cfg.remat else 0.0)
        return f * (1 + mult)  # fwd + bwd (+ remat recompute)
    return f


def cache_bytes(cfg, shape: ShapeSpec) -> float:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_headdim
        per = (H * cfg.ssm_headdim * cfg.ssm_state * 4
               + (cfg.ssm_conv - 1) * (d_inner + 2 * cfg.ssm_state) * 4)
        return cfg.n_layers * B * per
    if cfg.family == "hybrid":
        W = min(cfg.local_window, S)
        n_attn = cfg.n_layers // 3
        n_rec = cfg.n_layers - n_attn
        return (n_attn * B * W * cfg.n_kv_heads * cfg.head_dim * 2 * 2
                + n_rec * B * cfg.lru_width * 4 * 2)
    if cfg.use_mla:
        return cfg.n_layers * B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    per = B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    tot = cfg.n_layers * per
    if cfg.enc_layers:
        tot += cfg.n_layers * B * 1504 * cfg.n_heads * cfg.head_dim * 2 * 2
    return tot


KV_INT8_FACTOR = 0.52  # int8 codes + per-(token,head) fp32 scale overhead


def hbm_bytes_cell(cfg, shape: ShapeSpec, wmode: str, *, mode: str = "tp",
                   n_dev: int = 256, kv: str = "bf16") -> float:
    """Global HBM traffic for one step (documented structural model).

    mode='dp' replicates weights: every chip reads the full weight set, so
    global weight traffic is wb * n_dev (this is what makes small-model
    decode on a big mesh memory-inefficient — §Perf smollm iteration).
    """
    B, S = shape.global_batch, shape.seq_len
    wb = _weight_bytes_total(cfg, "bf16" if shape.kind == "train" else wmode)
    w_rep = float(n_dev) if mode == "dp" else 1.0
    cb = cache_bytes(cfg, shape) * (KV_INT8_FACTOR if kv == "int8" else 1.0)
    dtype_b = 2.0
    if shape.kind == "train":
        T = B * S
        # params read fwd+bwd, grads written, adam moments r/w (bf16 moments)
        w_traffic = (wb * 2 + wb * 1 + wb * 2) * w_rep
        act = ACT_RW_TRAIN * T * cfg.d_model * cfg.n_layers * dtype_b
        return w_traffic + act
    if shape.kind == "prefill":
        T = B * S
        act = ACT_RW_FWD * T * cfg.d_model * (cfg.n_layers + cfg.enc_layers) \
            * dtype_b
        return wb * w_rep + act + cb  # cache written once
    # decode: weights + full cache read per token + small activations
    act = ACT_RW_FWD * B * cfg.d_model * cfg.n_layers * dtype_b
    return wb * w_rep + cb + act


def model_flops_ideal(cfg, shape: ShapeSpec) -> float:
    """6*N*D / 2*N*D with causal-optimal attention — the 'useful' flops."""
    total, active = cfg.param_count()
    n = active if cfg.is_moe else total
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch
