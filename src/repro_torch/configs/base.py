"""ArchConfig: one dataclass describing every assigned architecture.

A copy of ``repro/configs/base.py`` (the port imports nothing of ``repro``),
field for field, for the six families: dense, moe, vlm, encdec, ssm and
hybrid.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention / norms / acts
    attn_bias: bool = False          # qwen-style QKV bias
    rope_theta: float = 10000.0
    local_window: int = 0            # sliding-window size (0 = global)
    norm: str = "rmsnorm"            # rmsnorm | layernorm | layernorm_nonparam
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    sub_quadratic: bool = False      # supports long_500k decode

    # granite-style muP multipliers
    emb_mult: float = 1.0
    resid_mult: float = 1.0
    logit_mult: float = 1.0

    # MoE
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense: int = 0             # leading dense layers (deepseek)
    capacity_factor: float = 1.25
    moe_group: int = 2048

    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mtp: bool = False                # multi-token-prediction head

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64

    # hybrid (recurrentgemma): layer pattern string, e.g. "RRA"
    layer_pattern: str = ""
    lru_width: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0

    # modality frontend stub (audio/vision): inputs include precomputed embeds
    frontend: str = "none"           # none | audio_stub | vision_stub
    n_patches: int = 0               # vision_stub: patches per image

    # numerics / execution
    dtype: str = "bfloat16"
    attn_chunk: int = 1024
    remat: bool = True
    xent_chunk: int = 512

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> Tuple[int, int]:
        """(total, active) parameter estimates for MODEL_FLOPS."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        Dh = self.head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            d_in = self.ssm_expand * D
            per = D * 2 * d_in + d_in * D + d_in * (2 * self.ssm_state + 2)
            tot = emb + L * per
            return tot, tot
        attn = D * (self.n_heads * Dh) * 2 + D * (self.n_kv_heads * Dh) * 2
        if self.use_mla:
            r, rq = self.kv_lora_rank, self.q_lora_rank
            dn, dr, dv = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
            H = self.n_heads
            attn = (D * rq + rq * H * (dn + dr) + D * (r + dr)
                    + r * H * (dn + dv) + H * dv * D)
        mlp_mult = 3 if self.act == "swiglu" else 2
        dense_mlp = mlp_mult * D * F
        if self.is_moe:
            moe_mlp = mlp_mult * D * self.moe_d_ff
            shared = mlp_mult * D * self.moe_d_ff * self.n_shared_experts
            n_moe = L - self.first_dense
            tot = (emb + L * attn + self.first_dense * dense_mlp
                   + n_moe * (self.n_experts * moe_mlp + shared + D * self.n_experts))
            act = (emb + L * attn + self.first_dense * dense_mlp
                   + n_moe * (self.top_k * moe_mlp + shared + D * self.n_experts))
            return tot, act
        n_attn_layers = L + self.enc_layers
        tot = emb + n_attn_layers * (attn + dense_mlp)
        if self.enc_layers:  # cross attention in decoder
            tot += L * attn
        # hybrid: RG-LRU blocks replace attention in R layers, counted as
        # attention (about the same size)
        return tot, tot


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink a config to smoke-test size, preserving structure (the
    reference's ``reduced``): 2 layers (3 for the hybrid family, one
    ``RRA`` period), d_model 64, 4 heads of 16, vocab 128, float32."""
    n_layers = {"hybrid": 3}.get(cfg.family, 2)
    if cfg.first_dense:
        n_layers = 2  # one dense + one moe
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=max(n_layers, 2 if cfg.enc_layers else n_layers),
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128,
        vocab=128,
        local_window=min(cfg.local_window, 16) if cfg.local_window else 0,
        moe_group=64,
        attn_chunk=32,
        xent_chunk=32,
        remat=False,
        dtype="float32",
    )
    if cfg.is_moe:
        # capacity_factor=8 makes the reduced config dropless so decode vs
        # full-forward consistency is exact (production keeps 1.25 + drops)
        changes.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=64,
                       first_dense=min(cfg.first_dense, 1),
                       capacity_factor=8.0)
    if cfg.use_mla:
        changes.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
                       qk_rope_dim=8, v_head_dim=16, head_dim=24)
    if cfg.family == "ssm":
        changes.update(ssm_state=16, ssm_headdim=16)
    if cfg.family == "hybrid":
        changes.update(layer_pattern=cfg.layer_pattern, lru_width=64)
    if cfg.enc_layers:
        changes.update(enc_layers=2)
    if cfg.n_patches:
        changes.update(n_patches=8)
    return dataclasses.replace(cfg, **changes)
