"""llama4-scout-17b-a16e — MoE 16e top-1 + shared expert [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Modeled as full-attention (chunked-attention variant not modeled) => skips
long_500k; vision early-fusion out of scope for the text backbone cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, n_experts=16, top_k=1,
    n_shared_experts=1, moe_d_ff=8192, rope_theta=5e5, act="swiglu",
    moe_group=1024)
