"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, MTP [arXiv:2412.19437; hf].

Assignment d_ff=2048 is the per-expert FF width (moe_d_ff); the 3 leading
dense layers use the published 18432. MLA decode uses the weight-absorbed
latent-cache form.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, d_ff=18432, vocab=129280, n_experts=256,
    top_k=8, n_shared_experts=1, moe_d_ff=2048, first_dense=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128, head_dim=192, mtp=True, act="swiglu",
    moe_group=128, capacity_factor=1.25)
