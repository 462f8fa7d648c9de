"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060; hf
state-spaces/mamba2-130m].

Attention-free, O(1) decode state.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, ssm_state=128, ssm_conv=4,
    ssm_expand=2, ssm_headdim=64, sub_quadratic=True, attn_chunk=256)
