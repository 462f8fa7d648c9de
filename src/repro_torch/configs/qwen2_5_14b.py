"""qwen2.5-14b — dense GQA + QKV bias [hf:Qwen/Qwen2.5-*; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=13824, vocab=152064, attn_bias=True,
    rope_theta=1e6, norm="rmsnorm", act="swiglu")
