"""phi-3-vision-4.2b — phi3-mini backbone; CLIP frontend STUBBED [hf:microsoft/Phi-3-vision-128k-instruct; hf].

input_specs feeds precomputed patch embeddings (B, n_patches, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064, norm="rmsnorm",
    act="swiglu", frontend="vision_stub", n_patches=256)
