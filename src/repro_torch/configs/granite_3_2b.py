"""granite-3-2b — GQA + muP-style multipliers [hf:ibm-granite/granite-3.0-2b-base; hf].

vocab 49155 is NOT divisible by the model mesh axis (16): embedding/lm_head
shard along d_model instead (see launch/sharding.py).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155, norm="rmsnorm",
    act="swiglu", emb_mult=12.0, resid_mult=0.22, logit_mult=1.0 / 8.0,
    tie_embeddings=True)
