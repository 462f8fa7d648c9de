"""recurrentgemma-2b — RG-LRU + local attention, pattern RRA
[arXiv:2402.19427; hf google/recurrentgemma-2b].

Sub-quadratic (an O(1) recurrent state and a 2048-token attention window).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
    local_window=2048, layer_pattern="RRA", lru_width=2560, act="geglu",
    norm="rmsnorm", sub_quadratic=True)
