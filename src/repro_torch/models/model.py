"""Model registry: family -> implementation class (dense, moe and vlm so
far)."""
from __future__ import annotations

from repro_torch.models.transformer import TransformerLM


def build_model(cfg):
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                              "(ROADMAP Queue 1 item 9)")
