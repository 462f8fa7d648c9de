"""Model registry: family -> implementation class (dense only so far)."""
from __future__ import annotations

from repro_torch.models.transformer import TransformerLM


def build_model(cfg):
    if cfg.family == "dense":
        return TransformerLM(cfg)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet, "
                              "see ROADMAP")
