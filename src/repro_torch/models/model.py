"""Model registry: family -> implementation class (dense, moe, vlm, encdec
and ssm so far)."""
from __future__ import annotations

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.ssm import MambaLM
from repro_torch.models.transformer import TransformerLM


def build_model(cfg):
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    if cfg.family == "ssm":
        return MambaLM(cfg)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                              "(ROADMAP Queue 1 item 9)")
