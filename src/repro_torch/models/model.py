"""Model registry: family -> implementation class, for the six families
(dense, moe, vlm, encdec, ssm, hybrid)."""
from __future__ import annotations

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.rglru import GriffinLM
from repro_torch.models.ssm import MambaLM
from repro_torch.models.transformer import TransformerLM

_FAMILIES = {"dense": TransformerLM, "moe": TransformerLM,
             "vlm": TransformerLM, "encdec": EncDecLM, "ssm": MambaLM,
             "hybrid": GriffinLM}


def build_model(cfg):
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; known: "
                         f"{sorted(_FAMILIES)}") from None
    return cls(cfg)
