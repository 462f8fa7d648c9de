"""Registry over the ported architecture configs.

The reference's ten architectures, in its order: the dense qwen2.5-14b,
smollm-135m, granite-3-2b and olmo-1b, the hybrid recurrentgemma-2b, the
MoE llama4-scout-17b-a16e and deepseek-v3-671b, the ssm mamba2-130m, the
encdec whisper-medium and the vlm phi-3-vision-4.2b. An unknown name raises
``KeyError`` listing them.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v3_671b,
    granite_3_2b,
    llama4_scout_17b_a16e,
    mamba2_130m,
    olmo_1b,
    phi3_vision_4_2b,
    qwen2_5_14b,
    recurrentgemma_2b,
    smollm_135m,
    whisper_medium,
)
from repro_torch.configs.base import ArchConfig, reduced

_MODULES = (qwen2_5_14b, smollm_135m, granite_3_2b, olmo_1b,
            recurrentgemma_2b, llama4_scout_17b_a16e, deepseek_v3_671b,
            mamba2_130m, whisper_medium, phi3_vision_4_2b)

_ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_IDS = tuple(_ARCHS)


def get_config(name: str) -> ArchConfig:
    try:
        return _ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}") from None


def get_smoke_config(name: str) -> ArchConfig:
    return reduced(get_config(name))
