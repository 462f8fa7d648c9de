"""Registry over the ported architecture configs.

The reference registers ten architectures; the port has the dense
smollm-135m, granite-3-2b, qwen2.5-14b and olmo-1b, the MoE
llama4-scout-17b-a16e and deepseek-v3-671b, the ssm mamba2-130m, the encdec
whisper-medium and the vlm phi-3-vision-4.2b so far, in the reference's
order. Asking for recurrentgemma-2b raises ``KeyError`` saying it is not
ported yet.
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
    smollm_135m,
    whisper_medium,
)
from repro_torch.configs.base import ArchConfig, reduced

_MODULES = (qwen2_5_14b, smollm_135m, granite_3_2b, olmo_1b,
            llama4_scout_17b_a16e, deepseek_v3_671b, mamba2_130m,
            whisper_medium, phi3_vision_4_2b)

_ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_IDS = tuple(_ARCHS)


def get_config(name: str) -> ArchConfig:
    try:
        return _ARCHS[name]
    except KeyError:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP Queue 1 "
                       f"item 9; ported: {ARCH_IDS})") from None


def get_smoke_config(name: str) -> ArchConfig:
    return reduced(get_config(name))
