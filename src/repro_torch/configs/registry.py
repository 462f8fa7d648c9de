"""Registry over the ported architecture configs.

The reference registers ten architectures; the port has smollm-135m (dense)
and llama4-scout-17b-a16e (MoE) so far. Asking for any other of the
reference's names raises ``KeyError`` saying it is not ported yet.
"""
from __future__ import annotations

from repro_torch.configs import llama4_scout_17b_a16e, smollm_135m
from repro_torch.configs.base import ArchConfig, reduced

_ARCHS = {m.CONFIG.name: m.CONFIG for m in (smollm_135m, llama4_scout_17b_a16e)}
ARCH_IDS = tuple(_ARCHS)


def get_config(name: str) -> ArchConfig:
    try:
        return _ARCHS[name]
    except KeyError:
        raise KeyError(f"arch {name!r} is not ported yet, see ROADMAP "
                       f"(ported: {ARCH_IDS})") from None


def get_smoke_config(name: str) -> ArchConfig:
    return reduced(get_config(name))
