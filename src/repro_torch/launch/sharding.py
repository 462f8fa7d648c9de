"""Per-architecture parallelism modes (the tables of
``repro/launch/sharding.py``).

  dp    params replicated, batch over data axes (small models)
  tp    tensor parallel over 'model' (2-10B)
  fsdp  tp + parameters/optimizer sharded over data axes too (>=14B)

The training launcher reads ``ARCH_MODE`` for its optimizer settings
(``launch.steps.TRAIN_OPT``). The spec functions that place parameters,
batches and caches on a mesh come with distributed calibration (ROADMAP
Queue 1 item 11).
"""
from __future__ import annotations

ARCH_MODE = {
    "qwen2.5-14b": "fsdp",
    "smollm-135m": "dp",
    "granite-3-2b": "tp",
    "olmo-1b": "tp",
    "recurrentgemma-2b": "tp",
    "llama4-scout-17b-a16e": "fsdp",
    "deepseek-v3-671b": "fsdp",
    "mamba2-130m": "dp",
    "whisper-medium": "tp",
    "phi-3-vision-4.2b": "tp",
}

# serving prefers TP everywhere: replicated weights multiply per-device
# weight traffic by the device count, and FSDP-sharded weights would be
# re-gathered every decode step
SERVE_MODE = {
    "smollm-135m": "tp",
    "mamba2-130m": "tp",
    "qwen2.5-14b": "tp",
    "llama4-scout-17b-a16e": "tp",
    "deepseek-v3-671b": "tp",
}


def serve_mode(name: str) -> str:
    return SERVE_MODE.get(name, ARCH_MODE.get(name, "tp"))
