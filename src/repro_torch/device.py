"""Device policy shared by every entry point of the port.

``device=None`` means CUDA. A CUDA request with no visible card raises: no
code path carries on on the CPU when it finds no GPU. Only an explicit
``device="cpu"`` runs on the CPU. Resolving a CUDA device also pins full
float32 matmuls and convolutions (no TF32), so float32 results on the card
are comparable with the CPU and with the JAX reference.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; repro_torch runs on the GPU by "
                "default — pass device='cpu' explicitly to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
