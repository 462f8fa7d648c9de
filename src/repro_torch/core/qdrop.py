"""QDrop (Wei et al., 2022), port of ``repro/core/qdrop.py``: randomly drop
activation quantization during reconstruction, so that weight rounding is
learned under partially quantized activations. ``drop_prob`` is the
probability that an element keeps its full-precision value.

The draw comes from the caller: a ``torch.Generator`` on the activation's
device, or a boolean mask (True keeps fp) that was drawn elsewhere, e.g.
in JAX by a parity test.
"""
from __future__ import annotations

import hashlib
import zlib
from typing import Dict, Union

import numpy as np
import torch

MaskOrGenerator = Union[torch.Generator, torch.Tensor, np.ndarray]


def qdrop(x_fp: torch.Tensor, x_q: torch.Tensor, drop_prob: float,
          mask_or_generator: MaskOrGenerator,
          enabled: bool = True) -> torch.Tensor:
    """Element-wise mix of fp and fake-quant activations (QDrop eq. 7)."""
    if not enabled or drop_prob <= 0.0:
        return x_q
    if drop_prob >= 1.0:
        return x_fp
    if isinstance(mask_or_generator, torch.Generator):
        keep_fp = torch.rand(x_fp.shape, generator=mask_or_generator,
                             device=x_fp.device) < drop_prob
    else:
        keep_fp = torch.as_tensor(mask_or_generator,
                                  device=x_fp.device).to(torch.bool)
    return torch.where(keep_fp, x_fp, x_q)


def salt(name: str) -> int:
    """A site's salt, the reference's ``crc32(name) & 0x7FFFFFFF``."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (a hash, so nearby
    inputs give unrelated streams)."""
    h = hashlib.blake2b(f"{seed}:{data}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & (2**63 - 1)


class SiteStreams:
    """The QDrop draws of one reconstruction run: one ``torch.Generator``
    per site on ``device``, seeded with ``fold_in(seed, salt(name))``, made
    at the site's first draw and read on from there, step after step."""

    def __init__(self, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        self._gens: Dict[str, torch.Generator] = {}

    def __call__(self, name: str) -> torch.Generator:
        gen = self._gens.get(name)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(fold_in(self.seed, salt(name)))
            self._gens[name] = gen
        return gen
