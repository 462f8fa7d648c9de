"""QDrop (Wei et al., 2022), port of ``repro/core/qdrop.py``: randomly drop
activation quantization during reconstruction, so that weight rounding is
learned under partially quantized activations. ``drop_prob`` is the
probability that an element keeps its full-precision value.

The draw comes from the caller: a ``torch.Generator`` on the activation's
device, or a boolean mask (True keeps fp) that was drawn elsewhere, e.g.
in JAX by a parity test. A data-parallel rank wraps either in ``Rows``:
the draw is made at the global batch's shape and sliced to the rank's
positions, so every rank sees the masks of the single-process run.
"""
from __future__ import annotations

import dataclasses
import hashlib
import zlib
from typing import Any, Dict, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Rows:
    """``source`` (a generator or a mask) drawn for a batch of ``total``
    positions, of which the activation holds positions [lo, hi): its leading
    axis holds (hi - lo) positions' rows, so the draw is made with that axis
    scaled to ``total`` positions and sliced."""
    source: Any
    lo: int
    hi: int
    total: int

    def mask(self, shape, drop_prob: float, device) -> torch.Tensor:
        rows, n = shape[0], self.hi - self.lo
        if rows * self.total % n:
            raise ValueError(f"an activation of {rows} rows does not split "
                             f"into {n} of {self.total} positions")
        per = rows * self.total // n
        full = (per,) + tuple(shape[1:])
        keep = _keep(self.source, full, drop_prob, device)
        at = rows * self.lo // n
        return keep[at:at + rows]


MaskOrGenerator = Union[torch.Generator, torch.Tensor, np.ndarray, Rows]


def _keep(src, shape, drop_prob: float, device) -> torch.Tensor:
    if isinstance(src, torch.Generator):
        return torch.rand(shape, generator=src, device=device) < drop_prob
    return torch.as_tensor(src, device=device).to(torch.bool)


def qdrop(x_fp: torch.Tensor, x_q: torch.Tensor, drop_prob: float,
          mask_or_generator: MaskOrGenerator,
          enabled: bool = True) -> torch.Tensor:
    """Element-wise mix of fp and fake-quant activations (QDrop eq. 7)."""
    if not enabled or drop_prob <= 0.0:
        return x_q
    if drop_prob >= 1.0:
        return x_fp
    if isinstance(mask_or_generator, Rows):
        keep_fp = mask_or_generator.mask(x_fp.shape, drop_prob, x_fp.device)
    else:
        keep_fp = _keep(mask_or_generator, x_fp.shape, drop_prob, x_fp.device)
    return torch.where(keep_fp, x_fp, x_q)


def salt(name: str) -> int:
    """A site's salt, the reference's ``crc32(name) & 0x7FFFFFFF``."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (a hash, so nearby
    inputs give unrelated streams)."""
    h = hashlib.blake2b(f"{seed}:{data}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & (2**63 - 1)


def site_seed(seed: int, name: str) -> int:
    """The seed of site ``name``'s stream in a run seeded ``seed``."""
    return fold_in(seed, salt(name))


class SiteStreams:
    """The QDrop draws of one reconstruction run: one ``torch.Generator``
    per site on ``device``, seeded with ``site_seed(seed, name)``, made at
    the site's first draw and read on from there, step after step. (The
    reconstruction engine keeps one generator per site of its own, which a
    CUDA graph replays, and re-seeds them the same way for every block.)"""

    def __init__(self, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        self._gens: Dict[str, torch.Generator] = {}

    def __call__(self, name: str) -> torch.Generator:
        gen = self._gens.get(name)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(site_seed(self.seed, name))
            self._gens[name] = gen
        return gen
