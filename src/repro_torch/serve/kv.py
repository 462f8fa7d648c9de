"""int8 KV cache for the serving engine (port of ``repro/serve/kv.py``).

Per-(token, head) absmax quantization of K/V entries:

  codes  int8   (..., S, H, D)    the entries on the [-127, 127] grid
  scale  f32    (..., S, H, 1)    absmax/127, floored at KV_EPS/127

:func:`int8_decode_attention` never dequantizes the cache: the key scale is
constant over the head dim, so ``q . (codes * scale) == (q . codes) * scale``
and it folds into the scores after the contraction; the value scale folds
into the softmax probabilities before the probs-x-codes contraction.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.attention import (NEG_INF, batch_only, pos_mask,
                                         softmax_last)
from repro_torch.core.dist import einsum

KV_EPS = 1e-6
KV_QMAX = 127.0
KV_SCALE_MIN = KV_EPS / KV_QMAX


class KVQuantUnsupported(ValueError):
    """A model family was asked for an int8 KV cache it cannot have.
    ``reason`` is the machine-readable tag."""

    def __init__(self, reason: str, detail: str):
        self.reason = reason
        super().__init__(f"{reason}: {detail}")


def kv_quantize(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax int8 quantization of K/V entries."""
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(dim=-1, keepdim=True), min=KV_EPS) / KV_QMAX
    codes = torch.clamp(torch.round(t32 / scale), -KV_QMAX, KV_QMAX)
    return codes.to(torch.int8), scale


def int8_decode_attention(q: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, pos, *,
                          window: int = 0) -> torch.Tensor:
    """Single-token decode attention directly over the int8 cache.

    q (B,1,Hq,D); codes (B,Smax,Hkv,D) int8; scales (B,Smax,Hkv,1) f32;
    ``pos`` a scalar or (B,) per-slot positions."""
    B, _, Hq, D = q.shape
    Smax, Hkv = k_codes.shape[1], k_codes.shape[2]
    G = Hq // Hkv
    qg = batch_only(q).reshape(B, 1, Hkv, G, D).float()
    s = einsum("bqhgd,bkhd->bhgqk", qg, k_codes.float())
    k_s = k_scale[..., 0].transpose(1, 2)[:, :, None, None, :]
    s = s * k_s * (D**-0.5)
    valid = pos_mask(pos, B, Smax, window, q.device)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = softmax_last(s)
    pv = p * v_scale[..., 0].transpose(1, 2)[:, :, None, None, :]
    out = einsum("bhgqk,bkhd->bqhgd", pv, v_codes.float())
    return out.reshape(B, 1, Hq, v_codes.shape[-1]).to(q.dtype)


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """The entries ``codes * scale`` in ``dtype``. The decode path never
    calls it: ``int8_decode_attention`` folds the scales in instead."""
    return (codes.float() * scale).to(dtype)


def quantized_cache(cache) -> bool:
    """Does this cache dict hold int8 codes + scales (vs raw K/V)?"""
    return isinstance(cache, dict) and "k_scale" in cache


def cache_bytes(cache) -> int:
    """Total bytes held by a cache: every tensor of its dicts and lists
    (codes + scales, raw K/V, recurrent states)."""
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(cache_bytes(v) for v in cache)
    return cache.numel() * cache.element_size()


def hbm_per_slot_bytes(cache, slots: int) -> int:
    """Bytes of KV state one decode slot pins in device memory."""
    return cache_bytes(cache) // slots


def hbm_per_slot_mib(cache, slots: int) -> float:
    """MiB of KV state one decode slot pins in device memory."""
    return hbm_per_slot_bytes(cache, slots) / 2**20


def unsupported(family: str, detail: str) -> KVQuantUnsupported:
    return KVQuantUnsupported(f"kv_quant_unsupported:{family}", detail)


def check_kv_quant_supported(cfg, kv_quant: bool) -> None:
    """Guard for ``init_cache(kv_quant=True)``: only attention KV caches
    hold per-head int8 entries."""
    if not kv_quant:
        return
    fam = getattr(cfg, "family", "?")
    if fam in ("ssm", "hybrid"):
        raise unsupported(fam, f"{cfg.name}: the {fam} family keeps recurrent "
                          "state, not an attention KV cache; serve it with "
                          "kv_quant=False")
    if getattr(cfg, "use_mla", False):
        raise unsupported("mla", f"{cfg.name}: MLA caches the compressed "
                          "latent; serve it with kv_quant=False")
