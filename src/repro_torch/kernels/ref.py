"""Plain PyTorch versions of every kernel (port of ``repro/kernels/ref.py``,
term for term).

They are what a kernel wrapper runs for CPU tensors, what the ``torch``
backend runs on any device, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def flexround_quant_ref(w, s1, s2, s3, zero, qmin: int, qmax: int):
    """Fused FlexRound quantize: W_hat = s1*(clip(round(W/(s1*s2*s3))+z) - z).

    w, s2: (M, N); s1, s3, zero: (1, N) broadcastable (per-channel) or (1, 1).
    """
    w32 = w.float()
    q = torch.round(w32 / (s1 * s2 * s3)) + zero
    q = torch.clamp(q, qmin, qmax)
    return (s1 * (q - zero)).to(w.dtype)


def qmatmul_int8_ref(a_q, b_q, a_scale, a_zero, b_scale, b_zero=None,
                     out_dtype=torch.float32):
    """W8A8 integer matmul with affine corrections.

    a_q (M, K) int8 codes of activations:  a = a_scale * (a_q - a_zero)
    b_q (K, N) int8 codes of weights:      b = b_scale * (b_q - b_zero)
    b_scale/b_zero: (1, N) or (1, 1); b_zero=None means symmetric weights.

    PyTorch has no int32 matmul on CUDA, so the accumulator is formed in
    float64, which is exact here: |acc| <= 128*128*K < 2^53 for every K in
    the reference's envelope (K <= 32768), so float64(acc) is the int32 sum
    and its float32 rounding equals the reference's int32->float32 cast.
    """
    acc = torch.matmul(a_q.double(), b_q.double()).float()
    K = a_q.shape[1]
    colsum = b_q.to(torch.int32).sum(dim=0, keepdim=True).float()
    out = acc - a_zero * colsum
    if b_zero is not None:
        rowsum = a_q.to(torch.int32).sum(dim=1, keepdim=True).float()
        out = out - rowsum * b_zero + K * a_zero * b_zero
    return (a_scale * b_scale * out).to(out_dtype)


def unpack_f32(codes: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Nibble-packed uint8 -> float32 codes, pairs along ``axis``."""
    from repro_torch.core.qtensor import _unpack_nibbles
    return _unpack_nibbles(codes, axis=axis).float()


def dequant_matmul_w4_ref(x, codes, scale, zero,
                          out_dtype: Optional[torch.dtype] = None):
    """W4A16 matmul: x (M, K) @ dequant(codes) where codes are nibble-packed
    (K//2, N) uint8, scale/zero (1, N) or (1, 1) float32."""
    w = scale * (unpack_f32(codes) - zero)
    out = torch.matmul(x.float(), w)
    return out.to(out_dtype or x.dtype)


def dequant_matmul_w8_ref(x, codes, scale, zero,
                          out_dtype: Optional[torch.dtype] = None):
    """W8A16 weight-only matmul: x (M, K) @ dequant(codes (K, N) uint8)."""
    w = scale * (codes.float() - zero)
    out = torch.matmul(x.float(), w)
    return out.to(out_dtype or x.dtype)


def dequant_matmul_batched_ref(x, codes, scale, zero, packed: bool,
                               out_dtype: Optional[torch.dtype] = None):
    """Per-expert dequant matmul: x (E, M, K) @ dequant(codes[e]) for each
    expert e. codes (E, K//2, N) packed uint8 or (E, K, N) uint8;
    scale/zero broadcastable to (E, 1, N)."""
    q = unpack_f32(codes, axis=1) if packed else codes.float()
    w = scale * (q - zero)  # (E, K, N)
    out = torch.einsum("emk,ekn->emn", x.float(), w)
    return out.to(out_dtype or x.dtype)
