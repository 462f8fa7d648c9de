"""K1 / K2 / K5 wrappers: weight-only dequant-matmul (the W4 and W8 serving
matmuls, and the per-expert product over stacked MoE weights), port of
``repro/kernels/dequant_matmul_w4.py``.

    out[M, N] = x[M, K] @ (scale[1, N] * (unpack(codes)[K, N] - zero[1, N]))
    out[e] = x[e] @ (scale[e] * (unpack(codes[e]) - zero[e]))   (batched)

For CUDA tensors the wrappers launch the hand-written kernel of
``csrc/dequant_matmul.cu`` (one template over packed/unpacked codes and
float32/bfloat16 x, with an expert grid axis); for CPU tensors they run the
plain version in :mod:`repro_torch.kernels.ref`. A CUDA tensor never takes
the plain version: the kernel launches or the wrapper raises. Each wrapper
counts its launches in ``<wrapper>.launches``; the batched one also counts
them per form in ``dequant_matmul_batched.forms`` (packed, unpacked).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

_LIB = CudaLibrary("dequant_matmul.cu", {
    "dequant_matmul_batched": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_void_p]})

_MAX_GRID_Y = 65535
_MAX_GRID_Z = 65535
_BM = 32  # rows per block in csrc/dequant_matmul.cu


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dequant_matmul: {msg}")


def _launch(x, codes, scale, zero, packed: bool) -> torch.Tensor:
    """One launch over E experts: x (E, M, K), codes (E, K/2 or K, N),
    scale/zero (E, 1, N); the 2-D kernels pass E = 1."""
    _check(x.dim() == 3 and codes.dim() == 3, "x and codes must be "
           "(E, M, K) and (E, K/2 or K, N)")
    E, M, K = x.shape
    N = codes.shape[2]
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"x dtype {x.dtype} is not float32 or bfloat16")
    _check(codes.dtype == torch.uint8, f"codes dtype {codes.dtype} is not uint8")
    _check(codes.shape[0] == E
           and codes.shape[1] == (K // 2 if packed else K)
           and (K % 2 == 0 or not packed),
           f"codes {tuple(codes.shape)} do not match x {tuple(x.shape)} "
           f"({'nibble-packed K/2' if packed else 'K'} rows expected)")
    for nm, t in (("scale", scale), ("zero", zero)):
        _check(t.dtype == torch.float32 and tuple(t.shape) == (E, 1, N),
               f"{nm} must be float32 {(E, 1, N)}, got {t.dtype} "
               f"{tuple(t.shape)}")
    for nm, t in (("x", x), ("codes", codes), ("scale", scale), ("zero", zero)):
        _check(t.is_cuda and t.device == x.device, f"{nm} is not on {x.device}")
        _check(t.is_contiguous(), f"{nm} is not contiguous")
    _check(E <= _MAX_GRID_Z and M <= _MAX_GRID_Y * _BM and K < 2**31
           and N < 2**31, f"shape ({E}, {M}, {K}, {N}) exceeds the kernel's "
           "grid")
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if E == 0 or M == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _LIB.call("dequant_matmul_batched", x.data_ptr(), codes.data_ptr(),
              scale.data_ptr(), zero.data_ptr(), out.data_ptr(), E, M, K, N,
              int(packed), int(x.dtype == torch.bfloat16), stream)
    return out


def _launch_2d(x, codes, scale, zero, packed: bool) -> torch.Tensor:
    _check(x.dim() == 2 and codes.dim() == 2, "x and codes must be 2-D")
    return _launch(x[None], codes[None], scale[None], zero[None], packed)[0]


def dequant_matmul_w4(x, codes, scale, zero):
    """K1: x (M, K) float32/bfloat16; codes (K//2, N) nibble-packed uint8;
    scale/zero (1, N) float32. Returns (M, N) in x's dtype."""
    if x.device.type == "cpu":
        return ref.dequant_matmul_w4_ref(x, codes, scale, zero)
    out = _launch_2d(x, codes, scale, zero, packed=True)
    dequant_matmul_w4.launches += 1
    return out


def dequant_matmul_w8(x, codes, scale, zero):
    """K2: x (M, K); codes (K, N) uint8, one code per byte; scale/zero
    (1, N) float32. Weight-only int8 serving and odd-K sub-8-bit weights."""
    if x.device.type == "cpu":
        return ref.dequant_matmul_w8_ref(x, codes, scale, zero)
    out = _launch_2d(x, codes, scale, zero, packed=False)
    dequant_matmul_w8.launches += 1
    return out


def dequant_matmul_batched(x, codes, scale, zero, packed: bool):
    """K5: x (E, M, K) float32/bfloat16; codes (E, K//2, N) nibble-packed
    along K (``packed``) or (E, K, N) uint8; scale/zero (E, 1, N) float32.
    Returns (E, M, N) in x's dtype: per expert x[e] @ dequant(codes[e])."""
    if x.device.type == "cpu":
        return ref.dequant_matmul_batched_ref(x, codes, scale, zero, packed)
    out = _launch(x, codes, scale, zero, packed=packed)
    dequant_matmul_batched.launches += 1
    dequant_matmul_batched.forms["packed" if packed else "unpacked"] += 1
    return out


dequant_matmul_w4.launches = 0
dequant_matmul_w8.launches = 0
dequant_matmul_batched.launches = 0
dequant_matmul_batched.forms = {"packed": 0, "unpacked": 0}
