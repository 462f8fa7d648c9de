"""K4 wrapper: fused FlexRound quantize (paper Eq. 2 forward), port of
``repro/kernels/flexround_quant.py``.

    out = s1 * (clip(round(w / (s1 * s2 * s3)) + zero, qmin, qmax) - zero)

w, s2: (M, N); s1, s3, zero: (1, N) float32 rows. For CUDA tensors this
launches the hand-written kernel of ``csrc/flexround_quant.cu``, which is
bit-exact against the plain version; for CPU tensors it runs the plain
version (``ref.flexround_quant_ref``). A CUDA tensor never takes the plain
version: the kernel launches or the wrapper raises.
``flexround_quant.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

_LIB = CudaLibrary("flexround_quant.cu", {
    "flexround_quant": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p]})


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flexround_quant: {msg}")


def flexround_quant(w, s1, s2, s3, zero, *, qmin: int, qmax: int):
    """w (M, N) float32/bfloat16; s2 (M, N) float32; s1/s3/zero (1, N)
    float32. Returns (M, N) in w's dtype."""
    if w.device.type == "cpu":
        return ref.flexround_quant_ref(w, s1, s2, s3, zero, qmin, qmax)
    _check(w.dim() == 2, f"w must be 2-D (M, N), got {tuple(w.shape)}")
    M, N = w.shape
    _check(w.dtype in (torch.float32, torch.bfloat16),
           f"w dtype {w.dtype} is not float32 or bfloat16")
    _check(s2.dtype == torch.float32 and tuple(s2.shape) == (M, N),
           f"s2 must be float32 {(M, N)}, got {s2.dtype} {tuple(s2.shape)}")
    for nm, t in (("s1", s1), ("s3", s3), ("zero", zero)):
        _check(t.dtype == torch.float32 and tuple(t.shape) == (1, N),
               f"{nm} must be float32 (1, {N}), got {t.dtype} {tuple(t.shape)}")
    for nm, t in (("w", w), ("s1", s1), ("s2", s2), ("s3", s3),
                  ("zero", zero)):
        _check(t.is_cuda and t.device == w.device, f"{nm} is not on {w.device}")
        _check(t.is_contiguous(), f"{nm} is not contiguous")
    _check(M < 2**31 and N < 2**31,
           f"shape ({M}, {N}) exceeds the kernel's indexing")
    out = torch.empty((M, N), dtype=w.dtype, device=w.device)
    if M == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(w.device).cuda_stream
    _LIB.call("flexround_quant", w.data_ptr(), s1.data_ptr(), s2.data_ptr(),
              s3.data_ptr(), zero.data_ptr(), out.data_ptr(), M, N, int(qmin),
              int(qmax), int(w.dtype == torch.bfloat16), stream)
    flexround_quant.launches += 1
    return out


flexround_quant.launches = 0
