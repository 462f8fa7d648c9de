"""K3 wrapper: W8A8 integer matmul, port of
``repro/kernels/qmatmul_int8.py``.

For activations a = a_scale * (A_q - a_zero) and weights
b = b_scale * (B_q - b_zero):

    out = a_scale * b_scale * (A_q @ B_q - (a_zero * colsum(B_q)
                               + rowsum(A_q) * b_zero - K * a_zero * b_zero))

colsum and rowsum are taken here with ``torch.sum`` on int32, outside the
kernel, as the reference does. For CUDA tensors this launches the
hand-written kernel of ``csrc/qmatmul_int8.cu``; for CPU tensors it runs the
plain version. ``qmatmul_int8.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

_LIB = CudaLibrary("qmatmul_int8.cu", {
    "qmatmul_int8": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
    + [ctypes.c_void_p]})

# the reference's verified envelope (kernels/envelope.py _K_MAX); the int32
# accumulator is exact well beyond it (|acc| <= 128*128*K < 2^31)
K_MAX = 32768
_MAX_GRID_Y = 65535
_BM = 32


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"qmatmul_int8: {msg}")


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(1)


def qmatmul_int8(a_q, b_q, a_scale, a_zero, b_scale, b_zero=None):
    """a_q (M, K) int8, b_q (K, N) int8, a_scale/a_zero scalars,
    b_scale/b_zero (1, N) float32 (``b_zero=None``: symmetric weights).
    Returns (M, N) float32."""
    if a_q.device.type == "cpu":
        return ref.qmatmul_int8_ref(a_q, b_q, a_scale, a_zero, b_scale,
                                    b_zero=b_zero)
    _check(a_q.dim() == 2 and b_q.dim() == 2, "a_q and b_q must be 2-D")
    M, K = a_q.shape
    N = b_q.shape[1]
    _check(a_q.dtype == torch.int8 and b_q.dtype == torch.int8,
           f"operands must be int8, got {a_q.dtype} and {b_q.dtype}")
    _check(b_q.shape[0] == K, f"b_q {tuple(b_q.shape)} does not match "
           f"a_q {tuple(a_q.shape)}")
    _check(K <= K_MAX, f"K={K} leaves the verified envelope K <= {K_MAX}")
    _check(M <= _MAX_GRID_Y * _BM and N < 2**31,
           f"shape ({M}, {K}, {N}) exceeds the kernel's grid")
    dev = a_q.device
    if b_zero is None:
        b_zero = torch.zeros((1, N), dtype=torch.float32, device=dev)
    for nm, t in (("b_scale", b_scale), ("b_zero", b_zero)):
        _check(t.dtype == torch.float32 and tuple(t.shape) == (1, N),
               f"{nm} must be float32 (1, {N}), got {t.dtype} {tuple(t.shape)}")
    for nm, t in (("a_q", a_q), ("b_q", b_q), ("b_scale", b_scale),
                  ("b_zero", b_zero)):
        _check(t.is_cuda and t.device == dev, f"{nm} is not on {dev}")
        _check(t.is_contiguous(), f"{nm} is not contiguous")
    a_s, a_z = _scalar(a_scale, dev), _scalar(a_zero, dev)
    colsum = torch.sum(b_q, dim=0, keepdim=True, dtype=torch.int32)
    rowsum = torch.sum(a_q, dim=1, keepdim=True, dtype=torch.int32)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    _LIB.call("qmatmul_int8", a_q.data_ptr(), b_q.data_ptr(), a_s.data_ptr(),
              a_z.data_ptr(), b_scale.data_ptr(), b_zero.data_ptr(),
              colsum.data_ptr(), rowsum.data_ptr(), out.data_ptr(), M, K, N,
              stream)
    qmatmul_int8.launches += 1
    return out


qmatmul_int8.launches = 0
