"""K3 wrapper: W8A8 integer matmul, port of
``repro/kernels/qmatmul_int8.py``.

For activations a = a_scale * (A_q - a_zero) and weights
b = b_scale * (B_q - b_zero):

    out = a_scale * b_scale * (A_q @ B_q - (a_zero * colsum(B_q)
                               + rowsum(A_q) * b_zero - K * a_zero * b_zero))

For CUDA tensors this launches the hand-written kernel of
``csrc/qmatmul_int8.cu`` (int8 wgmma on the tensor cores, the int32
accumulator exact; colsum and rowsum taken inside the kernel from the tiles
it stages) in the launch :func:`plan` lays out; for CPU tensors it runs the
plain version. A CUDA tensor never takes the plain version: the kernel
launches or the wrapper raises. ``qmatmul_int8.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.envelope import get_envelope

_LIB = CudaLibrary("qmatmul_int8.cu", {
    "qmatmul_int8": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "qmatmul_int8_init": []}, init="qmatmul_int8_init")

# the verified envelope of the w8a8 layout (kernels/envelope.py); the int32
# accumulator is exact well beyond it (|acc| <= 128*128*K < 2^31)
K_MAX = get_envelope("w8a8").k_max
_MAX_GRID_Y = 65535

# csrc/qmatmul_int8.cu
SMS = 132               # streaming multiprocessors of an H100 SXM
BM, BN, BK = 128, 128, 128  # rows of a_q, weight columns, K rows per step
MIN_SPLIT_STEPS = 16    # K steps per split at least: on an H100 at M =
                        # 512 a split costs ~4-6 us (its partial sums'
                        # round trip through L2), a K step ~0.6 us
MAX_SPLIT_TILES = 1024  # output tiles of a split launch, at most: one
                        # counter each


@dataclass(frozen=True)
class Plan:
    """How one K3 call launches: a grid of BM x BN output tiles with K in
    ``splits`` ranges of ``k_per_split`` rows (a multiple of BK), and the
    int32 workspace a split launch needs (0 bytes with one split)."""
    grid: Tuple[int, int, int]   # (column tiles, row tiles, K splits)
    k_per_split: int
    workspace_bytes: int
    vec_a: bool                  # 16-byte copies of a_q rows
    vec_b: bool                  # 16-byte copies of b_q rows

    @property
    def splits(self) -> int:
        return self.grid[2]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def workspace_ints(M: int, N: int, grid: Tuple[int, int, int]) -> Dict[str, int]:
    """The int32 workspace of a split launch, in the kernel's order:
    partial products (splits, M, N), column sums (splits, row tiles, N),
    row sums (splits, column tiles, M)."""
    gx, gy, z = grid
    return {"acc": z * M * N, "colsum": z * gy * N, "rowsum": z * gx * M}


def plan(M: int, K: int, N: int, a_dtype: torch.dtype = torch.int8,
         b_dtype: torch.dtype = torch.int8, a_ptr: int = 0,
         b_ptr: int = 0) -> Plan:
    """The launch of a K3 call on a_q (M, K) and b_q (K, N) at the given
    device addresses. A grid of fewer output tiles than SMs splits K, in
    whole BK steps, into as many ranges as put about one block on each SM,
    each of at least MIN_SPLIT_STEPS steps; the last block of each tile
    adds the splits, counted on one of MAX_SPLIT_TILES counters. Pure: no
    device is touched."""
    if a_dtype != torch.int8 or b_dtype != torch.int8:
        raise ValueError(f"qmatmul_int8: operands must be int8, got {a_dtype} "
                         f"and {b_dtype}")
    if M < 1 or N < 1 or K < 0:
        raise ValueError(f"qmatmul_int8: no plan for M={M} K={K} N={N}")
    if K > K_MAX:
        raise ValueError(f"qmatmul_int8: K={K} leaves the verified envelope "
                         f"K <= {K_MAX}")
    gx, gy = math.ceil(N / BN), math.ceil(M / BM)
    steps = max(1, math.ceil(K / BK))
    splits = max(1, min(SMS // (gx * gy), steps // MIN_SPLIT_STEPS))
    k_per_split = math.ceil(steps / splits) * BK
    splits = max(1, math.ceil(K / k_per_split))
    if gy > _MAX_GRID_Y:
        raise ValueError(f"qmatmul_int8: shape ({M}, {K}, {N}) exceeds the "
                         "kernel's grid")
    # a split grid has fewer than SMS <= MAX_SPLIT_TILES tiles
    grid = (gx, gy, splits)
    ws = sum(workspace_ints(M, N, grid).values()) if splits > 1 else 0
    return Plan(grid=grid, k_per_split=k_per_split, workspace_bytes=4 * ws,
                vec_a=K % 16 == 0 and a_ptr % 16 == 0,
                vec_b=N % 16 == 0 and b_ptr % 16 == 0)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"qmatmul_int8: {msg}")


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(1)


_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device) -> torch.Tensor:
    """The split counters on ``device``: zero, and left zero by every
    launch; allocated once, at the first split call on the device, which
    must not lie inside a CUDA-graph capture."""
    if device not in _COUNTERS:
        _COUNTERS[device] = torch.zeros(MAX_SPLIT_TILES, dtype=torch.int32,
                                        device=device)
    return _COUNTERS[device]


def launch(p: Plan, a_q, b_q, a_s, a_z, b_scale, b_zero, out, ws) -> None:
    """The kernel alone, as ``p`` lays it out, on checked, allocated
    tensors (``b_zero`` may be None; ``ws`` holds ``p.workspace_bytes``);
    not counted."""
    M, K = a_q.shape
    N = b_q.shape[1]
    counters = _counters(a_q.device) if p.splits > 1 else None
    _LIB.call("qmatmul_int8", a_q.data_ptr(), b_q.data_ptr(), a_s.data_ptr(),
              a_z.data_ptr(), b_scale.data_ptr(),
              0 if b_zero is None else b_zero.data_ptr(), out.data_ptr(),
              0 if ws is None else ws.data_ptr(),
              0 if counters is None else counters.data_ptr(), M, K, N,
              int(p.vec_a), int(p.vec_b), *p.grid, p.k_per_split,
              torch.cuda.current_stream(a_q.device).cuda_stream)


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
    dev = a_q.device
    tensors = [("a_q", a_q), ("b_q", b_q), ("b_scale", b_scale)]
    for nm, t in (("b_scale", b_scale), ("b_zero", b_zero)):
        if t is not None:
            _check(t.dtype == torch.float32 and tuple(t.shape) == (1, N),
                   f"{nm} must be float32 (1, {N}), got {t.dtype} "
                   f"{tuple(t.shape)}")
    if b_zero is not None:
        tensors.append(("b_zero", b_zero))
    for nm, t in tensors:
        _check(t.is_cuda and t.device == dev, f"{nm} is not on {dev}")
        _check(t.is_contiguous(), f"{nm} is not contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    p = plan(M, K, N, a_ptr=a_q.data_ptr(), b_ptr=b_q.data_ptr())
    ws = (torch.empty((p.workspace_bytes // 4,), dtype=torch.int32, device=dev)
          if p.splits > 1 else None)
    launch(p, a_q, b_q, _scalar(a_scale, dev), _scalar(a_zero, dev), b_scale,
           b_zero, out, ws)
    qmatmul_int8.launches += 1
    return out


qmatmul_int8.launches = 0
