"""K1 / K2 / K5 wrappers: weight-only dequant-matmul (the W4 and W8 serving
matmuls, and the per-expert product over stacked MoE weights), port of
``repro/kernels/dequant_matmul_w4.py``.

    out[M, N] = x[M, K] @ (scale[1, N] * (unpack(codes)[K, N] - zero[1, N]))
    out[e] = x[e] @ (scale[e] * (unpack(codes[e]) - zero[e]))   (batched)

For CUDA tensors the wrappers launch hand-written kernels; for CPU tensors
they run the plain versions in :mod:`repro_torch.kernels.ref`. A CUDA
tensor never takes the plain version: the kernel launches or the wrapper
raises. All three run ``csrc/dequant_matmul_2d.cu`` in the regime that
:func:`plan` picks from the shape: ``decode`` (bf16 x, M <= ``DECODE_MAX_M``:
split-K, codes streamed through a cp.async ring onto the tensor cores),
``mma`` (bf16 x, larger M: wgmma tiles) or ``fp32`` (float32 x, any M:
CUDA-core multiply-adds, kept out of TF32). K5 runs the same kernels over
its E experts in one launch, and a block whose rows of x are all +0 over
its K range (an expert no token was routed to) reads none of its codes.
Each wrapper counts its launches in ``<wrapper>.launches`` and per form in
``<wrapper>.forms``: the regime, and for K5 also packed or unpacked codes.
A call that runs the split-K reduction pass counts as one launch.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

_LIB = CudaLibrary("dequant_matmul_2d.cu", {
    "dequant_matmul_2d": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
    + [ctypes.c_void_p],
    "dequant_matmul_batched": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
    + [ctypes.c_void_p],
    "dequant_matmul_2d_init": []}, init="dequant_matmul_2d_init")

_MAX_GRID_Y = 65535
_MAX_GRID_Z = 65535

# csrc/dequant_matmul_2d.cu
SMS = 132                # streaming multiprocessors of an H100 SXM
DECODE_MAX_M = 8         # bf16 x with M above this takes the mma regime
# the C entry's `kernel` and its block tile (rows of x, weight columns):
# 1 dec_kernel, 2 wg_kernel; 0 is fp32_kernel (FP_BM x FP_BN)
TILES = {1: (8, 128), 2: (128, 128)}
K_GRAIN = 8              # decode and mma split K in multiples of 8 rows
MMA_MIN_ROWS = 256       # mma splits: their partial sums are M x N each
MMA_SPLIT_BELOW = SMS // 2  # mma grids of fewer tiles split K
DECODE_BLOCKS = 2 * SMS  # decode grids split K up to this many blocks
DECODE_OCCUPANCY = 4     # dec_kernel blocks resident per SM (its registers)
DECODE_ACTIVE = 4        # K5 at decode: experts taken to hold tokens (a
                         # serving step's 4 slots routed top-1)
MAX_SPLIT_TILES = 1024   # output tiles (of all experts) of a split decode
                         # launch, at most: one counter each
FP_BM, FP_BN = 4, 128    # fp32_kernel block: rows of x x columns
FP_ROW_STEP = 128        # code rows one pass of an fp32_kernel block covers
FP_MAX_ROWS = 1024       # code rows per split: x chunk <= 32 KB of smem
FP_MIN_ROWS = 128        # below this a split is not worth its partial sums
FP_RED_BYTES = 8 * FP_BM * FP_BN * 4  # cross-warp reduction buffer


@dataclass(frozen=True)
class Plan:
    """How one K1/K2/K5 call launches. ``rows_per_split`` counts K rows
    (decode, mma) or code rows (fp32_kernel);
    ``workspace_bytes`` is 0 with one split."""
    regime: str                  # "decode", "mma" or "fp32"
    kernel: int                  # the C entry's `kernel`
    grid: Tuple[int, int, int]   # (column tiles, row tiles of all experts,
                                 #  K splits)
    rows_per_split: int
    workspace_bytes: int
    smem_bytes: int              # dynamic shared memory (fp32_kernel)
    vec_codes: bool              # 16-byte code loads
    vec_x: bool                  # 16-byte x copies (decode, mma)

    @property
    def splits(self) -> int:
        return self.grid[2]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _tc_split(K: int, base: int, target: int, min_rows: int) -> int:
    """K rows per split of a tensor-core grid of ``base`` tiles: enough
    splits to reach ``target`` blocks, each of at least ``min_rows`` rows,
    in multiples of K_GRAIN rows."""
    splits = max(1, min(math.ceil(target / base), K // min_rows))
    per = math.ceil(K / splits)
    return min(K, math.ceil(per / K_GRAIN) * K_GRAIN)


def _fp32_split(R: int, base: int) -> int:
    """Code rows per split of fp32_kernel: about two blocks per SM over the
    whole grid, splits of at least FP_MIN_ROWS rows; where that leaves SMs
    idle, as many rows as put at least one block on every SM."""
    rps = max(FP_MIN_ROWS, math.ceil(R / max(1, 2 * SMS // base)))
    rps = min(rps, FP_MAX_ROWS)
    if math.ceil(R / rps) * base < SMS:
        rps = min(rps, max(1, R // math.ceil(SMS / base)))
    return rps


def plan(M: int, K: int, N: int, dtype: torch.dtype, packed: bool,
         x_ptr: int = 0, codes_ptr: int = 0, E: int = 1) -> Plan:
    """The launch of a K1 (``packed``) or K2 call on x (M, K) of ``dtype``
    and codes (K/2 or K, N) at the given device addresses, or of a K5 call
    on ``E`` such products (x (E, M, K), codes (E, K/2 or K, N)). bf16 x:
    the decode regime (dec_kernel) up to DECODE_MAX_M rows, the mma regime
    (wg_kernel) above; float32 x runs fp32_kernel. The grid's y axis holds
    every expert's row tiles. The K-split decision of the mma and fp32
    regimes counts the output tiles of all E experts. At decode, K5 splits
    K for the experts that hold tokens: the blocks of an expert whose rows
    of x are all zero skip their codes, and which experts those are is
    known only on the device, so the split takes min(E, DECODE_ACTIVE)
    experts as active (a serving step's 4 slots routed top-1) and makes
    their blocks fill every SM at the decode kernel's occupancy. With 16
    experts of 40 or 64 column tiles that is 4 or 3 splits; a dense stack
    runs as many more blocks, each a shorter K walk. A split decode launch
    counts its tiles on MAX_SPLIT_TILES counters, so K5 does not split
    where all experts' tiles exceed them. With ``E = 1`` the plan is the
    K1/K2 plan. Pure: no device is touched."""
    if M < 1 or K < 1 or N < 1 or E < 1 or (packed and K % 2):
        raise ValueError(f"dequant_matmul: no plan for E={E} M={M} K={K} "
                         f"N={N} packed={packed}")
    vec_codes = N % 16 == 0 and codes_ptr % 16 == 0
    vec_x = dtype == torch.bfloat16 and K % 8 == 0 and x_ptr % 16 == 0
    if dtype == torch.bfloat16 and M <= DECODE_MAX_M:
        # ~2 blocks per SM, so that enough code bytes are in flight
        regime, kernel = "decode", 1
        gx, gy = math.ceil(N / TILES[1][1]), math.ceil(M / TILES[1][0])
        if E == 1:
            rps = _tc_split(K, gx * gy, DECODE_BLOCKS, K_GRAIN)
        elif E * gx * gy <= MAX_SPLIT_TILES:
            rps = _tc_split(K, min(E, DECODE_ACTIVE) * gx * gy,
                            DECODE_OCCUPANCY * SMS, K_GRAIN)
        else:
            rps = K
        splits, smem = math.ceil(K / rps), 0
    elif dtype == torch.bfloat16:
        # K split where the grid leaves most SMs idle
        regime, kernel = "mma", 2
        gx, gy = math.ceil(N / TILES[2][1]), math.ceil(M / TILES[2][0])
        rps = _tc_split(K, E * gx * gy, MMA_SPLIT_BELOW, MMA_MIN_ROWS)
        splits, smem = math.ceil(K / rps), 0
    else:
        regime, kernel = "fp32", 0
        R = K // 2 if packed else K
        gx, gy = math.ceil(N / FP_BN), math.ceil(M / FP_BM)
        rps = _fp32_split(R, E * gx * gy)
        splits = math.ceil(R / rps)
        padded = math.ceil(rps / FP_ROW_STEP) * FP_ROW_STEP
        smem = max(padded * (2 if packed else 1) * 16, FP_RED_BYTES)
    gy *= E
    if gy > _MAX_GRID_Y or splits > _MAX_GRID_Z:
        raise ValueError(f"dequant_matmul: shape ({E}, {M}, {K}, {N}) "
                         "exceeds the kernel's grid")
    if splits > 1 and regime == "decode" and gx * gy > MAX_SPLIT_TILES:
        raise ValueError(f"dequant_matmul: a split decode launch of {gx * gy} "
                         f"output tiles exceeds the {MAX_SPLIT_TILES} split "
                         "counters")
    return Plan(regime=regime, kernel=kernel, grid=(gx, gy, splits),
                rows_per_split=rps,
                workspace_bytes=4 * splits * E * M * N if splits > 1 else 0,
                smem_bytes=smem, vec_codes=vec_codes, vec_x=vec_x)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dequant_matmul: {msg}")


def _validate(x, codes, scale, zero, packed: bool) -> None:
    """x (E, M, K), codes (E, K/2 or K, N), scale/zero (E, 1, N) on one
    card, contiguous."""
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
    _check(K < 2**31 and N < 2**31 and M * N < 2**31,
           f"shape ({E}, {M}, {K}, {N}) exceeds the kernels' int indices")


_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device) -> torch.Tensor:
    """The split counters of the decode kernel on ``device``: zero, and
    left zero by every launch; allocated once, at the first split call on
    the device, which must not lie inside a CUDA-graph capture."""
    if device not in _COUNTERS:
        _COUNTERS[device] = torch.zeros(MAX_SPLIT_TILES, dtype=torch.int32,
                                        device=device)
    return _COUNTERS[device]


def _launch(fn, x, codes, scale, zero, packed: bool,
            batched: bool) -> torch.Tensor:
    """One call of x (E, M, K) as :func:`plan` lays it out, counted on
    ``fn``: K5 (``batched``) through the C entry over E experts, K1/K2 with
    E = 1 through the 2-D entry. The split-K workspace comes from
    ``torch.empty`` (graph-capture safe), the split counters are allocated
    once per device."""
    _validate(x, codes, scale, zero, packed)
    E, M, K = x.shape
    N = codes.shape[2]
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if E == 0 or M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    p = plan(M, K, N, x.dtype, packed, x.data_ptr(), codes.data_ptr(), E=E)
    ws = torch.empty((p.workspace_bytes // 4,), dtype=torch.float32,
                     device=x.device) if p.splits > 1 else None
    counters = (_counters(x.device) if p.splits > 1 and p.regime == "decode"
                else None)
    ptrs = (x.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            out.data_ptr(), 0 if ws is None else ws.data_ptr(),
            0 if counters is None else counters.data_ptr())
    rest = (M, K, N, int(packed), p.kernel, int(p.vec_x), int(p.vec_codes),
            p.grid[0], p.grid[1], p.splits, p.rows_per_split, p.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream)
    if batched:
        _LIB.call("dequant_matmul_batched", *ptrs, E, *rest)
        fn.forms["packed" if packed else "unpacked"] += 1
    else:
        _LIB.call("dequant_matmul_2d", *ptrs, *rest)
    fn.launches += 1
    fn.forms[p.regime] += 1
    return out


def _launch_2d(fn, x, codes, scale, zero, packed: bool) -> torch.Tensor:
    """K1/K2: x (M, K) and codes (K/2 or K, N) as a stack of one."""
    _check(x.dim() == 2 and codes.dim() == 2, "x and codes must be 2-D")
    return _launch(fn, x[None], codes[None], scale[None], zero[None], packed,
                   batched=False)[0]


def dequant_matmul_w4(x, codes, scale, zero):
    """K1: x (M, K) float32/bfloat16; codes (K//2, N) nibble-packed uint8;
    scale/zero (1, N) float32. Returns (M, N) in x's dtype."""
    if x.device.type == "cpu":
        return ref.dequant_matmul_w4_ref(x, codes, scale, zero)
    return _launch_2d(dequant_matmul_w4, x, codes, scale, zero, packed=True)


def dequant_matmul_w8(x, codes, scale, zero):
    """K2: x (M, K); codes (K, N) uint8, one code per byte; scale/zero
    (1, N) float32. Weight-only int8 serving and odd-K sub-8-bit weights."""
    if x.device.type == "cpu":
        return ref.dequant_matmul_w8_ref(x, codes, scale, zero)
    return _launch_2d(dequant_matmul_w8, x, codes, scale, zero, packed=False)


def dequant_matmul_batched(x, codes, scale, zero, packed: bool):
    """K5: x (E, M, K) float32/bfloat16; codes (E, K//2, N) nibble-packed
    along K (``packed``) or (E, K, N) uint8; scale/zero (E, 1, N) float32.
    Returns (E, M, N) in x's dtype: per expert x[e] @ dequant(codes[e]).
    Blocks whose rows of x are all +0 write +0 without reading their codes
    (exact: the full sum of +0 * (q - zero) is +0 too)."""
    if x.device.type == "cpu":
        return ref.dequant_matmul_batched_ref(x, codes, scale, zero, packed)
    return _launch(dequant_matmul_batched, x, codes, scale, zero, packed,
                   batched=True)


dequant_matmul_w4.launches = 0
dequant_matmul_w4.forms = {"decode": 0, "mma": 0, "fp32": 0}
dequant_matmul_w8.launches = 0
dequant_matmul_w8.forms = {"decode": 0, "mma": 0, "fp32": 0}
dequant_matmul_batched.launches = 0
dequant_matmul_batched.forms = {"packed": 0, "unpacked": 0, "decode": 0,
                                "mma": 0, "fp32": 0}
