"""K1/K2/K5 on Hopper: the launch planner, the factored form the kernels
compute, and the precondition that makes it exact.

``csrc/dequant_matmul_2d.cu`` computes ``scale[n] * sum_k x[m, k] *
(q[k, n] - zero[n])`` with (q - zero) as bf16 on the tensor cores (decode
and mma regimes) or as float32 on the CUDA cores (float32 x), on one
operand (K1/K2) or per expert of a stack (K5), where a block whose rows of
x are all zero over its K range adds +0 without reading its codes. That is
exact only because zero points are integers in [0, 2^b - 1]; the tests
here hold that precondition for everything export produces, check the
bit tricks the kernels use to build (q - zero), hold the factored form
(and, for K5, its block-by-block skip) against the reference's interpreted
Pallas kernels, and pin the pure planning function (regime, grid, K
splits, workspace, alignment, experts) at every main-path shape. The
kernels themselves run on the card only (``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import dequant_matmul_w4 as jdm
from repro_torch.configs import get_smoke_config
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.core.reconstruct import quantize_blocks
from repro_torch.kernels import dequant_matmul_w4 as k12
from repro_torch.kernels import ref
from repro_torch.models.model import build_model

torch.set_num_threads(2)

SMOLLM_SITES = ((576, 576), (576, 192), (1536, 576), (576, 1536))
LLAMA4_2D = ((5120, 5120), (5120, 1024), (5120, 8192), (8192, 5120))
MAIN_MS = (4, 16, 32, 64, 512)
WHISPER_2D = ((1024, 1024), (1024, 4096), (4096, 1024))
MAMBA_2D = ((768, 3352), (1536, 768))  # in_proj's N % 16 = 8
# recurrentgemma-2b: the 2560-wide sites, wk/wv's N = 256 (one KV head of
# 256) and the geglu MLP's 7680
RG_2D = ((2560, 2560), (2560, 256), (2560, 7680), (7680, 2560))
PLAN_CASES = ([(M, K, N, packed) for M in MAIN_MS
               for K, N in SMOLLM_SITES + LLAMA4_2D for packed in (True, False)]
              # whisper-medium: decode at batch 4, the prefill's 4 x 16 rows,
              # the export's 16 x 64; the cross K/V over 4 and 16 x 1504
              # frames
              + [(M, K, N, packed) for M in (4, 64, 1024) for K, N in WHISPER_2D
                 for packed in (True, False)]
              + [(M, 1024, 1024, packed) for M in (6016, 24064)
                 for packed in (True, False)]
              # mamba2-130m: decode at batch 2, the 2 x 16 prefill, the
              # export's 64 x 64 rows
              + [(M, K, N, packed) for M in (2, 32, 4096) for K, N in MAMBA_2D
                 for packed in (True, False)]
              # recurrentgemma-2b: decode at batch 2, serve-smoke's 2 x 16
              # prefill, the 2 x 2040 prefill of the card's greedy decode,
              # the export's 64 x 64 rows
              + [(M, K, N, packed) for M in (2, 32, 4080, 4096)
                 for K, N in RG_2D for packed in (True, False)])


# ------------------------------------------------------------------ planner
@pytest.mark.parametrize("M,K,N,packed", PLAN_CASES,
                         ids=[f"m{M}k{K}n{N}{'w4' if p else 'w8'}"
                              for M, K, N, p in PLAN_CASES])
def test_plan_at_main_path_shapes(M, K, N, packed):
    p = k12.plan(M, K, N, torch.bfloat16, packed)
    assert p.regime == ("decode" if M <= k12.DECODE_MAX_M else "mma")
    bm, bn = k12.TILES[p.kernel]
    gx, gy, splits = p.grid
    assert gx == math.ceil(N / bn) and gy == math.ceil(M / bm)
    if M == 4:
        assert p.kernel == 1 and p.blocks >= k12.SMS  # one block per SM
    # the splits cover K exactly once, in multiples of 8 rows
    assert (splits - 1) * p.rows_per_split < K <= splits * p.rows_per_split
    assert splits == 1 or p.rows_per_split % k12.K_GRAIN == 0
    assert p.workspace_bytes == (4 * splits * M * N if splits > 1 else 0)
    if p.regime == "mma" and splits > 1:
        assert p.rows_per_split >= k12.MMA_MIN_ROWS
    # grids that fill the card need no split and no workspace
    if gx * gy >= (k12.DECODE_BLOCKS if p.regime == "decode"
                   else k12.MMA_SPLIT_BELOW):
        assert splits == 1
    # every main-path x is aligned, and every row of codes but in_proj's
    assert p.vec_x and p.vec_codes == (N % 16 == 0)


@pytest.mark.parametrize("M,K,N,packed,x_ptr,codes_ptr,vec_x,vec_codes", [
    (7, 578, 200, True, 0, 0, False, False),    # ragged: N % 16, K % 8
    (7, 577, 200, False, 0, 0, False, False),
    (40, 578, 200, True, 0, 0, False, False),
    (4, 576, 1536, True, 2, 0, False, True),    # x one bf16 off 16 bytes
    (40, 576, 1536, False, 0, 1, True, False),  # codes one byte off
    (4, 576, 1536, True, 0, 0, True, True),
])
def test_plan_flags_misaligned(M, K, N, packed, x_ptr, codes_ptr, vec_x,
                               vec_codes):
    p = k12.plan(M, K, N, torch.bfloat16, packed, x_ptr, codes_ptr)
    assert (p.vec_x, p.vec_codes) == (vec_x, vec_codes)
    assert p.regime == ("decode" if M <= k12.DECODE_MAX_M else "mma")


@pytest.mark.parametrize("M", [1, k12.DECODE_MAX_M - 1, k12.DECODE_MAX_M,
                               k12.DECODE_MAX_M + 1, 16, 64, 65])
def test_plan_threshold(M):
    """The decode kernel (1) up to DECODE_MAX_M rows, wgmma (2) above."""
    p = k12.plan(M, 576, 1536, torch.bfloat16, True)
    assert p.regime == ("decode" if M <= k12.DECODE_MAX_M else "mma")
    assert p.kernel == (1 if M <= k12.DECODE_MAX_M else 2)


@pytest.mark.parametrize("M,K,N", [(512, 5120, 8192), (512, 8192, 5120),
                                   (65, 5120, 1024), (512, 576, 192)])
def test_plan_wgmma_tiles(M, K, N):
    """The mma regime: wg_kernel, 128 rows of x by 128 weight columns per
    block, K split only where fewer than MMA_SPLIT_BELOW blocks would run,
    each split at least MMA_MIN_ROWS deep."""
    p = k12.plan(M, K, N, torch.bfloat16, True)
    assert p.kernel == 2 and k12.TILES[2] == (128, 128)
    assert p.grid[:2] == (math.ceil(N / 128), math.ceil(M / 128))
    if p.grid[0] * p.grid[1] >= k12.MMA_SPLIT_BELOW:
        assert p.splits == 1
    else:
        assert p.splits > 1 and p.rows_per_split >= k12.MMA_MIN_ROWS


@pytest.mark.parametrize("M,K,N", [(4, 576, 1536), (512, 8192, 5120),
                                   (7, 577, 200)])
def test_plan_float32_stays_on_cuda_cores(M, K, N):
    packed = K % 2 == 0
    p = k12.plan(M, K, N, torch.float32, packed)
    R = K // 2 if packed else K
    assert p.regime == "fp32" and p.kernel == 0 and not p.vec_x
    assert p.grid[:2] == (math.ceil(N / k12.FP_BN), math.ceil(M / k12.FP_BM))
    assert (p.splits - 1) * p.rows_per_split < R <= p.splits * p.rows_per_split
    assert p.rows_per_split <= k12.FP_MAX_ROWS
    assert p.smem_bytes <= 48 * 1024  # no opt-in needed


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="no plan"):
        k12.plan(4, 577, 64, torch.bfloat16, packed=True)
    with pytest.raises(ValueError, match="no plan"):
        k12.plan(0, 64, 64, torch.bfloat16, packed=False)
    with pytest.raises(ValueError, match="no plan"):
        k12.plan(4, 64, 64, torch.bfloat16, packed=False, E=0)


# The K1/K2 planner as it stood before it took an expert count, at every
# shape the tests above cover: M K N codes x x_ptr codes_ptr | regime
# kernel grid (3) rows_per_split workspace_bytes smem_bytes vec_codes vec_x
_K12_PLANS = """
1 576 1536 w4 bf16 0 0  decode 1 12 1 18 32 110592 0 11
4 576 192 w4 bf16 0 0  decode 1 2 1 72 8 221184 0 11
4 576 192 w8 bf16 0 0  decode 1 2 1 72 8 221184 0 11
4 576 576 w4 bf16 0 0  decode 1 5 1 36 16 331776 0 11
4 576 576 w8 bf16 0 0  decode 1 5 1 36 16 331776 0 11
4 576 1536 w4 bf16 0 0  decode 1 12 1 18 32 442368 0 11
4 576 1536 w4 bf16 2 0  decode 1 12 1 18 32 442368 0 10
4 576 1536 w8 bf16 0 0  decode 1 12 1 18 32 442368 0 11
4 1536 576 w4 bf16 0 0  decode 1 5 1 48 32 442368 0 11
4 1536 576 w8 bf16 0 0  decode 1 5 1 48 32 442368 0 11
4 5120 1024 w4 bf16 0 0  decode 1 8 1 32 160 524288 0 11
4 5120 1024 w8 bf16 0 0  decode 1 8 1 32 160 524288 0 11
4 5120 5120 w4 bf16 0 0  decode 1 40 1 7 736 573440 0 11
4 5120 5120 w8 bf16 0 0  decode 1 40 1 7 736 573440 0 11
4 5120 8192 w4 bf16 0 0  decode 1 64 1 5 1024 655360 0 11
4 5120 8192 w8 bf16 0 0  decode 1 64 1 5 1024 655360 0 11
4 8192 5120 w4 bf16 0 0  decode 1 40 1 7 1176 573440 0 11
4 8192 5120 w8 bf16 0 0  decode 1 40 1 7 1176 573440 0 11
7 576 1536 w4 bf16 0 0  decode 1 12 1 18 32 774144 0 11
7 577 200 w8 bf16 0 0  decode 1 2 1 37 16 207200 0 00
7 578 200 w4 bf16 0 0  decode 1 2 1 37 16 207200 0 00
8 576 1536 w4 bf16 0 0  decode 1 12 1 18 32 884736 0 11
9 576 1536 w4 bf16 0 0  mma 2 12 1 2 288 110592 0 11
16 576 192 w4 bf16 0 0  mma 2 2 1 2 288 24576 0 11
16 576 192 w8 bf16 0 0  mma 2 2 1 2 288 24576 0 11
16 576 576 w4 bf16 0 0  mma 2 5 1 2 288 73728 0 11
16 576 576 w8 bf16 0 0  mma 2 5 1 2 288 73728 0 11
16 576 1536 w4 bf16 0 0  mma 2 12 1 2 288 196608 0 11
16 576 1536 w8 bf16 0 0  mma 2 12 1 2 288 196608 0 11
16 1536 576 w4 bf16 0 0  mma 2 5 1 6 256 221184 0 11
16 1536 576 w8 bf16 0 0  mma 2 5 1 6 256 221184 0 11
16 5120 1024 w4 bf16 0 0  mma 2 8 1 9 576 589824 0 11
16 5120 1024 w8 bf16 0 0  mma 2 8 1 9 576 589824 0 11
16 5120 5120 w4 bf16 0 0  mma 2 40 1 2 2560 655360 0 11
16 5120 5120 w8 bf16 0 0  mma 2 40 1 2 2560 655360 0 11
16 5120 8192 w4 bf16 0 0  mma 2 64 1 2 2560 1048576 0 11
16 5120 8192 w8 bf16 0 0  mma 2 64 1 2 2560 1048576 0 11
16 8192 5120 w4 bf16 0 0  mma 2 40 1 2 4096 655360 0 11
16 8192 5120 w8 bf16 0 0  mma 2 40 1 2 4096 655360 0 11
32 576 192 w4 bf16 0 0  mma 2 2 1 2 288 49152 0 11
32 576 192 w8 bf16 0 0  mma 2 2 1 2 288 49152 0 11
32 576 576 w4 bf16 0 0  mma 2 5 1 2 288 147456 0 11
32 576 576 w8 bf16 0 0  mma 2 5 1 2 288 147456 0 11
32 576 1536 w4 bf16 0 0  mma 2 12 1 2 288 393216 0 11
32 576 1536 w8 bf16 0 0  mma 2 12 1 2 288 393216 0 11
32 1536 576 w4 bf16 0 0  mma 2 5 1 6 256 442368 0 11
32 1536 576 w8 bf16 0 0  mma 2 5 1 6 256 442368 0 11
32 5120 1024 w4 bf16 0 0  mma 2 8 1 9 576 1179648 0 11
32 5120 1024 w8 bf16 0 0  mma 2 8 1 9 576 1179648 0 11
32 5120 5120 w4 bf16 0 0  mma 2 40 1 2 2560 1310720 0 11
32 5120 5120 w8 bf16 0 0  mma 2 40 1 2 2560 1310720 0 11
32 5120 8192 w4 bf16 0 0  mma 2 64 1 2 2560 2097152 0 11
32 5120 8192 w8 bf16 0 0  mma 2 64 1 2 2560 2097152 0 11
32 8192 5120 w4 bf16 0 0  mma 2 40 1 2 4096 1310720 0 11
32 8192 5120 w8 bf16 0 0  mma 2 40 1 2 4096 1310720 0 11
40 576 1536 w8 bf16 0 1  mma 2 12 1 2 288 491520 0 01
40 578 200 w4 bf16 0 0  mma 2 2 1 2 296 64000 0 00
64 576 192 w4 bf16 0 0  mma 2 2 1 2 288 98304 0 11
64 576 192 w8 bf16 0 0  mma 2 2 1 2 288 98304 0 11
64 576 576 w4 bf16 0 0  mma 2 5 1 2 288 294912 0 11
64 576 576 w8 bf16 0 0  mma 2 5 1 2 288 294912 0 11
64 576 1536 w4 bf16 0 0  mma 2 12 1 2 288 786432 0 11
64 576 1536 w8 bf16 0 0  mma 2 12 1 2 288 786432 0 11
64 1536 576 w4 bf16 0 0  mma 2 5 1 6 256 884736 0 11
64 1536 576 w8 bf16 0 0  mma 2 5 1 6 256 884736 0 11
64 5120 1024 w4 bf16 0 0  mma 2 8 1 9 576 2359296 0 11
64 5120 1024 w8 bf16 0 0  mma 2 8 1 9 576 2359296 0 11
64 5120 5120 w4 bf16 0 0  mma 2 40 1 2 2560 2621440 0 11
64 5120 5120 w8 bf16 0 0  mma 2 40 1 2 2560 2621440 0 11
64 5120 8192 w4 bf16 0 0  mma 2 64 1 2 2560 4194304 0 11
64 5120 8192 w8 bf16 0 0  mma 2 64 1 2 2560 4194304 0 11
64 8192 5120 w4 bf16 0 0  mma 2 40 1 2 4096 2621440 0 11
64 8192 5120 w8 bf16 0 0  mma 2 40 1 2 4096 2621440 0 11
65 576 1536 w4 bf16 0 0  mma 2 12 1 2 288 798720 0 11
65 5120 1024 w4 bf16 0 0  mma 2 8 1 9 576 2396160 0 11
512 576 192 w4 bf16 0 0  mma 2 2 4 2 288 786432 0 11
512 576 192 w8 bf16 0 0  mma 2 2 4 2 288 786432 0 11
512 576 576 w4 bf16 0 0  mma 2 5 4 2 288 2359296 0 11
512 576 576 w8 bf16 0 0  mma 2 5 4 2 288 2359296 0 11
512 576 1536 w4 bf16 0 0  mma 2 12 4 2 288 6291456 0 11
512 576 1536 w8 bf16 0 0  mma 2 12 4 2 288 6291456 0 11
512 1536 576 w4 bf16 0 0  mma 2 5 4 4 384 4718592 0 11
512 1536 576 w8 bf16 0 0  mma 2 5 4 4 384 4718592 0 11
512 5120 1024 w4 bf16 0 0  mma 2 8 4 3 1712 6291456 0 11
512 5120 1024 w8 bf16 0 0  mma 2 8 4 3 1712 6291456 0 11
512 5120 5120 w4 bf16 0 0  mma 2 40 4 1 5120 0 0 11
512 5120 5120 w8 bf16 0 0  mma 2 40 4 1 5120 0 0 11
512 5120 8192 w4 bf16 0 0  mma 2 64 4 1 5120 0 0 11
512 5120 8192 w8 bf16 0 0  mma 2 64 4 1 5120 0 0 11
512 8192 5120 w4 bf16 0 0  mma 2 40 4 1 8192 0 0 11
512 8192 5120 w8 bf16 0 0  mma 2 40 4 1 8192 0 0 11
4 576 1536 w4 f32 0 0  fp32 0 12 1 12 26 294912 16384 10
7 577 200 w8 f32 0 0  fp32 0 2 2 34 17 190400 16384 00
512 8192 5120 w4 f32 0 0  fp32 0 40 128 4 1024 41943040 32768 10
"""
_K12_CASES = [line.split() for line in _K12_PLANS.strip().splitlines()]


@pytest.mark.parametrize("row", _K12_CASES, ids=["-".join(r[:7]) for r in
                                                 _K12_CASES])
def test_plan_with_one_expert_is_the_k1_k2_plan(row):
    """With E = 1 (the default) every field of the plan is what the K1/K2
    planner gave before the expert axis existed."""
    M, K, N = (int(v) for v in row[:3])
    dtype = torch.bfloat16 if row[4] == "bf16" else torch.float32
    args = (M, K, N, dtype, row[3] == "w4", int(row[5]), int(row[6]))
    p = k12.plan(*args, E=1)
    assert p == k12.plan(*args)
    want = k12.Plan(regime=row[7], kernel=int(row[8]),
                    grid=tuple(int(v) for v in row[9:12]),
                    rows_per_split=int(row[12]), workspace_bytes=int(row[13]),
                    smem_bytes=int(row[14]), vec_codes=row[15][0] == "1",
                    vec_x=row[15][1] == "1")
    assert p == want


# K5's main-path calls: 16 experts, capacity 4 (decode and prefill) and 40
# (export), the expert stacks (5120, 8192) and (8192, 5120)
K5_CASES = [(M, K, N, packed, dt) for M in (4, 40)
            for K, N in ((5120, 8192), (8192, 5120)) for packed in (True, False)
            for dt in ("bf16", "f32")]


@pytest.mark.parametrize("M,K,N,packed,dt", K5_CASES,
                         ids=[f"m{M}k{K}n{N}{'w4' if p else 'w8'}{dt}"
                              for M, K, N, p, dt in K5_CASES])
def test_plan_experts_at_k5_shapes(M, K, N, packed, dt):
    """E = 16: decode at M = 4, mma at M = 40 (bf16), fp32 for float32 x;
    the y axis holds the 16 experts' row tiles. Decode splits K so that the
    tiles of DECODE_ACTIVE experts fill every SM at the decode kernel's
    occupancy (3 splits of 64 column tiles, 4 of 40), its 16 x 64 or
    16 x 40 tiles within the split counters; the mma grid holds 16 x 64 or
    16 x 40 tiles, far above its split target, and runs one split; fp32
    splits K (its x chunk is bounded by shared memory). Split launches keep
    one E x M x N partial sum per split."""
    E = 16
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    p = k12.plan(M, K, N, dtype, packed, E=E)
    regime = "fp32" if dt == "f32" else ("decode" if M == 4 else "mma")
    assert p.regime == regime
    bm, bn = (k12.FP_BM, k12.FP_BN) if regime == "fp32" else k12.TILES[p.kernel]
    gx = math.ceil(N / bn)
    assert p.grid[:2] == (gx, E * math.ceil(M / bm))
    R = K // 2 if packed and regime == "fp32" else K
    assert (p.splits - 1) * p.rows_per_split < R <= p.splits * p.rows_per_split
    if regime == "mma":
        assert p.splits == 1 and p.workspace_bytes == 0
    else:
        assert p.workspace_bytes == 4 * p.splits * E * M * N
    if regime == "decode":
        assert p.splits == {64: 3, 40: 4}[gx]
        assert p.rows_per_split % k12.K_GRAIN == 0
        assert p.grid[0] * p.grid[1] <= k12.MAX_SPLIT_TILES
        active = k12.DECODE_ACTIVE * gx * p.splits
        assert active >= k12.DECODE_OCCUPANCY * k12.SMS
    assert p.vec_codes and p.vec_x == (dt == "bf16")


@pytest.mark.parametrize("M,K,N,packed", [(7, 578, 200, True),
                                          (7, 577, 200, False),
                                          (40, 578, 200, True),
                                          (4, 576, 1536, True)])
@pytest.mark.parametrize("E", [1, 3, 16])
def test_plan_experts_ragged_and_split(E, M, K, N, packed):
    """Small grids split K: the decision counts the output tiles of all E
    experts (mma) or of min(E, DECODE_ACTIVE) experts against a twice
    larger target (decode), so more experts never give more splits than
    one; a split decode launch keeps one counter per output tile of every
    expert, within MAX_SPLIT_TILES; the splits cover K once, in multiples
    of 8 rows; the workspace holds E x splits x M x N float32 partial
    sums."""
    p = k12.plan(M, K, N, torch.bfloat16, packed, E=E)
    one = k12.plan(M, K, N, torch.bfloat16, packed)
    bm, bn = k12.TILES[p.kernel]
    gx, gy = math.ceil(N / bn), math.ceil(M / bm)
    assert p.regime == one.regime and p.grid[:2] == (gx, E * gy)
    assert (p.splits - 1) * p.rows_per_split < K <= p.splits * p.rows_per_split
    assert p.splits == 1 or p.rows_per_split % k12.K_GRAIN == 0
    assert p.splits <= one.splits
    assert p.workspace_bytes == (4 * p.splits * E * M * N if p.splits > 1
                                 else 0)
    if p.regime == "decode" and p.splits > 1:
        assert gx * E * gy <= k12.MAX_SPLIT_TILES


def test_plan_experts_refused_beyond_the_grid(monkeypatch):
    """More row tiles of all experts than the grid's y axis takes are
    refused; K5 at decode runs one split where its tiles would exceed the
    split counters (K1/K2, whose split always fits, refuse such a plan)."""
    p = k12.plan(4, 5120, 8192, torch.bfloat16, True, E=65535)
    assert p.grid[1] == 65535
    with pytest.raises(ValueError, match="exceeds the kernel's grid"):
        k12.plan(4, 5120, 8192, torch.bfloat16, True, E=65536)
    with pytest.raises(ValueError, match="exceeds the kernel's grid"):
        k12.plan(40, 5120, 8192, torch.float32, True, E=6554)
    p = k12.plan(4, 5120, 8192, torch.bfloat16, True, E=17)
    assert p.splits == 1 and p.grid[0] * p.grid[1] == 17 * 64
    p = k12.plan(7, 578, 200, torch.bfloat16, True, E=3)
    assert p.splits > 1 and p.grid[0] * p.grid[1] == 6
    monkeypatch.setattr(k12, "MAX_SPLIT_TILES", 5)
    assert k12.plan(7, 578, 200, torch.bfloat16, True, E=3).splits == 1
    monkeypatch.setattr(k12, "MAX_SPLIT_TILES", 1)
    with pytest.raises(ValueError, match="split counters"):
        k12.plan(7, 578, 200, torch.bfloat16, True)


# ------------------------------------------------- (q - zero), bit by bit
@settings(max_examples=300, deadline=None)
@given(q=st.integers(0, 255), z=st.integers(0, 255))
def test_q_minus_zero_exact_in_bf16(q, z):
    """Every code and zero point are integers in [0, 255], so q - z lies in
    [-255, 255] and is exact in bf16 (8 significant bits), as the tensor-core
    kernels need; the float32 route (2^23 + q) - (2^23 + z) is exact too."""
    d = torch.tensor([q - z], dtype=torch.float32)
    assert d.to(torch.bfloat16).float().item() == q - z
    f32 = np.float32
    assert f32(f32(2**23 + q) - f32(2**23 + z)) == q - z


def _byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the eight bytes of (y << 32) | x."""
    pool = (y << 32) | x
    return sum(((pool >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _bf16_bits(v):
    return torch.tensor([v], dtype=torch.float32).to(torch.bfloat16).view(
        torch.int16).item() & 0xFFFF


@pytest.mark.parametrize("jj", range(4))
def test_nibble_pair_bits(jj):
    """The packed B fragment: byte jj of a code word holds rows 2i (low
    nibble) and 2i+1 (high); one byte permute and one mask-and-or give the
    bf16x2 {128 + lo, 128 + hi} that the kernels subtract {128 + z} from."""
    rng = np.random.default_rng(jj)
    for b in range(256):
        others = [int(v) for v in rng.integers(0, 256, 3)]
        word_bytes = others[:jj] + [b] + others[jj:]
        w = sum(v << (8 * i) for i, v in enumerate(word_bytes))
        lo, hi = w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F
        sel = jj | (jj << 4) | ((4 + jj) << 8) | ((4 + jj) << 12)
        q = (_byte_perm(lo, hi, sel) & 0x000F000F) | 0x43004300
        assert q & 0xFFFF == _bf16_bits(128 + (b & 0xF))
        assert q >> 16 == _bf16_bits(128 + (b >> 4))


@pytest.mark.parametrize("j", range(4))
def test_byte_under_float_exponent(j):
    """The unpacked B fragment: one byte permute of a code word with
    0x4B000000 gives the float32 bits of 2^23 + byte j."""
    rng = np.random.default_rng(j)
    sel = j | (4 << 4) | (4 << 8) | (7 << 12)
    for b in range(256):
        others = [int(v) for v in rng.integers(0, 256, 3)]
        word_bytes = others[:j] + [b] + others[j:]
        w = sum(v << (8 * i) for i, v in enumerate(word_bytes))
        bits = np.array([_byte_perm(w, 0x4B000000, sel)], np.uint32)
        assert bits.view(np.float32)[0] == np.float32(2**23 + b)


# ------------------------------------------------------------ factored form
def _factored(x, codes, scale, zero, packed):
    """The kernels' arithmetic in plain torch: float32 sum of x times the
    exact integers (q - zero), scaled once per column, rounded to x's type."""
    q = ref.unpack_f32(codes) if packed else codes.float()
    return (scale * (x.float() @ (q - zero))).to(x.dtype)


FACTORED = [(5, 64, 24, True), (7, 62, 8, True), (33, 126, 129, True),
            (4, 33, 24, False), (5, 128, 120, False), (1, 255, 8, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,packed", FACTORED)
def test_factored_form_matches_pallas_interpret(M, K, N, packed, dtype):
    """scale * (x @ (q - z)) against the reference's dequant_matmul_w4/_w8
    (Pallas, interpret mode), which rounds scale * (q - z) per element.
    float32: rtol = atol = 1e-5 (one float32 rounding per term apart, at
    most 255 terms). bf16: the two float32 sums round to bf16 at most one
    bf16 step (2^-7 relative) apart."""
    bits = 4 if packed else 8
    rng = np.random.default_rng([M, K, N, bits])
    q = rng.integers(0, 2**bits, (K, N)).astype(np.uint8)
    codes = (q[0::2] | (q[1::2] << 4)).astype(np.uint8) if packed else q
    scale = (np.exp(rng.standard_normal((1, N)) * 0.2) * 0.2
             / (2**bits - 1)).astype(np.float32)
    zero = np.round(rng.uniform(0, 2**bits - 1, (1, N))).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    got = _factored(xt, torch.from_numpy(codes), torch.from_numpy(scale),
                    torch.from_numpy(zero), packed)
    jfn = jdm.dequant_matmul_w4 if packed else jdm.dequant_matmul_w8
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    want = np.asarray(jfn(jx, jnp.asarray(codes), jnp.asarray(scale),
                          jnp.asarray(zero), interpret=True), np.float32)
    assert got.dtype == dtype and got.shape == (M, N)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2**-7, atol=1e-6))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _blocked_batched(x, codes, scale, zero, packed, p):
    """K5's kernels block by block in plain torch, as ``p`` lays them out:
    per expert, row tile and K split, a block whose rows of x are all +-0
    over its K range adds +0 (it reads no codes), any other adds the float32
    sum of x * (q - zero); the splits add in split order from +0, the scale
    comes once, then the rounding to x's type."""
    E, M, K = x.shape
    q = ref.unpack_f32(codes, axis=1) if packed else codes.float()
    qz = q - zero  # (E, K, N) exact integers
    bm = k12.FP_BM if p.regime == "fp32" else k12.TILES[p.kernel][0]
    # fp32_kernel splits code rows, the tensor-core kernels K rows
    kps = p.rows_per_split * (2 if packed and p.regime == "fp32" else 1)
    out = torch.zeros((E, M, codes.shape[2]))
    blocks = skipped = 0
    for e in range(E):
        for m0 in range(0, M, bm):
            acc = torch.zeros((min(bm, M - m0), codes.shape[2]))
            for k0 in range(0, K, kps):
                xs = x[e, m0:m0 + bm, k0:k0 + kps].float()
                blocks += 1
                if bool((xs != 0).any()):
                    acc = acc + xs @ qz[e, k0:k0 + kps]
                else:
                    skipped += 1  # adds +0: acc is unchanged
            out[e, m0:m0 + bm] = acc
    assert blocks == E * math.ceil(M / bm) * p.splits
    return (scale * out).to(x.dtype), skipped


BATCHED = [(4, 5, 64, 24, True), (3, 7, 126, 129, True),
           (4, 4, 33, 24, False), (3, 12, 128, 120, False),
           (2, 40, 62, 8, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N,packed", BATCHED)
def test_batched_factored_form_with_skip_matches_pallas_interpret(
        E, M, K, N, packed, dtype):
    """K5's blocks (:func:`_blocked_batched` under the plan for E experts:
    decode, mma or fp32, most of these small grids split K) against the
    reference's dequant_matmul_batched (Pallas, interpret mode). Expert 0's
    rows are zero (half of them -0), expert 1's zero over the first half of
    K only; the rest dense. Zeroed experts come out exactly +0 in both, and
    in the plain version; the rest agree within the tolerances of
    test_factored_form_matches_pallas_interpret."""
    bits = 4 if packed else 8
    rng = np.random.default_rng([E, M, K, N, bits])
    q = rng.integers(0, 2**bits, (E, K, N)).astype(np.uint8)
    codes = ((q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8) if packed
             else q)
    scale = (np.exp(rng.standard_normal((E, 1, N)) * 0.2) * 0.2
             / (2**bits - 1)).astype(np.float32)
    zero = np.round(rng.uniform(0, 2**bits - 1, (E, 1, N))).astype(np.float32)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    x[0] = 0.0
    x[0, ::2] = -0.0
    x[1, :, :K // 2] = 0.0
    xt = torch.from_numpy(x).to(dtype)
    ct, st, zt = (torch.from_numpy(a) for a in (codes, scale, zero))
    p = k12.plan(M, K, N, dtype, packed, E=E)
    got, skipped = _blocked_batched(xt, ct, st, zt, packed, p)
    assert skipped >= math.ceil(M / (k12.FP_BM if p.regime == "fp32"
                                     else k12.TILES[p.kernel][0])) * p.splits
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    want = np.asarray(jdm.dequant_matmul_batched(
        jx, jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(zero),
        packed=packed, interpret=True), np.float32)
    plain = ref.dequant_matmul_batched_ref(xt, ct, st, zt, packed)
    assert got.dtype == dtype and got.shape == (E, M, N)
    for out in (got.float().numpy(), want, plain.float().numpy()):
        assert (out[0] == 0).all() and not np.signbit(out[0]).any()
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2**-7, atol=1e-6))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


# ------------------------------------------------------------ precondition
def _qtensors(tree):
    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _qtensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _qtensors(v)


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("arch", ["smollm-135m", "llama4-scout-17b-a16e"])
def test_export_zero_points_are_integral_codes(arch, symmetric, granularity):
    """Every QTensor export-only quantize_blocks produces (W4 body, W8
    first layer) has integral zero points in [0, 2^b - 1], and codes in the
    same range: the precondition of the kernels' exact (q - zero)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    calib = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=8,
                         w_symmetric=symmetric, w_granularity=granularity,
                         iters=0, batch_size=2, rules=("layers.0.*:w_bits=8",))
    x0, blocks, _ = model.quant_blocks(params, calib)
    fin, _, _ = quantize_blocks(blocks, recipe, x0)
    qts = list(_qtensors(list(fin)))
    assert {qt.bits for qt in qts} == {4, 8}
    for qt in qts:
        hi = 2**qt.bits - 1
        z = qt.zero.double()
        assert torch.equal(z, torch.round(z)), "zero point is not an integer"
        assert z.min() >= 0 and z.max() <= hi
        codes = qt.unpacked_codes()
        assert codes.dtype == torch.uint8 and int(codes.max()) <= hi
