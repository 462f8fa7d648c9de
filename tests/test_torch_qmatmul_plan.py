"""K3 on Hopper: the launch planner of ``kernels/qmatmul_int8.py`` and CPU
models of what ``csrc/qmatmul_int8.cu`` does with its bytes.

The kernel runs on the card only (``chip_smoke.py``). Here: the pure
planning function at every K3 shape the main path and the card checks use
(the splits cover K exactly, the grid stays in CUDA's limits, the workspace
is exactly as large as the kernel's indexing reaches, and what no kernel
takes is refused); numpy models of the weight's byte transpose (ldmatrix
.trans from the lanes' row addresses, then two byte permutes: each thread's
A fragment must hold 4 consecutive K rows of its weight column), of the
shared-memory swizzles (conflict-free phases) and of the split-K launch
with in-kernel column and row sums, held against the reference's Pallas
kernel in interpret mode.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul_int8 import qmatmul_int8 as jqmatmul_int8
from repro_torch.kernels import qmatmul_int8 as k3
from repro_torch.kernels import ref

torch.set_num_threads(2)

SMOLLM_SITES = ((576, 576), (576, 192), (1536, 576), (576, 1536))
LLAMA4_2D = ((5120, 5120), (5120, 1024), (5120, 8192), (8192, 5120))
WHISPER_2D = ((1024, 1024), (1024, 4096), (4096, 1024))
RG_2D = ((2560, 2560), (2560, 256), (2560, 7680), (7680, 2560))
# every K3 shape of chip_smoke.py: smollm M in {4, 64, 512}, the llama4 2-D
# sites at M = 512 (the export pass), the ragged and split checks, and the
# envelope's edge K = 32768; whisper-medium's export (16 x 64 decoder rows,
# the cross K/V over 16 x 1504 frames) and mamba2-130m's (64 x 64 rows;
# in_proj's N = 3352 is not a multiple of 16); recurrentgemma-2b's four
# site shapes at its decode (the W8A8 first and last layers, batch 2) and
# its export
K3_SHAPES = ([(M, K, N) for M in (4, 64, 512) for K, N in SMOLLM_SITES]
             + [(512, K, N) for K, N in LLAMA4_2D]
             + [(7, 577, 200), (130, 577, 200), (130, 4097, 200),
                (64, k3.K_MAX, 256)]
             + [(1024, K, N) for K, N in WHISPER_2D] + [(24064, 1024, 1024)]
             + [(512, 768, 3352), (4096, 768, 3352), (4096, 1536, 768)]
             + [(M, K, N) for M in (2, 4096) for K, N in RG_2D])


def _written(M, K, N, p):
    """How often the kernel writes each int32 of a split launch's
    workspace: block (x, y, z) writes its tile's partial products at
    z * M * N + m * N + n, its column sums after all partial products at
    (z * gy + y) * N + n, its row sums after all column sums at (z * gx
    + x) * M + m, for the rows m < M and columns n < N of its tile."""
    gx, gy, Z = p.grid
    sizes = k3.workspace_ints(M, N, p.grid)
    count = np.zeros(sum(sizes.values()), np.int64)
    col0 = Z * M * N
    row0 = col0 + Z * gy * N
    for z in range(Z):
        for y in range(gy):
            m = np.arange(y * k3.BM, min(M, (y + 1) * k3.BM))
            for x in range(gx):
                n = np.arange(x * k3.BN, min(N, (x + 1) * k3.BN))
                np.add.at(count, (z * M * N + m[:, None] * N + n).ravel(), 1)
                np.add.at(count, col0 + (z * gy + y) * N + n, 1)
                np.add.at(count, row0 + (z * gx + x) * M + m, 1)
    return count


# ------------------------------------------------------------------ planner
@pytest.mark.parametrize("M,K,N", K3_SHAPES,
                         ids=[f"m{M}k{K}n{N}" for M, K, N in K3_SHAPES])
def test_plan_at_k3_shapes(M, K, N):
    p = k3.plan(M, K, N)
    gx, gy, splits = p.grid
    assert gx == math.ceil(N / k3.BN) and gy == math.ceil(M / k3.BM)
    # CUDA's grid limits: x < 2^31, y and z <= 65535
    assert gx < 2**31 and gy <= 65535 and 1 <= splits <= 65535
    # the splits cover K exactly once, in whole K steps
    assert p.k_per_split % k3.BK == 0
    assert (splits - 1) * p.k_per_split < K <= splits * p.k_per_split
    if splits > 1:
        # only grids that leave SMs idle split, into splits of at least
        # MIN_SPLIT_STEPS steps, each tile on one of the split counters
        assert gx * gy * splits <= k3.SMS
        assert p.k_per_split >= k3.MIN_SPLIT_STEPS * k3.BK
        assert gx * gy <= k3.MAX_SPLIT_TILES
        # every int32 of the workspace written exactly once, none beyond
        assert p.workspace_bytes % 4 == 0
        count = _written(M, K, N, p)
        assert 4 * count.size == p.workspace_bytes
        assert (count == 1).all()
    else:
        assert p.workspace_bytes == 0
        assert (gx * gy >= k3.SMS
                or K < 2 * k3.MIN_SPLIT_STEPS * k3.BK)
    assert p.vec_a == (K % 16 == 0) and p.vec_b == (N % 16 == 0)


def test_plan_splits_the_long_k_shapes():
    """At M = 512 only llama4's (5120, 1024) leaves SMs idle with K long
    enough to split, and at whisper's export M = 1024 only w_down (4096,
    1024); the envelope's edge and the ragged split check split; so does
    recurrentgemma-2b's decode through w_down (7680, 2560), in 3."""
    assert [s for s in K3_SHAPES if k3.plan(*s).splits > 1] == [
        (512, 5120, 1024), (130, 4097, 200), (64, k3.K_MAX, 256),
        (1024, 4096, 1024), (2, 7680, 2560)]
    assert k3.plan(2, 7680, 2560).splits == 3
    assert k3.plan(1024, 4096, 1024).splits == 2
    assert k3.plan(512, 5120, 1024).splits == 2
    assert k3.plan(64, k3.K_MAX, 256).splits == 16


@pytest.mark.parametrize("M,K,N,a_ptr,b_ptr,vec_a,vec_b", [
    (512, 576, 1536, 0, 0, True, True),
    (512, 576, 1536, 1, 0, False, True),     # a_q one byte off 16 bytes
    (512, 576, 1536, 0, 8, True, False),     # b_q eight bytes off
    (512, 576, 1536, 1, 1, False, False),
    (7, 577, 200, 0, 0, False, False),       # K % 16, N % 16
    (130, 4096, 200, 0, 0, True, False),
])
def test_plan_flags_misaligned(M, K, N, a_ptr, b_ptr, vec_a, vec_b):
    p = k3.plan(M, K, N, a_ptr=a_ptr, b_ptr=b_ptr)
    assert (p.vec_a, p.vec_b) == (vec_a, vec_b)


@pytest.mark.parametrize("kwargs,match", [
    (dict(M=64, K=k3.K_MAX + 1, N=256), "envelope"),
    (dict(M=64, K=64, N=64, a_dtype=torch.uint8), "int8"),
    (dict(M=64, K=64, N=64, b_dtype=torch.float32), "int8"),
    (dict(M=0, K=64, N=64), "no plan"),
    (dict(M=64, K=-1, N=64), "no plan"),
    (dict(M=65536 * 128, K=64, N=16), "grid"),
])
def test_plan_refuses_what_no_kernel_takes(kwargs, match):
    with pytest.raises(ValueError, match=match):
        k3.plan(**kwargs)


# ------------------------------------------------- the weight's byte moves
def _byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the eight bytes of (y << 32) | x."""
    pool = (y << 32) | x
    return sum(((pool >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _stage_weight(b):
    """The kernel's b_q stage: K row r of 128 bytes, its 16-byte chunk c at
    chunk c ^ bswz(r)."""
    st = np.zeros((k3.BK, k3.BN), np.uint8)
    for r in range(k3.BK):
        sw = (r & 1) | ((r >> 1) & 6)
        for c in range(8):
            st[r, 16 * (c ^ sw):16 * (c ^ sw) + 16] = b[r, 16 * c:16 * c + 16]
    return st


def _krow(lane):
    j, r = lane // 8, lane % 8
    return 16 * (j // 2) + 2 * (j % 2) + 4 * (r // 2) + r % 2


def _fragments(stage, warp, ks):
    """A fragments of every lane of ``warp`` at k32 step ``ks``: the lanes'
    ldmatrix row addresses, .trans on 16-bit elements, two byte permutes
    per register pair."""
    rows = []
    for lane in range(32):  # the 16-byte row each lane's address names
        r = ks * 32 + _krow(lane)
        sw = (r & 1) | ((r >> 1) & 6)
        rows.append(stage[r, 16 * (warp ^ sw):16 * (warp ^ sw) + 16])
    el = [np.frombuffer(row.tobytes(), np.uint16) for row in rows]
    frags = []
    for lane in range(32):
        g, t = lane // 4, lane % 4
        # .trans: thread (g, t) holds rows 2t, 2t + 1 of each 8x8 matrix j
        # at 16-bit column g
        q = [int(el[8 * j + 2 * t][g]) | (int(el[8 * j + 2 * t + 1][g]) << 16)
             for j in range(4)]
        frags.append((_byte_perm(q[0], q[1], 0x6420),
                      _byte_perm(q[0], q[1], 0x7531),
                      _byte_perm(q[2], q[3], 0x6420),
                      _byte_perm(q[2], q[3], 0x7531)))
    return frags


def _bytes(word):
    return [(word >> (8 * i)) & 0xFF for i in range(4)]


def _dp4a_ones(word):
    """__dp4a(word, 0x01010101, 0): the sum of its four signed bytes."""
    return sum(v - 256 if v > 127 else v for v in _bytes(word))


@pytest.mark.parametrize("warp", range(8))
def test_byte_transpose_gives_the_a_fragment(warp):
    """Thread (g, t) of warp w must hold, for weight columns 16w + 2g (A row
    g) and 16w + 2g + 1 (A row g + 8), K rows 4t..4t + 3 and 16 + 4t..
    16 + 4t + 3 of each k32 step, lower K in the lower byte: the
    mma.m16n8k32 / wgmma k32 A fragment of 8-bit types. The IDP4A of each
    register with 0x01010101 adds up to the tile's column sums."""
    rng = np.random.default_rng(warp)
    b = rng.integers(0, 256, (k3.BK, k3.BN)).astype(np.uint8)
    stage = _stage_weight(b)
    colsum = np.zeros(16, np.int64)
    for ks in range(k3.BK // 32):
        for lane, a in enumerate(_fragments(stage, warp, ks)):
            g, t = lane // 4, lane % 4
            c0, c1 = 16 * warp + 2 * g, 16 * warp + 2 * g + 1
            k_lo = ks * 32 + 4 * t + np.arange(4)
            assert _bytes(a[0]) == list(b[k_lo, c0])
            assert _bytes(a[1]) == list(b[k_lo, c1])
            assert _bytes(a[2]) == list(b[k_lo + 16, c0])
            assert _bytes(a[3]) == list(b[k_lo + 16, c1])
            colsum[2 * g] += _dp4a_ones(a[0]) + _dp4a_ones(a[2])
            colsum[2 * g + 1] += _dp4a_ones(a[1]) + _dp4a_ones(a[3])
    np.testing.assert_array_equal(
        colsum, b.view(np.int8)[:, 16 * warp:16 * warp + 16].astype(np.int64).sum(0))


def test_shared_memory_phases_are_conflict_free():
    """Each 8-lane phase of the weight tile's ldmatrix reads 8 rows of 16
    bytes in 8 distinct 16-byte bank groups; so do 8 consecutive threads
    of the row-sum reads of the a_q tile (128-byte swizzle); and every
    row's 8 chunks stay a permutation of its 8 slots."""
    for warp in range(8):
        for ks in range(k3.BK // 32):
            for j in range(4):
                slots = set()
                for lane in range(8 * j, 8 * j + 8):
                    r = ks * 32 + _krow(lane)
                    sw = (r & 1) | ((r >> 1) & 6)
                    slots.add((r * k3.BN // 16 + (warp ^ sw)) % 8)
                assert len(slots) == 8
    for base in range(0, 256, 8):
        for j in range(4):
            slots = {(r * 8 + (((tid % 2) * 4 + j) ^ (r % 8))) % 8
                     for tid in range(base, base + 8) for r in [tid // 2]}
            assert len(slots) == 8
    for r in range(k3.BK):
        sw = (r & 1) | ((r >> 1) & 6)
        assert sorted(c ^ sw for c in range(8)) == list(range(8))
        assert sorted(c ^ (r % 8) for c in range(8)) == list(range(8))


# ------------------------------------------- the launch, modelled in numpy
def _kernel_model(a_q, b_q, a_s, a_z, b_s, b_z, p):
    """The launch ``p`` block by block: int32 partial products and sums
    over each split's K range (zero-filled past K), added over the splits
    by the last block, then the epilogue of qmatmul_int8.py:46-53 in
    float32, each operation rounded alone."""
    M, K = a_q.shape
    N = b_q.shape[1]
    a = a_q.astype(np.int64)
    b = b_q.astype(np.int64)
    acc = np.zeros((M, N), np.int64)
    colsum = np.zeros(N, np.int64)
    rowsum = np.zeros(M, np.int64)
    for z in range(p.splits):
        kr = slice(z * p.k_per_split, min(K, (z + 1) * p.k_per_split))
        part = a[:, kr] @ b[kr]
        assert np.abs(part).max(initial=0) < 2**31  # int32 partial sums
        acc += part
        colsum += b[kr].sum(0)
        rowsum += a[:, kr].sum(1)
        assert np.abs(acc).max(initial=0) < 2**31
    f = np.float32
    scale = (f(a_s) * b_s.astype(f))[0]
    bz = b_z.astype(f)[0]
    kzz = (f(K) * f(a_z)) * bz
    corr = (f(a_z) * colsum.astype(f))[None] + rowsum.astype(f)[:, None] * bz
    corr = corr - kzz
    return scale * (acc.astype(f) - corr)


@pytest.mark.parametrize("M,K,N", [(7, 577, 200), (130, 577, 200),
                                   (130, 4097, 200), (64, 4096, 136)])
def test_launch_model_matches_pallas_interpret(M, K, N):
    """The model of the launch (split or not, as planned) against the
    reference's Pallas kernel in interpret mode, bit for bit: the int32
    sums are exact and the epilogue associates as the Pallas kernel does.
    The plain version associates as ref.py; with integral zero points, as
    the deploy path has them, it may differ only where K * a_z * b_z
    leaves float32's integers (K above ~1000): by a few roundings of the
    largest term."""
    rng = np.random.default_rng([M, K, N])
    a_q = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b_q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    a_s, a_z = np.float32(0.021), np.float32(7.0 - 128.0)
    b_s = (np.exp(rng.standard_normal((1, N)) * 0.2) * 0.2 / 255).astype(np.float32)
    b_z = (np.round(rng.uniform(0, 255, (1, N))) - 128).astype(np.float32)
    p = k3.plan(M, K, N)
    got = _kernel_model(a_q, b_q, a_s, a_z, b_s, b_z, p)
    want = np.asarray(jqmatmul_int8(
        jnp.asarray(a_q), jnp.asarray(b_q), a_s, a_z, jnp.asarray(b_s),
        jnp.asarray(b_z), interpret=True))
    np.testing.assert_array_equal(got, want)
    plain = ref.qmatmul_int8_ref(torch.from_numpy(a_q), torch.from_numpy(b_q),
                                 torch.tensor(a_s), torch.tensor(a_z),
                                 torch.from_numpy(b_s), torch.from_numpy(b_z))
    terms = (np.abs(a_q.astype(np.float64) @ b_q.astype(np.float64))
             + np.abs(a_z * b_q.astype(np.float64).sum(0))
             + np.abs(a_q.astype(np.float64).sum(1, keepdims=True) * b_z)
             + np.abs(K * a_z * b_z))
    tol = 16 * 2.0**-24 * np.abs(a_s * b_s) * terms
    assert (np.abs(got - plain.numpy().astype(np.float64)) <= tol).all()
    if K * 128 * 128 < 2**24:
        np.testing.assert_array_equal(got, plain.numpy())


def test_launch_model_at_the_envelope_edge():
    """K = 32768 with every code -128: acc = 2^29 for every output, carried
    through every split's int32 partial sums, as the card check runs it."""
    M, K, N = 64, k3.K_MAX, 256
    p = k3.plan(M, K, N)
    a_q = np.full((M, K), -128, np.int8)
    b_q = np.full((K, N), -128, np.int8)
    ones, zeros = np.ones((1, N), np.float32), np.zeros((1, N), np.float32)
    got = _kernel_model(a_q, b_q, np.float32(1), np.float32(0), ones, zeros, p)
    assert p.splits > 1
    np.testing.assert_array_equal(got, np.full((M, N), 2.0**29, np.float32))
