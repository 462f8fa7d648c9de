// K1 / K2 / K5: weight-only dequant-matmul for Hopper (sm_90a): decode, mma
// and fp32 regimes, on one 2-D operand or on a stack of experts.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dequant_matmul_w4.py:
// dequant_matmul (pl.pallas_call at :118, _kernel :37, _unpack_f32 :29),
// reached through dequant_matmul_w4 (:135, 4-bit codes (K/2, N), K row 2i
// in the low nibble and 2i+1 in the high nibble of byte row i, K1) and
// dequant_matmul_w8 (:144, codes (K, N), one per byte, K2):
//
//   out[M, N] = x[M, K] @ (scale[1, N] * (codes[K, N] - zero[1, N]))
//
// and dequant_matmul_batched (:157, pl.pallas_call at :186, _kernel_batched
// :57, K5), the same product per expert over stacked MoE weights:
//
//   out[e] = x[e] @ (scale[e] * (codes[e] - zero[e]))
//
// with x (E, M, K), codes (E, K/2, N) packed along K or (E, K, N), scale
// and zero (E, 1, N), out (E, M, N).
//
// All kernels compute the factored form
//
//   out[m, n] = scale[n] * sum_k x[m, k] * (q[k, n] - zero[n])
//
// Precondition: zero points are integers in [0, 2^b - 1] (the observers
// clamp round(-wmin / scale) + qmin and the QTensor shifts codes and zero
// by -qmin alike), so q - zero is an integer in [-255, 255]: exact in
// float32 (built as (2^23 + q) - (2^23 + zero), one subtraction) and in
// bfloat16 (8 significant bits). With bf16 x every product is then exact in
// the float32 sum and the scale is applied once, in the epilogue; the
// reference instead rounds scale * (q - zero) to float32 per element, a
// difference of O(2^-24) per term. Accumulation is float32; the output has
// x's type (bfloat16 rounded to nearest even).
//
// Regimes (chosen by the wrapper's pure planning function, kernels/
// dequant_matmul_w4.py:plan, which also sizes the grid and the workspace):
//
// decode (bf16 x, M <= 8) is bound by the weight's bytes (2*M flops per
//   code byte, far below the ~295 flops per byte at which an H100 stops
//   being memory bound). dec_kernel: 8 rows x 128 columns per block, K
//   steps of 128 rows (packed) or 64, a 4-stage cp.async ring: each thread
//   copies 16 bytes of codes along N per request (16 columns, 2 K rows when
//   packed), three stages in flight; (q - zero) is built as bf16 in
//   registers from the staged bytes (a byte permute and a mask per nibble
//   pair) and multiplied on the tensor cores (mma.sync.m16n8k16, 16 weight
//   columns as the 16-row operand and the 8 rows of x as the 8-column
//   one), so unpacking is the only per-weight work on the CUDA cores. K is
//   split over blockIdx.z so that every decode grid puts at least one
//   block on each of the 132 SMs (about two); the last block of each
//   output tile adds the splits.
// mma (bf16 x, M > 8; bound by operations at M = 512). wg_kernel: wgmma
//   (m64n128k16) with the weight as the register operand, built by the
//   same unpacking, and x read by the tensor cores straight from shared
//   memory in the 128-byte swizzle; 128 rows of x by 128 weight columns per
//   block, two blocks per SM, K split when the grid leaves most SMs idle.
// fp32 (float32 x, any M: the checks and the CPU-parity lattices; TF32
//   would break their tolerance) stays on CUDA cores: fp32_kernel streams
//   the codes with 16-byte loads, 4 rows of x per block from shared
//   memory, float32 multiply-adds, over M tiles of 4 rows and K splits.
//
// K5 runs the same three kernels with the template flag BATCHED set; the
// 2-D instantiations (BATCHED false) are the K1/K2 code unchanged, since an
// expert offset computed at run time on the shared kernels made K1 1.7x
// slower at decode. The expert rides on the grid's y axis, blockIdx.y =
// expert * (row tiles per expert) + row tile, so that z stays the K split
// and the decode kernel's per-tile split counters (indexed by y * gx + x)
// and its in-kernel reduction cover every expert's tiles unchanged; the
// split workspace is laid out (E, splits, M, N). At decode (4 capacity rows
// per expert, every serving call) K5 is bound by the stack's code bytes:
// 16 experts of 5120 x 8192 are 335.5 MB packed, 0.100 ms at 3.35 TB/s.
// But a serving step routes 4 tokens top-1, so at least 12 of the 16
// experts hold no token, and their rows of x, built by the dispatch einsum
// from an all-zero one-hot, are exactly zero. So a BATCHED block first
// reads its own rows of x over its own K range (16-byte loads, four per
// thread per round, row-major so that the first round finds the token a
// filled capacity slot 0 holds; x is at most 655 KB per decode launch and
// sits in L2) and, where every value is +0 or -0, streams none of its
// codes: it runs the kernel's epilogue on its zero accumulators, writing
// scale * +0 = +0 to its output tile, or +0 as its partial sum with its
// place in the split counter protocol, so the last block of a tile still
// fires and still adds every split. This is exact: (q - zero) and scale
// are finite, so the full computation's sum of +-0 * (q - zero) products
// from +0 is +0 as well. The test is a prologue in the block rather than
// a flag pass, so it costs no second launch and no buffer, needs no host
// sync, and stays capturable in a CUDA graph; fp32_kernel takes the OR of
// the x chunk it stages anyway.
//
// Split launches write float32 partial sums to a workspace and add them in
// split order, never with float atomics, so results do not change from run
// to run; grids that fill the card run one split.
//
// Alignment: 16-byte code loads need N % 16 == 0 and a 16-byte-aligned
// codes pointer, 16-byte x copies K % 8 == 0 and an aligned x pointer
// (each expert's slice then is aligned too); the planning function decides
// from the shape and data_ptr() and otherwise selects the instantiation
// with masked scalar loads. Ragged M, N and K are masked at load and store;
// the last K tile of the tensor-core kernels is zeroed on both x and
// (q - zero) past the split's end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;


// 2^23 + q as a float, exactly, for an integer 0 <= q < 2^23
__device__ __forceinline__ float magic(uint32_t q) {
  return __uint_as_float(0x4B000000u | q);
}

// K5: the block's expert from blockIdx.y = expert * (row tiles) + row tile;
// moves x, codes, scale, zero, out and (split launches) the workspace to
// that expert's slices and returns the block's row tile within it.
#define TO_EXPERT(BM, CODE_ROWS)                                        \
  [&] {                                                                 \
    const int gy_ = (M + (BM) - 1) / (BM);                              \
    const size_t e_ = blockIdx.y / gy_;                                 \
    x += e_ * M * K;                                                    \
    codes += e_ * (CODE_ROWS) * N;                                      \
    scale += e_ * N;                                                    \
    zero += e_ * N;                                                     \
    out += e_ * M * N;                                                  \
    if (gridDim.z > 1) ws += e_ * gridDim.z * M * N;                    \
    return (int)(blockIdx.y - e_ * gy_);                                \
  }()

// -------------------------------------------------------------------- fp32
constexpr int FP_BM = 4;        // rows of x per block
constexpr int FP_COLS = 16;     // columns per thread: one 16-byte code load
constexpr int FP_CT = 8;        // column threads per block
constexpr int FP_BN = FP_COLS * FP_CT;       // 128 columns per block
constexpr int FP_LANES = THREADS / FP_CT;     // 32 K lanes
constexpr int FP_UNROLL = 4;                   // code loads in flight
constexpr int FP_ROW_STEP = FP_LANES * FP_UNROLL;  // 128 code rows

// Dynamic shared memory: the block's K chunk of x as float4 (4 rows per k),
// padded with zeros to a multiple of FP_ROW_STEP code rows, then reused
// for the cross-warp reduction (8 warps x 4 rows x 128 columns). BATCHED:
// one expert of a K5 stack per row of blocks; a block whose staged x chunk
// is all +0 skips its codes.
template <bool PACKED, bool VEC, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
fp32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
            const float* __restrict__ scale, const float* __restrict__ zero,
            float* __restrict__ out, float* __restrict__ ws, int M, int K,
            int N, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KPER = PACKED ? 2 : 1;  // K rows per code row
  const int R = PACKED ? K / 2 : K;
  const int tid = threadIdx.x;
  const int ct = tid % FP_CT;
  const int kl = tid / FP_CT;
  const int nb = blockIdx.x * FP_BN;
  const int n0 = nb + ct * FP_COLS;
  int m0 = blockIdx.y * FP_BM;
  if constexpr (BATCHED) m0 = TO_EXPERT(FP_BM, R) * FP_BM;
  const int rbeg = blockIdx.z * rows_per_split;
  const int nrows = min(rows_per_split, R - rbeg);
  const int padded = (nrows + FP_ROW_STEP - 1) / FP_ROW_STEP * FP_ROW_STEP;
  const int kbeg = rbeg * KPER;
  const int kend = kbeg + nrows * KPER;
  const int nk = padded * KPER;

  uint32_t bits = 0;  // BATCHED: the OR of the staged x, signs dropped
  for (int i = tid; i < FP_BM * nk; i += THREADS) {
    const int m = i / nk;
    const int kk = i - m * nk;
    const int k = kbeg + kk;
    const float v = (m0 + m < M && k < kend) ? x[(size_t)(m0 + m) * K + k]
                                             : 0.0f;
    smem[kk * FP_BM + m] = v;
    if constexpr (BATCHED) bits |= __float_as_uint(v) & 0x7FFFFFFFu;
  }
  float zoff[FP_COLS];
#pragma unroll
  for (int j = 0; j < FP_COLS; ++j) {
    zoff[j] = 8388608.0f + (n0 + j < N ? zero[n0 + j] : 0.0f);
  }
  float acc[FP_BM][FP_COLS];
#pragma unroll
  for (int m = 0; m < FP_BM; ++m) {
#pragma unroll
    for (int j = 0; j < FP_COLS; ++j) acc[m][j] = 0.0f;
  }
  const float4* xs = reinterpret_cast<const float4*>(smem);
  const uint8_t* cbase = codes + (size_t)rbeg * N + n0;
  int lend = padded;  // code rows this block walks
  if constexpr (BATCHED) {
    if (!__syncthreads_or(bits != 0u)) lend = 0;  // x all +-0: codes unread
  } else {
    __syncthreads();
  }

  for (int lr = kl; lr < lend; lr += FP_ROW_STEP) {
    uint32_t w[FP_UNROLL][4];
#pragma unroll
    for (int u = 0; u < FP_UNROLL; ++u) {
      const int r = lr + u * FP_LANES;
      w[u][0] = w[u][1] = w[u][2] = w[u][3] = 0u;
      if (r < nrows && n0 < N) {
        const uint8_t* p = cbase + (size_t)r * N;
        if (VEC) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
          w[u][0] = v.x; w[u][1] = v.y; w[u][2] = v.z; w[u][3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < FP_COLS; ++j) {
            if (n0 + j < N) w[u][j / 4] |= (uint32_t)__ldg(p + j) << (8 * (j % 4));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < FP_UNROLL; ++u) {
      // rows past the split hold zero x, so their (0 - zero) terms add 0
      const int r = lr + u * FP_LANES;
      const float4 xa = xs[r * KPER];
      const float4 xb = PACKED ? xs[r * KPER + 1] : xa;
#pragma unroll
      for (int j = 0; j < FP_COLS; ++j) {
        const uint32_t b = (w[u][j / 4] >> (8 * (j % 4))) & 0xFFu;
        if (PACKED) {
          const float wl = magic(b & 0xFu) - zoff[j];
          const float wh = magic(b >> 4) - zoff[j];
          acc[0][j] = fmaf(xb.x, wh, fmaf(xa.x, wl, acc[0][j]));
          acc[1][j] = fmaf(xb.y, wh, fmaf(xa.y, wl, acc[1][j]));
          acc[2][j] = fmaf(xb.z, wh, fmaf(xa.z, wl, acc[2][j]));
          acc[3][j] = fmaf(xb.w, wh, fmaf(xa.w, wl, acc[3][j]));
        } else {
          const float wv = magic(b) - zoff[j];
          acc[0][j] = fmaf(xa.x, wv, acc[0][j]);
          acc[1][j] = fmaf(xa.y, wv, acc[1][j]);
          acc[2][j] = fmaf(xa.z, wv, acc[2][j]);
          acc[3][j] = fmaf(xa.w, wv, acc[3][j]);
        }
      }
    }
  }

  // the 4 K lanes of a warp (lanes 8 apart), then the 8 warps, in a fixed
  // order
#pragma unroll
  for (int m = 0; m < FP_BM; ++m) {
#pragma unroll
    for (int j = 0; j < FP_COLS; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  }
  __syncthreads();  // every thread is done reading x from smem
  const int warp = tid / 32;
  if (tid % 32 < FP_CT) {
#pragma unroll
    for (int m = 0; m < FP_BM; ++m) {
#pragma unroll
      for (int j = 0; j < FP_COLS; ++j) {
        smem[(warp * FP_BM + m) * FP_BN + ct * FP_COLS + j] = acc[m][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < FP_BM * FP_BN; i += THREADS) {
    const int m = i / FP_BN;
    const int c = i % FP_BN;
    float s = 0.0f;
#pragma unroll
    for (int wp = 0; wp < THREADS / 32; ++wp) {
      s += smem[(wp * FP_BM + m) * FP_BN + c];
    }
    const int gm = m0 + m;
    const int n = nb + c;
    if (gm < M && n < N) {
      if (gridDim.z == 1) {
        out[(size_t)gm * N + n] = scale[n] * s;
      } else {
        ws[((size_t)blockIdx.z * M + gm) * N + n] = s;
      }
    }
  }
}

// Second pass of a split fp32_kernel launch: out = scale * (sum of the
// splits' partial sums, in split order). BATCHED: expert blockIdx.y.
template <bool BATCHED>
__global__ void __launch_bounds__(THREADS)
reduce_splits_kernel(const float* __restrict__ ws,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int M, int N, int splits) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  if constexpr (BATCHED) {
    ws += (size_t)blockIdx.y * splits * mn;
    scale += (size_t)blockIdx.y * N;
    out += (size_t)blockIdx.y * mn;
  }
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  out[i] = scale[i % N] * s;
}


// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading src
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// lo at the lower k, in the low half, as the mma fragments order them;
// both are integers in [-255, 255], so the rounding is exact
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}
// Two consecutive code bytes of one smem row, in the low half of a word.
__device__ __forceinline__ uint32_t load_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The B fragment of half step h (rows kk, kk + 1 of the thread's NJ
// columns) from its raw code words: packed, byte j holds rows kk (low
// nibble) and kk + 1 (high) of column j, gathered into bf16x2 {128 + lo,
// 128 + hi} by one byte permute and one mask-and-or, minus zb[j] =
// {128 + zero, 128 + zero}; unpacked, bytes j of words cw[0..] / cw[NW..]
// hold rows kk / kk + 1, placed under the exponent of 2^23 by one byte
// permute, minus 2^23 + zero, and packed to bf16x2. All values are
// integers below 2^8 in magnitude, so every step is exact.
template <int NJ, bool PACKED, int CWN>
__device__ __forceinline__ void build_b(uint32_t (&b)[NJ][2], int h,
                                        const uint32_t (&cw)[CWN],
                                        const uint32_t (&zb)[NJ],
                                        const float (&zoff)[NJ]) {
  constexpr int NW = (NJ + 3) / 4;
  if (PACKED) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t lo = cw[i] & 0x0F0F0F0Fu;
      const uint32_t hi = (cw[i] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int jj = 0; jj < 4 && 4 * i + jj < NJ; ++jj) {
        const int j = 4 * i + jj;
        const uint32_t p = __byte_perm(lo, hi, jj | (jj << 4) | ((4 + jj) << 8)
                                                   | ((4 + jj) << 12));
        const uint32_t q = (p & 0x000F000Fu) | 0x43004300u;
        b[j][h] = as_u32(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&q),
                                 *reinterpret_cast<const __nv_bfloat162*>(&zb[j])));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint32_t sel = (j % 4) | (4 << 4) | (4 << 8) | (7 << 12);
      const float lo = __uint_as_float(__byte_perm(cw[j / 4], 0x4B000000u, sel)) - zoff[j];
      const float hi = __uint_as_float(__byte_perm(cw[NW + j / 4], 0x4B000000u, sel)) - zoff[j];
      b[j][h] = pack_bf16x2(lo, hi);
    }
  }
}

// K5's skip test: whether rows [m0, min(M, m0 + BM)) of x (row length K)
// hold any value other than +0 or -0 over columns [kbeg, kend) (a signed
// zero adds a +-0 product to the +0 accumulator, which stays +0). Rounds of
// SKIP_LOADS loads per thread, row-major, the block stopping at the first
// round that finds one; every thread returns the same answer.
constexpr int SKIP_LOADS = 4;
template <int BM, bool VEC_X>
__device__ __forceinline__ bool rows_nonzero(
    const __nv_bfloat16* __restrict__ x, int M, int K, int m0, int kbeg,
    int kend) {
  const int rows = min(BM, M - m0);
  const int len = kend - kbeg;
  // VEC_X: K, kbeg and kend are multiples of 8 and x is 16-byte aligned
  const int per_row = VEC_X ? len / 8 : len;
  const int total = rows * per_row;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  for (int base = 0; base < total; base += THREADS * SKIP_LOADS) {
    uint32_t bits = 0;
#pragma unroll
    for (int u = 0; u < SKIP_LOADS; ++u) {
      const int i = base + u * THREADS + threadIdx.x;
      if (i < total) {
        const int r = i / per_row;
        const int c = i - r * per_row;
        const size_t off = (size_t)(m0 + r) * K + kbeg;
        if (VEC_X) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + off) + c);
          bits |= v.x | v.y | v.z | v.w;
        } else {
          bits |= __ldg(xb + off + c);
        }
      }
    }
    if (__syncthreads_or((bits & 0x7FFF7FFFu) != 0u)) return true;
  }
  return false;
}

// The decode tile: 8 rows of x by 128 weight columns, K steps of 128 rows
// (packed) or 64, a 4-stage cp.async ring, 8 warps of 16 columns each.
constexpr int DEC_BM = 8;
constexpr int DEC_BN = 128;
constexpr int DEC_ST = 4;
constexpr int DEC_CS = DEC_BN + 16;  // code row bytes: conflict-free B reads
__host__ __device__ constexpr int dec_bk(bool packed) {
  return packed ? 128 : 64;
}
__host__ __device__ constexpr int dec_x_bytes(bool packed) {
  return DEC_ST * DEC_BM * (dec_bk(packed) + 8) * 2;  // rows padded 16 bytes
}
__host__ __device__ constexpr int dec_smem(bool packed) {
  return dec_x_bytes(packed)
         + DEC_ST * (packed ? dec_bk(packed) / 2 : dec_bk(packed)) * DEC_CS;
}

// Dynamic shared memory of the tensor-core kernels: the x ring, then the
// code ring.
extern __shared__ __align__(16) uint8_t tc_smem[];

// The decode regime. Warp w owns weight columns 16 w .. 16 w + 15 of the
// block, interleaved so that each thread's two columns (2g, 2g + 1) are
// adjacent code bytes (build_b turns them into bf16 (q - zero)); they are
// the 16-row operand of mma.m16n8k16 and the 8 rows of x the 8-column one,
// so no row of the product is padding. The fragments of each k16 step load
// while the previous step's B is built and its product issues. Blocks
// along z take k_per_split K rows each (a multiple of 8); the last block of
// an output tile to finish adds the tile's float32 partial sums in split
// order and resets its counter, so a split launch needs no second pass and
// its result does not depend on the order the blocks ran in. BATCHED (K5):
// one expert per row of blocks along y; a block whose rows of x are all +0
// over its K range runs no K tile and goes straight to the epilogue with
// zero accumulators, taking its part in the split protocol.
template <bool PACKED, bool VEC_X, bool VEC_C, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 4)
dec_kernel(const __nv_bfloat16* __restrict__ x,
           const uint8_t* __restrict__ codes, const float* __restrict__ scale,
           const float* __restrict__ zero, __nv_bfloat16* __restrict__ out,
           float* __restrict__ ws, int* __restrict__ counters, int M, int K,
           int N, int k_per_split) {
  constexpr int BK = dec_bk(PACKED);
  constexpr int KS = BK / 16;                    // k16 steps per tile
  constexpr int XS = BK + 8;                     // x row, 16 bytes padded
  constexpr int CROWS = PACKED ? BK / 2 : BK;
  constexpr int CS = DEC_CS;
  constexpr int XCH = BK / 8;                    // 16-byte chunks per x row
  constexpr int CCH = DEC_BN / 16;               // 16-byte chunks per code row
  constexpr int CW = PACKED ? 1 : 2;             // code words per half step
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  uint8_t* cs = tc_smem + dec_x_bytes(PACKED);
  __shared__ int last_block;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wn0 = (tid / 32) * 16;               // warp's first column
  const int g = lane / 4;
  const int t = lane % 4;
  int m0 = blockIdx.y * DEC_BM;
  if constexpr (BATCHED) m0 = TO_EXPERT(DEC_BM, PACKED ? K / 2 : K) * DEC_BM;
  const int n0 = blockIdx.x * DEC_BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int rend = PACKED ? kend / 2 : kend;  // K and kend are even if PACKED
  int ntiles = (kend - kbeg + BK - 1) / BK;
  if constexpr (BATCHED) {
    if (!rows_nonzero<DEC_BM, VEC_X>(x, M, K, m0, kbeg, kend)) ntiles = 0;
  }

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kbeg + kt * BK;
    for (int i = tid; i < DEC_BM * XCH; i += THREADS) {
      const int r = i / XCH;
      const int k = k0 + (i % XCH) * 8;
      const int gm = m0 + r;
      __nv_bfloat16* dst = xs + (stage * DEC_BM + r) * XS + (i % XCH) * 8;
      if (VEC_X) {  // K % 8 == 0: a chunk lies wholly inside or past kend
        const bool ok = gm < M && k < kend;
        cp_async16(dst, ok ? static_cast<const void*>(x + (size_t)gm * K + k)
                           : static_cast<const void*>(x), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dst[e] = (gm < M && k + e < kend) ? x[(size_t)gm * K + k + e]
                                            : __float2bfloat16_rn(0.0f);
        }
      }
    }
    for (int i = tid; i < CROWS * CCH; i += THREADS) {
      const int r = i / CCH;
      const int gr = (PACKED ? k0 / 2 : k0) + r;
      const int n = n0 + (i % CCH) * 16;
      uint8_t* dst = cs + (stage * CROWS + r) * CS + (i % CCH) * 16;
      if (VEC_C) {  // N % 16 == 0
        const bool ok = gr < rend && n < N;
        cp_async16(dst, ok ? static_cast<const void*>(codes + (size_t)gr * N + n)
                           : static_cast<const void*>(codes), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          dst[e] = (gr < rend && n + e < N) ? codes[(size_t)gr * N + n + e] : 0;
        }
      }
    }
  };

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // per column of the thread: 2^23 + zero (unpacked) or bf16x2
  // {128 + zero, 128 + zero} (packed)
  float zoff[2];
  uint32_t zb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = n0 + wn0 + g * 2 + j;
    const float z = n < N ? zero[n] : 0.0f;
    zoff[j] = 8388608.0f + z;
    zb[j] = pack_bf16x2(128.0f + z, 128.0f + z);
  }

  // x fragments (ldmatrix, rows 0-7) and the raw code words of k16 step
  // ks: rows kk (and kk + 1 unpacked) of the thread's two columns
  auto load_frags = [&](uint32_t (&a)[2], uint32_t (&cw)[2][CW],
                        const __nv_bfloat16* xt, const uint8_t* ct, int ks) {
    ldmatrix_x2(a[0], a[1], xt + (lane % 8) * XS + ks * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = ks * 16 + h * 8 + 2 * t;
      cw[h][0] = load_u16(ct + (PACKED ? kk / 2 : kk) * CS);
      if (!PACKED) cw[h][CW - 1] = load_u16(ct + (kk + 1) * CS);
    }
  };

#pragma unroll
  for (int s = 0; s < DEC_ST - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<DEC_ST - 2>();
    __syncthreads();  // tile kt landed; the stage refilled below is drained
    {
      const int nt = kt + DEC_ST - 1;
      if (nt < ntiles) load_tile(nt % DEC_ST, nt);
      cp_async_commit();
    }
    const int st = kt % DEC_ST;
    const __nv_bfloat16* xt = xs + st * DEC_BM * XS;
    const uint8_t* ct = cs + st * CROWS * CS + wn0 + g * 2;
    const int k0 = kbeg + kt * BK;
    const bool edge = k0 + BK > kend;
    uint32_t a[2][2];
    uint32_t cw[2][2][CW];
    load_frags(a[0], cw[0], xt, ct, 0);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks + 1 < KS) load_frags(a[(ks + 1) % 2], cw[(ks + 1) % 2], xt, ct, ks + 1);
      uint32_t b[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = ks * 16 + h * 8 + 2 * t;  // tile row of the low half
        build_b<2, PACKED>(b, h, cw[ks % 2][h], zb, zoff);
        if (edge) {  // the last partial tile: (q - zero) is 0 past kend
          const uint32_t keep = (k0 + kk >= kend ? 0u : 0xFFFFu)
                                | (k0 + kk + 1 >= kend ? 0u : 0xFFFF0000u);
          b[0][h] &= keep;
          b[1][h] &= keep;
        }
      }
      // rows g / g + 8 of the warp's 16 columns: columns 2g / 2g + 1
      const uint32_t wa[4] = {b[0][0], b[1][0], b[0][1], b[1][1]};
      mma_bf16(acc, wa, a[ks % 2][0], a[ks % 2][1]);
    }
  }
  cp_async_wait<0>();

  // acc[e] = out[m0 + 2t + (e & 1)][column 2g + (e >> 1) of the warp]
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = m0 + 2 * t + (e & 1);
    const int n = n0 + wn0 + g * 2 + (e >> 1);
    if (row >= M || n >= N) continue;
    if (!split) {
      out[(size_t)row * N + n] = __float2bfloat16_rn(scale[n] * acc[e]);
    } else {
      ws[((size_t)blockIdx.z * M + row) * N + n] = acc[e];
    }
  }
  if (!split) return;
  __threadfence();  // this block's partial sums, visible before the count
  __syncthreads();
  if (tid == 0) {
    int* count = &counters[blockIdx.y * gridDim.x + blockIdx.x];
    last_block = atomicAdd(count, 1) == (int)gridDim.z - 1;
    if (last_block) *count = 0;  // every split has counted: reset
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int Z = gridDim.z;
#pragma unroll
  for (int it = 0; it < DEC_BM * DEC_BN / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int row = m0 + i / DEC_BN;
    const int n = n0 + i % DEC_BN;
    if (row >= M || n >= N) continue;
    const float* p = ws + (size_t)row * N + n;
    const size_t step = (size_t)M * N;
    float s = 0.0f;
    int z = 0;
    for (; z + 4 <= Z; z += 4) {  // four loads in flight, summed in order
      const float v0 = __ldcg(p + z * step), v1 = __ldcg(p + (z + 1) * step);
      const float v2 = __ldcg(p + (z + 2) * step), v3 = __ldcg(p + (z + 3) * step);
      s += v0; s += v1; s += v2; s += v3;
    }
    for (; z < Z; ++z) s += __ldcg(p + z * step);
    out[(size_t)row * N + n] = __float2bfloat16_rn(scale[n] * s);
  }
}

// Second pass of a split wg_kernel launch: bf16 output.
template <bool BATCHED>
__global__ void __launch_bounds__(THREADS)
reduce_splits_bf16_kernel(const float* __restrict__ ws,
                          const float* __restrict__ scale,
                          __nv_bfloat16* __restrict__ out, int M, int N,
                          int splits) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  if constexpr (BATCHED) {
    ws += (size_t)blockIdx.y * splits * mn;
    scale += (size_t)blockIdx.y * N;
    out += (size_t)blockIdx.y * mn;
  }
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  out[i] = __float2bfloat16_rn(scale[i % N] * s);
}

// -------------------------------------------------------- warpgroup mma
// D[64 x 128] += A[64 x 16] * B[16 x 128] on the tensor cores (wgmma): A
// from registers (the layout of four stacked mma.m16n8k16 A fragments,
// warp w of the warpgroup holding rows 16w..16w+15), B from shared memory
// through its descriptor, K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// Keeps a register's value live (and its register unshared) up to here:
// the operands of an in-flight wgmma must not be reused before its wait.
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}
// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), 16-byte chunk c of row r stored at
// chunk c ^ (r % 8), 8-row groups 1024 bytes apart (SBO); the start address
// steps 32 bytes per k16 step inside the row. The group base is 1024-byte
// aligned.
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32)
         | (1ull << 62);
}

constexpr int WG_BM = 128;  // rows of x per block: the wgmma's N
constexpr int WG_BK = 64;
constexpr int WG_ST = 4;    // ring stages; two tiles ahead in flight
constexpr int WG_BN = 128;  // weight columns per block: 2 warpgroups x 64
constexpr int WG_CS = WG_BN + 16;  // code row bytes, padded
__host__ __device__ constexpr int wg_code_rows(bool packed) {
  return packed ? WG_BK / 2 : WG_BK;
}
__host__ __device__ constexpr int wg_x_bytes() {
  return WG_ST * WG_BM * WG_BK * 2;
}
__host__ __device__ constexpr int wg_smem(bool packed) {
  return wg_x_bytes() + WG_ST * wg_code_rows(packed) * WG_CS;
}

// The mma regime on wgmma: the weight is the M operand. Warp w of
// warpgroup wg owns weight columns 64 wg + 16 w .. + 15 and builds their
// (q - zero) as bf16 A fragments in registers with build_b, exactly as the
// decode tile does; x, the B operand, is copied by cp.async into 128-byte
// rows in the 128-byte swizzle (K-major; without it the tensor cores'
// shared-memory reads conflict) and read by the tensor cores through a
// descriptor, with no register copy. Per 64-row K tile a warpgroup issues
// 4 wgmma (m64n128k16) as one group and lets it run while it builds the
// next tile's fragments; a stage is refilled only after the groups that
// read it have completed. Two blocks share an SM. BATCHED (K5): as in
// dec_kernel, one expert per row of blocks, and blocks whose rows of x are
// all +0 over their K range skip every K tile.
template <bool PACKED, bool VEC_X, bool VEC_C, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 2)
wg_kernel(const __nv_bfloat16* __restrict__ x,
          const uint8_t* __restrict__ codes, const float* __restrict__ scale,
          const float* __restrict__ zero, __nv_bfloat16* __restrict__ out,
          float* __restrict__ ws, int M, int K, int N, int k_per_split) {
  constexpr int KS = WG_BK / 16;          // k16 steps per tile
  constexpr int CROWS = wg_code_rows(PACKED);
  constexpr int CS = WG_CS;
  constexpr int XCH = WG_BK / 8;          // 16-byte chunks per x row
  constexpr int CCH = WG_BN / 16;
  constexpr int XST = WG_BM * WG_BK;      // x elements per stage
  constexpr int CW = PACKED ? 1 : 2;      // code words per half step
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  uint8_t* cs = tc_smem + wg_x_bytes();
  if (__cvta_generic_to_shared(xs) % 1024 != 0) __trap();  // swizzle atoms
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wcol = (warp / 4) * 64 + (warp % 4) * 16;  // warp's first column
  const int g = lane / 4;
  const int t = lane % 4;
  int m0 = blockIdx.y * WG_BM;
  if constexpr (BATCHED) m0 = TO_EXPERT(WG_BM, PACKED ? K / 2 : K) * WG_BM;
  const int n0 = blockIdx.x * WG_BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int rend = PACKED ? kend / 2 : kend;
  int ntiles = (kend - kbeg + WG_BK - 1) / WG_BK;
  if constexpr (BATCHED) {
    if (!rows_nonzero<WG_BM, VEC_X>(x, M, K, m0, kbeg, kend)) ntiles = 0;
  }

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kbeg + kt * WG_BK;
    for (int i = tid; i < WG_BM * XCH; i += THREADS) {
      const int r = i / XCH;
      const int c = i % XCH;
      const int k = k0 + c * 8;
      const int gm = m0 + r;
      // row r, 16-byte chunk c at chunk c ^ (r % 8) (128-byte swizzle)
      __nv_bfloat16* dst = xs + stage * XST + r * WG_BK + ((c ^ (r % 8)) * 8);
      if (VEC_X) {
        const bool ok = gm < M && k < kend;
        cp_async16(dst, ok ? static_cast<const void*>(x + (size_t)gm * K + k)
                           : static_cast<const void*>(x), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dst[e] = (gm < M && k + e < kend) ? x[(size_t)gm * K + k + e]
                                            : __float2bfloat16_rn(0.0f);
        }
      }
    }
    for (int i = tid; i < CROWS * CCH; i += THREADS) {
      const int r = i / CCH;
      const int gr = (PACKED ? k0 / 2 : k0) + r;
      const int n = n0 + (i % CCH) * 16;
      uint8_t* dst = cs + (stage * CROWS + r) * CS + (i % CCH) * 16;
      if (VEC_C) {
        const bool ok = gr < rend && n < N;
        cp_async16(dst, ok ? static_cast<const void*>(codes + (size_t)gr * N + n)
                           : static_cast<const void*>(codes), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          dst[e] = (gr < rend && n + e < N) ? codes[(size_t)gr * N + n + e] : 0;
        }
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  float zoff[2];
  uint32_t zb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = n0 + wcol + g * 2 + j;
    const float z = n < N ? zero[n] : 0.0f;
    zoff[j] = 8388608.0f + z;
    zb[j] = pack_bf16x2(128.0f + z, 128.0f + z);
  }
  uint32_t af0[KS][4] = {}, af1[KS][4] = {};

#pragma unroll
  for (int s = 0; s < 2; ++s) {  // two tiles ahead
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  // one K tile: af receives its A fragments; prev holds the previous
  // tile's, in flight until this tile's wait
  auto tile = [&](int kt, uint32_t (&af)[KS][4], uint32_t (&prev)[KS][4]) {
    cp_async_wait<1>();
    __syncthreads();  // tile kt landed; tile kt - 2's wgmma group is done
    if (kt + 2 < ntiles) load_tile((kt + 2) % WG_ST, kt + 2);
    cp_async_commit();
    const int st = kt % WG_ST;
    const int k0 = kbeg + kt * WG_BK;
    const bool edge = k0 + WG_BK > kend;
    const uint8_t* ct = cs + st * CROWS * CS + wcol + g * 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t cw[2][CW];
      uint32_t b[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = ks * 16 + h * 8 + 2 * t;
        cw[h][0] = load_u16(ct + (PACKED ? kk / 2 : kk) * CS);
        if (!PACKED) cw[h][CW - 1] = load_u16(ct + (kk + 1) * CS);
        build_b<2, PACKED>(b, h, cw[h], zb, zoff);
        if (edge) {
          const uint32_t keep = (k0 + kk >= kend ? 0u : 0xFFFFu)
                                | (k0 + kk + 1 >= kend ? 0u : 0xFFFF0000u);
          b[0][h] &= keep;
          b[1][h] &= keep;
        }
      }
      // rows g / g + 8 of the warp's 16: columns 2g / 2g + 1
      af[ks][0] = b[0][0];
      af[ks][1] = b[1][0];
      af[ks][2] = b[0][1];
      af[ks][3] = b[1][1];
    }
    wgmma_fence();
    const __nv_bfloat16* xt = xs + st * XST;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // the k16 step ks starts 32 bytes further into the swizzled rows
      wgmma_m64n128k16(acc, af[ks], smem_desc_sw128(xt + ks * 16));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's group is done: prev is free
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(prev[ks][e]);
  };
  for (int kt = 0; kt < ntiles; kt += 2) {
    tile(kt, af0, af1);
    if (kt + 1 < ntiles) tile(kt + 1, af1, af0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fence_operand(af0[ks][e]);
      fence_operand(af1[ks][e]);
    }
#pragma unroll
  for (int e = 0; e < 64; ++e) fence_operand(acc[e]);
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < WG_BM / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * i + 2 * t + e;  // a row of x and out
        const int n = n0 + wcol + g * 2 + h;     // D row g + 8 h
        if (row >= M || n >= N) continue;
        const float v = acc[4 * i + 2 * h + e];
        if (!split) {
          out[(size_t)row * N + n] = __float2bfloat16_rn(scale[n] * v);
        } else {
          ws[((size_t)blockIdx.z * M + row) * N + n] = v;
        }
      }
    }
  }
}

struct Args {
  const void* x;
  const uint8_t* codes;
  const float* scale;
  const float* zero;
  void* out;
  float* ws;
  int* counters;
  int M, K, N, rows_per_split;
};

template <bool PACKED, bool VEC, bool BATCHED>
void run_fp32(const Args& a, dim3 grid, int smem, cudaStream_t s) {
  fp32_kernel<PACKED, VEC, BATCHED><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(a.x), a.codes, a.scale, a.zero,
      static_cast<float*>(a.out), a.ws, a.M, a.K, a.N, a.rows_per_split);
}

template <bool PACKED, bool VEC_X, bool VEC_C, bool BATCHED>
void run_dec(const Args& a, dim3 grid, cudaStream_t s) {
  dec_kernel<PACKED, VEC_X, VEC_C, BATCHED>
      <<<grid, THREADS, dec_smem(PACKED), s>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.codes, a.scale, a.zero,
      static_cast<__nv_bfloat16*>(a.out), a.ws, a.counters, a.M, a.K, a.N,
      a.rows_per_split);
}

template <bool PACKED, bool VEC_X, bool VEC_C, bool BATCHED>
void run_wg(const Args& a, dim3 grid, cudaStream_t s) {
  wg_kernel<PACKED, VEC_X, VEC_C, BATCHED>
      <<<grid, THREADS, wg_smem(PACKED), s>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.codes, a.scale, a.zero,
      static_cast<__nv_bfloat16*>(a.out), a.ws, a.M, a.K, a.N,
      a.rows_per_split);
}

// Launch one of a kernel's instantiations, chosen by the alignment flags.
#define DISPATCH(RUN, PACKED, BATCHED)                              \
  if (vec_x) {                                                      \
    vec_c ? RUN<PACKED, true, true, BATCHED>(a, grid, s)            \
          : RUN<PACKED, true, false, BATCHED>(a, grid, s);          \
  } else {                                                          \
    vec_c ? RUN<PACKED, false, true, BATCHED>(a, grid, s)           \
          : RUN<PACKED, false, false, BATCHED>(a, grid, s);         \
  }

template <bool PACKED, bool BATCHED>
void dec(bool vec_x, bool vec_c, const Args& a, dim3 grid, cudaStream_t s) {
  DISPATCH(run_dec, PACKED, BATCHED)
}

template <bool PACKED, bool BATCHED>
void wg(bool vec_x, bool vec_c, const Args& a, dim3 grid, cudaStream_t s) {
  DISPATCH(run_wg, PACKED, BATCHED)
}

// Lets the four instantiations of a kernel use `bytes` of dynamic shared
// memory (above 48 KB only by this opt-in); run once at load, outside any
// graph capture.
cudaError_t allow_smem(const void* const (&fns)[4], int bytes) {
  for (const void* fn : fns) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <bool PACKED, bool BATCHED>
cudaError_t allow_smem_all() {
  const void* const dec_fns[4] = {
      reinterpret_cast<const void*>(&dec_kernel<PACKED, true, true, BATCHED>),
      reinterpret_cast<const void*>(&dec_kernel<PACKED, true, false, BATCHED>),
      reinterpret_cast<const void*>(&dec_kernel<PACKED, false, true, BATCHED>),
      reinterpret_cast<const void*>(&dec_kernel<PACKED, false, false, BATCHED>)};
  const void* const wg_fns[4] = {
      reinterpret_cast<const void*>(&wg_kernel<PACKED, true, true, BATCHED>),
      reinterpret_cast<const void*>(&wg_kernel<PACKED, true, false, BATCHED>),
      reinterpret_cast<const void*>(&wg_kernel<PACKED, false, true, BATCHED>),
      reinterpret_cast<const void*>(&wg_kernel<PACKED, false, false, BATCHED>)};
  const cudaError_t e = allow_smem(dec_fns, dec_smem(PACKED));
  return e != cudaSuccess ? e : allow_smem(wg_fns, wg_smem(PACKED));
}

// One call of either C entry: `experts` slices of the operands (1 for the
// 2-D entry), the grid's y axis covering every expert's row tiles.
template <bool BATCHED>
int launch(const Args& a, int experts, int packed, int kernel, bool vec_x,
           bool vec_c, int gx, int gy, int splits, int smem_bytes,
           cudaStream_t s) {
  const dim3 grid(gx, gy, splits);
  bool second_pass = splits > 1;
  switch (kernel) {
    case 0:
      if (packed) {
        vec_c ? run_fp32<true, true, BATCHED>(a, grid, smem_bytes, s)
              : run_fp32<true, false, BATCHED>(a, grid, smem_bytes, s);
      } else {
        vec_c ? run_fp32<false, true, BATCHED>(a, grid, smem_bytes, s)
              : run_fp32<false, false, BATCHED>(a, grid, smem_bytes, s);
      }
      break;
    case 1:  // adds its splits itself
      packed ? dec<true, BATCHED>(vec_x, vec_c, a, grid, s)
             : dec<false, BATCHED>(vec_x, vec_c, a, grid, s);
      second_pass = false;
      break;
    case 2:
      packed ? wg<true, BATCHED>(vec_x, vec_c, a, grid, s)
             : wg<false, BATCHED>(vec_x, vec_c, a, grid, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !second_pass) return static_cast<int>(err);
  const size_t mn = (size_t)a.M * a.N;
  const dim3 rgrid(static_cast<unsigned>((mn + THREADS - 1) / THREADS),
                   experts);
  if (kernel == 0) {
    reduce_splits_kernel<BATCHED><<<rgrid, THREADS, 0, s>>>(
        a.ws, a.scale, static_cast<float*>(a.out), a.M, a.N, splits);
  } else {
    reduce_splits_bf16_kernel<BATCHED><<<rgrid, THREADS, 0, s>>>(
        a.ws, a.scale, static_cast<__nv_bfloat16*>(a.out), a.M, a.N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Sets the tensor-core kernels' dynamic shared memory limits; call once
// after loading the library. Returns the first CUDA error, or 0.
extern "C" int dequant_matmul_2d_init() {
  cudaError_t e = allow_smem_all<true, false>();
  if (e == cudaSuccess) e = allow_smem_all<false, false>();
  if (e == cudaSuccess) e = allow_smem_all<true, true>();
  if (e == cudaSuccess) e = allow_smem_all<false, true>();
  return static_cast<int>(e);
}

// Plain C interface (bound with ctypes); every launch parameter comes from
// the wrapper's planning function. kernel (x and out bfloat16 but for 0):
// 0 fp32_kernel (float32), 1 dec_kernel, 2 wg_kernel.
// codes uint8 (K/2, N) when packed, else (K, N); scale and zero float32
// (1, N); all contiguous. Grid (gx, gy, splits); rows_per_split counts
// code rows for fp32_kernel and K rows (a multiple of 8) for the tensor-
// core kernels. With splits > 1, `ws` holds splits x M x N float32
// partial sums: dec_kernel adds them in its last block per output tile,
// counted in `counters` (gx * gy ints, zero before the launch and after
// it); the other kernels in a second pass. Runs on `stream`, allocates
// nothing, and returns cudaGetLastError() after each launch.
extern "C" int dequant_matmul_2d(const void* x, const void* codes,
                                 const void* scale, const void* zero,
                                 void* out, void* ws, void* counters, int M,
                                 int K, int N, int packed, int kernel,
                                 int vec_x, int vec_codes, int gx, int gy,
                                 int splits, int rows_per_split,
                                 int smem_bytes, void* stream) {
  const Args a{x, static_cast<const uint8_t*>(codes),
               static_cast<const float*>(scale), static_cast<const float*>(zero),
               out, static_cast<float*>(ws), static_cast<int*>(counters),
               M, K, N, rows_per_split};
  return launch<false>(a, 1, packed, kernel, vec_x, vec_codes, gx, gy, splits,
                       smem_bytes, static_cast<cudaStream_t>(stream));
}

// K5, the same interface over E experts: x (E, M, K), codes (E, K/2, N) or
// (E, K, N), scale and zero (E, 1, N), out (E, M, N), contiguous; gy is
// E times the row tiles of one expert, `ws` holds E x splits x M x N
// partial sums and `counters` gx * gy ints. Blocks whose rows of x are all
// +0 over their K range read none of their codes.
extern "C" int dequant_matmul_batched(const void* x, const void* codes,
                                      const void* scale, const void* zero,
                                      void* out, void* ws, void* counters,
                                      int E, int M, int K, int N, int packed,
                                      int kernel, int vec_x, int vec_codes,
                                      int gx, int gy, int splits,
                                      int rows_per_split, int smem_bytes,
                                      void* stream) {
  const Args a{x, static_cast<const uint8_t*>(codes),
               static_cast<const float*>(scale), static_cast<const float*>(zero),
               out, static_cast<float*>(ws), static_cast<int*>(counters),
               M, K, N, rows_per_split};
  return launch<true>(a, E, packed, kernel, vec_x, vec_codes, gx, gy, splits,
                      smem_bytes, static_cast<cudaStream_t>(stream));
}

extern "C" const char* dequant_matmul_2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
