// K5: batched-expert weight-only dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/dequant_matmul_w4.py:
// dequant_matmul_batched (:157, pl.pallas_call at :186, _kernel_batched
// :57), the per-expert product over stacked MoE weights:
//
//   out[e] = x[e] @ (scale[e] * (codes[e] - zero[e]))
//
// x (E, M, K), codes (E, K/2, N) nibble-packed along K (K rows 2i in the
// low nibble, 2i+1 in the high nibble of byte row i) or (E, K, N), scale and
// zero (E, 1, N), out (E, M, N). Expert e = blockIdx.z; each expert's weight
// is read once per M tile, never dequantized in device memory.
// Accumulation is float32; the output has x's type (float32, or bfloat16
// rounded to nearest even). The 2-D kernels K1/K2 live in
// dequant_matmul_2d.cu.
//
// Bound on this card: at decode (4 capacity rows per expert) the kernel has
// to read the whole stack once (K*N/2 bytes per expert packed, K*N
// unpacked) for 2*M*K*N flops, far below the ~295 flops per byte at which
// an H100 stops being memory bound, so the bound is the weight bytes over
// 3.35 TB/s (16 experts of 5120 x 8192 W4: 335.5 MB, ~0.100 ms).
//
// Design (simple and right first): one block owns a BM x BN output tile of
// one expert and loops over K in BK steps. Each step stages the x tile as
// float32 and the dequantized weight tile in shared memory; nibbles are
// unpacked and scale*(q - zero) applied in registers while loading. Ragged
// M, N and K edges are masked at load and store time (no padded copies,
// unlike the TPU wrapper's _pad_mkn). Left for later work: the decode design
// of dequant_matmul_2d.cu with an expert grid axis, tensor cores, and
// skipping capacity rows no token fills.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;        // 8 row groups of one warp each
constexpr int ROWS_PER_THREAD = BM / ROW_GROUPS;  // 4 outputs per thread

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <bool PACKED, typename T>
__global__ void __launch_bounds__(THREADS)
dequant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                      const float* __restrict__ scale,
                      const float* __restrict__ zero, T* __restrict__ out,
                      int M, int K, int N) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rgrp = tid / BN;
  const int n = blockIdx.x * BN + col;
  const int m0 = blockIdx.y * BM;
  {  // expert e = blockIdx.z
    const size_t e = blockIdx.z;
    x += e * M * K;
    codes += e * (PACKED ? K / 2 : K) * N;
    scale += e * N;
    zero += e * N;
    out += e * M * N;
  }
  const bool n_ok = n < N;
  const float s = n_ok ? scale[n] : 0.0f;
  const float z = n_ok ? zero[n] : 0.0f;
  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK;
      const int c = i % BK;
      const int m = m0 + r;
      const int k = k0 + c;
      xs[r][c] = (m < M && k < K) ? load_f32(x + (size_t)m * K + k) : 0.0f;
    }
#pragma unroll
    for (int r = rgrp; r < BK; r += ROW_GROUPS) {
      const int k = k0 + r;
      float w = 0.0f;
      if (n_ok && k < K) {
        int q;
        if (PACKED) {
          const uint8_t b = codes[(size_t)(k >> 1) * N + n];
          q = (k & 1) ? (b >> 4) : (b & 0xF);
        } else {
          q = codes[(size_t)k * N + n];
        }
        // the reference's scale * (q - zero): q - zero is exact, one rounding
        w = s * (static_cast<float>(q) - z);
      }
      ws[r][col] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float w = ws[kk][col];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        acc[i] = fmaf(xs[rgrp + i * ROW_GROUPS][kk], w, acc[i]);
      }
    }
    __syncthreads();
  }
  if (!n_ok) return;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + rgrp + i * ROW_GROUPS;
    if (m < M) store_f32(out + (size_t)m * N + n, acc[i]);
  }
}

template <bool PACKED, typename T>
int launch(const void* x, const void* codes, const void* scale,
           const void* zero, void* out, int E, int M, int K, int N,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  dequant_matmul_kernel<PACKED, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<T*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes). x and out are float32 when bf16 == 0
// and bfloat16 otherwise; codes uint8 (E, K/2, N) when packed, else (E, K, N);
// scale and zero float32 (E, 1, N); all contiguous. Runs on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launch.
extern "C" int dequant_matmul_batched(const void* x, const void* codes,
                                      const void* scale, const void* zero,
                                      void* out, int E, int M, int K, int N,
                                      int packed, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    return bf16 ? launch<true, __nv_bfloat16>(x, codes, scale, zero, out, E, M, K, N, s)
                : launch<true, float>(x, codes, scale, zero, out, E, M, K, N, s);
  }
  return bf16 ? launch<false, __nv_bfloat16>(x, codes, scale, zero, out, E, M, K, N, s)
              : launch<false, float>(x, codes, scale, zero, out, E, M, K, N, s);
}

extern "C" const char* dequant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
