// K3: W8A8 integer matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/qmatmul_int8.py:
// qmatmul_int8 (:58; pl.pallas_call at :91, _kernel :31).
//
//   acc[M, N] = a_q[M, K] @ b_q[K, N]            int8 x int8 -> int32, exact
//   corr      = a_z*colsum[n] + rowsum[m]*b_z[n] - K*a_z*b_z[n]
//   out       = a_s*b_s[n] * (acc - corr)         float32
//
// with colsum/rowsum taken by the wrapper (torch.sum on int32) outside the
// kernel, as the reference does. The epilogue follows qmatmul_int8.py:46-53
// term for term in float32 with every multiply and add rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn): no FMA contraction, so it rounds like
// the reference kernel's separate float ops.
//
// Bound on this card: 2*M*K*N int8 ops against the 1,979 TOP/s int8 tensor
// core rate; at the export-pass shapes (M = 512) the operands are ~1.2 MB,
// so the ops bound the work. This first version uses CUDA-core integer
// multiply-adds and is far from that bound.
//
// Design (simple and right first): one block owns a BM x BN output tile and
// loops over K in BK steps, staging int8 tiles (widened to int32) in shared
// memory; each thread keeps four int32 accumulators in registers. The int32
// accumulator is exact for K <= 131072 (|acc| <= 128*128*K < 2^31); the
// wrapper enforces the reference's envelope, K <= 32768. Ragged edges are
// masked, not padded. Left for later work: mma.sync / wgmma s8, __dp4a,
// TMA staging.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;
constexpr int ROWS_PER_THREAD = BM / ROW_GROUPS;

__global__ void __launch_bounds__(THREADS)
qmatmul_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    const float* __restrict__ a_scale,
                    const float* __restrict__ a_zero,
                    const float* __restrict__ b_scale,
                    const float* __restrict__ b_zero,
                    const int32_t* __restrict__ colsum,
                    const int32_t* __restrict__ rowsum, float* __restrict__ out,
                    int M, int K, int N) {
  __shared__ int32_t as[BM][BK + 1];
  __shared__ int32_t bs[BK][BN];
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rgrp = tid / BN;
  const int n = blockIdx.x * BN + col;
  const int m0 = blockIdx.y * BM;
  const bool n_ok = n < N;
  int32_t acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK;
      const int c = i % BK;
      const int m = m0 + r;
      const int k = k0 + c;
      as[r][c] = (m < M && k < K) ? static_cast<int32_t>(a[(size_t)m * K + k]) : 0;
    }
#pragma unroll
    for (int r = rgrp; r < BK; r += ROW_GROUPS) {
      const int k = k0 + r;
      bs[r][col] = (n_ok && k < K) ? static_cast<int32_t>(b[(size_t)k * N + n]) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const int32_t w = bs[kk][col];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        acc[i] += as[rgrp + i * ROW_GROUPS][kk] * w;
      }
    }
    __syncthreads();
  }
  if (!n_ok) return;
  const float a_s = *a_scale;
  const float a_z = *a_zero;
  const float b_s = b_scale[n];
  const float b_z = b_zero[n];
  const float k_real = static_cast<float>(K);
  const float cs = static_cast<float>(colsum[n]);
  const float scale = __fmul_rn(a_s, b_s);
  const float kzz = __fmul_rn(__fmul_rn(k_real, a_z), b_z);
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + rgrp + i * ROW_GROUPS;
    if (m >= M) continue;
    const float rs = static_cast<float>(rowsum[m]);
    const float corr =
        __fsub_rn(__fadd_rn(__fmul_rn(a_z, cs), __fmul_rn(rs, b_z)), kzz);
    out[(size_t)m * N + n] =
        __fmul_rn(scale, __fsub_rn(static_cast<float>(acc[i]), corr));
  }
}

}  // namespace

// Plain C interface (bound with ctypes). a (M, K) and b (K, N) int8;
// a_scale and a_zero one float32 each (device pointers); b_scale, b_zero
// float32 (1, N); colsum int32 (1, N); rowsum int32 (M, 1); out float32
// (M, N). Runs on `stream`, allocates nothing, and returns cudaGetLastError()
// after the launch.
extern "C" int qmatmul_int8(const void* a, const void* b, const void* a_scale,
                            const void* a_zero, const void* b_scale,
                            const void* b_zero, const void* colsum,
                            const void* rowsum, void* out, int M, int K, int N,
                            void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmatmul_int8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(a_scale), static_cast<const float*>(a_zero),
      static_cast<const float*>(b_scale), static_cast<const float*>(b_zero),
      static_cast<const int32_t*>(colsum), static_cast<const int32_t*>(rowsum),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qmatmul_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
