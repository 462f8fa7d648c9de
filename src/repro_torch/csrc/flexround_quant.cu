// K4: fused FlexRound quantize (paper Eq. 2 forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flexround_quant.py:
// flexround_quant (:32, pl.pallas_call at :53, _kernel :21).
//
//   out[M, N] = s1 * (clip(round(w / (s1 * s2 * s3)) + z, qmin, qmax) - z)
//
// w and out are (M, N) float32 or bfloat16; s2 is (M, N) float32; s1, s3
// and z are float32 (1, N) rows. All arithmetic is float32 and each step
// rounds once, as ref.flexround_quant_ref does: (s1 * s2) * s3 and the
// division in IEEE round-to-nearest (__fmul_rn, __fdiv_rn: no FMA
// contraction, no approximate divide), rintf (half to even, as torch.round
// and jnp.round; never roundf), then the clip and s1 * (q - z); the output
// rounds to w's type to nearest even. So the kernel is bit-exact against the
// plain version.
//
// Bound on this card: one pass over w, s2 and out (for bf16 w,
// 2 + 4 + 2 bytes per element) and three (1, N) rows, for ~6 flops per
// element: far below the ~295 flops per byte at which an H100 stops being
// memory bound, so the bound is the bytes over 3.35 TB/s.
//
// Design: a thread owns one column n, loads its s1, s3 and z once into
// registers, and walks rows m = blockIdx.y, blockIdx.y + gridDim.y, ...
// (grid-stride over rows); neighbouring threads touch neighbouring columns,
// so every load and store of a row is coalesced. Ragged N is masked; no
// padded copies (the TPU wrapper pads to (block_m, block_n) tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TARGET_BLOCKS = 132 * 16;  // enough blocks in flight on 132 SMs

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flexround_quant_kernel(const T* __restrict__ w, const float* __restrict__ s1,
                       const float* __restrict__ s2,
                       const float* __restrict__ s3,
                       const float* __restrict__ zero, T* __restrict__ out,
                       int M, int N, float qmin, float qmax) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float a = s1[n];
  const float c = s3[n];
  const float z = zero[n];
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const size_t i = (size_t)m * N + n;
    const float div = __fmul_rn(__fmul_rn(a, s2[i]), c);
    float q = __fadd_rn(rintf(__fdiv_rn(load_f32(w + i), div)), z);
    q = fminf(fmaxf(q, qmin), qmax);
    store_f32(out + i, __fmul_rn(a, __fsub_rn(q, z)));
  }
}

template <typename T>
int launch(const void* w, const void* s1, const void* s2, const void* s3,
           const void* zero, void* out, int M, int N, int qmin, int qmax,
           cudaStream_t stream) {
  const int gx = (N + THREADS - 1) / THREADS;
  int gy = TARGET_BLOCKS / gx;
  gy = gy < 1 ? 1 : (gy > M ? M : gy);
  gy = gy > 65535 ? 65535 : gy;
  const dim3 grid(gx, gy);
  flexround_quant_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const float*>(s1),
      static_cast<const float*>(s2), static_cast<const float*>(s3),
      static_cast<const float*>(zero), static_cast<T*>(out), M, N,
      static_cast<float>(qmin), static_cast<float>(qmax));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes). w and out are float32 when
// bf16 == 0 and bfloat16 otherwise; s2 float32 (M, N); s1, s3 and zero
// float32 (1, N); all contiguous, M >= 1 and N >= 1. Runs on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launch.
extern "C" int flexround_quant(const void* w, const void* s1, const void* s2,
                               const void* s3, const void* zero, void* out,
                               int M, int N, int qmin, int qmax, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(w, s1, s2, s3, zero, out, M, N, qmin, qmax, s)
              : launch<float>(w, s1, s2, s3, zero, out, M, N, qmin, qmax, s);
}

extern "C" const char* flexround_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
