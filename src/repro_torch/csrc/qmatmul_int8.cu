// K3: W8A8 integer matmul for Hopper (sm_90a), on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/qmatmul_int8.py:
// qmatmul_int8 (:58; pl.pallas_call at :91, _kernel :31):
//
//   acc[M, N] = a_q[M, K] @ b_q[K, N]            int8 x int8 -> int32, exact
//   corr      = a_z*colsum[n] + rowsum[m]*b_z[n] - K*a_z*b_z[n]
//   out       = a_s*b_s[n] * (acc - corr)         float32
//
// colsum[n] = sum_k b_q[k, n] and rowsum[m] = sum_k a_q[m, k] are taken in
// this kernel (the reference takes them outside its kernel, with two more
// passes) from the int8 tiles it stages anyway, with __dp4a: the same int32
// sums. The epilogue follows qmatmul_int8.py:46-53 term for term in float32
// with every multiply and add rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn): no FMA contraction, so it rounds like the reference kernel's
// separate float ops. The int32 accumulator is exact for K <= 131072
// (|acc| <= 128*128*K < 2^31); the wrapper enforces the reference's
// envelope, K <= 32768.
//
// What bounds it on this card: 2*M*K*N operations against the 1,979 TOP/s
// of the int8 tensor cores, and the bytes of a_q, b_q and the float32 out
// against 3.35 TB/s. At M = 512 the large llama4-scout shapes (K x N of
// 5120 x 5120, 5120 x 8192, 8192 x 5120) are bound by operations (13.6-21.7
// us). There a 128 x 128 tile reads 32 KB from L2 per K step of 128, and
// with every SM streaming, L2 sets the pace of a step, not the ring's
// depth (4 to 6 stages timed the same on an H100) nor the tensor cores;
// fewer L2 bytes per operation (blocks of a cluster sharing their tiles)
// are the next lever. The smollm-135m shapes and 5120 x 1024 are bound by
// bytes,
// and that bound is a microsecond or less: there latency rules (the
// launch, the first tiles' loads, the epilogue) on grids of 8 to 48 output
// tiles for 132 SMs, and K is split only where it is long enough to pay
// for the partial sums' round trip through L2.
//
// Operand roles. wgmma computes the transposed tile out^T[n, m] =
// sum_k b_q[k, n] * a_q[m, k] (m64n128k32.s32.s8.s8): the weight is the
// 64-row register operand A (a warpgroup's 64 weight columns, 16 a warp),
// and the activation tile the operand B, read by the tensor cores straight
// from shared memory through a descriptor in the 128-byte swizzle. a_q is
// K-contiguous, which is the K-major layout 8-bit shared-memory operands
// must have (the transpose bit exists only for 16-bit types). But every
// 8-bit tensor-core operand wants 4 consecutive K values in each 32-bit
// register, and b_q (K, N) has N contiguous: the weight needs a byte
// transpose. It happens on the way from shared memory to registers.
// ldmatrix.trans moves 16-bit elements, so one .x4 hands each thread 16-bit
// pairs (its two adjacent weight columns) from 4 K rows that the lanes'
// row addresses pick (k = 4t, 4t + 1 from one 8 x 8 matrix, 4t + 2, 4t + 3
// from the next), and two byte permutes per register pair regroup them
// into the A fragment: per k32 step a thread issues one ldmatrix.x4, four
// PRMT and, for its columns' sums, four IDP4A. The weight tile is stored
// with its 16-byte chunks XOR-swizzled by row (bswz) so that the 8 rows
// each ldmatrix phase reads fall on distinct banks.
//
// Pipeline: 128 rows of a_q by 128 weight columns per block (two
// warpgroups), K steps of 128 (one swizzle row of a_q), a 4-stage cp.async
// ring (16 bytes per request, 128 KB of shared memory, one block per SM)
// with tiles k + 1 and k + 2 in flight while tile k's wgmma group runs;
// fragments of tile k are built while tile k - 1's group is still in
// flight. Ragged M, N and K are zero-filled at load (zero adds nothing to
// products or sums) and masked at the store; 16-byte copies need K % 16
// == 0 (a_q) or N % 16 == 0 (b_q) and 16-byte aligned pointers, which the
// wrapper's planner decides, else the instantiation with masked byte loads
// runs.
//
// Split K: a grid with fewer output tiles than SMs and a long K takes K in
// splits of whole 128-row steps (blockIdx.z). Each block writes its int32
// partial products, column sums and row sums to a workspace; the last
// block of a tile to finish (a per-tile counter, zero before and after the
// launch) adds the other splits' to its own and runs the epilogue. Integer
// addition is associative, so the result is exact whatever the order the
// blocks ran in; one launch, no host sync, capturable in a CUDA graph.
// After the K loop every block stages its tile through shared memory, so
// that partial sums, their reduction and the output move as coalesced
// 16-byte rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // two warpgroups
constexpr int BM = 128;       // rows of a_q per block: the wgmma's N
constexpr int BN = 128;       // weight columns per block: 2 x 64
constexpr int BK = 128;       // K per stage: one 128-byte swizzle row of a_q
constexpr int ST = 4;         // ring stages
constexpr int AHEAD = ST - 2; // tiles in flight: a stage is refilled once
                              // the wgmma group two tiles back is done
constexpr int KS = BK / 32;   // k32 steps per stage
constexpr int A_BYTES = BM * BK;  // one stage of a_q
constexpr int B_BYTES = BK * BN;  // one stage of b_q
// the rings (after the K loop: the int32 tile, rows TS ints apart), then
// BM row sums, BN column sums and the last-block flag
constexpr int SMEM = ST * (A_BYTES + B_BYTES) + (BM + BN) * 4 + 16;
constexpr int TS = BN + 4;  // staged tile row: 2-way bank conflicts at most
static_assert(BM * TS * 4 <= ST * (A_BYTES + B_BYTES), "tile fits the ring");
constexpr int ONES = 0x01010101;

extern __shared__ __align__(1024) uint8_t smem[];

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
// shared memory written through the generic proxy (cp.async, stores),
// visible to the tensor cores' async-proxy reads after the next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// D[64 x 128] += A[64 x 32] * B[32 x 128], int8 in, int32 out, on the
// tensor cores: A from registers (the mma.m16n8k32 A fragment, warp w of
// the warpgroup holding rows 16w..16w+15), B from shared memory through
// its descriptor, K-major.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int32_t (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// Keeps a register's value live (and its register unshared) up to here:
// the operands of an in-flight wgmma must not be reused before its wait.
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
__device__ __forceinline__ void fence_operand(int32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
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
// swizzle: rows of 128 int8 (128 bytes), 16-byte chunk c of row r stored
// at chunk c ^ (r % 8), 8-row groups 1024 bytes apart (SBO); the start
// address steps 32 bytes per k32 step inside the row. The group base is
// 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32)
         | (1ull << 62);
}

// The weight tile's swizzle: 16-byte chunk c of K row r is stored at chunk
// c ^ bswz(r). The 8 rows one ldmatrix phase reads (k = 4j + e, e in
// {0, 1}, j in 0..3, plus 0, 2, 16 or 18) map to 8 distinct chunks.
__host__ __device__ constexpr int bswz(int r) {
  return (r & 1) | ((r >> 1) & 6);
}

// One block: out rows m0 .. m0 + 127 by weight columns n0 .. n0 + 127 over
// the split's K range. Warp w (0..7) owns the 16 weight columns of chunk w
// (warpgroup w / 4, A rows 16 (w % 4) ..): A row g is column 2g of the
// chunk and A row g + 8 column 2g + 1, so a thread's two columns are
// adjacent bytes (one 16-bit element of ldmatrix).
template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS, 1)
qmm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
           const float* __restrict__ a_scale, const float* __restrict__ a_zero,
           const float* __restrict__ b_scale, const float* __restrict__ b_zero,
           float* __restrict__ out, int32_t* __restrict__ ws,
           int* __restrict__ counters, int M, int K, int N, int k_per_split) {
  uint8_t* as = smem;                  // ST x BM rows of 128 bytes
  uint8_t* bs = smem + ST * A_BYTES;   // ST x BK rows of 128 bytes
  int32_t* rs_sm = reinterpret_cast<int32_t*>(bs + ST * B_BYTES);
  int32_t* cs_sm = rs_sm + BM;
  int* last_block = reinterpret_cast<int*>(cs_sm + BN);
  if (__cvta_generic_to_shared(as) % 1024 != 0) __trap();  // swizzle atoms
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int ntiles = max(0, (kend - kbeg + BK - 1) / BK);

  // This thread's 16-byte chunks of every stage: chunk c0 of rows r0 + 32u
  // (u < 4) of both tiles; their swizzled places do not depend on u (32u
  // leaves r % 8 and bswz(r) as they are), so the addresses are set here
  // and a tile only moves them along K.
  const int r0 = tid / 8;
  const int c0 = tid % 8;
  const int a_dst = r0 * BK + ((c0 ^ (r0 % 8)) * 16);
  const int b_dst = r0 * BN + ((c0 ^ bswz(r0)) * 16);
  const size_t a_src = (size_t)(m0 + r0) * K + kbeg + c0 * 16;
  const size_t b_src = (size_t)(kbeg + r0) * N + n0 + c0 * 16;
  const bool b_col = n0 + c0 * 16 < N;

  auto load_tile = [&](int stage, int kt) {
    const int kk = kt * BK;  // the tile's first K row within the split
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // a_q: row m0 + r0 + 32u, K columns kbeg + kk + 16 c0 ..
      uint8_t* dst = as + stage * A_BYTES + a_dst + u * 32 * BK;
      const bool row_ok = m0 + r0 + 32 * u < M;
      const int8_t* src = a + a_src + (size_t)u * 32 * K + kk;
      if (VEC_A) {  // K % 16 == 0: a chunk lies wholly inside or past kend
        const bool ok = row_ok && kbeg + kk + c0 * 16 < kend;
        cp_async16(dst, ok ? static_cast<const void*>(src)
                           : static_cast<const void*>(a), ok);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if (row_ok && kbeg + kk + c0 * 16 + e < kend) {
            w[e / 4] |= (uint32_t)(uint8_t)src[e] << (8 * (e % 4));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // b_q: K row kbeg + kk + r0 + 32u, columns n0 + 16 c0 ..
      uint8_t* dst = bs + stage * B_BYTES + b_dst + u * 32 * BN;
      const bool row_ok = kbeg + kk + r0 + 32 * u < kend;
      const int8_t* src = b + b_src + ((size_t)u * 32 + kk) * N;
      if (VEC_B) {  // N % 16 == 0
        const bool ok = row_ok && b_col;
        cp_async16(dst, ok ? static_cast<const void*>(src)
                           : static_cast<const void*>(b), ok);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if (row_ok && n0 + c0 * 16 + e < N) {
            w[e / 4] |= (uint32_t)(uint8_t)src[e] << (8 * (e % 4));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  // ldmatrix row address of this lane inside a k32 step: matrix j = lane
  // / 8 (0, 1: k 0..15; 2, 3: k 16..31), its row r = lane % 8 holds k =
  // 16 (j / 2) + 2 (j % 2) + 4 (r / 2) + r % 2, so that .trans hands thread
  // (g, t) k = 4t, 4t + 1 from matrix 0 and 4t + 2, 4t + 3 from matrix 1
  const int lj = lane / 8;
  const int lr = lane % 8;
  const int krow = 16 * (lj / 2) + 2 * (lj % 2) + 4 * (lr / 2) + (lr % 2);
  const int b_lane = krow * BN + ((warp ^ bswz(krow)) * 16);

  int32_t acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;
  int32_t cs[2] = {0, 0};  // the thread's two columns over its K rows
  int32_t rsum = 0;        // row tid / 2, half tid % 2 of each a_q tile
  uint32_t af0[KS][4] = {}, af1[KS][4] = {};

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  // one K tile: af receives its A fragments; prev holds the previous
  // tile's, in flight until this tile's wait
  auto tile = [&](int kt, uint32_t (&af)[KS][4], uint32_t (&prev)[KS][4]) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();  // tile kt landed; tile kt - 2's wgmma group is done
    if (kt + AHEAD < ntiles) load_tile((kt + AHEAD) % ST, kt + AHEAD);
    cp_async_commit();
    const int st = kt % ST;
    const uint8_t* at = as + st * A_BYTES;
    const uint8_t* bt = bs + st * B_BYTES;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t q[4];
      ldmatrix_x4_trans(q, bt + ks * 32 * BN + b_lane);
      // q[0] = {k 4t: col 2g, 2g + 1; k 4t + 1: ...}, q[1] the same at k
      // 4t + 2, 4t + 3; q[2], q[3] at k + 16: one register per column
      af[ks][0] = __byte_perm(q[0], q[1], 0x6420);  // A row g, k 4t..
      af[ks][1] = __byte_perm(q[0], q[1], 0x7531);  // A row g + 8
      af[ks][2] = __byte_perm(q[2], q[3], 0x6420);  // A row g, k 16 + 4t..
      af[ks][3] = __byte_perm(q[2], q[3], 0x7531);
      cs[0] = __dp4a(static_cast<int>(af[ks][0]), ONES, cs[0]);
      cs[0] = __dp4a(static_cast<int>(af[ks][2]), ONES, cs[0]);
      cs[1] = __dp4a(static_cast<int>(af[ks][1]), ONES, cs[1]);
      cs[1] = __dp4a(static_cast<int>(af[ks][3]), ONES, cs[1]);
    }
    {  // half of the row's 8 chunks; slot (4 half + j) ^ (row % 8), so
       // that the 8 threads of a phase read 8 distinct bank groups
      const int r = tid / 2;
      const uint4* p = reinterpret_cast<const uint4*>(at + r * BK);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 v = p[((tid % 2) * 4 + j) ^ (r % 8)];
        rsum = __dp4a(static_cast<int>(v.x), ONES, rsum);
        rsum = __dp4a(static_cast<int>(v.y), ONES, rsum);
        rsum = __dp4a(static_cast<int>(v.z), ONES, rsum);
        rsum = __dp4a(static_cast<int>(v.w), ONES, rsum);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // the k32 step ks starts 32 bytes further into the swizzled rows
      wgmma_m64n128k32_s8(acc, af[ks], smem_desc_sw128(at + ks * 32));
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

  // the four K lanes t of a column, the two halves of a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 1);
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 2);
  }
  rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);

  // The tile goes through shared memory (the ring is free now) so that
  // the split partial sums, their reduction and the output move as
  // coalesced 16-byte rows: thread (rr, cq) then owns columns 4 cq .. 4 cq
  // + 3 of rows rr + 8 j. acc[4i + 2h + e] is out^T[column 2g + h of chunk
  // warp][row 8i + 2t + e].
  __syncthreads();  // every warp is done with the ring
  int32_t* tile_sm = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      *reinterpret_cast<int2*>(tile_sm + (8 * i + 2 * t + e) * TS + warp * 16
                               + 2 * g) =
          make_int2(acc[4 * i + e], acc[4 * i + 2 + e]);
    }
  if (t == 0) {
    cs_sm[warp * 16 + 2 * g] = cs[0];
    cs_sm[warp * 16 + 2 * g + 1] = cs[1];
  }
  if (tid % 2 == 0) rs_sm[tid / 2] = rsum;
  __syncthreads();
  const int rr = tid / 32;
  const int cq = tid % 32;
  const int n = n0 + 4 * cq;
  const bool vec_n = N % 4 == 0;  // 16-byte rows of the workspace and out
  int4 v[BM / 8];
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    v[j] = *reinterpret_cast<const int4*>(tile_sm + (rr + 8 * j) * TS + 4 * cq);
  }

  if (gridDim.z > 1) {
    const size_t mn = (size_t)M * N;
    const size_t Z = gridDim.z;
    int32_t* wcol = ws + Z * mn;                       // (Z, gridDim.y, N)
    int32_t* wrow = wcol + Z * gridDim.y * (size_t)N;  // (Z, gridDim.x, M)
    const size_t col_at = (size_t)blockIdx.y * N;
    const size_t row_at = (size_t)blockIdx.x * M;
    int32_t* wacc = ws + blockIdx.z * mn;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int m = m0 + rr + 8 * j;
      if (m >= M || n >= N) continue;
      int32_t* p = wacc + (size_t)m * N + n;
      if (vec_n) {
        *reinterpret_cast<int4*>(p) = v[j];
      } else {
        p[0] = v[j].x;
        if (n + 1 < N) p[1] = v[j].y;
        if (n + 2 < N) p[2] = v[j].z;
        if (n + 3 < N) p[3] = v[j].w;
      }
    }
    if (tid < BN) {
      if (n0 + tid < N) wcol[blockIdx.z * gridDim.y * (size_t)N + col_at + n0 + tid] = cs_sm[tid];
    } else if (m0 + tid - BN < M) {
      wrow[blockIdx.z * gridDim.x * (size_t)M + row_at + m0 + tid - BN] = rs_sm[tid - BN];
    }
    __threadfence();  // this block's partial sums, visible before the count
    __syncthreads();
    if (tid == 0) {
      int* count = &counters[blockIdx.y * gridDim.x + blockIdx.x];
      *last_block = atomicAdd(count, 1) == (int)gridDim.z - 1;
      if (*last_block) *count = 0;  // every split has counted: reset
    }
    __syncthreads();
    if (!*last_block) return;
    __threadfence();
    // the last block of the tile adds the other splits' partial sums to
    // its own, 16 rows in flight per thread; exact in any order
    for (size_t z = 0; z < Z; ++z) {
      if (z == blockIdx.z) continue;
      const int32_t* wz = ws + z * mn;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int m = m0 + rr + 8 * j;
        if (m >= M || n >= N) continue;
        const int32_t* p = wz + (size_t)m * N + n;
        if (vec_n) {
          const int4 u = __ldcg(reinterpret_cast<const int4*>(p));
          v[j].x += u.x; v[j].y += u.y; v[j].z += u.z; v[j].w += u.w;
        } else {
          v[j].x += __ldcg(p);
          if (n + 1 < N) v[j].y += __ldcg(p + 1);
          if (n + 2 < N) v[j].z += __ldcg(p + 2);
          if (n + 3 < N) v[j].w += __ldcg(p + 3);
        }
      }
    }
    if (tid < BN) {
      if (n0 + tid < N) {
        int32_t s = cs_sm[tid];
        for (size_t z = 0; z < Z; ++z) {
          if (z != blockIdx.z) s += __ldcg(wcol + z * gridDim.y * N + col_at + n0 + tid);
        }
        cs_sm[tid] = s;
      }
    } else if (m0 + tid - BN < M) {
      int32_t s = rs_sm[tid - BN];
      for (size_t z = 0; z < Z; ++z) {
        if (z != blockIdx.z) s += __ldcg(wrow + z * gridDim.x * M + row_at + m0 + tid - BN);
      }
      rs_sm[tid - BN] = s;
    }
    __syncthreads();
  }

  // the epilogue of qmatmul_int8.py:46-53, each operation rounded alone
  const float a_s = *a_scale;
  const float a_z = *a_zero;
  const float k_real = static_cast<float>(K);
  float scale[4], b_z[4], azcs[4], kzz[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int nq = min(n + q, N - 1);
    b_z[q] = b_zero != nullptr ? b_zero[nq] : 0.0f;
    scale[q] = __fmul_rn(a_s, b_scale[nq]);
    azcs[q] = __fmul_rn(a_z, static_cast<float>(cs_sm[4 * cq + q]));
    kzz[q] = __fmul_rn(__fmul_rn(k_real, a_z), b_z[q]);
  }
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const int m = m0 + rr + 8 * j;
    if (m >= M || n >= N) continue;
    const float rs = static_cast<float>(rs_sm[rr + 8 * j]);
    const int32_t av[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float corr =
          __fsub_rn(__fadd_rn(azcs[q], __fmul_rn(rs, b_z[q])), kzz[q]);
      o[q] = __fmul_rn(scale[q], __fsub_rn(static_cast<float>(av[q]), corr));
    }
    float* p = out + (size_t)m * N + n;
    if (vec_n) {
      *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (n + q < N) p[q] = o[q];
      }
    }
  }
}

template <bool VEC_A, bool VEC_B>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(&qmm_kernel<VEC_A, VEC_B>);
}

struct Args {
  const int8_t* a;
  const int8_t* b;
  const float* a_scale;
  const float* a_zero;
  const float* b_scale;
  const float* b_zero;
  float* out;
  int32_t* ws;
  int* counters;
  int M, K, N, k_per_split;
};

template <bool VEC_A, bool VEC_B>
void run(const Args& p, dim3 grid, cudaStream_t s) {
  qmm_kernel<VEC_A, VEC_B><<<grid, THREADS, SMEM, s>>>(
      p.a, p.b, p.a_scale, p.a_zero, p.b_scale, p.b_zero, p.out, p.ws,
      p.counters, p.M, p.K, p.N, p.k_per_split);
}

}  // namespace

// Lets the four instantiations use SMEM bytes of dynamic shared memory
// (above 48 KB only by this opt-in); call once after loading the library,
// outside any graph capture. Returns the first CUDA error, or 0.
extern "C" int qmatmul_int8_init() {
  const void* const fns[4] = {kernel_fn<true, true>(), kernel_fn<true, false>(),
                              kernel_fn<false, true>(), kernel_fn<false, false>()};
  for (const void* fn : fns) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Plain C interface (bound with ctypes); the launch parameters come from
// the wrapper's planning function (kernels/qmatmul_int8.py:plan). a (M, K)
// and b (K, N) int8; a_scale and a_zero one float32 each (device
// pointers); b_scale float32 (1, N); b_zero float32 (1, N), or null for
// symmetric weights; out float32 (M, N); all contiguous. Grid (gx, gy,
// splits) of 128 x 128 output tiles, k_per_split a multiple of 128. With
// splits > 1, `ws` holds splits x M x N int32 partial products, then
// splits x gy x N column sums and splits x gx x M row sums, and `counters`
// gx * gy ints, zero before the launch and after it. Runs on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launch.
extern "C" int qmatmul_int8(const void* a, const void* b, const void* a_scale,
                            const void* a_zero, const void* b_scale,
                            const void* b_zero, void* out, void* ws,
                            void* counters, int M, int K, int N, int vec_a,
                            int vec_b, int gx, int gy, int splits,
                            int k_per_split, void* stream) {
  const dim3 grid(gx, gy, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
               static_cast<const float*>(a_scale),
               static_cast<const float*>(a_zero),
               static_cast<const float*>(b_scale),
               static_cast<const float*>(b_zero), static_cast<float*>(out),
               static_cast<int32_t*>(ws), static_cast<int*>(counters),
               M, K, N, k_per_split};
  if (vec_a) {
    vec_b ? run<true, true>(p, grid, s) : run<true, false>(p, grid, s);
  } else {
    vec_b ? run<false, true>(p, grid, s) : run<false, false>(p, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qmatmul_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
