// w8a8 int8 GEMM for Hopper (sm_90a) with per-row and per-column scales:
//     out[m, n] = ((float)(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n],
// x_q (M, K) int8 row-major, w_q (K, N) int8 row-major, sx (M) and sw (N)
// f32, out (M, N) bf16 (rounded once, __float2bfloat16_rn) or f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py:41
// (int8_matmul; kernel body _int8_mm_kernel, :21).
//
// What bounds it on the H100: 2*M*N*K integer operations against the
// card's 1979 dense int8 TOPS, and M*K + K*N + 2*M*N (bf16 out) bytes plus
// the scales against 3.35 TB/s.  A square GEMM of 4096 is bound by
// operations (0.069 ms against 0.020 ms of bytes); a MoE expert's GEMM
// at M = 256 rows (1536 x 512 weights) by bytes (1.44 MB, 0.43 us against
// 0.20 us of operations).
//
// Design.  On the TPU the grid is (M block, N block, K block) with the K
// axis walked in order and the int32 sum kept in VMEM scratch between K
// blocks.  Here no grid axis runs in order, so one CTA owns one 64 x 64
// output tile and loops over K itself, the sum in registers.  Per K step
// of 64 the CTA stages the x tile (64 rows of 64 bytes) and the w tile in
// shared memory; the w tile is stored N-major (row n holds w[k0:k0+64, n])
// so that it feeds the "col" B operand of the tensor-core product with
// 32-bit loads.  Rows are padded to 80 bytes, which makes the fragment
// loads of a warp (8 rows x 4 words) hit 32 distinct banks.  Four warps
// each own a 32 x 32 quarter of the tile: per K step of 32, two A
// fragments (m16 x k32) and four B fragments (k32 x n8) feed eight
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 with int32 accumulators
// in registers.  The epilogue converts each sum to f32 (round to nearest,
// as int32 -> float32 converts), multiplies by sx[m] then by sw[n] and
// rounds once to the output type, so it is bit-exact against the plain
// version: integer sums do not depend on order.  Any M, N and K: the
// staging zero-fills the ragged edge (zeros add exactly 0) and the
// epilogue stores only in-range outputs.  The x tile is staged with
// 16-byte loads when K is a multiple of 16 and x is 16-byte aligned, the
// w tile when N is and w is, each else byte by byte.  Simple first: no
// double buffering (cp.async or TMA), no wgmma, no persistent schedule.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;     // bytes per staged row (see the note)
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage x[m0:m0+64, k0:k0+64] into xs (row-major) and w[k0:k0+64, n0:n0+64]
// into ws (N-major), zero outside the matrices.  A tile is 256 chunks of
// 16 bytes, two per thread; with VX (K % 16 == 0) or VW (N % 16 == 0) a
// chunk of that tile lies wholly inside or wholly outside.
template <bool VX, bool VW>
__device__ __forceinline__ void stage(const int8_t* __restrict__ x,
                                      const int8_t* __restrict__ w, int M,
                                      int N, int K, int m0, int n0, int k0,
                                      int8_t (*xs)[LDS], int8_t (*ws)[LDS]) {
  const int tid = threadIdx.x;
  if (VX) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, col = (c & 3) * 16;     // x: 4 chunks a row
      const int m = m0 + row, k = k0 + col;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < M && k < K)
        v = *reinterpret_cast<const int4*>(x + (size_t)m * K + k);
      *reinterpret_cast<int4*>(&xs[row][col]) = v;
    }
  } else {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int row = idx / BK, col = idx % BK;
      const int m = m0 + row, k = k0 + col;
      xs[row][col] = (m < M && k < K) ? x[(size_t)m * K + k] : int8_t(0);
    }
  }
  if (VW) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // a warp reads 32 consecutive k of one 16-wide n slice, so its
      // transposed byte stores land in 8 consecutive words of each row
      const int c = tid + i * THREADS;
      const int nq = (c >> 6) * 16, kk = c & 63;
      const int k = k0 + kk, n = n0 + nq;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < K && n < N)
        v = *reinterpret_cast<const int4*>(w + (size_t)k * N + n);
      const uint32_t word[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                                (uint32_t)v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)   // byte j of the chunk: w[k][n + j]
        ws[nq + j][kk] = (int8_t)(word[j >> 2] >> (8 * (j & 3)));
    }
  } else {
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN, nn = idx % BN;
      const int k = k0 + kk, n = n0 + nn;
      ws[nn][kk] = (k < K && n < N) ? w[(size_t)k * N + n] : int8_t(0);
    }
  }
}

template <typename TOut> __device__ __forceinline__ TOut cast_out(float v);
template <> __device__ __forceinline__ float cast_out<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 cast_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TOut, bool VX, bool VW>
__global__ void __launch_bounds__(THREADS)
int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ sx, const float* __restrict__ sw,
               TOut* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t xs[BM][LDS];
  __shared__ __align__(16) int8_t ws[BN][LDS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;          // groupID, thread in group
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<VX, VW>(x, w, M, N, K, m0, n0, k0, xs, ws);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A (16 x 32, row): rows g and g + 8, bytes 4t..4t+3 of each half
        const int r = wm + mi * 16 + g;
        a[mi][0] = ld32(&xs[r][ks + 4 * t]);
        a[mi][1] = ld32(&xs[r + 8][ks + 4 * t]);
        a[mi][2] = ld32(&xs[r][ks + 16 + 4 * t]);
        a[mi][3] = ld32(&xs[r + 8][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // B (32 x 8, col): column g, k = 4t..4t+3 and 16 + 4t..16 + 4t+3
        const int n = wn + ni * 8 + g;
        b[ni][0] = ld32(&ws[n][ks + 4 * t]);
        b[ni][1] = ld32(&ws[n][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // C (16 x 8): c0, c1 at row g, columns 2t and 2t + 1; c2, c3 at row g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + 8 * half;
      if (m >= M) continue;
      const float s_m = sx[m];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn + ni * 8 + 2 * t + j;
          if (n < N) {
            const float v = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + j]), s_m),
                sw[n]);
            out[(size_t)m * N + n] = cast_out<TOut>(v);
          }
        }
      }
    }
  }
}

template <typename TOut>
int launch(const int8_t* x, const int8_t* w, const float* sx, const float* sw,
           TOut* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vx = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vw = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vx && vw)
    int8_mm_kernel<TOut, true, true><<<grid, THREADS, 0, stream>>>(
        x, w, sx, sw, out, M, N, K);
  else if (vx)
    int8_mm_kernel<TOut, true, false><<<grid, THREADS, 0, stream>>>(
        x, w, sx, sw, out, M, N, K);
  else if (vw)
    int8_mm_kernel<TOut, false, true><<<grid, THREADS, 0, stream>>>(
        x, w, sx, sw, out, M, N, K);
  else
    int8_mm_kernel<TOut, false, false><<<grid, THREADS, 0, stream>>>(
        x, w, sx, sw, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: DT_F32 or DT_BF16 (common.cuh).  Returns a cudaError_t.
extern "C" int int8_matmul(const void* x, const void* w, const void* sx,
                           const void* sw, void* out, int M, int N, int K,
                           int out_dtype, void* stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  if (M > 65535 * BM) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_dtype == DT_F32)
    return launch<float>(xp, wp, sxp, swp, static_cast<float*>(out), M, N, K,
                         s);
  if (out_dtype == DT_BF16)
    return launch<bf16>(xp, wp, sxp, swp, static_cast<bf16*>(out), M, N, K,
                        s);
  return (int)cudaErrorInvalidValue;
}
