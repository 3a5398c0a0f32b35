// Paged decode attention for Hopper (sm_90a): one query token per lane
// attends through its block table into a global KV block pool.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode_attention.py:331
// (paged_decode_attention; kernel body _paged_decode_kernel, :34).
//
// What bounds it on the H100: bytes.  Each key costs 2*D*bytes of K/V read
// for 4*D flops per query head, so at G query heads per KV head the kernel
// does 2*G flops per byte, far under the ~295 flops/byte at which the card's
// bf16 tensor cores would become the limit.  The least time is the K/V bytes
// of the live keys over 3.35 TB/s.
//
// Design.  On the TPU the grid walks (lane, logical block) in order, the
// block table is scalar-prefetched into SMEM and the BlockSpec index map
// DMAs the physical block.  Here one CTA owns one (lane, KV head) pair and
// its G = H/K query heads (GQA stays grouped as (K, G, D): KV is never
// expanded), and a loop inside the CTA replaces the sequential grid axis:
// it walks the lane's keys 0..pos in tiles of 32, reading each key's
// physical block id from the table itself.  A tile's K and V rows are
// staged in shared memory with 16-byte loads (one key row is D contiguous
// elements of one KV head), so the G heads share one read of the pool.
// Keys are masked by kpos <= pos and the softmax is the reference's online
// f32 (m, l, acc); the output is acc / max(l, 1e-30).  Parked lanes
// (pos 0, table row 0) read the parking block 0 like any other block.
// Simple first: no split over the key axis, no TMA, CUDA cores only.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int TK = 32;        // keys per tile: one per lane in the softmax
constexpr int THREADS = 128;  // 4 warps
constexpr int NWARPS = THREADS / 32;

template <typename QT, typename KT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                    const KT* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions, QT* __restrict__ out,
                    int H, int K, int D, int n_blocks, int bs, int T,
                    float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [G][D]   this CTA's query heads
  float* ks = qs + G * D;       // [TK][D]  staged keys
  float* vs = ks + TK * D;      // [TK][D]  staged values
  float* ps = vs + TK * D;      // [G][TK]  scores, then probabilities
  float* acc = ps + G * TK;     // [G][D]   running numerator
  float* ms = acc + G * D;      // [G]      running max
  float* ls = ms + G;           // [G]      running denominator
  float* cs = ls + G;           // [G]      this tile's rescale factor

  const int h0 = kh * G;        // query heads h0 .. h0+G-1 read KV head kh
  const size_t q_off = ((size_t)b * H + h0) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = to_f(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  const int n_keys = min(positions[b] + 1, T * bs);   // keys 0 .. pos
  const int* table = tables + (size_t)b * T;
  constexpr int VEC = Vec<KT>::N;
  const int vecs_per_row = D / VEC;
  __syncthreads();

  for (int t0 = 0; t0 < n_keys; t0 += TK) {
    // stage the tile's key and value rows; rows past pos are zeros
    for (int i = tid; i < TK * vecs_per_row; i += THREADS) {
      const int t = i / vecs_per_row;
      const int c = (i - t * vecs_per_row) * VEC;
      const int kpos = t0 + t;
      float kv[VEC], vv[VEC];
      if (kpos < n_keys) {
        int blk = table[kpos / bs];
        blk = min(max(blk, 0), n_blocks - 1);   // never read outside the pool
        const size_t row = (((size_t)blk * bs + kpos % bs) * K + kh) * D + c;
        Vec<KT>::load(k_pool + row, kv);
        Vec<KT>::load(v_pool + row, vv);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ks[t * D + c + j] = kv[j];
        vs[t * D + c + j] = vv[j];
      }
    }
    __syncthreads();

    // scores: one warp per (head, key) pair, lanes split the head dim
    for (int pr = warp; pr < G * TK; pr += NWARPS) {
      const int g = pr / TK;
      const int t = pr - g * TK;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[g * D + d] * ks[t * D + d];
      s = warp_sum(s);
      if (lane == 0) ps[pr] = (t0 + t < n_keys) ? s * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per head, one key per lane
    for (int g = warp; g < G; g += NWARPS) {
      const float s = ps[g * TK + lane];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float l_tile = warp_sum(p);
      ps[g * TK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + l_tile;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc[g, d] * corr[g] + sum_t p[g, t] * v[t, d]
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = ps + g * TK;
      float a = acc[i] * cs[g];
#pragma unroll 8
      for (int t = 0; t < TK; ++t) a += pg[t] * vs[t * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    out[q_off + i] = from_f<QT>(acc[i] / fmaxf(ls[g], 1e-30f));
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* positions, void* out, int B, int H,
           int K, int D, int n_blocks, int bs, int T, float scale,
           cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = sizeof(float) * (2 * (size_t)G * D + 2 * (size_t)TK * D
                                       + (size_t)G * TK + 3 * (size_t)G);
  auto kern = paged_decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(K, B), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), tables, positions,
      static_cast<QT*>(out), H, K, D, n_blocks, bs, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D); k_pool/v_pool (n_blocks, bs, K, D); tables (B, T) int32;
// positions (B,) int32; out (B, H, D) in q's dtype.  All contiguous.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* positions, void* out, int B, int H, int K, int D, int n_blocks,
    int bs, int T, float scale, int q_dtype, int kv_dtype, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch<bf16, bf16>(q, k_pool, v_pool, tables, positions, out, B, H,
                              K, D, n_blocks, bs, T, scale, s);
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    return launch<float, float>(q, k_pool, v_pool, tables, positions, out, B,
                                H, K, D, n_blocks, bs, T, scale, s);
  if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    return launch<float, bf16>(q, k_pool, v_pool, tables, positions, out, B,
                               H, K, D, n_blocks, bs, T, scale, s);
  return (int)cudaErrorInvalidValue;
}
