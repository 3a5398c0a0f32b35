// Paged decode attention for Hopper (sm_90a): one query token per lane
// attends through its block table into a global KV block pool, or, in the
// LSE form, into one stripe of a block-striped pool.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/paged_decode_attention.py:
// - :331 paged_decode_attention (kernel body _paged_decode_kernel, :34);
// - :180 paged_decode_attention_lse (kernel body _paged_decode_lse_kernel,
//   :133), the per-stripe step of the tensor-sharded pool: it attends over
//   the table slots this stripe owns (owned[b, j] != 0) only and also
//   returns lse = m + log l (-1e30 where the stripe saw no key), so the
//   stripes' outputs merge exactly (combine_lse, in the wrapper's module).
//
// What bounds it on the H100: bytes.  Each key costs 2*D*bytes of K/V read
// for 4*D flops per query head, so at G query heads per KV head the kernel
// does 2*G flops per byte, far under the ~295 flops/byte at which the card's
// bf16 tensor cores would become the limit.  The least time is the K/V bytes
// of the live keys (in the LSE form: the live keys of the owned blocks)
// over 3.35 TB/s.
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
//
// The LSE form shares this body (template flag LSE).  Ownership is per
// block but a tile holds 32 keys across blocks, so the CTA first lists the
// lane's owned logical blocks at or before pos in shared memory (one warp,
// by ballot) and walks only their keys: an unowned block is never read,
// and its clipped local id never dereferenced.  A key masked out (past pos
// in the last owned block) contributes exactly 0 to l and acc: it is
// skipped, not scored -1e30, because where m is still -1e30 exp(s - m)
// would be 1 and a stripe that saw no key would report l > 0.  As the
// plain version does, the LSE form rounds the unnormalised exp(s - m) to
// the pool's dtype before PV while l sums the unrounded values.
// Simple first: no split over the key axis, no TMA, CUDA cores only.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int TK = 32;        // keys per tile: one per lane in the softmax
constexpr int THREADS = 128;  // 4 warps
constexpr int NWARPS = THREADS / 32;

// LSE: attend over the owned table slots only and write lse (the
// paged_decode_attention_lse form); otherwise owned and lse are unused.
template <typename QT, typename KT, bool LSE>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                    const KT* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    const int* __restrict__ owned, QT* __restrict__ out,
                    float* __restrict__ lse, int H, int K, int D,
                    int n_blocks, int bs, int T, float scale) {
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
  int* olist = reinterpret_cast<int*>(cs + G);  // [T] owned blocks (LSE)
  __shared__ int n_owned;

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
  if (LSE && warp == 0) {
    // olist = the owned logical blocks j with j*bs <= pos, in order
    const int* own = owned + (size_t)b * T;
    int count = 0;
    for (int j0 = 0; j0 < T; j0 += 32) {
      const int j = j0 + lane;
      const bool take = j < T && j * bs < n_keys && own[j] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, take);
      if (take) olist[count + __popc(ballot & ((1u << lane) - 1u))] = j;
      count += __popc(ballot);
    }
    if (lane == 0) n_owned = count;
  }
  __syncthreads();
  // the walk visits n_walk keys: all of 0 .. pos, or (LSE) every key of
  // the listed blocks, of which those past pos are masked
  const int n_walk = LSE ? n_owned * bs : n_keys;
  auto key_pos = [&](int w) {
    return LSE ? olist[w / bs] * bs + w % bs : w;
  };

  for (int t0 = 0; t0 < n_walk; t0 += TK) {
    // stage the tile's key and value rows; masked rows are zeros
    for (int i = tid; i < TK * vecs_per_row; i += THREADS) {
      const int t = i / vecs_per_row;
      const int c = (i - t * vecs_per_row) * VEC;
      const int kpos = t0 + t < n_walk ? key_pos(t0 + t) : n_keys;
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
      const bool live = t0 + t < n_walk && key_pos(t0 + t) < n_keys;
      if (lane == 0) ps[pr] = live ? s * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per head, one key per lane
    for (int g = warp; g < G; g += NWARPS) {
      const float s = ps[g * TK + lane];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      // a masked key adds nothing, also while m_new is still NEG_INF
      const float p = s == NEG_INF ? 0.f : expf(s - m_new);
      const float l_tile = warp_sum(p);
      ps[g * TK + lane] = LSE ? round_to<KT>(p) : p;
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
  if (LSE) {
    for (int g = tid; g < G; g += THREADS)
      lse[(size_t)b * H + h0 + g] =
          ls[g] > 0.f ? ms[g] + logf(fmaxf(ls[g], 1e-30f)) : NEG_INF;
  }
}

template <typename QT, typename KT, bool LSE>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* positions, const int* owned,
           void* out, float* lse, int B, int H, int K, int D, int n_blocks,
           int bs, int T, float scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = sizeof(float) * (2 * (size_t)G * D + 2 * (size_t)TK * D
                                       + (size_t)G * TK + 3 * (size_t)G)
                      + (LSE ? sizeof(int) * (size_t)T : 0);
  auto kern = paged_decode_kernel<QT, KT, LSE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(K, B), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), tables, positions, owned,
      static_cast<QT*>(out), lse, H, K, D, n_blocks, bs, T, scale);
  return (int)cudaGetLastError();
}

// one (q dtype, pool dtype) pair of the three the wrappers accept
template <bool LSE>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const int* tables, const int* positions, const int* owned,
             void* out, float* lse, int B, int H, int K, int D, int n_blocks,
             int bs, int T, float scale, int q_dtype, int kv_dtype,
             void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch<bf16, bf16, LSE>(q, k_pool, v_pool, tables, positions,
                                   owned, out, lse, B, H, K, D, n_blocks, bs,
                                   T, scale, s);
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    return launch<float, float, LSE>(q, k_pool, v_pool, tables, positions,
                                     owned, out, lse, B, H, K, D, n_blocks,
                                     bs, T, scale, s);
  if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    return launch<float, bf16, LSE>(q, k_pool, v_pool, tables, positions,
                                    owned, out, lse, B, H, K, D, n_blocks,
                                    bs, T, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, D); k_pool/v_pool (n_blocks, bs, K, D); tables (B, T) int32;
// positions (B,) int32; out (B, H, D) in q's dtype.  All contiguous.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* positions, void* out, int B, int H, int K, int D, int n_blocks,
    int bs, int T, float scale, int q_dtype, int kv_dtype, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, tables, positions, nullptr, out,
                         nullptr, B, H, K, D, n_blocks, bs, T, scale, q_dtype,
                         kv_dtype, stream);
}

// The per-stripe form: pools are one stripe (nb_loc, bs, K, D); tables hold
// local ids, clipped into range where not owned; owned (B, T) int32,
// nonzero where this stripe holds the slot's block; out (B, H, D) in q's
// dtype; lse (B, H) f32.  All contiguous.  Returns the cudaError_t.
extern "C" int paged_decode_attention_lse(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* positions, const int* owned, void* out, float* lse, int B,
    int H, int K, int D, int n_blocks, int bs, int T, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  return dispatch<true>(q, k_pool, v_pool, tables, positions, owned, out, lse,
                        B, H, K, D, n_blocks, bs, T, scale, q_dtype, kv_dtype,
                        stream);
}
