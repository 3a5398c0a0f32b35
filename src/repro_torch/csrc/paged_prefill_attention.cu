// Paged chunked-prefill attention for Hopper (sm_90a): C query tokens per
// lane attend through the lane's block table into the global KV pool, which
// already holds the chunk's own keys and values.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode_attention.py:255
// (paged_prefill_attention; kernel body _paged_prefill_kernel, :80).
// paged_verify_attention (:308) is the same kernel with starts = positions.
//
// What bounds it on the H100: one (lane, KV head) pair reads the K and V
// rows of its n visible keys once (4*n*D bytes in bf16) and does 4*D flops
// for each of its C*G query rows and each key that row sees (G query heads
// per KV head), about C*G flops per byte.  At llama2-7b's chunk of 128 and
// G = 1 that is under the card's ~295 flops per byte of bf16 tensor cores,
// so the least time is the bytes; GQA at G >= 4 passes the line.  This
// first kernel runs on the CUDA cores (f32 FMA, ~67 TFLOP/s at best, a
// crossover near 20 flops per byte), so in practice it is bound by
// operations at every chunk the engine serves; wgmma tiles are later work.
//
// Design.  On the TPU the grid is (lane, logical block) with the block axis
// walked in order: the block table and starts are scalar-prefetched into
// SMEM, the BlockSpec index map DMAs the physical block, and (m, l, acc)
// for all C*G rows of a KV head live in VMEM scratch across the walk.
// Hopper runs blocks in no order, so here one CTA owns one (lane, KV head,
// tile of 64 query rows) and loops over 32-key tiles itself, carrying
// (m, l, acc) in registers.  Query rows are ordered (c, g) inside a KV head
// as in the Pallas kernel: row r is chunk token r / G of query head
// kh * G + r % G, so GQA stays grouped (one staged key tile serves G heads
// and the KV is never expanded).  Each key's physical block id is read from
// the table itself in place of the scalar prefetch, and clamped into the
// pool.  The walk stops at the tile's last query, start + c_last: later
// blocks are never read (the Pallas kernel's pl.when skip).  Keys are
// masked by kpos <= start + c; key 0 is visible to every row, so the
// running max is a real score after the first tile.  Padded lanes (table
// of zeros, start 0) read the parking block 0 like any other block.  Four
// threads share a query row, each holding a quarter of q and of the f32
// accumulator with the head dim interleaved (d = c + 4*i) so the
// shared-memory reads of a key or value row are conflict-free; partial dot
// products meet by two warp shuffles.  The unnormalised exp(s - m) is
// rounded to the pool's dtype before the PV product, as flash_attention.cu
// does; the reference model (attention.py:618-619) rounds the normalised P.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int BQ = 64;                // query rows (token x group head) per CTA
constexpr int BK = 32;                // keys per tile
constexpr int TPR = 4;                // threads per query row
constexpr int THREADS = BQ * TPR;     // 256

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                     const KT* __restrict__ v_pool,
                     const int* __restrict__ tables,
                     const int* __restrict__ starts, QT* __restrict__ out,
                     int C, int H, int K, int n_blocks, int bs, int T,
                     float scale) {
  constexpr int DPT = D / TPR;        // head dims per thread
  constexpr int VEC = Vec<KT>::N;
  constexpr int VPR = D / VEC;        // 16-byte vectors per key row
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int G = H / K;
  const int rows = C * G;
  const int r0 = blockIdx.x * BQ;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = r0 + tid / TPR;
  const int c = tid % TPR;
  const bool valid = r < rows;
  const int tok = valid ? r / G : C - 1;         // chunk token of this row
  const int h = kh * G + (valid ? r % G : 0);
  const int start = starts[b];
  const int n_keys = T * bs;                     // keys the table can name
  const int last = min(start + tok, n_keys - 1); // keys 0 .. last visible
  // the tile's last query token bounds the walk for every row of the CTA
  const int tok_last = (min(r0 + BQ, rows) - 1) / G;
  const int k_end = min(start + tok_last + 1, n_keys);

  float qr[DPT], acc[DPT];
  const size_t q_off = (((size_t)b * C + tok) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = valid ? to_f(q[q_off + c + TPR * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const int* table = tables + (size_t)b * T;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                  // the previous tile's readers are done
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int t = i / VPR;
      const int col = (i - t * VPR) * VEC;
      const int kpos = k0 + t;
      float kv[VEC], vv[VEC];
      if (kpos < k_end) {
        int blk = table[kpos / bs];
        blk = min(max(blk, 0), n_blocks - 1);   // never read outside the pool
        const size_t row = (((size_t)blk * bs + kpos % bs) * K + kh) * D + col;
        Vec<KT>::load(k_pool + row, kv);
        Vec<KT>::load(v_pool + row, vv);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        *reinterpret_cast<float4*>(&ks[t][col + j]) =
            make_float4(kv[j], kv[j + 1], kv[j + 2], kv[j + 3]);
        *reinterpret_cast<float4*>(&vs[t][col + j]) =
            make_float4(vv[j], vv[j + 1], vv[j + 2], vv[j + 3]);
      }
    }
    __syncthreads();

    float s[BK];
    float m_tile = NEG_INF;
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[t][c + TPR * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[t] = (k0 + t <= last) ? part * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[t]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    float l_tile = 0.f;
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      const float p = expf(s[t] - m_new);
      l_tile += p;
      const float pv = round_to<KT>(p);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += pv * vs[t][c + TPR * i];
    }
    l = l * corr + l_tile;
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      out[q_off + c + TPR * i] = from_f<QT>(acc[i] * inv);
  }
}

template <typename QT, typename KT, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* starts, void* out, int B, int C,
           int H, int K, int n_blocks, int bs, int T, float scale,
           cudaStream_t stream) {
  const int rows = C * (H / K);
  const dim3 grid((rows + BQ - 1) / BQ, K, B);
  paged_prefill_kernel<QT, KT, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), tables, starts, static_cast<QT*>(out),
      C, H, K, n_blocks, bs, T, scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int dispatch_d(const void* q, const void* k_pool, const void* v_pool,
               const int* tables, const int* starts, void* out, int B, int C,
               int H, int K, int D, int n_blocks, int bs, int T, float scale,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<QT, KT, 16>(q, k_pool, v_pool, tables, starts, out,
                                       B, C, H, K, n_blocks, bs, T, scale, s);
    case 32: return launch<QT, KT, 32>(q, k_pool, v_pool, tables, starts, out,
                                       B, C, H, K, n_blocks, bs, T, scale, s);
    case 64: return launch<QT, KT, 64>(q, k_pool, v_pool, tables, starts, out,
                                       B, C, H, K, n_blocks, bs, T, scale, s);
    case 128: return launch<QT, KT, 128>(q, k_pool, v_pool, tables, starts,
                                         out, B, C, H, K, n_blocks, bs, T,
                                         scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/out (B, C, H, D); k_pool/v_pool (n_blocks, bs, K, D); tables (B, T)
// int32; starts (B,) int32.  All contiguous.  Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* starts, void* out, int B, int C, int H, int K, int D,
    int n_blocks, int bs, int T, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (B == 0 || C == 0) return 0;
  if (K <= 0 || H % K != 0 || T <= 0 || bs <= 0 || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return dispatch_d<bf16, bf16>(q, k_pool, v_pool, tables, starts, out, B,
                                  C, H, K, D, n_blocks, bs, T, scale, s);
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    return dispatch_d<float, float>(q, k_pool, v_pool, tables, starts, out, B,
                                    C, H, K, D, n_blocks, bs, T, scale, s);
  if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    return dispatch_d<float, bf16>(q, k_pool, v_pool, tables, starts, out, B,
                                   C, H, K, D, n_blocks, bs, T, scale, s);
  return (int)cudaErrorInvalidValue;
}
