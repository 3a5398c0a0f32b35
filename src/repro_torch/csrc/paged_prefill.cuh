// Paged chunked-prefill attention for Hopper (sm_90a), the bodies of both
// its forms: C query tokens per lane attend through the lane's block table
// into the global KV pool, which already holds the chunk's own keys and
// values.  paged_prefill_attention.cu builds the plain form,
// paged_prefill_attention_lse.cu the owned/LSE form; each instantiates only
// its own, so nvcc builds them in parallel.
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
// so the least time is the bytes; GQA at G >= 4 passes the line.  On the
// CUDA cores (f32 FMA, ~67 TFLOP/s at best, a crossover near 20 flops per
// byte) the same work is bound by operations at every chunk the engine
// serves, so bf16 runs on the tensor cores.
//
// On the TPU the grid is (lane, logical block) with the block axis walked
// in order: the block table and starts are scalar-prefetched into SMEM, the
// BlockSpec index map DMAs the physical block, and (m, l, acc) for all C*G
// rows of a KV head live in VMEM scratch across the walk.  Hopper runs
// blocks in no order, so here one CTA owns one (lane, KV head, tile of
// query rows) and loops over key tiles itself.  Query rows are ordered
// (c, g) inside a KV head as in the Pallas kernel: row r is chunk token
// r / G of query head kh * G + r % G, so GQA stays grouped (one staged key
// tile serves G heads and the KV is never expanded).  Each key's physical
// block id is read from the table itself in place of the scalar prefetch,
// and clamped into the pool.  The walk stops at the CTA's last query,
// start + tok_last: later blocks are never read (the Pallas kernel's
// pl.when skip).  Keys are masked by kpos <= start + c; key 0 is visible to
// every row.  Padded lanes (table of zeros, start 0) read the parking block
// 0 like any other block.  The unnormalised exp(s - m) is rounded to the
// pool's dtype before the PV product, as flash_attention.cu does; the
// reference model (attention.py:618-619) rounds the normalised P.
//
// bf16: wgmma tiles (paged_prefill_wgmma), kernel 1's design over a gather.
// One CTA owns 128 query rows as two warpgroups of 64 (one wgmma M each).
// Q's rows are not one TMA box (G need not divide 128, and the rows of
// consecutive tokens lie H * D apart), so Q comes in once by 16-byte
// cp.async copies, row by row, into kernel 1's swizzled panels, and stays.
// A 64-key tile comes from 64 / bs physical blocks (or part of one), so it
// is gathered the same way: the CTA first stages the block ids of its walk
// from the table in shared memory (clamped into the pool), so no copy
// waits on a load of the table; then each thread copies 16-byte chunks of
// its keys' rows into the swizzled K and V panels of a ring of 2 stages;
// keys past the walk's end are zero-filled.  The chunk's 16-byte unit u of a row r of a panel lands at
// u ^ ((r * SW / 128) mod SW / 16), the swizzle a TMA box of the same
// panel writes (panels start on 1024 bytes), so kernel 1's descriptors
// and products read it unchanged: S = Q K^T as wgmma m64n64k16 from
// shared memory, the online softmax on the accumulator fragment, O += P V
// with P from registers and V through the transpose bit (hopper.cuh).  The
// copies are generic-proxy writes that wgmma reads through the async
// proxy, so every thread fences the proxies after its copies land and
// before the barrier that releases the tile.  Any bs works.  A warpgroup
// skips a tile none of its rows sees, and masks per element only a tile
// that straddles a row's bound; a masked key adds exactly 0.  Rows past
// C * G are neither stored nor allowed to widen the walk.  Every head dim
// kernel 1 takes: its panels and swizzle per D (hopper.cuh's Tiles<D>).
//
// The owned/LSE form (paged_prefill_attention_lse) is kernel 3 over one
// stripe of the block-striped pool, what kernel 4 is to kernel 2: it
// replaces the per-rank attention of the reference's sharded chunk prefill
// (src/repro/models/attention.py:677, _paged_prefill_core).  The pools are
// one stripe, the table holds local ids (clamped into the stripe where not
// owned) and owned (B, T) marks the slots whose block the stripe holds; a
// row that sees no owned key gives o = 0 and lse = -1e30.  It writes lse =
// m + log l per query row beside o, which combine_lse merges over the
// stripes.
//
// Its bf16 route (paged_prefill_lse_wgmma) was first the plain body with
// the owned mask on the gather, and that bounded it: every 64-key tile up
// to the walk's end ran QK^T and PV when any of its blocks was owned (at 2
// stripes over scrambled tables ~15 of 16 tiles), so a stripe did nearly
// all of kernel 3's tensor-core work, and one CTA walked a long lane alone
// (0.0843 ms a stripe at llama2-7b's phase-1 shape on an H100 80GB HBM3 at
// 700 W, above kernel 3's 0.0795 ms over the whole pool).  It now walks
// only the owned blocks, split over CTAs, as kernel 4 does
// (split_decode.cuh): each CTA lists its lane's owned blocks up to its
// query tile's walk end in table order (a prefix sum over owned by warp
// ballots), and the walk's 64-key tiles are consecutive walk positions,
// each key carrying its logical position (table index * bs + offset) for
// the causal test, so a tile holds unowned slots nowhere and unfilled
// slots only at a split's end, and "every row sees every key" is a test
// on the tile's last position.  The walk splits into pieces of L keys
// (paged_prefill_split_plan, from shapes alone: the chunk tick is one CUDA
// graph), grid (K, B, splits * query tiles), the splits slowest so every
// walk's first piece starts first; a split past the walk returns at once.  A lone live split writes o and lse itself; otherwise each
// writes its partial (m, l, acc) per query row to f32 scratch the wrapper
// allocates, and the last CTA of the (lane, KV head, query tile) to draw a
// ticket merges them in split order (o = sum e^{m_s - M} acc_s / sum
// e^{m_s - M} l_s, lse = M + log of that sum) and resets its counter, the
// tickets kernels 2, 4 and 5 keep zeroed.  The tile body is the plain
// form's: wgmma over the swizzled panels, K/V gathered through the table
// by cp.async into a 2-stage ring (TMA cannot gather 16-row blocks).  Its
// f32 route keeps the first design (paged_prefill_f32 with LSE, the owned
// mask on the copy, a tile with no owned key adding nothing): it serves
// only the f32 plans' parity.
//
// f32 q (over an f32 or a bf16 pool): the CUDA-core kernel
// (paged_prefill_f32).  Tensor cores in f32 would be TF32, which the f32
// plans' 1e-4 parity cannot take.  Four threads share a query row, each
// holding a quarter of q and of the f32 accumulator with the head dim
// interleaved (d = c + 4*i) so the shared-memory reads of a key or value
// row are conflict-free; partial dot products meet by two warp shuffles;
// tiles of 32 keys (16 at D = 256, as kernel 1's f32 form) are copied to
// f32 in shared memory.  The route is chosen by dtype alone.
#pragma once

#include "hopper.cuh"

namespace {

using namespace repro;

constexpr float LN2 = 0.6931471805599453f;   // the LSE form's m, log2 -> ln

// ---------------------------------------------------------------------------
// f32 q: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;            // query rows (token x group head) per CTA
constexpr int F32_TPR = 4;            // threads per query row
constexpr int F32_THREADS = F32_BQ * F32_TPR;   // 256

template <typename KT, int D, bool LSE>
__global__ void __launch_bounds__(F32_THREADS)
paged_prefill_f32(const float* __restrict__ q, const KT* __restrict__ k_pool,
                  const KT* __restrict__ v_pool,
                  const int* __restrict__ tables,
                  const int* __restrict__ starts,
                  const int* __restrict__ owned, float* __restrict__ out,
                  float* __restrict__ lse, int C, int H, int K, int n_blocks,
                  int bs, int T, float scale) {
  constexpr int BKF = D > 128 ? 16 : 32;   // keys per tile
  constexpr int DPT = D / F32_TPR;    // head dims per thread
  constexpr int VEC = Vec<KT>::N;
  constexpr int VPR = D / VEC;        // 16-byte vectors per key row
  __shared__ __align__(16) float ks[BKF][D];
  __shared__ __align__(16) float vs[BKF][D];
  __shared__ bool own_s[BKF];         // LSE: key k0 + t lies in an owned block

  const int G = H / K;
  const int rows = C * G;
  const int r0 = blockIdx.x * F32_BQ;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = r0 + tid / F32_TPR;
  const int c = tid % F32_TPR;
  const bool valid = r < rows;
  const int tok = valid ? r / G : C - 1;         // chunk token of this row
  const int h = kh * G + (valid ? r % G : 0);
  const int start = starts[b];
  const int n_keys = T * bs;                     // keys the table can name
  const int last = min(start + tok, n_keys - 1); // keys 0 .. last visible
  // the tile's last query token bounds the walk for every row of the CTA
  const int tok_last = (min(r0 + F32_BQ, rows) - 1) / G;
  const int k_end = min(start + tok_last + 1, n_keys);

  float qr[DPT], acc[DPT];
  const size_t q_off = (((size_t)b * C + tok) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = valid ? q[q_off + c + F32_TPR * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const int* table = tables + (size_t)b * T;
  const int* own_row = owned + (size_t)b * T;   // read only when LSE

  for (int k0 = 0; k0 < k_end; k0 += BKF) {
    __syncthreads();                  // the previous tile's readers are done
    for (int i = tid; i < BKF * VPR; i += F32_THREADS) {
      const int t = i / VPR;
      const int col = (i - t * VPR) * VEC;
      const int kpos = k0 + t;
      float kv[VEC], vv[VEC];
      const bool live = kpos < k_end && (!LSE || own_row[kpos / bs] != 0);
      if (LSE && col == 0) own_s[t] = live;
      if (live) {
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

    float s[BKF];
    float m_tile = NEG_INF;
    uint32_t seen = 0;                // keys this row sees in the tile
#pragma unroll
    for (int t = 0; t < BKF; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[t][c + F32_TPR * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const bool see = k0 + t <= last && (!LSE || own_s[t]);
      seen |= (uint32_t)see << t;
      s[t] = see ? part * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[t]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    float l_tile = 0.f;
#pragma unroll
    for (int t = 0; t < BKF; ++t) {
      // a row of the LSE form may see no key yet (m_new = -1e30): a key it
      // does not see adds exactly 0 (key 0, which every row of the plain
      // form sees, keeps m_new finite there)
      const float p = (!LSE || (seen >> t & 1u)) ? expf(s[t] - m_new) : 0.f;
      l_tile += p;
      const float pv = round_to<KT>(p);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += pv * vs[t][c + F32_TPR * i];
    }
    l = l * corr + l_tile;
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) out[q_off + c + F32_TPR * i] = acc[i] * inv;
    if (LSE && c == 0) lse[q_off / D] = l > 0.f ? m + logf(l) : NEG_INF;
  }
}

struct Args {                         // one launch's shape
  int B, C, H, K, n_blocks, bs, T;
  float scale;
  const int* owned;                   // the LSE form's (B, T) mask
  float* lse;                         // ... and its (B, C, H) output;
  float* part;                        // its bf16 route's split partials,
  int* tickets;                       // their counters (zero between
  int L, splits;                      // launches), the split plan
};

template <typename KT, int D, bool LSE>
int launch_f32(const void* q, const void* k_pool, const void* v_pool,
               const int* tables, const int* starts, void* out, const Args& a,
               cudaStream_t stream) {
  const int rows = a.C * (a.H / a.K);
  const dim3 grid((rows + F32_BQ - 1) / F32_BQ, a.K, a.B);
  paged_prefill_f32<KT, D, LSE><<<grid, F32_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), tables, starts, a.owned,
      static_cast<float*>(out), a.lse, a.C, a.H, a.K, a.n_blocks, a.bs, a.T,
      a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma tiles over a gathered, swizzled K/V ring
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; with ``fill`` false the 16 bytes are zeros and
// nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 1) : "memory");
}

// byte offset of 16-byte unit ``u`` of row ``r`` in a panel of SW-byte
// rows, swizzled as TMA's SWIZZLE_<SW>B writes it
template <int SW>
__device__ __forceinline__ uint32_t swizzled(int r, int u) {
  const uint32_t o = (uint32_t)(r * SW + u * 16);
  return o ^ (((o >> 7) & (SW / 16 - 1)) << 4);
}

// One 64-key tile for a warpgroup ``g``'s 64 query rows (this thread's
// rows r0 + 8 i, its keys c0 + {0, 1} of each 8-key column group): S = Q
// K^T as wgmma m64n64k16 from shared memory, the online softmax on the
// accumulator fragment, O += P V with P from registers and V through the
// transpose bit.  Unless ``full``, the keys ``dead(x, i)`` names (x the
// key's index in the tile) are masked for row i, and each adds exactly 0.
template <int D, class Dead>
__device__ __forceinline__ void attend_tile(uint32_t sq, uint32_t sk,
                                            uint32_t sv, int g, int c0,
                                            bool full, const Dead& dead,
                                            float scale_log2, float* oacc,
                                            float* m, float* l) {
  using Tl = Tiles<D>;
  constexpr int E = Tl::E, SW = Tl::SW, MODE = Tl::MODE;
  float sacc[32];                     // S: 64 x 64 per warpgroup
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / E;        // the panel, and 32 bytes a k16 step
    const uint32_t off = kk * 16 % E * 2;
    const uint64_t da =
        desc(sq + p * BQ * SW + 64 * g * SW + off, 16, 8 * SW, MODE);
    const uint64_t db = desc(sk + p * BK * SW + off, 16, 8 * SW, MODE);
    wgmma_ss_n64(sacc, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs<32>(sacc);

  // online softmax on the fragment: sacc[4 j + 2 i + c] is row r0 + 8 i,
  // key 8 j + c0 + c of the tile
  uint32_t live = 0xffffffffu;
  if (!full) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (dead(8 * j + c0 + c, i)) live &= ~(1u << (4 * j + 2 * i + c));
  }
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    sacc[e] = (live >> e & 1u) ? sacc[e] * scale_log2 : NEG_INF;
    mt[e / 2 % 2] = fmaxf(mt[e / 2 % 2], sacc[e]);
  }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    const float m_new = fmaxf(m[i], mt[i]);
    corr[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float p = (live >> e & 1u) ? exp2f(sacc[e] - m[e / 2 % 2]) : 0.f;
    l[e / 2 % 2] += p;
    sacc[e] = p;
  }
  uint32_t pa[16];                    // P as bf16 pairs: the A fragments
#pragma unroll
  for (int e = 0; e < 16; ++e) pa[e] = pack_bf16(sacc[2 * e], sacc[2 * e + 1]);
#pragma unroll
  for (int e = 0; e < D / 2; ++e) oacc[e] *= corr[e / 2 % 2];

  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    pv<D, 0>(oacc, pa + 4 * kk, sv + kk * 16 * SW);
  wgmma_commit();
  wgmma_wait();
  fence_regs<D / 2>(oacc);
}

// Q rows q0 .. q0 + 127 of (lane b, KV head kh) (zeros past R), unit u of
// row r into its swizzled panel, by cp.async (the caller commits)
template <int D>
__device__ __forceinline__ void load_q(uint32_t sq, const bf16* q, int b,
                                       int kh, int q0, int R, int G, int C,
                                       int H) {
  using Tl = Tiles<D>;
  constexpr int SW = Tl::SW, UPR = D / 8, UPP = Tl::E / 8;
  for (int i = threadIdx.x; i < BQ * UPR; i += THREADS) {
    const int r = i / UPR, u = i % UPR;
    const int qr = q0 + r;
    const bool live = qr < R;
    const int tok = live ? qr / G : 0;
    const int h = kh * G + (live ? qr % G : 0);
    cp_async16(sq + u / UPP * BQ * SW + swizzled<SW>(r, u % UPP),
               q + (((size_t)b * C + tok) * H + h) * D + u * 8, live);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, Tiles<D>::MIN_BLOCKS)
paged_prefill_wgmma(const bf16* __restrict__ q,
                    const bf16* __restrict__ k_pool,
                    const bf16* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ starts, bf16* __restrict__ out,
                    int C, int H, int K, int n_blocks, int bs, int T,
                    float scale_log2) {
  using Tl = Tiles<D>;
  constexpr int SW = Tl::SW;
  constexpr int UPR = D / 8;          // 16-byte units per row
  constexpr int UPP = Tl::E / 8;      // ... per panel row
  extern __shared__ unsigned char smem_raw[];

  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + Tl::Q_BYTES;     // stage s: K, then V
  // the physical block of each of the walk's logical blocks, clamped
  int* blocks = reinterpret_cast<int*>(smem_raw + (sq - smem_u32(smem_raw))
                                       + Tl::SMEM - 1024);

  const int G = H / K;
  const int R = C * G;                // query rows of the (lane, KV head)
  const int n_qt = (R + BQ - 1) / BQ;
  // the latest rows walk the most keys: they go first
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int start = starts[b];
  const int n_keys = T * bs;          // keys the table can name
  const int* table = tables + (size_t)b * T;
  // row r sees keys 0 .. kmax(r); the CTA's last row bounds the walk
  auto kmax_of = [&](int r) {
    return min(start + min(r, R - 1) / G, n_keys - 1);
  };
  const int k_end = kmax_of(q0 + BQ - 1) + 1;
  const int n_tiles = (k_end + BK - 1) / BK;
  for (int i = tid; i < (k_end + bs - 1) / bs; i += THREADS)
    blocks[i] = min(max(table[i], 0), n_blocks - 1);   // in the pool
  __syncthreads();

  load_q<D>(sq, q, b, kh, q0, R, G, C, H);
  auto load_kv = [&](int t) {
    const uint32_t dk = skv + t % NST * 2 * Tl::KV_BYTES;
    const int k0 = t * BK;
    for (int i = tid; i < BK * UPR; i += THREADS) {
      const int r = i / UPR, u = i % UPR;
      const int kpos = k0 + r;
      const bool live = kpos < k_end;
      const int blk = live ? blocks[kpos / bs] : 0;
      const size_t row =
          (((size_t)blk * bs + (live ? kpos % bs : 0)) * K + kh) * D + u * 8;
      const uint32_t off = u / UPP * BK * SW + swizzled<SW>(r, u % UPP);
      cp_async16(dk + off, k_pool + row, live);
      cp_async16(dk + Tl::KV_BYTES + off, v_pool + row, live);
    }
  };
  // group t holds tile t (and group 0 Q): NST groups in flight at the top
  // of the loop
  for (int t = 0; t < NST; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  const int g = tid / 128;            // warpgroup: rows 64 g .. 64 g + 63
  const int w = tid % 128 / 32;       // warp: 16 of those rows
  const int lane = tid % 32;
  const int rlo = q0 + 64 * g;        // the warpgroup's rows, clamped to R
  const int rhi = min(rlo + 63, R - 1);
  const bool rows = rlo < R;
  // kmax is nondecreasing in the row: the warpgroup's bounds
  const int kmax_lo = kmax_of(rlo);
  const int kmax_hi = kmax_of(rhi);
  // this thread's rows r0 and r0 + 8 of the accumulator fragments, and its
  // keys 2 (lane % 4) + {0, 1} of each 8-key column group
  const int r0 = rlo + 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int kmax[2] = {kmax_of(r0), kmax_of(r0 + 8)};

  float oacc[D / 2];                  // O: 64 x D per warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_ring();             // this thread's copies of tile t
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                  // everyone's copies of tile t
    const int k0 = t * BK;
    const uint32_t sk = skv + t % NST * 2 * Tl::KV_BYTES;
    // warpgroup-uniform: does any row see a key of the tile; do all rows
    // see all of them
    if (rows && k0 <= kmax_hi)
      attend_tile<D>(sq, sk, sk + Tl::KV_BYTES, g, c0,
                     k0 + BK - 1 <= kmax_lo,
                     [&](int x, int i) { return k0 + x > kmax[i]; },
                     scale_log2, oacc, m, l);
    __syncthreads();                  // both warpgroups are done with the stage
    if (t + NST < n_tiles) load_kv(t + NST);
    cp_async_commit();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= R) continue;
    const size_t row = ((size_t)b * C + r / G) * H + kh * G + r % G;
    bf16* op = out + row * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          oacc[4 * j + 2 * i] * inv[i], oacc[4 * j + 2 * i + 1] * inv[i]);
  }
}

// ---------------------------------------------------------------------------
// the owned/LSE form on the tensor cores: the owned walk split over CTAs
// ---------------------------------------------------------------------------

constexpr int LSE_MAX_SPLITS = 16;    // the merge's weights in the K/V ring

// Grid (K, B, splits * query tiles).  Each CTA lists its lane's owned
// blocks up to its query tile's walk end (a prefix sum over owned by
// ballots), walks the keys of its split [split * L, (split + 1) * L) of
// that walk (64-key tiles of consecutive walk positions, each key with its
// logical position for the causal test), and either writes o and lse
// (one live split) or its partial (m, l, acc) per query row; the last CTA
// of the (lane, KV head, query tile) to draw a ticket merges the partials
// in split order.
template <int D>
__global__ void __launch_bounds__(THREADS, Tiles<D>::MIN_BLOCKS)
paged_prefill_lse_wgmma(const bf16* __restrict__ q,
                        const bf16* __restrict__ k_pool,
                        const bf16* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ starts,
                        const int* __restrict__ owned, bf16* __restrict__ out,
                        float* __restrict__ lse, float* __restrict__ part,
                        int* __restrict__ tickets, int C, int H, int K,
                        int n_blocks, int bs, int T, int L, int splits,
                        float scale_log2) {
  using Tl = Tiles<D>;
  constexpr int SW = Tl::SW;
  constexpr int UPR = D / 8;          // 16-byte units per row
  constexpr int UPP = Tl::E / 8;      // ... per panel row
  extern __shared__ unsigned char smem_raw[];
  __shared__ int klog[NST][BK];       // a staged key's logical position
  __shared__ int warp_n[THREADS / 32];
  __shared__ int ticket;
  __shared__ float inv_l[BQ];

  unsigned char* base = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u)
                                    - smem_u32(smem_raw));
  const uint32_t sq = smem_u32(base);
  const uint32_t skv = sq + Tl::Q_BYTES;     // stage s: K, then V
  // the walk: the table index and the physical block of its j-th block
  int* oblk = reinterpret_cast<int*>(base + Tl::SMEM - 1024);
  int* pblk = oblk + T;

  const int G = H / K;
  const int R = C * G;
  const int n_qt = (R + BQ - 1) / BQ;
  // the splits vary slowest: every lane's first split (the one a walk
  // always has) is dispatched before any lane's second
  const int split = blockIdx.z / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.z % n_qt;    // latest rows first
  const int q0 = qt * BQ;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int start = starts[b];
  const int n_keys = T * bs;
  const int* table = tables + (size_t)b * T;
  auto kmax_of = [&](int r) {
    return min(start + min(r, R - 1) / G, n_keys - 1);
  };
  const int k_end = kmax_of(q0 + BQ - 1) + 1;
  const int nb_end = (k_end + bs - 1) / bs;

  // the owned blocks before nb_end, in table order: a prefix sum of owned
  int n_own = 0;
  for (int i0 = 0; i0 < nb_end; i0 += THREADS) {
    const int i = i0 + tid;
    const bool own = i < nb_end && owned[(size_t)b * T + i] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, own);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int before = n_own, total = 0;
#pragma unroll
    for (int x = 0; x < THREADS / 32; ++x) {
      before += x < warp ? warp_n[x] : 0;
      total += warp_n[x];
    }
    if (own) {
      const int j = before + __popc(bal & ((1u << lane) - 1u));
      oblk[j] = i;
      pblk[j] = min(max(table[i], 0), n_blocks - 1);   // in the stripe
    }
    n_own += total;
    __syncthreads();
  }
  // the walk's keys: the owned blocks' whole, less those of the last
  // block past k_end where that block is the walk's last
  const int n_walk = n_own == 0 ? 0
                     : n_own * bs - (oblk[n_own - 1] == nb_end - 1
                                         ? nb_end * bs - k_end : 0);
  const int n_live = (n_walk + L - 1) / L;
  const int pair = (b * K + kh) * n_qt + qt;
  const int n_rows = min(BQ, R - q0);

  if (split >= n_live) {
    if (split == 0) {                 // the stripe owns no key of the walk
      for (int x = tid; x < n_rows * UPR; x += THREADS) {
        const int r = q0 + x / UPR;
        const size_t row = ((size_t)b * C + r / G) * H + kh * G + r % G;
        reinterpret_cast<uint4*>(out + row * D)[x % UPR] =
            make_uint4(0u, 0u, 0u, 0u);
        if (x % UPR == 0) lse[row] = NEG_INF;
      }
    }
    return;
  }
  const int lo = split * L;
  const int hi = min(lo + L, n_walk);
  const int n_tiles = (hi - lo + BK - 1) / BK;

  load_q<D>(sq, q, b, kh, q0, R, G, C, H);
  auto load_kv = [&](int t) {
    const uint32_t dk = skv + t % NST * 2 * Tl::KV_BYTES;
    const int k0 = lo + t * BK;
    for (int i = tid; i < BK * UPR; i += THREADS) {
      const int r = i / UPR, u = i % UPR;
      const int wp = k0 + r;          // the key's walk position
      const bool live = wp < hi;
      const int j = live ? wp / bs : 0, off = live ? wp - j * bs : 0;
      const size_t row =
          (((size_t)pblk[j] * bs + off) * K + kh) * D + u * 8;
      if (u == 0) klog[t % NST][r] = live ? oblk[j] * bs + off : 0x7fffffff;
      const uint32_t dst = u / UPP * BK * SW + swizzled<SW>(r, u % UPP);
      cp_async16(dk + dst, k_pool + row, live);
      cp_async16(dk + Tl::KV_BYTES + dst, v_pool + row, live);
    }
  };
  for (int t = 0; t < NST; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  const int g = tid / 128;
  const int w = tid % 128 / 32;
  const int rlo = q0 + 64 * g;
  const int rhi = min(rlo + 63, R - 1);
  const bool rows = rlo < R;
  const int kmax_lo = kmax_of(rlo);
  const int kmax_hi = kmax_of(rhi);
  const int r0 = rlo + 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int kmax[2] = {kmax_of(r0), kmax_of(r0 + 8)};

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_ring();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t sk = skv + t % NST * 2 * Tl::KV_BYTES;
    const int* kl = klog[t % NST];
    // logical positions rise along the walk: the tile's first key is its
    // least, and an unfilled slot (past the split's end) reads as past
    // every row
    if (rows && kl[0] <= kmax_hi)
      attend_tile<D>(sq, sk, sk + Tl::KV_BYTES, g, c0, kl[BK - 1] <= kmax_lo,
                     [&](int x, int i) { return kl[x] > kmax[i]; },
                     scale_log2, oacc, m, l);
    __syncthreads();
    if (t + NST < n_tiles) load_kv(t + NST);
    cp_async_commit();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (n_live == 1) {                  // the whole walk: o and lse here
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= R) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      const size_t row = ((size_t)b * C + r / G) * H + kh * G + r % G;
      // m is in log2 units (the scores carry scale * log2 e)
      if (lane % 4 == 0)
        lse[row] = l[i] > 0.f ? m[i] * LN2 + logf(l[i]) : NEG_INF;
      bf16* op = out + row * D + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
            oacc[4 * j + 2 * i] * inv, oacc[4 * j + 2 * i + 1] * inv);
    }
    return;
  }

  // the split's partial per query row: (m, l) then acc (BQ x D), f32
  const size_t pstride = (size_t)BQ * (D + 2);
  float* all = part + (size_t)pair * splits * pstride;
  float* mine = all + split * pstride;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rl = r0 + 8 * i - q0;   // the row in the tile
    if (lane % 4 == 0) {
      mine[2 * rl] = m[i];
      mine[2 * rl + 1] = l[i];
    }
    float* ap = mine + 2 * BQ + (size_t)rl * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(ap + 8 * j) =
          make_float2(oacc[4 * j + 2 * i], oacc[4 * j + 2 * i + 1]);
  }
  // the ticket: every writer's partial is visible device-wide before the
  // counter moves
  __threadfence();
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(&tickets[pair], 1);
  __syncthreads();
  if (ticket != n_live - 1) return;
  __threadfence();

  // the last CTA merges the live splits in split order: per row the
  // weights e^{m_s - M} into shared memory (the ring is free), then o
  float* wts = reinterpret_cast<float*>(base + Tl::Q_BYTES);  // [BQ][splits]
  for (int rl = tid; rl < n_rows; rl += THREADS) {
    float M = NEG_INF;
    for (int s = 0; s < n_live; ++s)
      M = fmaxf(M, __ldcg(all + s * pstride + 2 * rl));
    float Lsum = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float wgt = exp2f(__ldcg(all + s * pstride + 2 * rl) - M);
      wts[rl * splits + s] = wgt;
      Lsum += wgt * __ldcg(all + s * pstride + 2 * rl + 1);
    }
    inv_l[rl] = 1.f / fmaxf(Lsum, 1e-30f);
    const int r = q0 + rl;
    lse[((size_t)b * C + r / G) * H + kh * G + r % G] =
        Lsum > 0.f ? M * LN2 + logf(Lsum) : NEG_INF;
  }
  __syncthreads();
  for (int x = tid; x < n_rows * (D / 4); x += THREADS) {
    const int rl = x / (D / 4), d = 4 * (x % (D / 4));
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {  // 16-byte loads, several in flight
      const float wgt = wts[rl * splits + s];
      const float4 acc = __ldcg(reinterpret_cast<const float4*>(
          all + s * pstride + 2 * BQ + (size_t)rl * D + d));
      o[0] += wgt * acc.x;
      o[1] += wgt * acc.y;
      o[2] += wgt * acc.z;
      o[3] += wgt * acc.w;
    }
    const int r = q0 + rl;
    const size_t row = ((size_t)b * C + r / G) * H + kh * G + r % G;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0] * inv_l[rl],
                                                    o[1] * inv_l[rl]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2] * inv_l[rl],
                                                    o[3] * inv_l[rl]);
    *reinterpret_cast<uint2*>(out + row * D + d) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
  if (tid == 0) tickets[pair] = 0;    // ready for the next launch
}

template <int D, bool LSE>
int launch_wgmma(const void* q, const void* k_pool, const void* v_pool,
                 const int* tables, const int* starts, void* out,
                 const Args& a, cudaStream_t stream) {
  // above 48 KB shared memory is dynamic only, and per device: set on
  // every launch (a host-side attribute, no device work); the tiles, then
  // the walk's block ids (the LSE form: table indices and physical ids)
  const int smem = Tiles<D>::SMEM + (LSE ? 8 : 4) * a.T;
  const int rows = a.C * (a.H / a.K);
  const int n_qt = (rows + BQ - 1) / BQ;
  if constexpr (LSE) {
    if (a.L <= 0 || a.L % BK != 0 || a.splits < 1
        || a.splits > LSE_MAX_SPLITS || a.part == nullptr
        || a.tickets == nullptr)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_lse_wgmma<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(a.K, a.B, a.splits * n_qt);
    paged_prefill_lse_wgmma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
        static_cast<const bf16*>(v_pool), tables, starts, a.owned,
        static_cast<bf16*>(out), a.lse, a.part, a.tickets, a.C, a.H, a.K,
        a.n_blocks, a.bs, a.T, a.L, a.splits, a.scale * LOG2E);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_qt, a.K, a.B);
    paged_prefill_wgmma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
        static_cast<const bf16*>(v_pool), tables, starts,
        static_cast<bf16*>(out), a.C, a.H, a.K, a.n_blocks, a.bs, a.T,
        a.scale * LOG2E);
  }
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, const int*,
                         const int*, void*, const Args&, cudaStream_t);

// the launcher of a (q, pool) dtype pair at head dim D: bf16 over bf16 on
// the tensor cores, f32 q on the CUDA cores
template <int D, bool LSE>
LaunchFn at(int q_dtype, int kv_dtype) {
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16) return launch_wgmma<D, LSE>;
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    return launch_f32<float, D, LSE>;
  if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    return launch_f32<bf16, D, LSE>;
  return nullptr;
}

template <bool LSE>
LaunchFn launcher(int q_dtype, int kv_dtype, int D) {
  switch (D) {
    case 16: return at<16, LSE>(q_dtype, kv_dtype);
    case 32: return at<32, LSE>(q_dtype, kv_dtype);
    case 64: return at<64, LSE>(q_dtype, kv_dtype);
    case 80: return at<80, LSE>(q_dtype, kv_dtype);
    case 96: return at<96, LSE>(q_dtype, kv_dtype);
    case 128: return at<128, LSE>(q_dtype, kv_dtype);
    case 256: return at<256, LSE>(q_dtype, kv_dtype);
    default: return nullptr;
  }
}

// one launch of the plain (LSE false) or the owned/LSE form: each source
// instantiates only its own form, so the two build in parallel
template <bool LSE>
int launch_form(const void* q, const void* k_pool, const void* v_pool,
                const int* tables, const int* starts, void* out, int D,
                int q_dtype, int kv_dtype, const Args& a, void* stream) {
  if (a.B == 0 || a.C == 0) return 0;
  if (a.K <= 0 || a.H % a.K != 0 || a.T <= 0 || a.bs <= 0 || a.n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const LaunchFn launch = launcher<LSE>(q_dtype, kv_dtype, D);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(q, k_pool, v_pool, tables, starts, out, a,
                static_cast<cudaStream_t>(stream));
}

}  // namespace
