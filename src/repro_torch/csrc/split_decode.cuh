// The flash-decode body shared by kernel 5 (decode_attention.cu, a lane's
// contiguous cache) and kernels 2 and 4 (paged_decode_attention.cu, a
// lane's walk through its block table): one query token per lane, the
// lane's keys split over CTAs and the splits merged inside the same launch.
//
// What bounds it on the H100: bytes.  Each key costs 2*D elements of K/V
// read for 4*D flops per query head, so at G query heads per KV head the
// kernels do 2*G flops per bf16 byte, far under the ~295 flops/byte at
// which the card's bf16 tensor cores would become the limit: they stay on
// the CUDA cores, and the design is about keeping enough K/V bytes in
// flight on all 132 SMs.
//
// The walk.  A kernel names where the keys of lane b lie by a Walk:
//   int begin(b, lo, L, ids)  called by every thread of the CTA; returns
//       the lane's walk length n (the same in every thread) and stages in
//       shared memory (ids) what the rows of walk positions [lo, lo + L)
//       need, ending with a barrier where it staged anything;
//   size_t row(b, w, lo, ids) the element offset of walk position w's key
//       row of KV head 0 (KV head kh's row is kh * D further on).
// Kernel 5 walks keys 0 .. min(position, S - 1) of its row; kernel 2 keys
// 0 .. position through the table; kernel 4 the keys of the owned blocks
// at or before position, in table order.
//
// The split.  The grid is (splits, K * head groups, B): split s of a
// (lane, KV head, head group) owns walk positions [s*L, (s+1)*L), L chosen
// by the wrapper from shapes only, never from positions, which stay on the
// card.  A split past the lane's walk (s >= ceil(n / L)) returns at once:
// it writes nothing and takes no ticket, and the merge counts the live
// splits ceil(n / L) only, which every CTA of the lane computes alike.
// Where n = 0, split 0 writes o = 0 (and, with LSE, lse = -1e30).
//
// Inside a CTA, K/V tiles of TK keys (~16 KB of K a tile: 64 keys at
// D = 128 in bf16) stay in the cache's dtype in shared memory, copied with
// 16-byte cp.async into a ring of 2 stages, so the next tile's copy
// overlaps this tile's arithmetic.  A group of LPK lanes owns a whole key:
// lane j holds 16-byte chunks j, j + LPK, ... of the row, so a score is
// reduced over D by shuffles inside a warp and never across warps; the
// shuffle steps are unrolled (a step past the group adds 0), and a group
// scores 8 / GB keys at once, so the chains of several keys and heads
// overlap.  The G query heads of the KV head (up to 8 per CTA; a larger G
// takes several head groups) share each staged row: each lane keeps its
// chunks of the G queries and of the G accumulators in registers, and GQA
// is never expanded.  Each key group runs its own online softmax (m, l,
// acc) over the keys it owns, one rescale per batch of keys.  With
// ROUND_P the unnormalised exp(s - m) is rounded to the cache's dtype
// before PV while l sums the unrounded values, as the reference model's
// _flash_decode_core does (models/attention.py:484-491), here per key
// group and split, the rounding point the sharded core also has; without
// it P stays in f32.  At the split's end the key groups merge in shared
// memory (one warp per head) and the split writes its partial (m, l,
// acc[D]) per query head to f32 scratch the wrapper allocates.
//
// The merge.  Every live CTA, after its partial is written, fences and
// takes a ticket with atomicAdd on its (lane, KV head, head group)
// counter; the CTA that draws the last ticket reads the live partials
// back through L2 (ld.cg; the splits' weights into shared memory, one
// warp per head) and writes o = sum_i e^{m_i - M} acc_i / max(sum_i
// e^{m_i - M} l_i, 1e-30) and, with LSE, lse = M + log(sum_i e^{m_i - M}
// l_i).  It resets its counter to 0, so the counters stay zero between
// launches and need no memset: the wrappers keep them in one zeroed
// buffer per device and stream, which kernels 2, 4 and 5 share (launches
// on one stream run in order).  A launch that faults leaves the context
// unusable and counters are lost with it; a launch that is refused never
// touched them.  One launch per call, no second pass.
//
// Any D % 8 == 0 up to 512 (NCH 16-byte chunks a lane: 1 or 2, or 4 in
// f32), every (q, cache) dtype pair of the wrappers' _PAIRS.
#pragma once

#include "common.cuh"

namespace repro {
namespace split {

constexpr int THREADS = 128;      // 4 warps
constexpr int NST = 2;            // K/V stages in the ring
constexpr int MAX_G = 8;          // query heads per CTA
constexpr int MAX_SPLITS = 256;   // the last CTA's weights in shared memory
constexpr int MAX_D = 512;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the sum over a key group of ``lpk`` lanes (a power of two <= 32, the
// groups aligned on it): every step runs, those that would cross into
// the next group add nothing, so the steps unroll
__device__ __forceinline__ float group_sum(float x, int lpk) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x += o < lpk ? y : 0.f;
  }
  return x;
}

struct Shape {
  int H, K, D, L, splits, groups;   // groups: head groups per KV head
  int ids_off;                      // bytes of dynamic shared memory
                                    // before the walk's staged ids
  float scale;
};

// GB: query heads a lane holds (>= the CTA's), NCH: 16-byte chunks of a
// row per lane; ROUND_P: round exp(s - m) to KT before PV; LSE: write
// lse (B, H) beside o
template <typename QT, typename KT, int GB, int NCH, bool ROUND_P, bool LSE,
          class Walk>
__device__ __forceinline__ void split_decode(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, QT* __restrict__ out, float* __restrict__ lse,
    float* __restrict__ part, int* __restrict__ tickets, const Shape& a,
    int TK, int LPK, const Walk& walk) {
  constexpr int VEC = Vec<KT>::N;     // elements per 16-byte chunk
  constexpr int KB = 8 / GB;          // keys a group scores at once
  const int split = blockIdx.x;
  const int kh = blockIdx.y / a.groups;
  const int hg = blockIdx.y % a.groups;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = a.H / a.K;
  const int HPC = min(G, MAX_G);      // heads per CTA (the last group may
  const int h0 = kh * G + hg * HPC;   // hold fewer)
  const int gc = min(HPC, G - hg * HPC);
  const int D = a.D;
  const int CPR = D / VEC;            // chunks per key row
  const int NG = THREADS / LPK;       // key groups
  const int grp = tid / LPK;
  const int j = tid % LPK;            // lane within the key group
  const int pair = (b * a.K + kh) * a.groups + hg;
  // partial i of this pair: HPC x (m, l) then HPC x D of acc
  const size_t pstride = (size_t)HPC * (D + 2);
  float* mine = part + ((size_t)pair * a.splits + split) * pstride;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ticket;
  int* ids = reinterpret_cast<int*>(smem_raw + a.ids_off);

  const int lo = split * a.L;
  const int n_walk = max(walk.begin(b, lo, a.L, ids), 0);
  const int n_live = (n_walk + a.L - 1) / a.L;
  if (split >= n_live) {
    if (split == 0) {                  // the lane sees no key
      for (int i = tid; i < gc * D; i += THREADS)
        out[((size_t)b * a.H + h0) * D + i] = from_f<QT>(0.f);
      if (LSE)
        for (int g = tid; g < gc; g += THREADS)
          lse[(size_t)b * a.H + h0 + g] = NEG_INF;
    }
    return;
  }
  const int hi = min(lo + a.L, n_walk);

  {
    KT* ring = reinterpret_cast<KT*>(smem_raw);      // [NST][2][TK][D]
    const size_t stage = (size_t)2 * TK * D;
    const KT* kb = k + (size_t)kh * D;
    const KT* vb = v + (size_t)kh * D;
    const int n_tiles = (hi - lo + TK - 1) / TK;

    auto load_tile = [&](int t) {
      KT* ks = ring + (size_t)(t % NST) * stage;
      KT* vs = ks + (size_t)TK * D;
      const int t0 = lo + t * TK;
      const int n = min(TK, hi - t0);
      for (int i = tid; i < n * CPR; i += THREADS) {
        const int r = i / CPR;
        const int c = (i - r * CPR) * VEC;
        const size_t src = walk.row(b, t0 + r, lo, ids) + c;
        cp_async16(ks + r * D + c, kb + src);
        cp_async16(vs + r * D + c, vb + src);
      }
    };

    // this lane's chunks of the CTA's query heads, in f32
    float qr[GB][NCH * VEC], acc[GB][NCH * VEC], m[GB], l[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        const int c = j + n * LPK;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[g][n * VEC + e] = 0.f;
          qr[g][n * VEC + e] =
              (g < gc && c < CPR)
                  ? to_f(q[((size_t)b * a.H + h0 + g) * D + c * VEC + e])
                  : 0.f;
        }
      }
    }

#pragma unroll
    for (int t = 0; t < NST - 1; ++t) {
      if (t < n_tiles) load_tile(t);
      cp_async_commit();
    }
    // the warp's first key group
    const int grp0 = warp * (32 / min(LPK, 32));
    for (int t = 0; t < n_tiles; ++t) {
      if (t + NST - 1 < n_tiles) load_tile(t + NST - 1);
      cp_async_commit();
      cp_async_wait<NST - 1>();
      __syncthreads();                 // tile t has landed for every thread

      const KT* ks = ring + (size_t)(t % NST) * stage;
      const KT* vs = ks + (size_t)TK * D;
      const int n = min(TK, hi - (lo + t * TK));
      // a group takes keys grp + NG * i of the tile, KB at a time; every
      // lane of a warp runs the shuffles, and a key past the tile's end
      // updates nothing
      for (int i0 = 0; grp0 + NG * i0 < n; i0 += KB) {
        float s[GB][KB];
#pragma unroll
        for (int kb2 = 0; kb2 < KB; ++kb2) {
          const int r = grp + NG * (i0 + kb2);
          float kc[NCH * VEC];
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const int ch = j + c * LPK;
            if (r < n && ch < CPR) {
              Vec<KT>::load(ks + r * D + ch * VEC, kc + c * VEC);
            } else {
#pragma unroll
              for (int e = 0; e < VEC; ++e) kc[c * VEC + e] = 0.f;
            }
          }
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < NCH * VEC; ++e) d += qr[g][e] * kc[e];
            s[g][kb2] = d;
          }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int kb2 = 0; kb2 < KB; ++kb2)
            s[g][kb2] = group_sum(s[g][kb2], LPK) * a.scale;
        // online softmax over the batch: one rescale per head (uniform in
        // the group: every lane holds the same scores)
        float p[GB][KB];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float mx = NEG_INF;
#pragma unroll
          for (int kb2 = 0; kb2 < KB; ++kb2)
            if (grp + NG * (i0 + kb2) < n) mx = fmaxf(mx, s[g][kb2]);
          if (mx > m[g]) {
            const float corr = expf(m[g] - mx);
            l[g] *= corr;
#pragma unroll
            for (int e = 0; e < NCH * VEC; ++e) acc[g][e] *= corr;
            m[g] = mx;
          }
#pragma unroll
          for (int kb2 = 0; kb2 < KB; ++kb2) {
            p[g][kb2] = grp + NG * (i0 + kb2) < n ? expf(s[g][kb2] - m[g])
                                                  : 0.f;
            l[g] += p[g][kb2];
          }
        }
#pragma unroll
        for (int kb2 = 0; kb2 < KB; ++kb2) {
          const int r = grp + NG * (i0 + kb2);
          if (r >= n) continue;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const int ch = j + c * LPK;
            if (ch >= CPR) continue;
            float vc[VEC];
            Vec<KT>::load(vs + r * D + ch * VEC, vc);
#pragma unroll
            for (int g = 0; g < GB; ++g) {
              const float pr = ROUND_P ? round_to<KT>(p[g][kb2]) : p[g][kb2];
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[g][c * VEC + e] += pr * vc[e];
            }
          }
        }
      }
      __syncthreads();                 // stage t % NST is free again
    }
    cp_async_wait<0>();                // nothing in flight into the ring

    // merge the key groups in shared memory (the ring is free now):
    // gm[g][grp] = (m, l), then the group's weight; ga[grp][g][D]
    float* gm = reinterpret_cast<float*>(smem_raw);
    float* ga = gm + 2 * NG * GB;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (j == 0) {
        gm[2 * (g * NG + grp)] = m[g];
        gm[2 * (g * NG + grp) + 1] = l[g];
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int ch = j + c * LPK;
        if (ch >= CPR) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          ga[((size_t)grp * GB + g) * D + ch * VEC + e] = acc[g][c * VEC + e];
      }
    }
    __syncthreads();
    // one warp per head: the split's max and sum, and each group's weight
    for (int g = warp; g < gc; g += THREADS / 32) {
      float M = NEG_INF;
      for (int i = lane; i < NG; i += 32) M = fmaxf(M, gm[2 * (g * NG + i)]);
      M = warp_max(M);
      float L = 0.f;
      for (int i = lane; i < NG; i += 32) {
        const float w = expf(gm[2 * (g * NG + i)] - M);
        gm[2 * (g * NG + i)] = w;
        L += w * gm[2 * (g * NG + i) + 1];
      }
      L = warp_sum(L);
      if (lane == 0) {
        mine[2 * g] = M;
        mine[2 * g + 1] = L;
      }
    }
    __syncthreads();
    for (int i = tid; i < gc * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      float o = 0.f;
      for (int r = 0; r < NG; ++r)
        o += gm[2 * (g * NG + r)] * ga[((size_t)r * GB + g) * D + d];
      mine[2 * HPC + i] = o;
    }
  }

  // the ticket: every writer's partial is visible device-wide before the
  // counter moves
  __threadfence();
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(&tickets[pair], 1);
  __syncthreads();
  if (ticket != n_live - 1) return;
  __threadfence();

  // the last CTA merges: one warp per head reads the live splits' (m, l)
  // through L2 into shared memory as weights, then every thread sums its
  // outputs' accumulators, the loads of one output independent
  const float* all = part + (size_t)pair * a.splits * pstride;
  float* wts = reinterpret_cast<float*>(smem_raw);   // [gc][splits]
  __shared__ float inv_l[MAX_G];
  __syncthreads();                     // the group merge's reads are done
  for (int g = warp; g < gc; g += THREADS / 32) {
    float M = NEG_INF;
    for (int s = lane; s < n_live; s += 32)
      M = fmaxf(M, __ldcg(all + s * pstride + 2 * g));
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < n_live; s += 32) {
      const float w = expf(__ldcg(all + s * pstride + 2 * g) - M);
      wts[g * a.splits + s] = w;
      L += w * __ldcg(all + s * pstride + 2 * g + 1);
    }
    L = warp_sum(L);
    if (lane == 0) {
      inv_l[g] = 1.f / fmaxf(L, 1e-30f);
      if (LSE)
        lse[(size_t)b * a.H + h0 + g] =
            L > 0.f ? M + logf(fmaxf(L, 1e-30f)) : NEG_INF;
    }
  }
  __syncthreads();
  for (int i = tid; i < gc * D; i += THREADS) {
    const int g = i / D;
    const float* w = wts + g * a.splits;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s)
      o += w[s] * __ldcg(all + s * pstride + 2 * HPC + i);
    out[((size_t)b * a.H + h0 + g) * D + i - g * D] = from_f<QT>(o * inv_l[g]);
  }
  if (tid == 0) tickets[pair] = 0;     // ready for the next launch
}

// keys per tile: ~16 KB of K (and of V) a stage, 16 to 64 keys
inline int tile_keys(int D, int el) {
  int tk = 64;
  while (tk > 16 && tk * D * el > 16384) tk /= 2;
  return tk;
}

// a launch's lanes per key (a power of two), keys per tile and dynamic
// shared memory before the walk's ids: the ring, the key groups' merge or
// the last CTA's weights, whichever is largest, rounded to 16 bytes
struct Launch {
  int lpk, tk;
  size_t smem;
};

template <typename KT, int GB>
Launch launch_shape(int D, int splits) {
  constexpr int VEC = Vec<KT>::N;
  const int cpr = D / VEC;
  int lpk = 1;
  while (lpk < cpr && lpk < 32) lpk *= 2;
  const int tk = tile_keys(D, (int)sizeof(KT));
  const int ng = THREADS / lpk;
  const size_t ring = (size_t)NST * 2 * tk * D * sizeof(KT);
  const size_t merge = sizeof(float) * ((size_t)2 * ng * GB
                                        + (size_t)ng * GB * D);
  const size_t weights = sizeof(float) * (size_t)GB * splits;
  size_t smem = ring > merge ? ring : merge;
  smem = smem > weights ? smem : weights;
  return {lpk, tk, (smem + 15) / 16 * 16};
}

// Launcher::run<GB, NCH> for >= hpc heads a CTA and D / VEC chunks a
// row, or nullptr: the instantiations a wrapper can reach
template <class Launcher, int NCH>
auto pick_heads(int hpc) -> decltype(&Launcher::template run<1, 1>) {
  return hpc <= 1   ? &Launcher::template run<1, NCH>
         : hpc <= 2 ? &Launcher::template run<2, NCH>
         : hpc <= 4 ? &Launcher::template run<4, NCH>
                    : &Launcher::template run<8, NCH>;
}

template <class Launcher, int VEC>
auto pick(int hpc, int D) -> decltype(&Launcher::template run<1, 1>) {
  const int nch = (D / VEC + 31) / 32;
  if (nch <= 1) return pick_heads<Launcher, 1>(hpc);
  if (nch <= 2) return pick_heads<Launcher, 2>(hpc);
  if constexpr (VEC == 4) {
    if (nch <= 4) return pick_heads<Launcher, 4>(hpc);
  }
  return nullptr;
}

}  // namespace split
}  // namespace repro
