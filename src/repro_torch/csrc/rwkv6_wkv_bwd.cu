// Backward of the RWKV6 WKV recurrence for Hopper (sm_90a): kernel 7's
// gradient.  Per (batch, head), with S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// y_t = r_t . (S_{t-1} + (u * k_t) v_t^T) and G_t = dL/dS_t (G_T = dS_T,
// or 0):
//
//     dr_t    = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//     dk_t    = G_t v_t + r_t * u (v_t . dy_t)
//     dv_t    = G_t^T k_t + c_t dy_t,          c_t = sum_i r_i u_i k_i
//     dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//     du     += r_t * k_t (v_t . dy_t)
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T,    ds0 = G_0.
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/rwkv6_wkv.py:52
// is forward-only, and the reference trains through XLA autodiff of
// src/repro/models/ssm.py:214 (_wkv_chunk).  The training form of kernel 7
// (rwkv6_wkv.cu with CK = true) writes S_t before every step t that is a
// multiple of C; this kernel recomputes each chunk's states from its
// checkpoint.  It never recovers S_{t-1} from S_t by dividing by w_t: w =
// exp(-exp(dw)) underflows toward 0, so no chunkwise tensor-core form
// (decay ratios w_s / w_t) exists either, and it stays on the CUDA cores.
//
// What bounds it on the H100: per step and (b, h) ~14 f32 flops an entry
// of the D x D state (the recompute 3, dr, dk, dw and dv 2 each, G's
// update 3), against 5 rows of D read and 4 written: operations, 0.142 ms
// at rwkv6-3b's training shape (B = 4, T = 1024, H = 40, D = 64) on the
// CUDA cores' 67 TFLOP/s.  The T steps depend on each other only through
// the two elementwise recurrences (S forward, G backward); every sum over
// a row or a column is off that chain.
//
// What held the first design back (one CTA a (b, h), 2.42 ms at that
// shape on an H100 80GB HBM3 at 700 W): each chunk's C recomputed states
// went to a B*H*C*D*D f32 scratch in device memory and came back one per
// step, 5.4 GB a call, and the grid of B*H CTAs of 8 warps, one chain of
// shuffles and barriers a step, left the card waiting on latency.
//
// Design.  The rows of S and G split over a thread-block cluster of P
// CTAs (P = D / 16: 16 rows a CTA; 4 at rwkv6-3b's D = 64, at most 8 at
// D = 128, the portable cluster size): grid B*H*P, 640 CTAs at the
// training shape.  A CTA has 256 threads, a half-warp a row, lane tc of it holding the D / 16 consecutive columns from tc * D /
// 16 of G in registers (read as vectors from the staged rows).  dr, dk,
// dw, du and ds0 sum over a row's columns or are the row itself, so each
// is whole inside the CTA that holds the row; dv sums over the rows, so
// the CTAs' partials meet through distributed shared memory (below).
//
// No state leaves the chip.  A chunk's states are recomputed from its
// checkpoint in two levels: a forward pass over the chunk keeps every
// SUB-th state (SUB = 16 up to D = 64, 8 above; sub-checkpoints, each
// thread its own entries, in shared memory), then the sub-chunks are
// walked from the last, each recomputing its SUB states from its
// sub-checkpoint into registers and walking its steps backwards (a whole
// sub-chunk without a test a step, so the steps' loads interleave).  That
// is 2 more flops an entry than one recompute.  The states' update is the
// forward's (fmaf(w, S, k v)), so the states are the forward's bits.  The
// checkpoint interval C (wkv_chunk: 32 at D = 64) is half the first
// design's, which keeps a CTA at ~85 KB of shared memory (bf16, D = 64):
// two CTAs of 8 warps an SM, where 64 steps a chunk leave one.
//
// Per step a thread does its entries' FMAs only: dr's, dk's and dw's
// partial sums over its columns are kept for the sub-chunk (3 * SUB
// values, padded to a multiple of 16) and reduced over the half-warp
// together at its end by exchanging halves (15 shuffles a 16 values,
// after which lane l holds value l's total).  dv's partials (G_t[i, j]
// k_i) meet the warp's other row by one shuffle and go to shared memory.
// At the sub-chunk's end the row pairs are summed in order, this CTA's
// part of c_t (r_i u_i k_i over its rows) times dy_t added, and each
// column's partial is pushed into the shared memory of the CTA that owns
// the column (a store through distributed shared memory); the CTA then
// arrives at a cluster barrier and waits on it only after the next
// sub-chunk's walk, so the barrier's latency hides behind that work.
// After the wait each CTA sums its RS columns' P partials in rank order,
// reading its own shared memory only.  The partials are double-buffered,
// so one barrier a sub-chunk orders every push before its read and every
// read before the next push into the same buffer.  No atomics: every sum
// has one order, so two runs give the same bits.  The sub-chunk's
// outputs are staged in shared memory and written 16 bytes a store (each
// step's RS rows or columns of a CTA are one contiguous segment).
//
// The chunk's inputs (v and dy whole, r, k and w for the CTA's rows, and
// the checkpoint's rows) are staged by 16-byte cp.async into one of two
// buffers while the previous chunk walks; each thread's copies arrive on
// the buffer's mbarrier (cp.async.mbarrier.arrive.noinc) and the walk
// waits on its phase.  r/k/v/dy f32 or bf16 (widened on use), dr/dk/dv
// rounded once to their dtype, dw, du and ds0 f32.  du is summed per
// (b, h): the lane that writes a step's dr adds that step's term, and
// the row's 16 lanes are added once at the end; the wrapper sums the
// partials over b (torch's sum(0), which uses no atomics).  Head dims:
// every D % 16 == 0 up to 128, one design.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

constexpr int TC = 16;      // column lanes of a row (a half-warp)

// the training form's checkpoint interval C (rwkv6_wkv.py's wkv_chunk):
// the largest power of two up to 2048 / D
constexpr int chunk_of(int D) {
  int c = 1;
  while (2 * c * D <= 2048) c *= 2;
  return c;
}

template <typename T, int D>
struct Plan {
  static constexpr int RS = 16;                 // rows of S a CTA
  static constexpr int P = D / RS;              // CTAs a cluster (a head)
  static constexpr int NT = RS * TC;            // threads
  static constexpr int CPT = D / TC;            // columns a thread
  // steps of a sub-chunk, its states in registers (SUB x CPT a thread)
  static constexpr int SUB = CPT <= 4 ? 16 : 8;
  static constexpr int NRED = (3 * SUB + 15) / 16 * 16;   // dr, dk, dw
  static constexpr int C = chunk_of(D);
  static constexpr int NSUB = C / SUB;
  static constexpr int EL = sizeof(T);
  // one stage of a chunk's inputs, in bytes: v, dy (C x D), r, k (C x RS)
  // in T; w (C x RS) and the checkpoint's rows (RS x D) f32
  static constexpr int VB = C * D * EL;
  static constexpr int RB = C * RS * EL;
  static constexpr int WB = C * RS * 4;
  static constexpr int KB = RS * D * 4;
  static constexpr int SB = 2 * VB + 2 * RB + WB + KB;
  // floats after the two stages: sub-checkpoints, dv's row pairs, the
  // partials of dv the cluster's CTAs push here (2 buffers of P x SUB x
  // RS), a sub-chunk's outputs (dr, dk, dw, dv), c_t's part and v . dy
  static constexpr int F_SUBCK = NSUB * CPT * NT;
  static constexpr int F_DVBUF = SUB * (RS / 2) * D;
  static constexpr int F_RECV = 2 * P * SUB * RS;
  static constexpr int F_OBUF = 4 * SUB * RS;
  static constexpr int SMEM =
      2 * SB + 4 * (F_SUBCK + F_DVBUF + F_RECV + F_OBUF + 2 * C) + 16;
  static_assert(D % TC == 0 && RS * EL % 16 == 0 && P <= 8, "plan");
  static_assert(SB % 16 == 0 && C % SUB == 0, "stage layout");
};

struct TStrides {           // element strides of one (B, T, H, D) tensor
  long long b, t, h;        // the D axis is contiguous
};

// v[i] (NV a multiple of 16) are a lane's partials; the 16 lanes of a
// half-warp exchange halves (8 + 4 + 2 + 1 shuffles per 16 values), after
// which lane l holds in v[16 n] the total of value 16 n + l
template <int OFF, int NV>
__device__ __forceinline__ void reduce_half16(float (&v)[NV], int l) {
  if constexpr (OFF >= 1) {
    const bool up = (l & OFF) != 0;
#pragma unroll
    for (int g = 0; g < NV; g += 16)
#pragma unroll
      for (int i = 0; i < OFF; ++i) {
        const float send = up ? v[g + i] : v[g + i + OFF];
        const float keep = up ? v[g + i + OFF] : v[g + i];
        v[g + i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
    reduce_half16<OFF / 2, NV>(v, l);
  }
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// N consecutive elements at p, widened (16-bit pairs unpacked by shifts;
// vector loads where N allows: p is on 2 N bytes (bf16) or 4 N (f32))
template <typename T, int N>
__device__ __forceinline__ void load_cols(const T* p, float (&x)[N]) {
  if constexpr (sizeof(T) == 2 && N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const uint2 w2 = *reinterpret_cast<const uint2*>(p + c);
      x[c] = __uint_as_float(w2.x << 16);
      x[c + 1] = __uint_as_float(w2.x & 0xffff0000u);
      x[c + 2] = __uint_as_float(w2.y << 16);
      x[c + 3] = __uint_as_float(w2.y & 0xffff0000u);
    }
  } else if constexpr (sizeof(T) == 2 && N % 2 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + c);
      x[c] = __uint_as_float(w1 << 16);
      x[c + 1] = __uint_as_float(w1 & 0xffff0000u);
    }
  } else if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + c);
      x[c] = f.x;
      x[c + 1] = f.y;
      x[c + 2] = f.z;
      x[c + 3] = f.w;
    }
  } else if constexpr (sizeof(T) == 4 && N % 2 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 f = *reinterpret_cast<const float2*>(p + c);
      x[c] = f.x;
      x[c + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) x[c] = to_f(p[c]);
  }
}

// 16 bytes of T at dst from 16 / sizeof(T) floats (bf16 rounded to nearest)
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* src) {
  if constexpr (sizeof(T) == 2) {
    uint4 o;
    uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(dst) = o;
  } else {
    *reinterpret_cast<float4*>(dst) =
        make_float4(src[0], src[1], src[2], src[3]);
  }
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(Plan<T, D>::NT)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ ck,
               const float* __restrict__ dS, const T* __restrict__ dy,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ ds0, int H, int Tlen, TStrides sr,
               TStrides sk, TStrides sv, TStrides sw, TStrides sd) {
  using Pl = Plan<T, D>;
  constexpr int RS = Pl::RS, P = Pl::P, NT = Pl::NT, CPT = Pl::CPT;
  constexpr int C = Pl::C, EL = Pl::EL, SUB = Pl::SUB, NRED = Pl::NRED;
  constexpr int VB = Pl::VB, RB = Pl::RB, WB = Pl::WB, SB = Pl::SB;
  extern __shared__ __align__(16) unsigned char smem[];
  float* subck = reinterpret_cast<float*>(smem + 2 * SB);  // [NSUB][CPT][NT]
  float* dvbuf = subck + Pl::F_SUBCK;                     // [SUB][RS/2][D]
  float* recv = dvbuf + Pl::F_DVBUF;                      // [2][P][SUB][RS]
  float* obuf = recv + Pl::F_RECV;        // [4][SUB][RS]: dr, dk, dw, dv
  float* cpart = obuf + Pl::F_OBUF;                       // [C]
  float* vdy = cpart + C;                                 // [C]
  uint64_t* bar = reinterpret_cast<uint64_t*>(vdy + C);   // [2]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / P;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int a = tid / TC, tc = tid % TC;   // the thread's row in the CTA
  const int j0 = tc * CPT;                 // ... and its first column
  const int warp = tid / 32, lane = tid % 32;
  const int i = rank * RS + a;             // ... and its row in S
  const T* rb = r + b * sr.b + h * sr.h + rank * RS;
  const T* kb = k + b * sk.b + h * sk.h + rank * RS;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h + rank * RS;
  const T* db = dy + b * sd.b + h * sd.h;
  const size_t ob = ((size_t)b * Tlen * H + h) * D;   // contiguous outputs
  const size_t HD = (size_t)H * D;
  const int n_ck = (Tlen + C - 1) / C;
  const float u_i = u[(size_t)h * D + i];
  const float u_tc = tc < RS ? u[(size_t)h * D + rank * RS + tc] : 0.f;

  if (tid == 0) {
    mbar_init(smem_u32(&bar[0]), NT);
    mbar_init(smem_u32(&bar[1]), NT);
  }
  // every CTA of the cluster is running before any pushes into another
  cluster_arrive();
  cluster_wait();

  // chunk n's inputs into stage st; this thread's copies arrive on the
  // stage's mbarrier when they land
  auto stage = [&](int n, int st) {
    const uint32_t s0 = smem_u32(smem + st * SB);
    const int t0 = n * C, cnt = min(C, Tlen - t0);
    constexpr int VU = D * EL / 16;         // 16-byte units of a row
    for (int x = tid; x < cnt * VU; x += NT) {
      const int tt = x / VU, uu = x - tt * VU;
      const uint32_t off = (uint32_t)(tt * D * EL + uu * 16);
      cp16(s0 + off, reinterpret_cast<const char*>(vb + (t0 + tt) * sv.t)
                         + uu * 16);
      cp16(s0 + VB + off,
           reinterpret_cast<const char*>(db + (t0 + tt) * sd.t) + uu * 16);
    }
    constexpr int RU = RS * EL / 16;        // ... of the CTA's rows
    for (int x = tid; x < cnt * RU; x += NT) {
      const int tt = x / RU, uu = x - tt * RU;
      const uint32_t off = (uint32_t)(tt * RS * EL + uu * 16);
      cp16(s0 + 2 * VB + off,
           reinterpret_cast<const char*>(rb + (t0 + tt) * sr.t) + uu * 16);
      cp16(s0 + 2 * VB + RB + off,
           reinterpret_cast<const char*>(kb + (t0 + tt) * sk.t) + uu * 16);
    }
    constexpr int WU = RS * 4 / 16;
    for (int x = tid; x < cnt * WU; x += NT) {
      const int tt = x / WU, uu = x - tt * WU;
      cp16(s0 + 2 * VB + 2 * RB + (uint32_t)(tt * RS * 4 + uu * 16),
           reinterpret_cast<const char*>(wb + (t0 + tt) * sw.t) + uu * 16);
    }
    const float* src = ck + ((size_t)bh * n_ck + n) * D * D
                       + (size_t)rank * RS * D;
    for (int x = tid; x < RS * D / 4; x += NT)
      cp16(s0 + 2 * VB + 2 * RB + WB + x * 16, src + x * 4);
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_u32(&bar[st]))
                 : "memory");
  };

  // the sub-chunk's outputs in obuf, 16 bytes a store: each step's RS rows
  // (dr, dk, dw) or columns (dv) of this CTA are one contiguous segment;
  // ``rows`` the dr/dk/dw of steps [t_rows, t_rows + n_rows), dv those of
  // [t_dv, t_dv + n_dv)
  auto flush = [&](int t_rows, int n_rows, int t_dv, int n_dv) {
    constexpr int UT = RS * EL / 16, UF = RS / 4, U = 3 * UT + UF;
    for (int y = tid; y < SUB * U; y += NT) {
      const int s = y / U, z = y % U;
      if (z < 2 * UT || z >= 3 * UT) {      // dr, dk, dw
        if (s >= n_rows) continue;
        const size_t row = ob + (size_t)(t_rows + s) * HD + rank * RS;
        if (z < 2 * UT) {
          const int kind = z / UT, u = z % UT;
          store16<T>((kind == 0 ? dr : dk) + row + u * (16 / EL),
                     obuf + (kind * SUB + s) * RS + u * (16 / EL));
        } else {
          const int u = z - 3 * UT;
          store16<float>(dw + row + u * 4, obuf + (2 * SUB + s) * RS + u * 4);
        }
      } else {                              // dv
        if (s >= n_dv) continue;
        const int u = z - 2 * UT;
        store16<T>(dv + ob + (size_t)(t_dv + s) * HD + rank * RS
                       + u * (16 / EL),
                   obuf + (3 * SUB + s) * RS + u * (16 / EL));
      }
    }
  };
  // dv of the sub-chunk whose partials were pushed into buffer ``par``:
  // the P CTAs' partials in rank order, into obuf
  auto gather_dv = [&](int par, int n_dv) {
    const float* rv = recv + par * P * SUB * RS;
    for (int x = tid; x < SUB * RS; x += NT) {
      if (x / RS >= n_dv) continue;
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) sum += rv[p * SUB * RS + x];
      obuf[3 * SUB * RS + x] = sum;
    }
  };

  float G[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    G[c] = dS ? dS[((size_t)bh * D + i) * D + j0 + c] : 0.f;
  float du_acc = 0.f;
  int ns = 0;                               // sub-chunks walked
  int t_prev = 0, n_prev = 0;               // the last one's steps

  if (n_ck > 0) stage(n_ck - 1, 0);
  for (int kk = 0; kk < n_ck; ++kk) {
    const int n = n_ck - 1 - kk, st = kk & 1;
    const int t0 = n * C, cnt = min(C, Tlen - t0);
    __syncthreads();                        // chunk kk - 1's readers are done
    if (n > 0) stage(n - 1, st ^ 1);        // the next chunk's inputs
    mbar_wait(smem_u32(&bar[st]), (kk >> 1) & 1);
    const unsigned char* sb = smem + st * SB;
    const T* sv_ = reinterpret_cast<const T*>(sb);
    const T* sd_ = reinterpret_cast<const T*>(sb + VB);
    const T* sr_ = reinterpret_cast<const T*>(sb + 2 * VB);
    const T* sk_ = reinterpret_cast<const T*>(sb + 2 * VB + RB);
    const float* sw_ = reinterpret_cast<const float*>(sb + 2 * VB + 2 * RB);
    const float* sck = sw_ + C * RS;

    // v_t . dy_t over the whole rows, and this CTA's part of c_t: a
    // half-warp a step
    for (int t1 = 0; t1 < cnt; t1 += RS) {  // uniform: the shuffles
      const int tt = t1 + a;                 // need both half-warps
      const bool live = tt < cnt;
      float x = 0.f;
      if (live) {
        float vv[CPT], dd[CPT];
        load_cols(sv_ + tt * D + j0, vv);
        load_cols(sd_ + tt * D + j0, dd);
#pragma unroll
        for (int c = 0; c < CPT; ++c) x = fmaf(vv[c], dd[c], x);
      }
      float cc = live && tc < RS ? to_f(sr_[tt * RS + tc]) * u_tc
                                       * to_f(sk_[tt * RS + tc])
                                 : 0.f;
      x = half_sum(x);
      cc = half_sum(cc);
      if (live && tc == 0) {
        vdy[tt] = x;
        cpart[tt] = cc;
      }
    }

    // the forward pass: every SUB-th state of the chunk, this thread's
    // entries, into the sub-checkpoints
    const int nsub = (cnt + SUB - 1) / SUB;
    {
      float S[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) S[c] = sck[a * D + j0 + c];
      for (int m = 0; m < nsub; ++m) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) subck[(m * CPT + c) * NT + tid] = S[c];
        if (m == nsub - 1) break;
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          const int tt = m * SUB + s;
          const float ki = to_f(sk_[tt * RS + a]), wi = sw_[tt * RS + a];
          float vv[CPT];
          load_cols(sv_ + tt * D + j0, vv);
#pragma unroll
          for (int c = 0; c < CPT; ++c)   // the forward's update
            S[c] = fmaf(wi, S[c], ki * vv[c]);
        }
      }
    }
    __syncthreads();                        // vdy and c_t's part are there

    for (int m = nsub - 1; m >= 0; --m, ++ns) {
      const int n_s = min(SUB, cnt - m * SUB);   // the sub-chunk's steps
      // its states S_{t-1} of its steps t, in registers
      float sst[SUB][CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) sst[0][c] = subck[(m * CPT + c) * NT + tid];
#pragma unroll
      for (int s = 1; s < SUB; ++s) {
        const int tt = m * SUB + s - 1;
        const float ki = to_f(sk_[tt * RS + a]), wi = sw_[tt * RS + a];
        float vv[CPT];
        load_cols(sv_ + tt * D + j0, vv);
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          sst[s][c] = fmaf(wi, sst[s - 1][c], ki * vv[c]);
      }
      // its steps, last first: dr, dk, dw partials kept, dv's to smem
      float red[NRED];
#pragma unroll
      for (int x = 0; x < NRED; ++x) red[x] = 0.f;
      auto step = [&](int s) {
        const int tt = m * SUB + s;
        const float ri = to_f(sr_[tt * RS + a]);
        const float ki = to_f(sk_[tt * RS + a]), wi = sw_[tt * RS + a];
        float vv[CPT], dd[CPT], dvp[CPT];
        load_cols(sv_ + tt * D + j0, vv);
        load_cols(sd_ + tt * D + j0, dd);
        float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          pr = fmaf(sst[s][c], dd[c], pr);
          pk = fmaf(G[c], vv[c], pk);
          pw = fmaf(G[c], sst[s][c], pw);
          dvp[c] = G[c] * ki;
          dvp[c] += __shfl_xor_sync(0xffffffffu, dvp[c], 16);
          G[c] = fmaf(wi, G[c], ri * dd[c]);
        }
        if (lane < 16) {                    // the warp's two rows' dv
          float* dst = dvbuf + (s * (RS / 2) + warp) * D + j0;
          if constexpr (CPT % 4 == 0) {
#pragma unroll
            for (int c = 0; c < CPT; c += 4)
              *reinterpret_cast<float4*>(dst + c) =
                  make_float4(dvp[c], dvp[c + 1], dvp[c + 2], dvp[c + 3]);
          } else {
#pragma unroll
            for (int c = 0; c < CPT; ++c) dst[c] = dvp[c];
          }
        }
        red[s] = pr;
        red[SUB + s] = pk;
        red[2 * SUB + s] = pw;
      };
      if (n_s == SUB) {                     // a whole sub-chunk: no tests,
#pragma unroll                              // so the steps interleave
        for (int s = SUB - 1; s >= 0; --s) step(s);
      } else {                              // uniform in the cluster
#pragma unroll
        for (int s = SUB - 1; s >= 0; --s)
          if (s < n_s) step(s);
      }
      __syncthreads();                      // the row pairs' dv are there
      if (ns > 0) {
        cluster_wait();                     // the last sub-chunk's pushes
        gather_dv((ns - 1) & 1, n_prev);
      }
      // push this sub-chunk's dv partial (its row pairs in order, plus its
      // part of c_t times dy_t) to the CTA that owns each column
      {
        float* mine = recv + (ns & 1) * P * SUB * RS + rank * SUB * RS;
        for (int x = tid; x < SUB * D; x += NT) {
          const int s = x / D, j = x - s * D;
          if (s >= n_s) continue;
          const int tt = m * SUB + s;
          float sum = 0.f;
#pragma unroll
          for (int q = 0; q < RS / 2; ++q)
            sum += dvbuf[(s * (RS / 2) + q) * D + j];
          sum = fmaf(cpart[tt], to_f(sd_[tt * D + j]), sum);
          cluster.map_shared_rank(mine, j / RS)[s * RS + j % RS] = sum;
        }
      }
      cluster_arrive();                     // they are there at its wait
      // meanwhile the rows' sums over their columns: lane tc of a row holds
      // value 16 e + tc of each 16: dr of step x, dk of step x - SUB, dw
      // of step x - 2 SUB (x = 16 e + tc)
      reduce_half16<8, NRED>(red, tc);
#pragma unroll
      for (int e = 0; e < NRED / 16; ++e) {
        const int x = 16 * e + tc;
        const int kind = x / SUB, s = x % SUB, tt = m * SUB + s;
        if (kind < 3 && s < n_s) {
          float val = red[16 * e];
          if (kind == 0) {                  // dr, and du's term of step s
            const float ki = to_f(sk_[tt * RS + a]);
            val = fmaf(u_i * ki, vdy[tt], val);
            du_acc = fmaf(to_f(sr_[tt * RS + a]) * ki, vdy[tt], du_acc);
          } else if (kind == 1)
            val = fmaf(to_f(sr_[tt * RS + a]) * u_i, vdy[tt], val);
          obuf[(kind * SUB + s) * RS + a] = val;
        }
      }
      __syncthreads();                      // the outputs are in obuf
      flush(t0 + m * SUB, n_s, t_prev, ns > 0 ? n_prev : 0);
      t_prev = t0 + m * SUB;
      n_prev = n_s;
    }
  }
  if (ns > 0) {                             // the last sub-chunk's dv
    cluster_wait();
    __syncthreads();                        // the last flush read obuf
    gather_dv((ns - 1) & 1, n_prev);
    __syncthreads();
    flush(0, 0, t_prev, n_prev);
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c)
    ds0[((size_t)bh * D + i) * D + j0 + c] = G[c];
  du_acc = half_sum(du_acc);                // the row's lanes' terms
  if (tc == 0) du_part[(size_t)bh * D + i] = du_acc;
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const float*,
                        const float*, const float*, const float*, const T*,
                        T*, T*, T*, float*, float*, float*, int, int, TStrides,
                        TStrides, TStrides, TStrides, TStrides);

struct Launch {
  int P, NT, C, smem;
};

template <typename T, int D>
Launch shape_of(Kernel<T>* fn) {
  using Pl = Plan<T, D>;
  *fn = wkv_bwd_kernel<T, D>;
  return {Pl::P, Pl::NT, Pl::C, Pl::SMEM};
}

template <typename T>
Launch kernel_of(int D, Kernel<T>* fn) {
  switch (D) {
    case 16: return shape_of<T, 16>(fn);
    case 32: return shape_of<T, 32>(fn);
    case 48: return shape_of<T, 48>(fn);
    case 64: return shape_of<T, 64>(fn);
    case 80: return shape_of<T, 80>(fn);
    case 96: return shape_of<T, 96>(fn);
    case 112: return shape_of<T, 112>(fn);
    case 128: return shape_of<T, 128>(fn);
    default: *fn = nullptr; return {0, 0, 0, 0};
  }
}

template <typename T>
int launch(void* const* a, int B, int Tlen, int H, int D, int C,
           const TStrides* st, cudaStream_t stream) {
  Kernel<T> fn = nullptr;
  const Launch l = kernel_of<T>(D, &fn);
  if (fn == nullptr || C != l.C) return (int)cudaErrorInvalidValue;
  // above 48 KB shared memory is dynamic only, and per device: set on
  // every launch (a host-side attribute, no device work)
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H * l.P));
  cfg.blockDim = dim3((unsigned)l.NT);
  cfg.dynamicSmemBytes = (size_t)l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)l.P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, fn, static_cast<const T*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const float*>(a[3]),
      static_cast<const float*>(a[4]), static_cast<const float*>(a[5]),
      static_cast<const float*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<T*>(a[8]), static_cast<T*>(a[9]), static_cast<T*>(a[10]),
      static_cast<float*>(a[11]), static_cast<float*>(a[12]),
      static_cast<float*>(a[13]), H, Tlen, st[0], st[1], st[2], st[3], st[4]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// r/k/v/dy (B, T, H, D) in dtype (f32 or bf16) and w (B, T, H, D) f32, each
// with D contiguous, every row on 16 bytes; u (H, D) f32; ck the training
// form's checkpoints (B, H, ceil(T / C), D, D) f32; dS (B, H, D, D) f32 or
// nullptr (0); outputs dr/dk/dv (B, T, H, D) contiguous in dtype, dw (B, T,
// H, D) f32, du_part (B, H, D) f32, ds0 (B, H, D, D) f32.  p holds B, T,
// H, D, C, dtype, then the element strides of the B, T and H axes of r, k,
// v, w and dy.  Returns the cudaError_t of the launch (0 = launched; a
// cluster the card cannot place is refused there).
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const float* w, const float* u, const float* ck,
                             const float* dS, const void* dy, void* dr,
                             void* dk, void* dv, float* dw, float* du_part,
                             float* ds0, const long long* p, void* stream) {
  const int B = (int)p[0], T = (int)p[1], H = (int)p[2], D = (int)p[3];
  const int C = (int)p[4], dtype = (int)p[5];
  if (B == 0 || H == 0) return 0;
  if (B < 0 || H < 0 || T < 0 || (long long)B * H * 8 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const TStrides st[5] = {{p[6], p[7], p[8]}, {p[9], p[10], p[11]},
                         {p[12], p[13], p[14]}, {p[15], p[16], p[17]},
                         {p[18], p[19], p[20]}};
  void* const a[14] = {const_cast<void*>(r), const_cast<void*>(k),
                       const_cast<void*>(v), const_cast<float*>(w),
                       const_cast<float*>(u), const_cast<float*>(ck),
                       const_cast<float*>(dS), const_cast<void*>(dy), dr, dk,
                       dv, dw, du_part, ds0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch<float>(a, B, T, H, D, C, st, s);
  if (dtype == DT_BF16) return launch<bf16>(a, B, T, H, D, C, st, s);
  return (int)cudaErrorInvalidValue;
}
