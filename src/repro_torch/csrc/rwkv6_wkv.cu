// RWKV6 WKV recurrence for Hopper (sm_90a): per (batch, head) a D x D f32
// state S carried over time,
//     y_t = r_t . (S + (u * k_t) v_t^T);   S <- diag(w_t) S + k_t v_t^T.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv.py:52
// (rwkv6_wkv; kernel body _wkv_kernel, :24).
//
// What bounds it on the H100: bytes or operations, and the sequential time
// axis.  The function needs 5*D^2 + 5*D f32 flops per step and (b, h), in
// the form y_j = sum_i r_i S_ij + v_j c_t with c_t = sum_i r_i u_i k_i,
// then S_ij <- w_i S_ij + k_i v_j, against D elements each of r, k, v and
// w read and of y written: D/4 flops per byte with f32 r/k/v/y, 5*D/12
// with bf16, beside the card's ~20 f32 flops per byte of HBM bandwidth.
// So at prefill with D = 64 the f32 pair is bound by bytes and the bf16
// pair by operations (2.48 us for T = 200, H = 40).  At decode (T = 1) the
// bytes are the state, read and written once: 2 * B*H*D^2*4 B, 5.24 MB at
// B=4, H=40, D=64, ~1.6 us at 3.35 TB/s.  Besides, T steps depend on each
// other, which sets a latency floor of T dependent steps whatever the
// bandwidth: per step and entry one FMA of the state's update.
//
// Design.  On the TPU the grid is (b, h, time block) with the time axis
// walked in order and S kept in VMEM scratch between blocks; it asserts
// T % block_t == 0.  Here no grid axis runs in order, so a CTA loops over
// all T itself.  Given r, k, w and u, column j of S and y_j read no other
// column, so the D columns split over CTAs, JC each (grid: B*H*(D/JC)),
// and each column's D rows over Q lanes of one warp: lane q of column j
// keeps its R = D/Q entries of S[:, j] in registers, the blocks of V rows
// (V = row_block(D): 4, or 2 at D = 80 and 112) numbered q, q + Q, q + 2Q,
// ..., so the Q lanes read V consecutive floats each, together one
// contiguous run, and the columns of a warp read the same (a broadcast).
// Per step a lane adds r_i S_ij over its rows (one FMA an entry) and
// updates them (S_ij <- w_i S_ij + k_i v_j: a multiply and an FMA), 5
// flops an entry; the next step's rows load while this one computes.
//
// The sum y_j = sum_i r_i S_ij has one order whatever Q: block b belongs
// to partial b mod P (P = parts(D), a power of two that every Q divides),
// each partial is one chain of FMAs over its blocks in order, and the P
// partials are added as a butterfly, p + (p + P/2) first, then P/4, ...,
// 1.  A lane holds the P/Q partials p = q (mod Q), so it adds the levels
// P/2 .. Q in registers and the Q lanes of a column add the levels Q/2 ..
// 1 by shuffles: the same additions of the same values, so one call of T
// steps and T calls of one step give the same bits although the plan
// gives them different Q.  A lane keeps its sums of Q steps in registers
// and the Q lanes of a column reduce them together, each keeping the half
// its partner does not (Q - 1 shuffles for Q steps, off the state's
// dependency chain, pairing lanes in the same order), after which lane q
// holds step q's sum, adds v_j c_t and writes y_j.  The plan (wkv_plan,
// from shapes alone, the same for every T) takes Q = 4 lanes a column at
// D = 64 and JC = 32 columns a CTA: 128 stepping lanes, 80 CTAs for a
// 200-token prefill of rwkv6-3b and 320 for its 4-slot decode step.
//
// Each CTA has one more warp, the producer: it copies r, k, v and w in
// tiles of TT steps (2048 / D steps of bf16 r/k/v or 1024 / D of f32, with
// f32 w: 20 or 32 KB a buffer; down to a multiple of Q) by cp.async into
// two buffers, 16 bytes a copy through the (B, T, H, D) strides (plain
// loads where a pointer or stride is not a multiple of 16 bytes; any T:
// the last tile is short), and computes c_t = sum_i r_i u_i k_i once a
// step for the CTA (8 lanes a step, vector loads, 3 shuffles), while the
// stepping warps work through the other buffer.  They meet at named
// barriers, one of each kind per buffer: tile n has landed (the stepping
// warps start), its c_t are written (needed only for y), its buffer is
// consumed (the producer refills it with tile n + 2).  Measured on the
// card, the producer's work (the copies' issue and the c_t pass) and the
// steps' are about even at rwkv6-3b's prefill, so more CTAs a head (which
// each copy whole rows) do not help.
//
// A call of at most SHORT_T = 4 steps (a decode step) stages no tile: the
// stepping warps read their rows of r, k, w and v_j straight from memory
// (the first step's loads issued beside the state's), and their first
// warp computes each step's c_t with the producer's arithmetic (the same
// rows a lane, order and shuffles), so a decode step gives the bits a
// longer call gives; the other warps step meanwhile and wait for c_t only
// to add v_j c_t to y; the producer warp returns at once.
//
// The training form (CK = true; rwkv6_wkv.py rwkv6_wkv_train) is the same
// kernel that also writes each lane's entries of S to the checkpoints
// before every step t with t % C == 0 (C a power of two, wkv_chunk: 32 at
// D = 64), where the lane holds S_t: the steps' arithmetic, and so y and
// the final state, are the serve form's bit for bit.  Kernel 7's backward
// (rwkv6_wkv_bwd.cu) recomputes each chunk's states from them.  The
// serve form (CK = false) compiles to the code it always had.
//
// A lane reads its entries of S straight into registers at the start and
// writes them back at the end, and no other lane touches them, so s_out
// may be s0: the slot pool's decode updates its state in place.  s0 ==
// nullptr means a zero state (prefill).  r/k/v/y are f32 or bf16 (staged
// as they are, widened on use, y rounded once on store); w, u and the
// state are f32.  Head dims: every D % 16 == 0 up to 128.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int MAX_THREADS = 256;
constexpr int SHORT_T = 4;        // calls of at most this many steps skip
                                  // the producer

// rows of a block (a lane's vector of S's entries): 4, or 2 where D / 8
// rows a lane are not a multiple of 4
__host__ __device__ constexpr int row_block(int D) {
  return D == 80 || D == 112 ? 2 : 4;
}
// partials of y_j's sum: the largest power of two up to 16 dividing the
// D / row_block(D) blocks; every Q of D divides it (rwkv6_wkv.py _PARTS)
__host__ __device__ constexpr int parts(int D) {
  int p = 1;
  while (p < 16 && (D / row_block(D)) % (2 * p) == 0) p *= 2;
  return p;
}

struct Strides {            // element strides of one (B, T, H, D) tensor
  long long b, t, h;        // the D axis is contiguous
};

template <typename T, int V> struct VecLoad;
template <> struct VecLoad<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <> struct VecLoad<float, 2> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  }
};
template <> struct VecLoad<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    o[0] = *p;
  }
};
template <> struct VecLoad<bf16, 4> {
  __device__ __forceinline__ static void load(const bf16* p, float* o) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};
template <> struct VecLoad<bf16, 2> {
  __device__ __forceinline__ static void load(const bf16* p, float* o) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  }
};
template <> struct VecLoad<bf16, 1> {
  __device__ __forceinline__ static void load(const bf16* p, float* o) {
    o[0] = __bfloat162float(*p);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// steps t0 .. t0 + n - 1 of one (B, T, H, D) tensor's (b, h) rows into
// ``dst`` (n rows of D) by the 32 lanes of one warp: 16 bytes a copy when
// ``vec`` (lane l copies chunk l % CH of every (32 / CH)-th row), else
// element by element
template <typename E, int D>
__device__ __forceinline__ void stage_rows(E* dst, const E* src,
                                           long long st, int t0, int n,
                                           bool vec, int lane) {
  if (vec) {
    constexpr int CH = D * (int)sizeof(E) / 16;   // 16-byte chunks a row
    static_assert(CH <= 32, "a row is at most one copy a lane");
    constexpr int RPI = 32 / CH;                  // rows an iteration
    for (int u = lane % CH, tt = lane < RPI * CH ? lane / CH : n; tt < n;
         tt += RPI)
      cp_async16(reinterpret_cast<char*>(dst + tt * D) + 16 * u,
                 reinterpret_cast<const char*>(src + (t0 + tt) * st) +
                     16 * u);
  } else {
    for (int c = lane; c < n * D; c += 32) {
      const int tt = c / D, i = c - tt * D;
      dst[tt * D + i] = src[(t0 + tt) * st + i];
    }
  }
}

// c_t = sum_i r_i u_i k_i of one step whose r, k and u rows start at rt,
// kt and ut: the 8 lanes of a warp's group of 8 (lane / 8) take D / 8
// consecutive rows each, two partial sums, then 3 shuffles; the same
// arithmetic whether the rows lie in shared memory (the producer's tiles)
// or in global memory (a short call's, read W = 1 element a load)
template <typename T, int D, int W>
__device__ __forceinline__ float c_of(const T* rt, const T* kt,
                                      const float* ut, bool live, int lane) {
  constexpr int CR = D / 8;                      // rows a lane, W a load
  const int i0 = lane % 8 * CR;
  float c[2] = {0.f, 0.f};
  if (live) {
#pragma unroll
    for (int m = 0; m < CR; m += W) {
      float rr[W], kk[W], uu[W];
      VecLoad<T, W>::load(rt + i0 + m, rr);
      VecLoad<T, W>::load(kt + i0 + m, kk);
      VecLoad<float, W>::load(ut + i0 + m, uu);
#pragma unroll
      for (int e = 0; e < W; ++e)
        c[(m + e) & 1] = fmaf(rr[e] * uu[e], kk[e], c[(m + e) & 1]);
    }
  }
  float cc = c[0] + c[1];
  cc += __shfl_xor_sync(0xffffffffu, cc, 4);
  cc += __shfl_xor_sync(0xffffffffu, cc, 2);
  cc += __shfl_xor_sync(0xffffffffu, cc, 1);
  return cc;
}

// named barriers between the producer warp and the stepping warps, one of
// each per buffer: the next use of an id waits for the other side's last
// (a producer arrival for tile n + 2 follows its sync on tile n's buffer)
__device__ __forceinline__ int bar_full(int buf) { return 1 + buf; }
__device__ __forceinline__ int bar_c(int buf) { return 3 + buf; }
__device__ __forceinline__ int bar_free(int buf) { return 5 + buf; }
constexpr int BAR_SHORT = 7;    // a short call's c_t are written

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// one step's rows of this lane: r, k, w at its R rows, and v_j
template <int R>
struct Row {
  float r[R], k[R], w[R], vj;
};

// v[i] (i < Q) are a lane's partial sums of Q steps; the Q lanes of a
// column exchange halves Q - 1 times (Q/2 + Q/4 + ... + 1 shuffles), after
// which lane q holds the total of step q
template <int OFF, int Q>
__device__ __forceinline__ void reduce_half(float (&v)[Q], int q) {
  if constexpr (OFF >= 1) {
    const bool up = (q & OFF) != 0;
#pragma unroll
    for (int i = 0; i < OFF; ++i) {
      const float send = up ? v[i] : v[i + OFF];
      const float keep = up ? v[i + OFF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    reduce_half<OFF / 2, Q>(v, q);
  }
}

template <typename T, int D, int Q, bool CK>
__global__ void __launch_bounds__(MAX_THREADS + 32)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* s0, float* s_out,
           T* __restrict__ y, int H, int Tlen, int JC, Strides sr,
           Strides sk, Strides sv, Strides sw, bool vec,
           float* __restrict__ ck, int c_shift) {
  constexpr int R = D / Q;                       // rows a lane keeps
  constexpr int V = row_block(D);                // rows a block
  constexpr int A = R / V;                       // blocks a lane
  constexpr int P = parts(D);                    // partials of y_j
  constexpr int L = P / Q;                       // partials a lane
  // steps a tile (20 KB of r/k/v/w a buffer), whole groups of Q where
  // that holds one
  constexpr int TS = (sizeof(T) == 2 ? 2048 : 1024) / D;
  constexpr int TT = TS >= Q ? TS / Q * Q : TS;
  static_assert(D % Q == 0 && R % V == 0 && P % Q == 0 && A % L == 0 &&
                Q <= 32 && TT >= 1, "plan");
  __shared__ __align__(16) T rs[2][TT * D];
  __shared__ __align__(16) T ks[2][TT * D];
  __shared__ __align__(16) T vs[2][TT * D];
  __shared__ __align__(16) float ws[2][TT * D];
  __shared__ float cs[2][TT];
  __shared__ __align__(16) float us[D];

  const int tid = threadIdx.x;
  const int nc = JC * Q;                         // stepping threads
  const int groups = D / JC;
  const int bh = blockIdx.x / groups;
  const int j0 = (blockIdx.x - bh * groups) * JC;
  const int b = bh / H, h = bh - b * H;
  const int jl = tid / Q, q = tid - jl * Q;
  const int j = j0 + jl;
  const int n_tiles = (Tlen + TT - 1) / TT;

  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h;
  T* yb = y + ((size_t)b * Tlen * H + h) * D;
  const size_t s_off = (size_t)bh * D * D + j;

  const int nb = nc + 32;                        // barrier participants
  if (tid >= nc) {
    // the producer warp: copies tile n + 1 and computes its c_t while the
    // other warps step through tile n
    if (Tlen <= SHORT_T) return;
    const int lane = tid - nc;
    for (int i = lane; i < D; i += 32) us[i] = u[(size_t)h * D + i];
    for (int n = 0; n < n_tiles; ++n) {
      const int buf = n & 1, t0 = n * TT;
      const int cnt = min(TT, Tlen - t0);
      if (n >= 2) bar_sync(bar_free(buf), nb);  // tile n - 2 is consumed
      stage_rows<T, D>(rs[buf], rb, sr.t, t0, cnt, vec, lane);
      stage_rows<T, D>(ks[buf], kb, sk.t, t0, cnt, vec, lane);
      stage_rows<T, D>(vs[buf], vb, sv.t, t0, cnt, vec, lane);
      stage_rows<float, D>(ws[buf], wb, sw.t, t0, cnt, vec, lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
      bar_arrive(bar_full(buf), nb);
      for (int base = 0; base < cnt; base += 4) {
        const int tt = base + lane / 8;
        const float c = c_of<T, D, (D / 8) % 4 == 0 ? 4 : 2>(
            rs[buf] + tt * D, ks[buf] + tt * D, us, tt < cnt, lane);
        if (tt < cnt && lane % 8 == 0) cs[buf][tt] = c;
      }
      bar_arrive(bar_c(buf), nb);
    }
    // the last two tiles' buffers: every arrival is matched
    for (int n = max(n_tiles, 2); n < n_tiles + 2; ++n)
      bar_sync(bar_free(n & 1), nb);
    return;
  }

  // this lane's entries of S[:, j] straight into registers (independent
  // loads, in flight while tile 0 lands)
  float S[R];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int e = 0; e < V; ++e)
      S[a * V + e] =
          s0 ? s0[s_off + (size_t)(a * V * Q + V * q + e) * D] : 0.f;

  // the training form: this lane's entries of S_t into checkpoint t / C
  // when t is a multiple of C (the state before step t)
  const int n_ck = CK ? (Tlen + (1 << c_shift) - 1) >> c_shift : 0;
  auto checkpoint = [&](int t) {
    if constexpr (CK) {
      if ((t & ((1 << c_shift) - 1)) == 0) {
        float* dst = ck + ((size_t)bh * n_ck + (t >> c_shift)) * D * D + j;
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int e = 0; e < V; ++e)
            dst[(size_t)(a * V * Q + V * q + e) * D] = S[a * V + e];
      }
    }
  };

  // this lane's rows of step tt of the tile in ``buf``
  auto load = [&](int buf, int tt) {
    Row<R> x;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int i0 = tt * D + a * V * Q + V * q;
      VecLoad<T, V>::load(rs[buf] + i0, x.r + a * V);
      VecLoad<T, V>::load(ks[buf] + i0, x.k + a * V);
      VecLoad<float, V>::load(ws[buf] + i0, x.w + a * V);
    }
    x.vj = to_f(vs[buf][tt * D + j]);
    return x;
  };
  // one step: this lane's share of sum_i r_i S_ij, returned, and the
  // update of its entries.  Block a of the lane is in local partial a mod
  // L (global partial (a mod L) * Q + q), one FMA chain each; the partials
  // then meet in the butterfly's levels P/2 .. Q
  auto step = [&](const Row<R>& x) {
    float ya[L];
#pragma unroll
    for (int a = 0; a < L; ++a) ya[a] = 0.f;
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = a * V + e;
        ya[a % L] = fmaf(x.r[i], S[i], ya[a % L]);
        S[i] = fmaf(x.w[i], S[i], x.k[i] * x.vj);
      }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
      for (int a = 0; a < o; ++a) ya[a] += ya[a + o];
    return ya[0];
  };

  if (Tlen <= SHORT_T) {
    // a short call (a decode step): the stepping warps read their rows
    // straight from memory (V elements a load where the launch is
    // aligned: with Q = 4 a lane's 16 rows take 12 loads, not 48; on an
    // H100 80GB HBM3 scalar loads made rwkv6-3b's decode step 0.0055 ms
    // against 0.0045), warp 0 computes each step's c_t as the producer
    // would, and no tile is staged
    auto load_global = [&](int tt) {
      Row<R> x;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int i = a * V * Q + V * q;
        if (vec) {
          VecLoad<T, V>::load(rb + tt * sr.t + i, x.r + a * V);
          VecLoad<T, V>::load(kb + tt * sk.t + i, x.k + a * V);
          VecLoad<float, V>::load(wb + tt * sw.t + i, x.w + a * V);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            x.r[a * V + e] = to_f(rb[tt * sr.t + i + e]);
            x.k[a * V + e] = to_f(kb[tt * sk.t + i + e]);
            x.w[a * V + e] = wb[tt * sw.t + i + e];
          }
        }
      }
      x.vj = to_f(vb[tt * sv.t + j]);
      return x;
    };
    Row<R> x;
    if (Tlen > 0) x = load_global(0);   // in flight beside S's loads
    if (tid < 32) {
      const int tt = tid / 8;
      const float c = c_of<T, D, 1>(rb + tt * sr.t, kb + tt * sk.t,
                                    u + (size_t)h * D, tt < Tlen, tid);
      if (tt < Tlen && tid % 8 == 0) cs[0][tt] = c;
    }
    for (int tt = 0; tt < Tlen; ++tt) {
      if (tt > 0) x = load_global(tt);
      checkpoint(tt);
      float yp = step(x);
#pragma unroll
      for (int o = Q / 2; o > 0; o >>= 1)
        yp += __shfl_xor_sync(0xffffffffu, yp, o);
      if (tt == 0) bar_sync(BAR_SHORT, nc);   // only y waits for c_t
      if (q == 0)
        yb[(size_t)tt * H * D + j] = from_f<T>(fmaf(x.vj, cs[0][tt], yp));
    }
  } else {
    for (int n = 0; n < n_tiles; ++n) {
      const int buf = n & 1, t0 = n * TT;
      const int cnt = min(TT, Tlen - t0);
      bar_sync(bar_full(buf), nb);       // tile n has landed
      bool c_ready = false;
      int tt0 = 0;
      for (; tt0 + Q <= cnt; tt0 += Q) {  // whole groups of Q steps
        float yp[Q];
        Row<R> x = load(buf, tt0);
#pragma unroll
        for (int uu = 0; uu < Q; ++uu) {  // step uu + 1's rows load while
          Row<R> nx;                     // step uu computes
          if (uu + 1 < Q) nx = load(buf, tt0 + uu + 1);
          checkpoint(t0 + tt0 + uu);
          yp[uu] = step(x);
          if (uu + 1 < Q) x = nx;
        }
        if (!c_ready) {
          bar_sync(bar_c(buf), nb);
          c_ready = true;
        }
        reduce_half<Q / 2, Q>(yp, q);
        const int tt = tt0 + q;
        yb[(size_t)(t0 + tt) * H * D + j] =
            from_f<T>(fmaf(to_f(vs[buf][tt * D + j]), cs[buf][tt], yp[0]));
      }
      for (int tt = tt0; tt < cnt; ++tt) {  // the rest, one at a time
        const Row<R> x = load(buf, tt);
        checkpoint(t0 + tt);
        float yp = step(x);
#pragma unroll
        for (int o = Q / 2; o > 0; o >>= 1)
          yp += __shfl_xor_sync(0xffffffffu, yp, o);
        if (!c_ready) {
          bar_sync(bar_c(buf), nb);
          c_ready = true;
        }
        if (q == 0)
          yb[(size_t)(t0 + tt) * H * D + j] =
              from_f<T>(fmaf(x.vj, cs[buf][tt], yp));
      }
      bar_arrive(bar_free(buf), nb);     // done with buf
    }
  }

#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int e = 0; e < V; ++e)
      s_out[s_off + (size_t)(a * V * Q + V * q + e) * D] = S[a * V + e];
}

// the instantiated (D, Q) pairs: the plan's Q (wkv_plan's _LANES: 4 at
// D = 64, D / 8 or the nearest power of two elsewhere), and D = 64 also
// at Q = 2, 8 and 16 for the plan's sweep.  Every pair of one D gives the
// same bits.  The training form takes the plan's Q only
template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const float*,
                        const float*, const float*, float*, T*, int, int, int,
                        Strides, Strides, Strides, Strides, bool, float*,
                        int);

template <typename T, bool CK>
Kernel<T> kernel_of(int D, int Q) {
  switch (D * 64 + Q) {
    case 16 * 64 + 2: return wkv_kernel<T, 16, 2, CK>;
    case 32 * 64 + 4: return wkv_kernel<T, 32, 4, CK>;
    case 48 * 64 + 4: return wkv_kernel<T, 48, 4, CK>;
    case 64 * 64 + 4: return wkv_kernel<T, 64, 4, CK>;
    case 80 * 64 + 8: return wkv_kernel<T, 80, 8, CK>;
    case 96 * 64 + 8: return wkv_kernel<T, 96, 8, CK>;
    case 112 * 64 + 8: return wkv_kernel<T, 112, 8, CK>;
    case 128 * 64 + 8: return wkv_kernel<T, 128, 8, CK>;
  }
  if (CK) return nullptr;             // the sweep's pairs serve only
  switch (D * 64 + Q) {
    case 64 * 64 + 2: return wkv_kernel<T, 64, 2, false>;
    case 64 * 64 + 8: return wkv_kernel<T, 64, 8, false>;
    case 64 * 64 + 16: return wkv_kernel<T, 64, 16, false>;
  }
  return nullptr;
}

bool aligned(const void* p, const Strides& s, int el) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b * el % 16 == 0 &&
         s.t * el % 16 == 0 && s.h * el % 16 == 0;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* s_out, void* y, int B,
           int Tlen, int H, int D, int JC, int Q, const Strides* st,
           float* ck, int C, cudaStream_t stream) {
  const Kernel<T> fn = ck != nullptr ? kernel_of<T, true>(D, Q)
                                      : kernel_of<T, false>(D, Q);
  int c_shift = 0;
  while ((1 << c_shift) < C) ++c_shift;
  if (fn == nullptr || JC < 1 || D % JC != 0 || JC * Q % 32 != 0 ||
      JC * Q > MAX_THREADS || (ck != nullptr && (C < 1 || C != 1 << c_shift)))
    return (int)cudaErrorInvalidValue;
  const int el = (int)sizeof(T);
  const bool vec = aligned(r, st[0], el) && aligned(k, st[1], el) &&
                   aligned(v, st[2], el) && aligned(w, st[3], 4);
  const long long grid = (long long)B * H * (D / JC);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fn<<<(unsigned)grid, JC * Q + 32, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, s_out, static_cast<T*>(y), H, Tlen,
      JC, st[0], st[1], st[2], st[3], vec, ck, c_shift);
  return (int)cudaGetLastError();
}

}  // namespace

// r/k/v (B, T, H, D) in dtype (f32 or bf16) and w (B, T, H, D) f32, each
// with D contiguous; u (H, D) f32; s0 (B, H, D, D) f32 or nullptr for a
// zero state; s_out (B, H, D, D) f32, may equal s0; y (B, T, H, D)
// contiguous in dtype; ck nullptr (the serve form) or the training form's
// checkpoints (B, H, ceil(T / C), D, D) f32.  p holds B, T, H, D, jc, q,
// dtype (DT_F32 or DT_BF16), then the element strides of the B, T and H
// axes of r, k, v and w, then C (the checkpoints' interval, a power of
// two; read only with ck); (jc, q): columns a CTA and lanes a column
// (wkv_plan).  Returns the cudaError_t of the launch (0 = launched).
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const float* s0,
                         float* s_out, void* y, float* ck,
                         const long long* p, void* stream) {
  const int B = (int)p[0], T = (int)p[1], H = (int)p[2], D = (int)p[3];
  const int jc = (int)p[4], q = (int)p[5], dtype = (int)p[6];
  if (B == 0 || H == 0) return 0;
  if (B < 0 || H < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const Strides st[4] = {{p[7], p[8], p[9]}, {p[10], p[11], p[12]},
                         {p[13], p[14], p[15]}, {p[16], p[17], p[18]}};
  const int C = (int)p[19];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(r, k, v, w, u, s0, s_out, y, B, T, H, D, jc, q, st,
                         ck, C, s);
  if (dtype == DT_BF16)
    return launch<bf16>(r, k, v, w, u, s0, s_out, y, B, T, H, D, jc, q, st,
                        ck, C, s);
  return (int)cudaErrorInvalidValue;
}
