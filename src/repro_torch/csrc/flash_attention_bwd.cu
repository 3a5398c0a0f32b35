// GQA flash attention, backward (kernel 1's gradient) for Hopper (sm_90a),
// FlashAttention-2 style: dq, dk and dv of the forward in flash_attention.cu
// from q, k, v, o, dO and the forward's per-row log-sum-exp, in every form
// the forward takes (causal or bidirectional, with or without a window W:
// query q sees key k iff k > q - W, and k <= q when causal), at head dims
// 16, 32, 64, 80, 96, 128 and 256, in f32 and bf16.
//
// Replaces no TPU kernel: the reference's Pallas flash_attention
// (src/repro/kernels/flash_attention.py:79) is forward-only and the
// reference trains through XLA autodiff of causal_attention
// (src/repro/models/attention.py:182).  The port's training forward runs
// kernel 1, so its gradient is a kernel too.
//
// What bounds it on the H100.  The least work is 10 D flops per (query,
// key) pair seen (S = Q K^T once, dP = dO V^T, dV += P^T dO, dK += dS^T
// Q, dQ += dS K: 2.5 times the forward's 4 D) against 4 (H + K) S D
// elements moved per batch (q, o, dO and dq per query head; k, v, dk and
// dv per KV head) and the f32 lse.  In bf16 that is 2.5 D / 8 flops a byte
// per key a query sees: the bytes bound it at llama2-7b's S = 512, the
// operations from S ~ 1000 on, both at the tensor cores' rate.  So bf16
// runs on the tensor cores; f32 cannot (they would be TF32, which the f32
// plans' 1e-5 parity cannot take, the forward's rule) and keeps the
// CUDA-core kernels.  The route is chosen by dtype alone; nothing falls
// back from one to the other.
//
// Three launches on one stream, no atomics (two calls give the same bits):
//   pass 0  delta = rowsum(dO * O) in f32, one warp per query row, into a
//           scratch that passes 1 and 2 read (bwd_delta);
//   pass 1  dK and dV, one CTA per (key tile, KV head, batch);
//   pass 2  dQ, one CTA per (query tile, head, batch).
// Pass 2 recomputes S and dP: 14 D flops a pair in all, 1.4 times the
// least, the price of writing no partial dQ and taking no atomics.
//
// bf16: wgmma tiles fed by TMA (bwd_dkdv_wgmma, bwd_dq_wgmma; helpers in
// hopper.cuh).  Operands lie in shared memory as the forward's do: D / E
// swizzled panels of 64 rows x E elements, one TMA box each, through
// tensor maps of every operand's own strides (dO's too).  A CTA owns 64
// rows and, up to D = 128, is one warpgroup of 128 threads (wgmma's M = 64
// rows), so 2-4 CTAs share an SM and one's softmax overlaps another's
// products: two warpgroups of one CTA, 128 rows, waited for each other at
// every tile (0.207 against 0.145 ms at llama2-7b's shape on an H100 80GB
// HBM3 at 700 W, scripts/bwd_probe.py).
//   pass 1  K and V of the CTA's 64 keys come once by TMA.  The CTA walks
//           the group's H / K query heads in head order and, for each, the
//           64-row query tiles that see its keys (from the diagonal when
//           causal, up to the window's reach); a tile's Q, dO and its 64
//           lse log2(e) and delta (one bulk copy from pass 0's scratch)
//           come through a ring of 2 TMA stages, thread 0 refilling a
//           stage once the CTA has left it.  Per query tile:
//             S^T = K Q^T   wgmma m64n64k16, A = the K tile, B = the Q
//                           tile, both K-major as they lie (the forward's
//                           descriptors with the roles swapped);
//             dP^T = V dO^T the same with V and the dO tile;
//             P^T = exp2(S^T scale log2(e) - lse log2(e)) in f32 on the
//                           accumulator fragment, a masked pair exactly 0;
//             dS^T = P^T (dP^T - delta), delta per query column;
//             dV += P^T dO  wgmma m64nNk16 with A = P^T from registers (the
//                           accumulator fragment of S^T is the A fragment,
//                           packed to bf16 pairs) and B = the dO tile with
//                           the transpose bit (queries x D: MN-major), N
//                           in pieces of at most 64 (pv in hopper.cuh);
//             dK += dS^T Q  the same with dS^T packed to bf16 and the Q
//                           tile.
//           dK is scaled once at the end; the group's heads are summed in
//           the accumulators, in head order, and written once as bf16.
//   pass 2  The CTA's 64 query rows: their Q and dO by one TMA load; K and
//           V tiles of 64 keys through a 2-stage ring over the forward's
//           key range.  Per key tile: S = Q K^T and dP = dO V^T (wgmma
//           m64n64k16), P from the row's lse, dS = P (dP - delta) packed
//           to bf16, dQ += dS K with the K tile MN-major; dQ scaled once
//           and written as bf16.
// Registers decide D = 256: the dK and dV accumulators are 64 x D f32 each,
// D registers a thread, and with S^T's and dP^T's 32 each they fit 255 up
// to D = 128 and not at 256.  There two warpgroups take the CTA's 64 rows
// and half of the accumulators' columns each; each computes S and dP in
// full, so a pair costs 22 D flops (12 D in pass 1, 10 D in pass 2) where
// it costs 14 D below, and the CTA (198 KB of shared memory) has its SM.
// Masks and skips.  A CTA skips a tile in which none of its pairs is seen
// and masks per element only a tile that straddles a bound (of the mask,
// or of S: keys and queries past S arrive as zeros from TMA and are
// masked, never weighed).  Under causal attention pass 1's key tile 0 sees
// every query and pass 2's last query tile every key: the grid's slowest
// dimension walks tiles in that order, so the heavy CTAs start first.
// All waits on a tile's barriers come before its first wgmma fence: a
// wgmma issued after a wait's loop without a fence of its own made ptxas
// serialise every wgmma of the kernel (its C7520 note).
// Rounding.  P for dV is rounded to bf16 as the forward's plain version
// rounds the P of PV, and dS to bf16 before dK and dQ (the products take
// bf16 operands); the plain version (flash_attention_bwd_ref) rounds both
// where the kernel does.  Every sum is accumulated in f32.
//
// f32: the CUDA-core kernels (bwd_dkdv, bwd_dq), the first design of this
// backward.  Pass 1 gives each key row to TPR threads holding 4-float
// chunks of its k, v, dk and dv in registers (DPT = D / TPR <= 32 dims),
// staging Q, dO, lse and delta of a query tile in shared memory; per query
// row s = q.k and dp = dO.v are partial dots summed over the row's TPR
// lanes by shuffles.  Pass 2 is the forward f32 kernel's shape with dq in
// registers and K and V tiles in shared memory.  D = 256 takes 8 threads a
// row and 16-row staged tiles, D <= 128 4 threads and 32-row (D > 64) or
// 64-row tiles: at most 32 KB of static shared memory.
//
// ptxas -v for sm_90a (CUDA 12.8), D = 16 / 32 / 64 / 80 / 96 / 128 / 256,
// no spill, no serialised wgmma:
//   bf16 pass 1 (bwd_dkdv_wgmma) 122 / 139 / 161 / 183 / 193 / 226 / 226
//   registers, pass 2 (bwd_dq_wgmma) 110 / 110 / 124 / 130 / 140 / 156 /
//   156; dynamic shared memory (Plan<D>) 14,336 / 26,624 / 51,200 /
//   63,488 / 75,776 / 100,352 / 198,656 and 13,312 / 25,600 / 50,176 /
//   62,464 / 74,752 / 99,328 / 197,632 bytes (static_assert: <= 232,448);
//   CTAs an SM, by registers and shared memory, 4 / 3 / 3 / 2 / 2 / 2 / 1
//   and 4 / 4 / 4 / 3 / 3 / 2 / 1;
//   f32 pass 1 48 / 64 / 124 / 159 / 188 / 232 / 231 registers, pass 2 40 /
//   48 / 80 / 121 / 124 / 157 / 157.
#include <cuda.h>

#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int TR = 64;                // rows of a streamed tile (= BK)

struct Args {                         // one launch's shape and flags
  int B, H, K, S, window;
  bool causal;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
};

template <int D>
struct Bwd {
  static constexpr int TPR = D / 32 > 4 ? D / 32 : 4;  // threads per row
  static constexpr int DPT = D / TPR;                  // dims per thread
  static constexpr int NCH = DPT / 4;                  // 4-float chunks
  static constexpr int ROWS = THREADS / TPR;           // rows per CTA
  static constexpr int TILE = D <= 64 ? 64 : D <= 128 ? 32 : 16;  // staged
  static_assert(DPT % 4 == 0 && TPR * DPT == D, "chunks must tile D");
};

// 4 consecutive elements, as floats
template <typename T> struct Quad;

template <> struct Quad<float> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

// the first dim of chunk j of lane c of a row
template <int D>
__device__ __forceinline__ int chunk_dim(int c, int j) {
  return 4 * (c + Bwd<D>::TPR * j);
}

// sum over the TPR lanes of a row (consecutive lanes of one warp)
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [r0, r0 + ROWS) of a (.., S, D) operand into a float tile in shared
// memory, by 16-byte loads; rows past S are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(float (*dst)[D], const T* base,
                                      long long stride, int r0, int S,
                                      int tid) {
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = D / VEC;
  for (int i = tid; i < ROWS * VPR; i += THREADS) {
    const int t = i / VPR;
    const int cc = (i - t * VPR) * VEC;
    float x[VEC];
    if (r0 + t < S) {
      Vec<T>::load(base + (long long)(r0 + t) * stride + cc, x);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(&dst[t][cc + j]) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
  }
}

// does query qp see key kp (both below S)
__device__ __forceinline__ bool sees(int qp, int kp, bool causal,
                                     int window) {
  return (!causal || kp <= qp) && (window == 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// pass 0: delta = rowsum(dO * O), one warp per query row
// ---------------------------------------------------------------------------

// Without lse (the f32 route) delta is written (B, H, S).  With lse (the
// bf16 route) each 64-row tile of a (batch, head) is written as 64 lse
// log2(e) then 64 delta, (B, H, ceil(S / 64), 2, 64), rows past S as 0:
// one 512-byte copy per query tile for pass 1, in the log2 units its
// exponentials take.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta, int H,
          int S, int D, Strides os, Strides dos) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int NT = (S + TR - 1) / TR;
  if (row >= (lse == nullptr ? S : NT * TR)) return;  // whole warps
  float acc = 0.f;
  if (row < S) {
    const T* op = o + b * os.b + h * os.h + (long long)row * os.s;
    const T* dp = dout + b * dos.b + h * dos.h + (long long)row * dos.s;
    for (int d = lane; d < D; d += 32) acc += to_f(op[d]) * to_f(dp[d]);
    acc = warp_sum(acc);
  }
  if (lane != 0) return;
  const long long bh = (long long)b * H + h;
  if (lse == nullptr) {
    delta[bh * S + row] = acc;
  } else {
    float* t = delta + (bh * NT + row / TR) * 2 * TR + row % TR;
    t[0] = row < S ? lse[bh * S + row] * LOG2E : 0.f;
    t[TR] = acc;
  }
}

// ---------------------------------------------------------------------------
// f32 pass 1: dK, dV per (key tile, KV head, batch), CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, Args a) {
  using C = Bwd<D>;
  constexpr int TPR = C::TPR, NCH = C::NCH, ROWS = C::ROWS, TQ = C::TILE;
  __shared__ __align__(16) float qsm[TQ][D];
  __shared__ __align__(16) float dosm[TQ][D];
  __shared__ float lsm[TQ], dlsm[TQ];

  const int k0 = blockIdx.x * ROWS;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c = tid % TPR;
  const int kpos = k0 + tid / TPR;
  const bool valid = kpos < a.S;
  const int S = a.S, window = a.window;
  const bool causal = a.causal;

  float kr[NCH][4], vr[NCH][4], dka[NCH][4], dva[NCH][4];
  {
    const T* kp = k + b * a.ks.b + kh * a.ks.h + (long long)kpos * a.ks.s;
    const T* vp = v + b * a.vs.b + kh * a.vs.h + (long long)kpos * a.vs.s;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (valid) {
        Quad<T>::load(kp + chunk_dim<D>(c, j), kr[j]);
        Quad<T>::load(vp + chunk_dim<D>(c, j), vr[j]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!valid) kr[j][e] = vr[j][e] = 0.f;
        dka[j][e] = dva[j][e] = 0.f;
      }
    }
  }

  // the query rows that see a key of this tile: from the first key on
  // when causal; below the last key + W with a window
  const int k_last = min(S, k0 + ROWS) - 1;
  const int q_begin = causal ? k0 / TQ * TQ : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const int G = a.H / a.K;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + b * a.qs.b + h * a.qs.h;
    const T* db = dout + b * a.dos.b + h * a.dos.h;
    const float* lb = lse + ((long long)b * a.H + h) * S;
    const float* deb = delta + ((long long)b * a.H + h) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += TQ) {
      __syncthreads();                // the previous tile's readers are done
      stage<T, D, TQ>(qsm, qb, a.qs.s, q0, S, tid);
      stage<T, D, TQ>(dosm, db, a.dos.s, q0, S, tid);
      for (int i = tid; i < TQ; i += THREADS) {
        lsm[i] = q0 + i < S ? lb[q0 + i] : 0.f;
        dlsm[i] = q0 + i < S ? deb[q0 + i] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < TQ; ++i) {
        const int qp = q0 + i;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const float4 qq =
              *reinterpret_cast<const float4*>(&qsm[i][chunk_dim<D>(c, j)]);
          const float4 dd =
              *reinterpret_cast<const float4*>(&dosm[i][chunk_dim<D>(c, j)]);
          s += qq.x * kr[j][0] + qq.y * kr[j][1] + qq.z * kr[j][2] +
               qq.w * kr[j][3];
          dp += dd.x * vr[j][0] + dd.y * vr[j][1] + dd.z * vr[j][2] +
                dd.w * vr[j][3];
        }
        s = row_sum<TPR>(s);
        dp = row_sum<TPR>(dp);
        const bool seen = valid && qp < S && sees(qp, kpos, causal, window);
        const float p = seen ? expf(s * a.scale - lsm[i]) : 0.f;
        const float ds = p * (dp - dlsm[i]);
        const float pr = round_to<T>(p);
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const float4 qq =
              *reinterpret_cast<const float4*>(&qsm[i][chunk_dim<D>(c, j)]);
          const float4 dd =
              *reinterpret_cast<const float4*>(&dosm[i][chunk_dim<D>(c, j)]);
          dva[j][0] += pr * dd.x; dva[j][1] += pr * dd.y;
          dva[j][2] += pr * dd.z; dva[j][3] += pr * dd.w;
          dka[j][0] += ds * qq.x; dka[j][1] += ds * qq.y;
          dka[j][2] += ds * qq.z; dka[j][3] += ds * qq.w;
        }
      }
    }
  }

  if (valid) {
    T* dkp = dk + b * a.dks.b + kh * a.dks.h + (long long)kpos * a.dks.s;
    T* dvp = dv + b * a.dvs.b + kh * a.dvs.h + (long long)kpos * a.dvs.s;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][e] *= a.scale;
      Quad<T>::store(dkp + chunk_dim<D>(c, j), dka[j]);
      Quad<T>::store(dvp + chunk_dim<D>(c, j), dva[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 pass 2: dQ per (query tile, head, batch), CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, Args a) {
  using C = Bwd<D>;
  constexpr int TPR = C::TPR, NCH = C::NCH, ROWS = C::ROWS, TK = C::TILE;
  __shared__ __align__(16) float ksm[TK][D];
  __shared__ __align__(16) float vsm[TK][D];

  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = (int)((long long)h * a.K / a.H);
  const int tid = threadIdx.x;
  const int c = tid % TPR;
  const int qpos = q0 + tid / TPR;
  const bool valid = qpos < a.S;
  const int S = a.S, window = a.window;
  const bool causal = a.causal;

  float qr[NCH][4], dor[NCH][4], dqa[NCH][4];
  {
    const T* qp = q + b * a.qs.b + h * a.qs.h + (long long)qpos * a.qs.s;
    const T* dp = dout + b * a.dos.b + h * a.dos.h + (long long)qpos * a.dos.s;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (valid) {
        Quad<T>::load(qp + chunk_dim<D>(c, j), qr[j]);
        Quad<T>::load(dp + chunk_dim<D>(c, j), dor[j]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!valid) qr[j][e] = dor[j][e] = 0.f;
        dqa[j][e] = 0.f;
      }
    }
  }
  const long long row = ((long long)b * a.H + h) * S + qpos;
  const float lq = valid ? lse[row] : 0.f;
  const float dl = valid ? delta[row] : 0.f;

  const T* kb = k + b * a.ks.b + kh * a.ks.h;
  const T* vb = v + b * a.vs.b + kh * a.vs.h;
  // causal: later keys are above the diagonal; with a window, earlier keys
  // are outside every row's window
  const int k_end = causal ? min(S, q0 + ROWS) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / TK * TK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    __syncthreads();
    stage<T, D, TK>(ksm, kb, a.ks.s, k0, S, tid);
    stage<T, D, TK>(vsm, vb, a.vs.s, k0, S, tid);
    __syncthreads();
    for (int t = 0; t < TK; ++t) {
      const int kp = k0 + t;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ksm[t][chunk_dim<D>(c, j)]);
        const float4 vv =
            *reinterpret_cast<const float4*>(&vsm[t][chunk_dim<D>(c, j)]);
        s += qr[j][0] * kk.x + qr[j][1] * kk.y + qr[j][2] * kk.z +
             qr[j][3] * kk.w;
        dp += dor[j][0] * vv.x + dor[j][1] * vv.y + dor[j][2] * vv.z +
              dor[j][3] * vv.w;
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const bool seen = valid && kp < S && sees(qpos, kp, causal, window);
      const float p = seen ? expf(s * a.scale - lq) : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ksm[t][chunk_dim<D>(c, j)]);
        dqa[j][0] += ds * kk.x; dqa[j][1] += ds * kk.y;
        dqa[j][2] += ds * kk.z; dqa[j][3] += ds * kk.w;
      }
    }
  }

  if (valid) {
    T* dqp = dq + b * a.dqs.b + h * a.dqs.h + (long long)qpos * a.dqs.s;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[j][e] *= a.scale;
      Quad<T>::store(dqp + chunk_dim<D>(c, j), dqa[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int NSTB = 2;               // stages of each pass's ring

// A CTA owns 64 rows (keys in pass 1, queries in pass 2).  Up to D = 128
// one warpgroup holds their accumulators; at D = 256 two warpgroups take
// the same rows and half of the accumulators' columns each.
template <int D>
struct Plan {
  using T = Tiles<D>;
  static constexpr int WGS = D > 128 ? 2 : 1;  // warpgroups a CTA
  static constexpr int NTHREADS = 128 * WGS;
  static constexpr int DW = D / WGS;            // columns a warpgroup sums
  static constexpr int TILE_BYTES = TR * D * 2;
  static constexpr int LD_BYTES = 2 * TR * 4;   // lse log2(e), delta
  static constexpr int SMEM_DKDV =
      2 * TILE_BYTES + NSTB * (2 * TILE_BYTES + LD_BYTES) + 1024;
  static constexpr int SMEM_DQ = 2 * TILE_BYTES + NSTB * 2 * TILE_BYTES + 1024;
  static_assert(Tiles<DW>::E == T::E, "a column half keeps D's panels");
  static_assert(SMEM_DKDV <= 232448 && SMEM_DQ <= 232448,
                "a CTA's shared memory");
};

// ``bytes`` (a multiple of 16) from global to shared memory in one bulk
// copy that completes on ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// one 64 x 64 f32 tile (of S or dP) of a warpgroup: A and B the 64-row
// tiles at ``sa`` and ``sb``, both K-major
template <int D>
__device__ __forceinline__ void scores(float* acc, uint32_t sa, uint32_t sb) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / T::E;     // the panel, and 32 bytes a k16 step
    const uint32_t off = kk * 16 % T::E * 2;
    wgmma_ss_n64(acc,
                 desc(sa + p * TR * T::SW + off, 16, 8 * T::SW, T::MODE),
                 desc(sb + p * TR * T::SW + off, 16, 8 * T::SW, T::MODE),
                 kk > 0);
  }
}

// acc[:, c] += A B[:, c] over the columns c of a warpgroup's accumulator:
// A 64 x 64 from registers (4 k16 steps of bf16 pairs), B the 64-row tile
// at ``sb`` with the transpose bit, from the panel of its first column
template <int DW>
__device__ __forceinline__ void product(float* acc, const uint32_t* a,
                                        uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < TR / 16; ++kk)
    pv<DW, 0>(acc, a + 4 * kk, sb + kk * 16 * Tiles<DW>::SW);
}

// this thread's rows r, r + 8 of an accumulator of DW columns from c into
// a bf16 (.., S, D) row-major operand at ``base`` (rows below S only)
template <int DW>
__device__ __forceinline__ void store_rows(bf16* base, long long stride,
                                           int r, int c, int S,
                                           const float* acc, float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r + 8 * i >= S) continue;
    bf16* p = base + (long long)(r + 8 * i) * stride + c;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(Plan<D>::NTHREADS, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap,
               const float* __restrict__ ld, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Strides dks, Strides dvs, int H, int K,
               int S, int window, bool causal, float scale,
               float scale_log2) {
  using P = Plan<D>;
  constexpr int E = P::T::E, SW = P::T::SW, NB = P::T::NB, DW = P::DW;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * NSTB];  // K and V; Q, dO

  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sk = (base + 1023u) & ~1023u;
  const uint32_t sv = sk + P::TILE_BYTES;
  const uint32_t sst = sv + P::TILE_BYTES;  // stage s: Q, then dO
  const uint32_t sld = sst + NSTB * 2 * P::TILE_BYTES;  // + s LD_BYTES
  const float* ldsm = reinterpret_cast<const float*>(smem_raw + (sld - base));
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_st = smem_u32(&bars[1]);  // + 16 s (Q), + 16 s + 8 (dO)

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * TR;     // causal: key tile 0, seen by all, first
  const int G = H / K;
  const int NT = (S + TR - 1) / TR;
  // the query tiles that see a key of this CTA: from the first key on when
  // causal; below the last key + W with a window
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, min(S, k0 + TR) - 1 + window) : S;
  const int n_q = (q_end - q_begin + TR - 1) / TR;
  const int n_t = G * n_q;            // (head, query tile) in head order
  const int tid = threadIdx.x;

  auto load_tile = [&](int t) {
    const int s = t % NSTB;
    const int h = kh * G + t / n_q;
    const int q0 = q_begin + t % n_q * TR;
    const uint32_t dst = sst + s * 2 * P::TILE_BYTES;
    const uint32_t bq = bar_st + 16 * s;
    mbar_expect(bq, P::TILE_BYTES + P::LD_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p)
      tma_load(dst + p * TR * SW, &qmap, bq, p * E, q0, h, b);
    bulk_load(sld + s * P::LD_BYTES,
              ld + (((long long)b * H + h) * NT + q0 / TR) * 2 * TR,
              P::LD_BYTES, bq);
    mbar_expect(bq + 8, P::TILE_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p)
      tma_load(dst + P::TILE_BYTES + p * TR * SW, &domap, bq + 8, p * E, q0,
               h, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * NSTB; ++i) mbar_init(bar_kv + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar_kv, 2 * P::TILE_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      tma_load(sk + p * TR * SW, &kmap, bar_kv, p * E, k0, kh, b);
      tma_load(sv + p * TR * SW, &vmap, bar_kv, p * E, k0, kh, b);
    }
    for (int t = 0; t < min(NSTB, n_t); ++t) load_tile(t);
  }

  const int w = tid % 128 / 32;       // warp: 16 of the 64 keys
  const int lane = tid % 32;
  const int c_off = tid / 128 * DW;   // the warpgroup's columns of dK, dV
  const uint32_t cpanel = c_off / E * TR * SW;  // ... in a 64-row tile
  const int klo = k0, khi = k0 + TR - 1;  // the CTA's keys
  // this thread's keys kr and kr + 8 of the accumulator fragments, and its
  // queries 8 j + c0 + {0, 1} of a tile
  const int kr = klo + 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);

  float dka[DW / 2], dva[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int t = 0; t < n_t; ++t) {
    const int s = t % NSTB;
    const uint32_t ph = (uint32_t)(t / NSTB) & 1u;
    const int q0 = q_begin + t % n_q * TR;
    const uint32_t sq = sst + s * 2 * P::TILE_BYTES;
    const uint32_t sdo = sq + P::TILE_BYTES;
    const uint32_t bq = bar_st + 16 * s;
    // CTA-uniform: is any pair of the tile seen; is every pair
    const bool any = (!causal || klo <= min(q0 + TR - 1, S - 1)) &&
                     (window == 0 || min(khi, S - 1) > q0 - window);
    const bool full = khi < S && q0 + TR - 1 < S && (!causal || khi <= q0) &&
                      (window == 0 || klo > q0 + TR - 1 - window);
    if (any) {
      // both waits before the fence: a wgmma issued after a wait's loop
      // without its own fence makes ptxas serialise every wgmma
      mbar_wait(bq, ph);
      mbar_wait(bq + 8, ph);
      float sacc[32], dpacc[32];      // S^T, dP^T: 64 keys x 64 queries
      wgmma_fence();
      scores<D>(sacc, sk, sq);
      scores<D>(dpacc, sv, sdo);
      wgmma_commit();
      wgmma_wait();
      fence_regs<32>(sacc);
      fence_regs<32>(dpacc);

      // P^T and dS^T on the fragments: acc[4 j + 2 i + c] is key kr + 8 i,
      // query q0 + 8 j + c0 + c
      const float* lt = ldsm + s * 2 * TR;  // the tile's lse log2(e); delta
      uint32_t pa[16], dsa[16];       // P^T, dS^T as bf16 pairs: A fragments
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int col = 8 * (e / 2) + c0;
        const int key = kr + 8 * (e % 2);
        const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
        const float2 dl = *reinterpret_cast<const float2*>(lt + TR + col);
        float p[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qp = q0 + col + c;
          const bool live =
              full || (key < S && qp < S && (!causal || key <= qp) &&
                       (window == 0 || key > qp - window));
          const float x = sacc[2 * e + c] * scale_log2 - (c ? l2.y : l2.x);
          p[c] = live ? exp2f(x) : 0.f;
          ds[c] = p[c] * (dpacc[2 * e + c] - (c ? dl.y : dl.x));
        }
        pa[e] = pack_bf16(p[0], p[1]);
        dsa[e] = pack_bf16(ds[0], ds[1]);
      }

      wgmma_fence();
      product<DW>(dva, pa, sdo + cpanel);
      product<DW>(dka, dsa, sq + cpanel);
      wgmma_commit();
      wgmma_wait();
      fence_regs<DW / 2>(dva);
      fence_regs<DW / 2>(dka);
    } else if (tid == 0) {
      // no key sees this tile: still see its copies land before the stage
      // is refilled or the CTA exits
      mbar_wait(bq, ph);
      mbar_wait(bq + 8, ph);
    }
    __syncthreads();                  // every warpgroup is done with stage s
    if (tid == 0 && t + NSTB < n_t) load_tile(t + NSTB);
  }

  store_rows<DW>(dk + b * dks.b + kh * dks.h, dks.s, kr, c_off + c0, S, dka,
                 scale);
  store_rows<DW>(dv + b * dvs.b + kh * dvs.h, dvs.s, kr, c_off + c0, S, dva,
                 1.f);
}

template <int D>
__global__ void __launch_bounds__(Plan<D>::NTHREADS, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap domap,
             const float* __restrict__ ld, bf16* __restrict__ dq,
             Strides dqs, int H, int K, int S, int window, bool causal,
             float scale, float scale_log2) {
  using P = Plan<D>;
  constexpr int E = P::T::E, SW = P::T::SW, NB = P::T::NB, DW = P::DW;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * NSTB];  // Q and dO; K, V

  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + P::TILE_BYTES;
  const uint32_t skv = sdo + P::TILE_BYTES;  // stage s: K, then V
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_kv = smem_u32(&bars[1]);  // + 16 s (K), + 16 s + 8 (V)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int NT = (S + TR - 1) / TR;
  // causal: the longest rows first, so the last wave is the short tiles
  const int q0 = (causal ? NT - 1 - (int)blockIdx.z : (int)blockIdx.z) * TR;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  // causal: later keys are above the diagonal; with a window, earlier keys
  // are outside every row's window
  const int k_end = causal ? min(S, q0 + TR) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / TR * TR : 0;
  const int n_tiles = (k_end - k_begin + TR - 1) / TR;

  auto load_kv = [&](int t) {
    const int s = t % NSTB;
    const int k0 = k_begin + t * TR;
    const uint32_t dst = skv + s * 2 * P::TILE_BYTES;
    const uint32_t bk = bar_kv + 16 * s;
    mbar_expect(bk, P::TILE_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p)
      tma_load(dst + p * TR * SW, &kmap, bk, p * E, k0, kh, b);
    mbar_expect(bk + 8, P::TILE_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p)
      tma_load(dst + P::TILE_BYTES + p * TR * SW, &vmap, bk + 8, p * E, k0,
               kh, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * NSTB; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar_q, 2 * P::TILE_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      tma_load(sq + p * TR * SW, &qmap, bar_q, p * E, q0, h, b);
      tma_load(sdo + p * TR * SW, &domap, bar_q, p * E, q0, h, b);
    }
    for (int t = 0; t < min(NSTB, n_tiles); ++t) load_kv(t);
  }

  const int w = tid % 128 / 32;       // warp: 16 of the 64 rows
  const int lane = tid % 32;
  const int c_off = tid / 128 * DW;   // the warpgroup's columns of dQ
  const uint32_t cpanel = c_off / E * TR * SW;  // ... in a 64-key tile
  const int rlo = q0;                 // the CTA's rows, clamped to S
  const int rhi = min(rlo + TR - 1, S - 1);
  // every row sees kmin < kpos <= kmax; kmax is nondecreasing in the row,
  // kmin too
  const int kmax_lo = causal ? rlo : S - 1;
  const int kmax_hi = causal ? rhi : S - 1;
  // this thread's rows r0 and r0 + 8 of the fragments, and its keys
  // 8 j + c0 + {0, 1} of a tile
  const int r0 = rlo + 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);
  int kmax[2], kmin[2];
  float l2[2], dl[2];                 // the rows' lse log2(e) and delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    kmax[i] = causal ? r : S - 1;
    kmin[i] = window > 0 ? r - window : -1;
    const float* lt =
        ld + (((long long)b * H + h) * NT + r / TR) * 2 * TR + r % TR;
    l2[i] = r < S ? lt[0] : 0.f;
    dl[i] = r < S ? lt[TR] : 0.f;
  }

  float dqa[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dqa[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % NSTB;
    const uint32_t ph = (uint32_t)(t / NSTB) & 1u;
    const int k0 = k_begin + t * TR;
    const uint32_t sk = skv + s * 2 * P::TILE_BYTES;
    const uint32_t sv = sk + P::TILE_BYTES;
    const uint32_t bk = bar_kv + 16 * s;
    // CTA-uniform: does any row see a key of the tile; do all rows see
    // all of them
    const bool any = k0 <= kmax_hi &&
                     (window == 0 || k0 + TR - 1 > rlo - window);
    const bool full = k0 + TR - 1 <= kmax_lo &&
                      (window == 0 || k0 > rhi - window);
    if (any) {
      mbar_wait(bk, ph);
      mbar_wait(bk + 8, ph);
      float sacc[32], dpacc[32];      // S, dP: 64 rows x 64 keys
      wgmma_fence();
      scores<D>(sacc, sq, sk);
      scores<D>(dpacc, sdo, sv);
      wgmma_commit();
      wgmma_wait();
      fence_regs<32>(sacc);
      fence_regs<32>(dpacc);

      // dS on the fragments: acc[4 j + 2 i + c] is row r0 + 8 i, key
      // k0 + 8 j + c0 + c
      uint32_t dsa[16];               // dS as bf16 pairs: the A fragments
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int i = e % 2;
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + 8 * (e / 2) + c0 + c;
          const bool live = full || (kpos > kmin[i] && kpos <= kmax[i]);
          const float p =
              live ? exp2f(sacc[2 * e + c] * scale_log2 - l2[i]) : 0.f;
          ds[c] = p * (dpacc[2 * e + c] - dl[i]);
        }
        dsa[e] = pack_bf16(ds[0], ds[1]);
      }

      wgmma_fence();
      product<DW>(dqa, dsa, sk + cpanel);
      wgmma_commit();
      wgmma_wait();
      fence_regs<DW / 2>(dqa);
    } else if (tid == 0) {
      mbar_wait(bk, ph);
      mbar_wait(bk + 8, ph);
    }
    __syncthreads();                  // every warpgroup is done with stage s
    if (tid == 0 && t + NSTB < n_tiles) load_kv(t + NSTB);
  }

  store_rows<DW>(dq + b * dqs.b + h * dqs.h, dqs.s, r0, c_off + c0, S, dqa,
                 scale);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* scratch, void* dq,
                void* dk, void* dv, const Args& a, cudaStream_t stream) {
  using P = Plan<D>;
  constexpr int E = P::T::E;
  const int NT = (a.S + TR - 1) / TR;
  bwd_delta<bf16><<<dim3((NT * TR + THREADS / 32 - 1) / (THREADS / 32), a.H,
                         a.B),
                    THREADS, 0, stream>>>(static_cast<const bf16*>(o),
                                          static_cast<const bf16*>(dout), lse,
                                          scratch, a.H, a.S, D, a.os, a.dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // every tile of both passes is 64 rows
  CUtensorMap qm, dom, km, vm;
  if (!tensor_map(&qm, q, D, a.S, a.H, a.B, a.qs, E, TR) ||
      !tensor_map(&dom, dout, D, a.S, a.H, a.B, a.dos, E, TR) ||
      !tensor_map(&km, k, D, a.S, a.K, a.B, a.ks, E, TR) ||
      !tensor_map(&vm, v, D, a.S, a.K, a.B, a.vs, E, TR))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = a.scale * LOG2E;
  // above 48 KB shared memory is dynamic only, and per device: set on
  // every launch (a host-side attribute, no device work)
  err = cudaFuncSetAttribute(bwd_dkdv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::SMEM_DKDV);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_wgmma<D><<<dim3(a.K, a.B, NT), P::NTHREADS, P::SMEM_DKDV,
                      stream>>>(
      qm, km, vm, dom, scratch, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      a.dks, a.dvs, a.H, a.K, a.S, a.window, a.causal, a.scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::SMEM_DQ);
  if (err != cudaSuccess) return (int)err;
  bwd_dq_wgmma<D><<<dim3(a.H, a.B, NT), P::NTHREADS, P::SMEM_DQ, stream>>>(
      qm, km, vm, dom, scratch, static_cast<bf16*>(dq), a.dqs, a.H, a.K, a.S,
      a.window, a.causal, a.scale, scale_log2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, const Args& a, cudaStream_t stream) {
  using C = Bwd<D>;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  bwd_delta<float><<<dim3((a.S + THREADS / 32 - 1) / (THREADS / 32), a.H,
                          a.B),
                     THREADS, 0, stream>>>(static_cast<const float*>(o), dot,
                                           nullptr, delta, a.H, a.S, D, a.os,
                                           a.dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv<float, D><<<dim3((a.S + C::ROWS - 1) / C::ROWS, a.K, a.B),
                       THREADS, 0, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq<float, D><<<dim3((a.S + C::ROWS - 1) / C::ROWS, a.H, a.B), THREADS,
                     0, stream>>>(qt, kt, vt, dot, lse, delta,
                                  static_cast<float*>(dq), a);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const float*, float*, void*, void*,
                         void*, const Args&, cudaStream_t);

// the launcher of dtype ``bf16`` (wgmma) or f32 (CUDA cores) at head dim D
LaunchFn launcher(bool bf16_, int D) {
  switch (D) {
    case 16: return bf16_ ? launch_bf16<16> : launch_f32<16>;
    case 32: return bf16_ ? launch_bf16<32> : launch_f32<32>;
    case 64: return bf16_ ? launch_bf16<64> : launch_f32<64>;
    case 80: return bf16_ ? launch_bf16<80> : launch_f32<80>;
    case 96: return bf16_ ? launch_bf16<96> : launch_f32<96>;
    case 128: return bf16_ ? launch_bf16<128> : launch_f32<128>;
    case 256: return bf16_ ? launch_bf16<256> : launch_f32<256>;
    default: return nullptr;
  }
}

}  // namespace

// q/o/dO/dq (B, H, S, D), k/v/dk/dv (B, K, S, D), each given by its
// (B, H, S) element strides with a unit stride on D; lse (B, H, S) f32,
// contiguous; ``scratch`` f32 of at least 2 B H ceil(S / 64) 64 elements
// (pass 0's delta).  causal and window as for the forward
// (flash_attention).  dk and dv are summed over each KV head's H / K query
// heads.  bf16 runs on the tensor cores, f32 on the CUDA cores.  Returns
// the cudaError_t of the launches.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int H, int K, int S, int D, int causal, int window,
    const long long* strides, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (dtype != DT_BF16 && dtype != DT_F32) return (int)cudaErrorInvalidValue;
  const LaunchFn fn = launcher(dtype == DT_BF16, D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  // strides: q, k, v, o, dO, dq, dk, dv, each (b, h, s)
  const long long* s = strides;
  const Args a{B, H, K, S, window, causal != 0,
               {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
               {s[9], s[10], s[11]}, {s[12], s[13], s[14]},
               {s[15], s[16], s[17]}, {s[18], s[19], s[20]},
               {s[21], s[22], s[23]}, scale};
  return fn(q, k, v, o, dout, static_cast<const float*>(lse),
            static_cast<float*>(scratch), dq, dk, dv, a,
            static_cast<cudaStream_t>(stream));
}
