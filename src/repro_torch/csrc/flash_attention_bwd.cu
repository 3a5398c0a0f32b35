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
// dv per KV head) and the f32 lse.  In bf16 at llama2-7b's S = 512 the
// bytes bound it at the tensor cores' peak; this first design runs on the
// CUDA cores (67 TFLOP/s of f32 FMA), where the operations do, and it
// recomputes S and dP in both passes (14 D a pair).  Everything is
// accumulated in f32; bf16 inputs are widened when loaded.
//
// Three launches on one stream, no atomics (two calls give the same bits):
//   pass 0  delta = rowsum(dO * O) in f32, one warp per query row, into a
//           (B, H, S) scratch that passes 1 and 2 read;
//   pass 1  dK and dV: one CTA per (key tile, KV head, batch).  Each key
//           row is owned by TPR threads, each holding 4-float chunks of
//           its k, v, dk and dv in registers (DPT = D / TPR <= 32 dims).
//           The CTA walks the H / K query heads of its group and, for each,
//           the query tiles that see its keys (from the diagonal when
//           causal, up to the window's reach), staging Q, dO, lse and
//           delta of a tile in shared memory (f32, 32 KB).  Per query row:
//           s = q.k and dp = dO.v (partial dots over the thread's chunks,
//           summed over the row's TPR lanes by shuffles), P = exp(s scale
//           - lse), dV += P dO, dS = P (dp - delta), dK += dS q; dK is
//           scaled once at the end.  The group's heads are summed inside
//           the CTA, in head order.
//   pass 2  dQ: one CTA per (query tile, head, batch), the forward f32
//           kernel's shape: TPR threads per query row hold q, dO and dq;
//           K and V tiles of the keys the rows see come through shared
//           memory; dQ += dS k, scaled at the end.
// P for dV is rounded to v's dtype, as the forward's plain version rounds
// the P of PV (dS keeps the f32 P).  Shared-memory reads are 16-byte
// (float4) and conflict-free: the TPR lanes of a row read consecutive
// chunks, the rows of a warp the same ones (a broadcast).
//
// D = 256 takes 8 threads per row (32 dims each) and 16-row staged tiles;
// D <= 128 takes 4 threads per row and 32-row (D > 64) or 64-row tiles, so
// a staged pair of tiles is at most 32 KB of static shared memory.  ptxas
// -v for sm_90a (CUDA 12.8), D = 16 / 32 / 64 / 80 / 96 / 128 / 256, no
// spill anywhere: pass 1 48 / 64 / 122 / 135 / 181 / 230 / 230 registers
// in bf16 (f32: 48 / 64 / 124 / 159 / 188 / 232 / 231), pass 2 40 / 48 /
// 80 / 119 / 122 / 156 / 156 (f32: 40 / 48 / 80 / 121 / 124 / 157 / 157);
// one CTA of 256 threads an SM above ~128 registers, the occupancy a
// faster design would raise first.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

struct Strides {                      // element strides of (B, H, S); D is 1
  long long b, h, s;
};

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

// 4 consecutive elements, widened to / narrowed from float
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

template <> struct Quad<bf16> {
  __device__ __forceinline__ static void load(const bf16* p, float* o) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  __device__ __forceinline__ static void store(bf16* p, const float* o) {
    __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&a);
    v.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = v;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, int H, int S, int D, Strides os,
          Strides dos) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  if (row >= S) return;               // whole warps: no shuffle is split
  const T* op = o + b * os.b + h * os.h + (long long)row * os.s;
  const T* dp = dout + b * dos.b + h * dos.h + (long long)row * dos.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f(op[d]) * to_f(dp[d]);
  acc = warp_sum(acc);
  if (lane == 0) delta[((long long)b * H + h) * S + row] = acc;
}

// ---------------------------------------------------------------------------
// pass 1: dK, dV per (key tile, KV head, batch)
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
// pass 2: dQ per (query tile, head, batch)
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const Args& a, cudaStream_t stream) {
  using C = Bwd<D>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  bwd_delta<T><<<dim3((a.S + THREADS / 32 - 1) / (THREADS / 32), a.H, a.B),
                 THREADS, 0, stream>>>(static_cast<const T*>(o), dot, delta,
                                       a.H, a.S, D, a.os, a.dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv<T, D><<<dim3((a.S + C::ROWS - 1) / C::ROWS, a.K, a.B), THREADS, 0,
                   stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                             static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq<T, D><<<dim3((a.S + C::ROWS - 1) / C::ROWS, a.H, a.B), THREADS, 0,
                 stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq),
                           a);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const float*, float*, void*, void*,
                         void*, const Args&, cudaStream_t);

template <typename T>
LaunchFn launcher_of(int D) {
  switch (D) {
    case 16: return launch<T, 16>;
    case 32: return launch<T, 32>;
    case 64: return launch<T, 64>;
    case 80: return launch<T, 80>;
    case 96: return launch<T, 96>;
    case 128: return launch<T, 128>;
    case 256: return launch<T, 256>;
    default: return nullptr;
  }
}

}  // namespace

// q/o/dO/dq (B, H, S, D), k/v/dk/dv (B, K, S, D), each given by its
// (B, H, S) element strides with a unit stride on D; lse and the delta
// scratch (B, H, S) f32, contiguous.  causal and window as for the forward
// (flash_attention).  dk and dv are summed over each KV head's H / K query
// heads.  Returns the cudaError_t of the launches.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int K, int S, int D, int causal, int window,
    const long long* strides, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (dtype != DT_BF16 && dtype != DT_F32) return (int)cudaErrorInvalidValue;
  const LaunchFn fn =
      dtype == DT_BF16 ? launcher_of<bf16>(D) : launcher_of<float>(D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  // strides: q, k, v, o, dO, dq, dk, dv, each (b, h, s)
  const long long* s = strides;
  const Args a{B, H, K, S, window, causal != 0,
               {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
               {s[9], s[10], s[11]}, {s[12], s[13], s[14]},
               {s[15], s[16], s[17]}, {s[18], s[19], s[20]},
               {s[21], s[22], s[23]}, scale};
  return fn(q, k, v, o, dout, static_cast<const float*>(lse),
            static_cast<float*>(delta), dq, dk, dv, a,
            static_cast<cudaStream_t>(stream));
}
