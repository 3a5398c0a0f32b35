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
// exp(-exp(dw)) underflows toward 0.
//
// What bounds it on the H100: per step and (b, h) ~10 f32 flops an entry of
// the D x D state (the chunk's recompute 2, dr, dk, dw and dv one FMA each,
// G's update 2, plus the reductions), against 5 rows of D read and 4
// written: ~2 D flops a byte, so operations at rwkv6-3b's D = 64 (6.7
// GFLOP a layer at 4 x 1024 tokens, 0.10 ms on the CUDA cores' 67
// TFLOP/s) over ~0.08 ms of bytes.  Besides, the T steps depend on each
// other through G.
//
// Design.  Every gradient but dv sums over S's columns, dv over its rows,
// so a CTA keeps a whole head: one CTA a (b, h) (160 at rwkv6-3b's
// training shape, B = 4, H = 40), 256 threads as a 16 x 16 grid, thread
// (tr, tc) holding rows tr + 16 a and columns tc + 16 b of G in registers
// ((D / 16)^2 entries: 16 at D = 64).  A half-warp spans the 16 column
// threads of a row group, so a row's sums over its columns take 4
// shuffles within the half-warp: each thread's 3 D/16 partials of dr, dk
// and dw are reduced together by exchanging halves (15 shuffles for 16
// values, after which lane l holds value l's total), and that lane writes
// it.  dv's partial sums over a thread's rows meet the other half-warp's
// by one shuffle and the 8 warps' in shared memory, summed in warp order
// by a pass every GS = 8 steps.  (v_t . dy_t) and c_t are summed by every
// half-warp alike (4 shuffles each).  Chunks run from the last: the
// chunk's r, k, v, w and dy are staged in shared memory as f32 (C x D x
// 5, 80 KB), its states recomputed from the checkpoint into a scratch
// buffer in device memory (each thread stores and later loads its own
// entries, so it needs no barrier), then its steps walked backwards.  du
// is summed per (b, h) by the lane that holds a row's dr and written as a
// partial; the wrapper sums the partials over b (torch's sum(0), which
// uses no atomics).  No atomics: every sum has one order, so two runs
// give the same bits.  r/k/v/dy f32
// or bf16 (widened on staging), dr/dk/dv rounded once to their dtype, dw,
// du and ds0 f32.  Head dims: every D % 16 == 0 up to 128.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int NT = 256;     // threads: a 16 x 16 grid
constexpr int TC = 16;      // column threads (a half-warp)
constexpr int TR = 16;      // row threads
constexpr int NW = NT / 32;
constexpr int GS = 8;       // steps between dv's passes

struct Strides {            // element strides of one (B, T, H, D) tensor
  long long b, t, h;        // the D axis is contiguous
};

// v[i] (i < 16 * NR) are a lane's partials; the 16 lanes of a half-warp
// exchange halves (8 + 4 + 2 + 1 shuffles per 16 values), after which lane
// l holds in v[16 n] the total of value 16 n + l
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ ck,
               const float* __restrict__ dS, const T* __restrict__ dy,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ ds0, float* __restrict__ scr, int H,
               int Tlen, int C, Strides sr, Strides sk, Strides sv,
               Strides sw, Strides sd) {
  constexpr int RPT = D / TR;                   // rows a thread
  constexpr int CPT = D / TC;                   // columns a thread
  constexpr int EPT = RPT * CPT;                // entries a thread
  constexpr int NV = 3 * RPT;                   // dr, dk, dw partials
  constexpr int NR = (NV + 15) / 16;            // rounds of 16
  extern __shared__ __align__(16) float smem[];
  float* in_r = smem;                           // (C, D) each, f32
  float* in_k = in_r + C * D;
  float* in_v = in_k + C * D;
  float* in_w = in_v + C * D;
  float* in_d = in_w + C * D;
  float* us = in_d + C * D;                     // (D)
  float* dvbuf = us + D;                        // (GS, NW, D)
  float* cbuf = dvbuf + GS * NW * D;            // (GS)

  const int tid = threadIdx.x;
  const int tr = tid / TC, tc = tid % TC;
  const int warp = tid / 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h;
  const T* db = dy + b * sd.b + h * sd.h;
  const size_t ob = ((size_t)b * Tlen * H + h) * D;   // contiguous outputs
  const size_t HD = (size_t)H * D;
  const int n_ck = (Tlen + C - 1) / C;
  float* my_scr = scr + (size_t)bh * min(C, Tlen) * D * D + tid;

  for (int i = tid; i < D; i += NT) us[i] = u[(size_t)h * D + i];

  float G[RPT][CPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      G[a][c] = dS ? dS[((size_t)bh * D + tr + TR * a) * D + tc + TC * c]
                   : 0.f;
  float du_acc[NR];
#pragma unroll
  for (int n = 0; n < NR; ++n) du_acc[n] = 0.f;

  for (int n = n_ck - 1; n >= 0; --n) {
    const int t0 = n * C, cnt = min(C, Tlen - t0);
    __syncthreads();                    // the last chunk's readers are done
    for (int x = tid; x < cnt * D; x += NT) {
      const int tt = x / D, i = x - tt * D;
      in_r[x] = to_f(rb[(t0 + tt) * sr.t + i]);
      in_k[x] = to_f(kb[(t0 + tt) * sk.t + i]);
      in_v[x] = to_f(vb[(t0 + tt) * sv.t + i]);
      in_w[x] = wb[(t0 + tt) * sw.t + i];
      in_d[x] = to_f(db[(t0 + tt) * sd.t + i]);
    }
    __syncthreads();

    // the chunk's states S_{t0} .. S_{t0 + cnt - 1}, from its checkpoint,
    // each into the scratch (this thread's entries only)
    {
      float S[RPT][CPT];
      const float* src = ck + ((size_t)bh * n_ck + n) * D * D;
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          S[a][c] = src[(tr + TR * a) * D + tc + TC * c];
      for (int tt = 0; tt < cnt; ++tt) {
        float* dst = my_scr + (size_t)tt * D * D;
        const float* kt = in_k + tt * D;
        const float* wt = in_w + tt * D;
        const float* vt = in_v + tt * D;
#pragma unroll
        for (int a = 0; a < RPT; ++a) {
          const float ki = kt[tr + TR * a], wi = wt[tr + TR * a];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dst[(a * CPT + c) * NT] = S[a][c];
            // the forward's update, the same rounding
            S[a][c] = fmaf(wi, S[a][c], ki * vt[tc + TC * c]);
          }
        }
      }
    }

    // the chunk's steps, last first
    int g = 0;                          // steps in the pending dv pass
    for (int tt = cnt - 1; tt >= 0; --tt) {
      const float* src = my_scr + (size_t)tt * D * D;
      float S[RPT][CPT];
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int c = 0; c < CPT; ++c) S[a][c] = src[(a * CPT + c) * NT];
      const float* rt = in_r + tt * D;
      const float* kt = in_k + tt * D;
      const float* vt = in_v + tt * D;
      const float* wt = in_w + tt * D;
      const float* dt = in_d + tt * D;
      float rr[RPT], kk[RPT], vv[CPT], dd[CPT];
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        rr[a] = rt[tr + TR * a];
        kk[a] = kt[tr + TR * a];
      }
      float vdy = 0.f, c_t = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        vv[c] = vt[tc + TC * c];
        dd[c] = dt[tc + TC * c];
        vdy = fmaf(vv[c], dd[c], vdy);
        const int i = tc + TC * c;      // rows tc + 16 c for c_t
        c_t = fmaf(rt[i] * us[i], kt[i], c_t);
      }
      vdy = half_sum(vdy);
      c_t = half_sum(c_t);

      float red[16 * NR];
#pragma unroll
      for (int x = 0; x < 16 * NR; ++x) red[x] = 0.f;
      float dvp[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) dvp[c] = 0.f;
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const float wi = wt[tr + TR * a];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          red[a] = fmaf(S[a][c], dd[c], red[a]);                // dr
          red[RPT + a] = fmaf(G[a][c], vv[c], red[RPT + a]);    // dk
          red[2 * RPT + a] = fmaf(G[a][c], S[a][c], red[2 * RPT + a]);
          dvp[c] = fmaf(G[a][c], kk[a], dvp[c]);
          G[a][c] = fmaf(wi, G[a][c], rr[a] * dd[c]);
        }
      }
      reduce_half16<8, 16 * NR>(red, tc);
      const int t = t0 + tt;
#pragma unroll
      for (int n2 = 0; n2 < NR; ++n2) {
        const int x = 16 * n2 + tc;
        if (x < NV) {
          const int kind = x / RPT, a = x - kind * RPT;
          const int i = tr + TR * a;
          const size_t o = ob + (size_t)t * HD + i;
          const float val = red[16 * n2];
          if (kind == 0) {
            dr[o] = from_f<T>(fmaf(us[i] * kt[i], vdy, val));
            du_acc[n2] = fmaf(rt[i] * kt[i], vdy, du_acc[n2]);
          } else if (kind == 1) {
            dk[o] = from_f<T>(fmaf(rt[i] * us[i], vdy, val));
          } else {
            dw[o] = val;
          }
        }
      }
      // dv: the warp's two row groups, then the warps in order
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dvp[c] += __shfl_xor_sync(0xffffffffu, dvp[c], 16);
        if ((tid & 31) < 16) dvbuf[(g * NW + warp) * D + tc + TC * c] = dvp[c];
      }
      if (tid == 0) cbuf[g] = c_t;
      ++g;
      if (g == GS || tt == 0) {
        __syncthreads();
        for (int x = tid; x < g * D; x += NT) {
          const int gg = x / D, j = x - gg * D;
          const int ts = tt + g - 1 - gg;   // the step of pass entry gg
          float sum = 0.f;
#pragma unroll
          for (int q = 0; q < NW; ++q) sum += dvbuf[(gg * NW + q) * D + j];
          dv[ob + (size_t)(t0 + ts) * HD + j] =
              from_f<T>(fmaf(cbuf[gg], in_d[ts * D + j], sum));
        }
        __syncthreads();
        g = 0;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ds0[((size_t)bh * D + tr + TR * a) * D + tc + TC * c] = G[a][c];
#pragma unroll
  for (int n2 = 0; n2 < NR; ++n2) {
    const int x = 16 * n2 + tc;
    if (x < RPT)                        // kind 0: dr's lane of row i
      du_part[(size_t)bh * D + tr + TR * x] = du_acc[n2];
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const float*,
                        const float*, const float*, const float*, const T*,
                        T*, T*, T*, float*, float*, float*, float*, int, int,
                        int, Strides, Strides, Strides, Strides, Strides);

template <typename T>
Kernel<T> kernel_of(int D) {
  switch (D) {
    case 16: return wkv_bwd_kernel<T, 16>;
    case 32: return wkv_bwd_kernel<T, 32>;
    case 48: return wkv_bwd_kernel<T, 48>;
    case 64: return wkv_bwd_kernel<T, 64>;
    case 80: return wkv_bwd_kernel<T, 80>;
    case 96: return wkv_bwd_kernel<T, 96>;
    case 112: return wkv_bwd_kernel<T, 112>;
    case 128: return wkv_bwd_kernel<T, 128>;
    default: return nullptr;
  }
}

template <typename T>
int launch(void* const* a, int B, int Tlen, int H, int D, int C,
           const Strides* st, cudaStream_t stream) {
  const Kernel<T> fn = kernel_of<T>(D);
  if (fn == nullptr || C < 1 || C * D > 4096) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (5 * C * D + D + GS * NW * D + GS);
  // above 48 KB shared memory is dynamic only, and per device: set on
  // every launch (a host-side attribute, no device work)
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const float*>(a[3]),
      static_cast<const float*>(a[4]), static_cast<const float*>(a[5]),
      static_cast<const float*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<T*>(a[8]), static_cast<T*>(a[9]), static_cast<T*>(a[10]),
      static_cast<float*>(a[11]), static_cast<float*>(a[12]),
      static_cast<float*>(a[13]), static_cast<float*>(a[14]), H, Tlen, C,
      st[0], st[1], st[2], st[3], st[4]);
  return (int)cudaGetLastError();
}

}  // namespace

// r/k/v/dy (B, T, H, D) in dtype (f32 or bf16) and w (B, T, H, D) f32, each
// with D contiguous; u (H, D) f32; ck the training form's checkpoints (B,
// H, ceil(T / C), D, D) f32; dS (B, H, D, D) f32 or nullptr (0); outputs
// dr/dk/dv (B, T, H, D) contiguous in dtype, dw (B, T, H, D) f32, du_part
// (B, H, D) f32, ds0 (B, H, D, D) f32; scr a scratch of B * H * min(C, T)
// * D * D f32.  p holds B, T, H, D, C, dtype, then the element strides of
// the B, T and H axes of r, k, v, w and dy.  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const float* w, const float* u, const float* ck,
                             const float* dS, const void* dy, void* dr,
                             void* dk, void* dv, float* dw, float* du_part,
                             float* ds0, float* scr, const long long* p,
                             void* stream) {
  const int B = (int)p[0], T = (int)p[1], H = (int)p[2], D = (int)p[3];
  const int C = (int)p[4], dtype = (int)p[5];
  if (B == 0 || H == 0) return 0;
  if (B < 0 || H < 0 || T < 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides st[5] = {{p[6], p[7], p[8]}, {p[9], p[10], p[11]},
                         {p[12], p[13], p[14]}, {p[15], p[16], p[17]},
                         {p[18], p[19], p[20]}};
  void* const a[15] = {const_cast<void*>(r), const_cast<void*>(k),
                       const_cast<void*>(v), const_cast<float*>(w),
                       const_cast<float*>(u), const_cast<float*>(ck),
                       const_cast<float*>(dS), const_cast<void*>(dy), dr, dk,
                       dv, dw, du_part, ds0, scr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch<float>(a, B, T, H, D, C, st, s);
  if (dtype == DT_BF16) return launch<bf16>(a, B, T, H, D, C, st, s);
  return (int)cudaErrorInvalidValue;
}
