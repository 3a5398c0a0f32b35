// RWKV6 WKV recurrence for Hopper (sm_90a): per (batch, head) a D x D f32
// state S carried over time,
//     y_t = r_t . (S + (u * k_t) v_t^T);   S <- diag(w_t) S + k_t v_t^T.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv.py:52
// (rwkv6_wkv; kernel body _wkv_kernel, :24).
//
// What bounds it on the H100: bytes or operations, and the sequential time
// axis.  The function needs 5*D^2 + 5*D f32 flops per step and (b, h), in
// the form y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i, then
// S_ij <- w_i S_ij + k_i v_j, against D elements each of r, k, v and w
// read and of y written: D/4 flops per byte with f32 r/k/v/y, 5*D/12 with
// bf16, beside the card's ~20 f32 flops per byte of HBM bandwidth.  So at
// prefill with D = 64 the f32 pair is bound by bytes and the bf16 pair by
// operations (2.48 us for T = 200, H = 40).  At decode (T = 1) the bytes
// are the state, read and written once: 2 * B*H*D^2*4 B, 5.24 MB at B=4,
// H=40, D=64, ~1.6 us at 3.35 TB/s.  Besides, T steps depend on each
// other, which sets a latency floor of T dependent steps whatever the
// bandwidth.  This body spends 8 flops per entry (it recomputes
// (u_i k_i) v_j for every entry), which is not what holds it back.
//
// Design.  On the TPU the grid is (b, h, time block) with the time axis
// walked in order and S kept in VMEM scratch between blocks; it asserts
// T % block_t == 0.  Here no grid axis runs in order, so one CTA owns one
// (b, h) pair and loops over all T itself.  The v columns of S are
// independent given r, k and w, so thread j owns column S[:, j] in
// registers (D floats; D is a template parameter so the column stays in
// registers).  The CTA stages TT steps of r, k, v and w at a time in
// shared memory (coalesced loads through the (B, T, H, D) strides, any T:
// the last tile is short), then walks them: thread j computes
// y_j = sum_i r_i (S_ij + (u_i k_i) v_j) with four partial sums, updates
// S_ij <- w_i S_ij + k_i v_j, and writes y_j (coalesced over j).  The
// final column is written once at the end.  A column is read whole before
// it is written and no other thread touches it, so s_out may be s0: the
// slot pool's decode updates its state in place.  s0 == nullptr means a
// zero state (prefill).  r/k/v/y are f32 or bf16 (widened on load, y
// rounded once on store); w, u and the state are f32.  Simple first: one
// CTA of D threads per (b, h) (40 CTAs at prefill with B=1, 160 at decode
// with 4 slots), no split of the rows of S over threads, no double
// buffering of the staged tiles.
#include "common.cuh"

namespace {

using namespace repro;

struct Strides {            // element strides of one (B, T, H, D) tensor
  long long b, t, h;        // the D axis is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(D)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* s0, float* s_out,
           T* __restrict__ y, int H, int Tlen, Strides sr, Strides sk,
           Strides sv, Strides sw) {
  constexpr int TT = 2048 / D;   // steps per staged tile: 32 KB of smem
  __shared__ float rs[TT * D];
  __shared__ float ks[TT * D];
  __shared__ float vs[TT * D];
  __shared__ float ws[TT * D];
  __shared__ float us[D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;

  float S[D];
  const size_t s_off = (size_t)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = s0 ? s0[s_off + (size_t)i * D + j] : 0.f;
  us[j] = u[(size_t)h * D + j];

  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h;
  T* yb = y + ((size_t)b * Tlen * H + h) * D;

  for (int t0 = 0; t0 < Tlen; t0 += TT) {
    const int n = min(TT, Tlen - t0);
    __syncthreads();   // the previous tile is consumed (and us is written)
    for (int idx = j; idx < n * D; idx += D) {
      const int tt = idx / D;
      const int c = idx - tt * D;
      const long long t = t0 + tt;
      rs[idx] = to_f(rb[t * sr.t + c]);
      ks[idx] = to_f(kb[t * sk.t + c]);
      vs[idx] = to_f(vb[t * sv.t + c]);
      ws[idx] = wb[t * sw.t + c];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float* rt = rs + tt * D;
      const float* kt = ks + tt * D;
      const float* wt = ws + tt * D;
      const float vj = vs[tt * D + j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float ki = kt[i];
        acc[i & 3] += rt[i] * (S[i] + (us[i] * ki) * vj);
        S[i] = wt[i] * S[i] + ki * vj;
      }
      const float yj = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      yb[(size_t)(t0 + tt) * H * D + j] = from_f<T>(yj);
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) s_out[s_off + (size_t)i * D + j] = S[i];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* s_out, void* y, int B,
           int Tlen, int H, const Strides* st, cudaStream_t stream) {
  wkv_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, s_out, static_cast<T*>(y), H, Tlen,
      st[0], st[1], st[2], st[3]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* r, const void* k, const void* v, const float* w,
               const float* u, const float* s0, float* s_out, void* y, int B,
               int Tlen, int H, int D, const Strides* st,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, s_out, y, B, Tlen, H, st, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, s_out, y, B, Tlen, H, st, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, s_out, y, B, Tlen, H, st, stream);
    case 128: return launch<T, 128>(r, k, v, w, u, s0, s_out, y, B, Tlen, H, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v (B, T, H, D) in dtype (f32 or bf16) and w (B, T, H, D) f32, each
// with D contiguous and the element strides of its B, T and H axes in
// strides[3*i .. 3*i+2] (i = r, k, v, w); u (H, D) f32; s0 (B, H, D, D)
// f32 or nullptr for a zero state; s_out (B, H, D, D) f32, may equal s0;
// y (B, T, H, D) contiguous in dtype.  D in {16, 32, 64, 128}.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const float* s0,
                         float* s_out, void* y, int B, int T, int H, int D,
                         const long long* strides, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (B < 0 || H < 0 || T < 0) return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_d<float>(r, k, v, w, u, s0, s_out, y, B, T, H, D, st, s);
  if (dtype == DT_BF16)
    return dispatch_d<bf16>(r, k, v, w, u, s0, s_out, y, B, T, H, D, st, s);
  return (int)cudaErrorInvalidValue;
}
