// Dense flash-decode for Hopper (sm_90a): one query token per lane attends
// over the lane's contiguous KV cache (the slot pool, or a sliding
// window's ring).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:70
// (decode_attention; kernel body _decode_kernel, :26).
//
// What bounds it on the H100: bytes (the K/V of the live keys 0 ..
// position over 3.35 TB/s; split_decode.cuh says why).
//
// Design: flash-decoding, split over the key axis and merged inside the
// same launch, the body in split_decode.cuh.  On the TPU the grid is
// (lane, key block of 512) with the key axis walked in order and (m, l,
// acc) in VMEM scratch.  Here the grid is (splits, K * head groups, B):
// split s of a (lane, KV head) owns keys [s*L, (s+1)*L) of the lane's 0 ..
// min(position, S - 1), L chosen by the wrapper from shapes only (B, K, S:
// the largest power of two >= 32 that still gives >= 2 CTAs per SM; at
// most 256 splits).  The walk is the lane's row of the cache (DenseWalk);
// the unnormalised exp(s - m) is rounded to the cache's dtype before PV,
// as the reference model's _flash_decode_core does.
//
// Parked lanes (position 0) read key 0 of their row.  Any S, any D % 8 ==
// 0 up to 512, every (q, cache) dtype pair of the wrapper's _PAIRS.
#include "split_decode.cuh"

namespace {

using namespace repro;
using namespace repro::split;

// keys 0 .. min(position, S - 1) of lane b's row of a (B, S, K, D) cache
struct DenseWalk {
  const int* positions;
  int S, K, D;
  __device__ int begin(int b, int, int, int*) const {
    return min(positions[b] + 1, S);
  }
  __device__ size_t row(int b, int w, int, const int*) const {
    return ((size_t)b * S + w) * K * D;
  }
};

template <typename QT, typename KT, int GB, int NCH>
__global__ void __launch_bounds__(THREADS)
split_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const int* __restrict__ positions,
                    QT* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ tickets, Shape a, int S, int TK,
                    int LPK) {
  split_decode<QT, KT, GB, NCH, true, false>(
      q, k, v, out, nullptr, part, tickets, a, TK, LPK,
      DenseWalk{positions, S, a.K, a.D});
}

struct Args {
  const void *q, *k, *v;
  const int* positions;
  void* out;
  float* part;
  int* tickets;
  int B, S;
  Shape a;
  cudaStream_t stream;
};

template <typename QT, typename KT>
struct Dense {
  template <int GB, int NCH>
  static int run(Args x) {
    const Launch ln = launch_shape<KT, GB>(x.a.D, x.a.splits);
    x.a.ids_off = (int)ln.smem;
    auto kern = split_decode_kernel<QT, KT, GB, NCH>;
    // above 48 KB shared memory is dynamic only, and per device: set on
    // every launch (a host-side attribute, no device work)
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ln.smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(x.a.splits, x.a.K * x.a.groups, x.B), THREADS, ln.smem,
           x.stream>>>(
        static_cast<const QT*>(x.q), static_cast<const KT*>(x.k),
        static_cast<const KT*>(x.v), x.positions, static_cast<QT*>(x.out),
        x.part, x.tickets, x.a, x.S, ln.tk, ln.lpk);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// q (B, H, D); k/v (B, S, K, D); positions (B,) int32; out (B, H, D) in
// q's dtype.  All contiguous.  part: f32 scratch of B * K * groups * splits
// * min(H / K, 8) * (D + 2) floats, groups = ceil((H / K) / 8) and splits =
// ceil(S / L); tickets: B * K * groups int32, zero before the launch and
// left zero after it.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* positions, void* out, void* part,
                                void* tickets, int B, int H, int K, int D,
                                int S, int L, float scale, int q_dtype,
                                int kv_dtype, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || D % 8 != 0 || D <= 0 || D > MAX_D || S <= 0 ||
      L <= 0 || (S + L - 1) / L > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const int hpc = G < MAX_G ? G : MAX_G;
  const Args x{q, k, v, positions, out, static_cast<float*>(part),
               static_cast<int*>(tickets), B, S,
               Shape{H, K, D, L, (S + L - 1) / L, (G + hpc - 1) / hpc, 0,
                     scale},
               static_cast<cudaStream_t>(stream)};
  int (*fn)(Args) = nullptr;
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    fn = pick<Dense<bf16, bf16>, Vec<bf16>::N>(hpc, D);
  else if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    fn = pick<Dense<float, float>, Vec<float>::N>(hpc, D);
  else if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    fn = pick<Dense<float, bf16>, Vec<bf16>::N>(hpc, D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(x);
}
