// Paged decode attention for Hopper (sm_90a): one query token per lane
// attends through its block table into a global KV block pool, or, in the
// LSE form, into one stripe of a block-striped pool.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/paged_decode_attention.py:
// - :331 paged_decode_attention (kernel body _paged_decode_kernel, :34);
// - :180 paged_decode_attention_lse (kernel body _paged_decode_lse_kernel,
//   :133), the per-stripe step of the tensor-sharded pool: it attends over
//   the table slots this stripe owns (owned[b, j] != 0) only and also
//   returns lse = m + log l (-1e30 where the stripe saw no key), so the
//   stripes' outputs merge exactly (combine_lse, in the wrapper's module).
//
// What bounds it on the H100: bytes.  The least time is the K/V bytes of
// the live keys (in the LSE form: the live keys of the owned blocks) over
// 3.35 TB/s; split_decode.cuh says why.
//
// Design: flash-decoding split over each lane's walk through its table
// and merged inside the same launch, kernel 5's body (split_decode.cuh).
// On the TPU the grid walks (lane, logical block) in order, the block
// table is scalar-prefetched into SMEM and the BlockSpec index map DMAs
// the physical block.  Here the grid is (splits, K * head groups, B):
// split s of a (lane, KV head) owns walk positions [s*L, (s+1)*L), L a
// multiple of the block size chosen by the wrapper from shapes only (B, H,
// K and the table's T * bs keys; paged_split_plan), so a split covers
// whole blocks.  Each CTA stages its split's physical block ids once in
// shared memory (clipped into [0, n_blocks): a row is never read outside
// the pool), and the row of walk position w is ((ids[(w - lo) / bs] * bs
// + w % bs) * K + kh) * D: K/V rows arrive by 16-byte cp.async into the
// 2-stage ring, in the pool's dtype.  Parked lanes (pos 0, table row 0)
// read key 0 of the parking block like any other block.  Kernel 2 keeps P
// in f32 before PV, as the Pallas kernel does.
//
// The LSE form walks only the owned blocks at or before pos: one warp of
// each CTA lists them by ballot, in table order, keeps the ids of the
// ranks its split covers, and counts the walk's keys (every owned block's
// bs keys, the last one's up to pos).  An unowned block is never read and
// its clipped local id never dereferenced.  Every key of the walk is live,
// so a masked key is never scored: it adds exactly 0 to l and acc (scored
// -1e30 it would add exp(0) = 1 where m is still -1e30, and a stripe that
// saw no key would report l > 0).  A lane whose stripe owns no key at or
// before pos has no live split: split 0 writes o = 0 and lse = -1e30.  As
// the plain version does, the LSE form rounds the unnormalised exp(s - m)
// to the pool's dtype before PV while l sums the unrounded values, here
// per key group and split (the rounding point the sharded core has).
#include "split_decode.cuh"

namespace {

using namespace repro;
using namespace repro::split;

__device__ __forceinline__ int clip_block(int blk, int n_blocks) {
  return min(max(blk, 0), n_blocks - 1);
}

// keys 0 .. min(position, T * bs - 1) of lane b, through its table row
struct TableWalk {
  const int* tables;
  const int* positions;
  int T, bs, n_blocks, K, D;
  __device__ int begin(int b, int lo, int L, int* ids) const {
    const int n = min(positions[b] + 1, T * bs);
    const int j0 = lo / bs;
    const int nb = (min(L, n - lo) + bs - 1) / bs;   // 0 past the walk
    for (int i = threadIdx.x; i < nb && j0 + i < T; i += blockDim.x)
      ids[i] = clip_block(tables[(size_t)b * T + j0 + i], n_blocks);
    __syncthreads();
    return n;
  }
  __device__ size_t row(int, int w, int lo, const int* ids) const {
    return ((size_t)ids[(w - lo) / bs] * bs + w % bs) * K * D;
  }
};

// the keys of lane b's owned blocks j with j * bs <= position, in table
// order: walk position w is key w % bs of the (w / bs)-th owned block,
// whose id begin() stages at rank w / bs - lo / bs (rows as TableWalk's)
struct OwnedWalk : TableWalk {
  const int* owned;
  __device__ int begin(int b, int lo, int L, int* ids) const {
    __shared__ int n_walk;
    const int n_keys = min(positions[b] + 1, T * bs);
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int r0 = lo / bs, r1 = r0 + L / bs;   // ranks this split reads
      const int* own = owned + (size_t)b * T;
      int count = 0, last = 0;
      for (int j0 = 0; j0 < T && j0 * bs < n_keys; j0 += 32) {
        const int j = j0 + lane;
        const bool take = j < T && j * bs < n_keys && own[j] != 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, take);
        const int rank = count + __popc(ballot & ((1u << lane) - 1u));
        if (take && rank >= r0 && rank < r1)
          ids[rank - r0] = clip_block(tables[(size_t)b * T + j], n_blocks);
        if (ballot) last = j0 + 31 - __clz((int)ballot);
        count += __popc(ballot);
      }
      if (lane == 0)
        n_walk = count == 0 ? 0
                            : (count - 1) * bs + min(bs, n_keys - last * bs);
    }
    __syncthreads();
    return n_walk;
  }
};

template <typename QT, typename KT, int GB, int NCH>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const QT* __restrict__ q,
                          const KT* __restrict__ k_pool,
                          const KT* __restrict__ v_pool, TableWalk walk,
                          QT* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ tickets, Shape a, int TK,
                          int LPK) {
  split_decode<QT, KT, GB, NCH, false, false>(
      q, k_pool, v_pool, out, nullptr, part, tickets, a, TK, LPK, walk);
}

template <typename QT, typename KT, int GB, int NCH>
__global__ void __launch_bounds__(THREADS)
paged_decode_lse_split_kernel(const QT* __restrict__ q,
                              const KT* __restrict__ k_pool,
                              const KT* __restrict__ v_pool, OwnedWalk walk,
                              QT* __restrict__ out, float* __restrict__ lse,
                              float* __restrict__ part,
                              int* __restrict__ tickets, Shape a, int TK,
                              int LPK) {
  split_decode<QT, KT, GB, NCH, true, true>(
      q, k_pool, v_pool, out, lse, part, tickets, a, TK, LPK, walk);
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const int *tables, *positions, *owned;
  void* out;
  float *lse, *part;
  int* tickets;
  int B, n_blocks, bs, T;
  Shape a;
  cudaStream_t stream;
};

template <typename QT, typename KT, bool LSE>
struct Paged {
  template <int GB, int NCH>
  static int run(Args x) {
    const Launch ln = launch_shape<KT, GB>(x.a.D, x.a.splits);
    x.a.ids_off = (int)ln.smem;
    const size_t smem = ln.smem + sizeof(int) * (size_t)(x.a.L / x.bs);
    const dim3 grid(x.a.splits, x.a.K * x.a.groups, x.B);
    const QT* q = static_cast<const QT*>(x.q);
    const KT* kp = static_cast<const KT*>(x.k_pool);
    const KT* vp = static_cast<const KT*>(x.v_pool);
    QT* out = static_cast<QT*>(x.out);
    // above 48 KB shared memory is dynamic only, and per device: set on
    // every launch (a host-side attribute, no device work)
    cudaError_t e;
    if constexpr (LSE) {
      auto kern = paged_decode_lse_split_kernel<QT, KT, GB, NCH>;
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      kern<<<grid, THREADS, smem, x.stream>>>(
          q, kp, vp,
          OwnedWalk{{x.tables, x.positions, x.T, x.bs, x.n_blocks, x.a.K,
                     x.a.D},
                    x.owned},
          out, x.lse, x.part, x.tickets, x.a, ln.tk, ln.lpk);
    } else {
      auto kern = paged_decode_split_kernel<QT, KT, GB, NCH>;
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      kern<<<grid, THREADS, smem, x.stream>>>(
          q, kp, vp,
          TableWalk{x.tables, x.positions, x.T, x.bs, x.n_blocks, x.a.K,
                    x.a.D},
          out, x.part, x.tickets, x.a, ln.tk, ln.lpk);
    }
    return (int)cudaGetLastError();
  }
};

// one (q dtype, pool dtype) pair of the three the wrappers accept
template <bool LSE>
int dispatch(Args x, int q_dtype, int kv_dtype) {
  if (x.B == 0) return 0;
  const Shape& a = x.a;
  if (a.K <= 0 || a.H % a.K != 0 || a.D % 8 != 0 || a.D <= 0 ||
      a.D > MAX_D || x.bs <= 0 || x.T <= 0 || x.n_blocks <= 0 || a.L <= 0 ||
      a.L % x.bs != 0 || (x.T * x.bs + a.L - 1) / a.L > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int G = a.H / a.K;
  const int hpc = G < MAX_G ? G : MAX_G;
  x.a.splits = (x.T * x.bs + a.L - 1) / a.L;
  x.a.groups = (G + hpc - 1) / hpc;
  int (*fn)(Args) = nullptr;
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    fn = pick<Paged<bf16, bf16, LSE>, Vec<bf16>::N>(hpc, a.D);
  else if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    fn = pick<Paged<float, float, LSE>, Vec<float>::N>(hpc, a.D);
  else if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    fn = pick<Paged<float, bf16, LSE>, Vec<bf16>::N>(hpc, a.D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(x);
}

}  // namespace

// q (B, H, D); k_pool/v_pool (n_blocks, bs, K, D); tables (B, T) int32;
// positions (B,) int32; out (B, H, D) in q's dtype.  All contiguous.  L:
// walk positions a split, a multiple of bs, with splits = ceil(T * bs / L)
// <= 256; part: f32 scratch of B * K * groups * splits * min(H / K, 8) *
// (D + 2) floats, groups = ceil((H / K) / 8); tickets: B * K * groups
// int32, zero before the launch and left zero after it.  Any D % 8 == 0
// up to 512.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* positions, void* out, void* part, void* tickets, int B, int H,
    int K, int D, int n_blocks, int bs, int T, int L, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  return dispatch<false>(
      Args{q, k_pool, v_pool, tables, positions, nullptr, out, nullptr,
           static_cast<float*>(part), static_cast<int*>(tickets), B,
           n_blocks, bs, T, Shape{H, K, D, L, 0, 0, 0, scale},
           static_cast<cudaStream_t>(stream)},
      q_dtype, kv_dtype);
}

// The per-stripe form: pools are one stripe (nb_loc, bs, K, D); tables hold
// local ids, clipped into range where not owned; owned (B, T) int32,
// nonzero where this stripe holds the slot's block; out (B, H, D) in q's
// dtype; lse (B, H) f32; L, splits, part and tickets as above (the plan
// reads T * bs keys: the walk is at most that long).  All contiguous.
// Returns the cudaError_t.
extern "C" int paged_decode_attention_lse(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* positions, const int* owned, void* out, float* lse,
    void* part, void* tickets, int B, int H, int K, int D, int n_blocks,
    int bs, int T, int L, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  return dispatch<true>(
      Args{q, k_pool, v_pool, tables, positions, owned, out, lse,
           static_cast<float*>(part), static_cast<int*>(tickets), B,
           n_blocks, bs, T, Shape{H, K, D, L, 0, 0, 0, scale},
           static_cast<cudaStream_t>(stream)},
      q_dtype, kv_dtype);
}
