// GQA flash attention (forward) for Hopper (sm_90a): prompt prefill over
// all earlier keys (causal), or over every key (bidirectional: the encoder),
// and in either form optionally over a window W > 0 of the latest keys
// (query q sees key k iff k > q - W, and k <= q when causal).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:79
// (flash_attention; kernel body _flash_kernel, :27) in every form: causal
// or not, with and without its window.
//
// What bounds it on the H100: the least time is bytes below S ~ 1200 and
// operations above.  Causal attention does 4*D flops per (query, key) pair
// on the lower triangle, 2*D*S^2 per (batch, head), against 8*S*D bytes of
// bf16 q/k/v/o: S/4 flops per byte, which passes the card's ~295 flops per
// byte (989 TFLOP/s over 3.35 TB/s) near S = 1200; bidirectional attention
// sees every pair, twice the flops, and passes it near S = 600.  With a
// window W the pairs are S*W - W*(W-1)/2 when causal (for S > W): the work
// grows as S*W, not S^2.  Both products therefore belong on the tensor
// cores, and the bf16 kernel below runs them there.
//
// bf16: wgmma tiles fed by TMA (flash_kernel_wgmma).  One CTA owns a
// 128-row query tile of one (batch, head): two warpgroups of 128 threads,
// each the 64 rows of one wgmma M.  Q comes by one TMA load and stays in
// shared memory for the whole key loop.  Key tiles of 64 rows (K and V,
// each with its own mbarrier) come by TMA into a ring of 2 stages: thread 0
// issues tile t + 2 into a stage as soon as both warpgroups have left tile
// t (a __syncthreads), so the next tile's copy overlaps this tile's
// products.  Per key tile a warpgroup computes
//   S = Q K^T   wgmma m64n64k16, A = Q and B = the K tile from shared
//               memory, both K-major as they lie (D contiguous);
//   the online softmax in f32 on the accumulator fragment (each thread
//   holds 2 rows x 16 keys; the row max meets over its quad by 2 shuffles,
//   the row sum stays per thread until the end);
//   O += P V    wgmma m64nNk16 with A = P from registers (the accumulator
//               fragment of S is the A fragment of PV, so P is only packed
//               to bf16 pairs) and B = the V tile from shared memory with
//               the transpose bit (V is keys x D, D contiguous: MN-major);
//               N is D in pieces of at most 64 (80 = 64 + 16, 96 = 64 + 32).
// O is an f32 accumulator of 64 x D per warpgroup in registers, divided by
// the row sum and written with plain 4-byte stores of the rows below S.
// P is the unnormalised exp(s - m) of the running max rounded to bf16
// before PV; the plain version rounds the normalised P instead (as the
// reference model's _attn_block does, src/repro/models/attention.py:175),
// a difference within the bf16 tolerance.  (The Pallas kernel casts v to
// f32 at flash_attention.py:53, so its p.astype(v.dtype) does not round.)
//
// Shared memory layout and swizzle.  Each operand tile is stored as D / E
// panels of rows x E elements, one TMA box each, E the widest of 64, 32,
// 16 that divides D: 128-byte swizzle for D in {64, 128, 256} (one, two or
// four panels), 64-byte for 32 and 96 (one or three), 32-byte for 16 and 80
// (one or five).  D is never padded with products.  A wgmma descriptor
// names the panel's swizzle; along D (the K of QK^T) a k16 step that stays
// inside a panel advances the start address by 32 bytes, one that enters
// the next panel moves to it; for V the 8-key groups lie 8*E*2 bytes apart
// (the descriptor's stride offset) and the panels BK*E*2 bytes apart (its
// leading offset).  Every panel starts on 1024 bytes, so the swizzle phase
// TMA writes is the one wgmma reads.  The three maps over (D, S, heads, B)
// are encoded on the host per call from the strides the wrapper passes
// (tensor_map in hopper.cuh: cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, no -lcuda), so
// the model's (B, S, H, D) activations are read in place; rows and keys
// past S arrive as zeros (TMA's out-of-bounds fill).
//
// Masks and skips.  When causal a CTA stops at the diagonal (the
// reference's @pl.when skip); with a window it starts at the key tile
// holding q0 - W + 1 (its second skip).  A warpgroup skips a tile that no
// row of its own sees, and masks per element only a tile that straddles a
// bound of one of its rows: kmin < kpos <= kmax, kmax = q (causal) or S - 1
// (bidirectional: a zero-filled key past S would score 0 and take weight
// exp(0 - m)), kmin = q - W.  A masked key adds exactly 0 (p = 0, not
// exp(s - m), which is exp(0) = 1 while a row's running max is still the
// finite sentinel -1e30).  A window >= S changes neither the tiles walked
// nor the arithmetic of any row below S, so it gives the unwindowed
// output bit for bit.
//
// f32: the CUDA-core kernel (flash_kernel_f32).  Tensor cores in f32 are
// TF32, ~3 decimal digits, which the f32 compute plans cannot take (they
// hold kernel against plain at 1e-4 of the logits).  So f32 keeps the
// first design: 256 threads, 4 per query row over a 64-row tile, f32 FMAs
// over f32 copies of 32-key tiles (16 at D = 256) in shared memory.  The
// choice is by dtype alone; nothing falls back from one kernel to the
// other.
//
// The training forward.  Given an lse pointer (flash_attention_lse), each
// query row's log-sum-exp of its scaled scores is written there, f32
// (B, H, S), for the backward (flash_attention_bwd.cu) to recompute P
// from: lane 0 of a row's quad writes (m + log2 l) ln 2 in the wgmma
// kernel, whose m and l are in units of log2; the row's first thread
// writes m + log l in the f32 kernel.  The serve paths pass null and pay
// one branch at the end.
//
// Registers and shared memory per instantiation, as ptxas -v reports them
// for sm_90a (CUDA 12.8), D = 16 / 32 / 64 / 80 / 96 / 128 / 256:
//   wgmma: 89 / 95 / 109 / 124 / 128 / 128 / 225 registers, no spill but a
//          104-byte one at D = 128, where __launch_bounds__(256, 2) holds
//          it to 128 registers for two CTAs an SM (ptxas then serialises
//          the wgmmas for want of registers); 48 bytes of static shared
//          memory (the mbarriers) and 768 D + 1024 bytes of dynamic (Q,
//          two K/V stages, the 1024-byte alignment): 13,312 at D = 16 to
//          197,632 at D = 256.
//   f32:   64 / 79 / 110 / 113 / 127 / 128 / 254 registers, no spill;
//          4,096 / 8,192 / 16,384 / 20,480 / 24,576 / 32,768 / 32,768
//          bytes of static shared memory.
#include <cuda.h>

#include "hopper.cuh"

namespace {

using namespace repro;

constexpr float LN2 = 0.6931471805599453f;   // lse: log2 units -> natural

struct Args {                         // one launch's shape and flags
  int B, H, K, S, window;
  bool causal;
  Strides qs, ks, vs, os;
  float scale;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;                  // query rows per CTA
constexpr int F32_TPR = 4;                  // threads per query row
constexpr int F32_THREADS = F32_BQ * F32_TPR;

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int K, int S, int window,
                 bool causal, Strides qs, Strides ks_, Strides vs_,
                 Strides os, float scale) {
  constexpr int BK = D > 128 ? 16 : 32;  // keys per tile
  constexpr int DPT = D / F32_TPR;    // head dims per thread
  constexpr int VEC = Vec<float>::N;
  constexpr int VPR = D / VEC;        // 16-byte vectors per key row
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int q0 = blockIdx.x * F32_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = (int)((long long)h * K / H);
  const int tid = threadIdx.x;
  const int row = tid / F32_TPR;
  const int c = tid % F32_TPR;
  const int qpos = q0 + row;
  const bool valid = qpos < S;

  float qr[DPT], acc[DPT];
  const float* qp = q + b * qs.b + h * qs.h + (long long)qpos * qs.s;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = valid ? qp[c + F32_TPR * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const float* kb = k + b * ks_.b + kh * ks_.h;
  const float* vb = v + b * vs_.b + kh * vs_.h;
  // the row sees keys kmin < kpos <= kmax: the causal bound, or the last
  // key (a zero key past S would score 0, not be masked); the window's
  const int kmax = causal ? qpos : S - 1;
  const int kmin = window > 0 ? qpos - window : -1;
  // causal: later keys are above the diagonal
  const int k_end = causal ? min(S, q0 + F32_BQ) : S;
  // with a window, earlier keys are outside every row's window
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                  // the previous tile's readers are done
    for (int i = tid; i < BK * VPR; i += F32_THREADS) {
      const int t = i / VPR;
      const int cc = (i - t * VPR) * VEC;
      const int kpos = k0 + t;
      float kv[VEC], vv[VEC];
      if (kpos < S) {
        Vec<float>::load(kb + (long long)kpos * ks_.s + cc, kv);
        Vec<float>::load(vb + (long long)kpos * vs_.s + cc, vv);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kv[j] = vv[j] = 0.f;
      }
      *reinterpret_cast<float4*>(&ks[t][cc]) =
          make_float4(kv[0], kv[1], kv[2], kv[3]);
      *reinterpret_cast<float4*>(&vs[t][cc]) =
          make_float4(vv[0], vv[1], vv[2], vv[3]);
    }
    __syncthreads();

    float s[BK];
    unsigned live = 0u;               // bit t: key k0 + t is seen by the row
    float m_tile = NEG_INF;
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[t][c + F32_TPR * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = k0 + t;
      const bool seen = kpos > kmin && kpos <= kmax;
      live |= (unsigned)seen << t;
      s[t] = seen ? part * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[t]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    float l_tile = 0.f;
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      const float p = (live >> t & 1u) ? expf(s[t] - m_new) : 0.f;
      l_tile += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += p * vs[t][c + F32_TPR * i];
    }
    l = l * corr + l_tile;
    m = m_new;
  }

  if (valid) {
    float* op = o + b * os.b + h * os.h + (long long)qpos * os.s;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[c + F32_TPR * i] = acc[i] * inv;
    // the training forward: the row's log-sum-exp for the backward
    if (lse != nullptr && c == 0)
      lse[((long long)b * H + h) * S + qpos] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const Args& a, cudaStream_t stream) {
  const dim3 grid((a.S + F32_BQ - 1) / F32_BQ, a.H, a.B);
  flash_kernel_f32<D><<<grid, F32_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, a.H, a.K,
      a.S,
      a.window, a.causal, a.qs, a.ks, a.vs, a.os, a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma tiles fed by TMA (helpers in hopper.cuh)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, Tiles<D>::MIN_BLOCKS)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ o, float* __restrict__ lse,
                   Strides os, int H, int K, int S, int window, bool causal,
                   float scale_log2) {
  using T = Tiles<D>;
  constexpr int E = T::E, SW = T::SW, NB = T::NB, MODE = T::MODE;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * NST];  // q; k, v per stage

  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + T::Q_BYTES;     // stage s: K, then V
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_kv = smem_u32(&bars[1]);  // + 16 s (K), + 16 s + 8 (V)

  const int n_qt = (S + BQ - 1) / BQ;
  // causal: the longest rows first, so the last wave is the short tiles
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = (int)((long long)h * K / H);
  const int tid = threadIdx.x;

  // causal: later keys are above the diagonal; with a window, earlier keys
  // are outside every row's window
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  auto load_kv = [&](int t) {
    const int s = t % NST;
    const int k0 = k_begin + t * BK;
    const uint32_t dk = skv + s * 2 * T::KV_BYTES;
    const uint32_t bk = bar_kv + 16 * s;
    mbar_expect(bk, T::KV_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p)
      tma_load(dk + p * BK * SW, &kmap, bk, p * E, k0, kh, b);
    mbar_expect(bk + 8, T::KV_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p)
      tma_load(dk + T::KV_BYTES + p * BK * SW, &vmap, bk + 8, p * E, k0, kh,
               b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < 2 * NST; ++i) mbar_init(bar_kv + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar_q, T::Q_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p)
      tma_load(sq + p * BQ * SW, &qmap, bar_q, p * E, q0, h, b);
    for (int t = 0; t < min(NST, n_tiles); ++t) load_kv(t);
  }

  const int g = tid / 128;            // warpgroup: rows 64 g .. 64 g + 63
  const int w = tid % 128 / 32;       // warp: 16 of those rows
  const int lane = tid % 32;
  const int rlo = q0 + 64 * g;        // the warpgroup's rows, clamped to S
  const int rhi = min(rlo + 63, S - 1);
  const bool rows = rlo < S;
  // the rows whose keys this warpgroup's tiles are tested against: every
  // row sees kmin < kpos <= kmax; kmax is nondecreasing in the row, kmin too
  const int kmax_lo = causal ? rlo : S - 1;
  const int kmax_hi = causal ? rhi : S - 1;
  // this thread's rows r0 and r0 + 8 of the accumulator fragments, and its
  // keys 2 (lane % 4) + {0, 1} of each 8-key column group
  const int r0 = rlo + 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);
  int kmax[2], kmin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kmax[i] = causal ? r0 + 8 * i : S - 1;
    kmin[i] = window > 0 ? r0 + 8 * i - window : -1;
  }

  float oacc[D / 2];                  // O: 64 x D per warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  if (rows) mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % NST;
    const uint32_t ph = (uint32_t)(t / NST) & 1u;
    const int k0 = k_begin + t * BK;
    const uint32_t sk = skv + s * 2 * T::KV_BYTES;
    const uint32_t sv = sk + T::KV_BYTES;
    const uint32_t bk = bar_kv + 16 * s;
    // warpgroup-uniform: does any row see a key of the tile; do all rows
    // see all of them
    const bool any = rows && k0 <= kmax_hi &&
                     (window == 0 || k0 + BK - 1 > rlo - window);
    const bool full = k0 + BK - 1 <= kmax_lo &&
                      (window == 0 || k0 > rhi - window);
    if (any) {
      mbar_wait(bk, ph);
      float sacc[32];                 // S: 64 x 64 per warpgroup
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk * 16 / E;    // the panel, and 32 bytes a k16 step
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
      // key k0 + 8 j + c0 + c
      uint32_t live = 0xffffffffu;
      if (!full) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kpos = k0 + 8 * j + c0 + c;
              if (!(kpos > kmin[i] && kpos <= kmax[i]))
                live &= ~(1u << (4 * j + 2 * i + c));
            }
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
      uint32_t pa[16];                // P as bf16 pairs: the A fragments
#pragma unroll
      for (int e = 0; e < 16; ++e) pa[e] = pack_bf16(sacc[2 * e], sacc[2 * e + 1]);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) oacc[e] *= corr[e / 2 % 2];

      mbar_wait(bk + 8, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pv<D, 0>(oacc, pa + 4 * kk, sv + kk * 16 * SW);
      wgmma_commit();
      wgmma_wait();
      fence_regs<D / 2>(oacc);
    } else if (tid == 0) {
      // no row of warpgroup 0 reads this tile: still see its copies land
      // before the stage is refilled or the CTA exits
      mbar_wait(bk, ph);
      mbar_wait(bk + 8, ph);
    }
    __syncthreads();                  // both warpgroups are done with stage s
    if (tid == 0 && t + NST < n_tiles) load_kv(t + NST);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  // the training forward: each row's natural log-sum-exp (m and l are in
  // units of log2) for the backward
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < S)
        lse[((long long)b * H + h) * S + r] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * LN2;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= S) continue;
    bf16* op = o + b * os.b + h * os.h + (long long)r * os.s + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          oacc[4 * j + 2 * i] * inv[i], oacc[4 * j + 2 * i + 1] * inv[i]);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const Args& a, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, D, a.S, a.H, a.B, a.qs, T::E, BQ) ||
      !tensor_map(&km, k, D, a.S, a.K, a.B, a.ks, T::E, BK) ||
      !tensor_map(&vm, v, D, a.S, a.K, a.B, a.vs, T::E, BK))
    return (int)cudaErrorInvalidValue;
  // above 48 KB shared memory is dynamic only, and per device: set on
  // every launch (a host-side attribute, no device work)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  flash_kernel_wgmma<D><<<grid, THREADS, T::SMEM, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), lse, a.os, a.H, a.K, a.S, a.window,
      a.causal, a.scale * LOG2E);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, void*,
                         float*, const Args&, cudaStream_t);

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

// q/o (B, H, S, D), k/v (B, K, S, D), each given by its (B, H, S) element
// strides with a unit stride on D; causal != 0 attends keys k <= q only,
// causal == 0 every key; window 0 sets no lower bound, a window W > 0 keeps
// keys k > q - W.  bf16 runs on the tensor cores, f32 on the CUDA cores.
// With lse non-null (the training forward) each query row's log-sum-exp of
// its scaled scores is written there, f32 (B, H, S) contiguous; the serve
// paths pass null.  Returns the cudaError_t of the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H, int K,
    int S, int D, int causal, int window, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int dtype, void* lse,
    void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (dtype != DT_BF16 && dtype != DT_F32) return (int)cudaErrorInvalidValue;
  const LaunchFn launch = launcher(dtype == DT_BF16, D);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{B, H, K, S, window, causal != 0, {q_sb, q_sh, q_ss},
               {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
               scale};
  return launch(q, k, v, o, static_cast<float*>(lse), a,
                static_cast<cudaStream_t>(stream));
}
