// w8a8 int8 GEMM for Hopper (sm_90a) with per-row and per-column scales:
//     out[m, n] = ((float)(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n],
// x_q (M, K) int8 row-major, w_q (K, N) int8 row-major, sx (M) and sw (N)
// f32, out (M, N) bf16 (rounded once, __float2bfloat16_rn) or f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py:41
// (int8_matmul; kernel body _int8_mm_kernel, :21).
//
// What bounds it on the H100: 2*M*N*K integer operations against the
// card's 1979 dense int8 TOPS, and M*K + K*N + 2*M*N (bf16 out) bytes plus
// the scales against 3.35 TB/s.  A square GEMM of 4096 is bound by
// operations (0.069 ms against 0.020 ms of bytes); a MoE expert's GEMM
// at M = 256 rows (1536 x 512 weights) by bytes (1.44 MB, 0.43 us against
// 0.20 us of operations), where a launch is mostly its latency: few output
// tiles, each a long walk over K.
//
// Design.  The products run on Hopper's int8 tensor-core instruction,
// wgmma.mma_async m64n128k32.s32.s8.s8, int32 accumulators in registers.
// One CTA owns a 128 x 128 output tile and a range of K (its split), as
// three warpgroups: warpgroup 0 produces, warpgroups 1 and 2 consume, each
// the 64 rows of one wgmma M.  K comes in blocks of 128 bytes through a
// ring of NS = 4 stages in shared memory, each stage an x panel, a w panel
// and a staging buffer, handed over by two mbarriers a stage (full:
// the producers' 128 arrivals; empty: one arrival from each of the
// consumers' 8 warps once the stage's products have retired).
//
//   x (M, K) is K-major as it lies: its 128 x 128-byte block is copied by
//   cp.async straight into a panel of 128-byte rows in the 128-byte
//   swizzle (16-byte unit u of row r at u ^ (r mod 8)), which the wgmma
//   descriptor reads as A.
//   w (K, N) is N-major, and int8 wgmma takes both operands K-major only
//   (the transpose bit exists for 16-bit types alone).  So its block is
//   copied by cp.async into a staging buffer (row k, 128 bytes of n; unit
//   u of row k at u ^ (k/4 mod 8)), and once it has landed the producers
//   transpose it in registers: each thread reads 4 x 4-byte blocks (4
//   words, 4 k rows of 4 n), turns them with 8 __byte_perm into 4 words of
//   4 k each, and stores them into the B panel (row n, 128 bytes of k, the
//   128-byte swizzle).  A warp's 32 reads of a block hit 32 banks (the
//   staging swizzle), its stores 16 (2 ways).
//
// The producers keep three blocks in flight ahead of the one they
// transpose, so copies, the transposition and the consumers' products of
// the previous block overlap; the consumers keep one block's products in
// flight while they wait for the next.  The copies and the transposed
// stores are generic-proxy writes that wgmma reads through the async
// proxy: each producer fences the proxies before it arrives on the full
// barrier.  Copies are as wide as the rows' alignment allows, for x (by
// K) and w (by N) each: 16 bytes (cp.async.cg) when the row length and the
// base pointer are multiples of 16, else 8 or 4 (cp.async.ca), else single
// bytes (plain loads and stores); a copy past M, N or the split's end of K
// reads nothing and writes zeros (cp.async's src-size 0), and zeros add
// exactly 0.  So any M, N and K.
//
// Split-K.  When the output has few tiles, as a MoE expert's GEMM, the
// wrapper's plan (int8_split_plan, from shapes alone) splits K into
// ``splits`` ranges of whole blocks, one CTA each (grid: N tiles, M tiles,
// splits).  Every split writes its int32 tile to scratch the wrapper
// allocates, in the accumulators' own order (each consumer thread 16
// int4, coalesced), fences, and takes a ticket on the tile's counter; the
// last one adds the other splits' partials to its own registers (integer
// sums: exact in any order), runs the epilogue and resets the counter to 0
// for the next launch.  The counters are the split decode kernels' (one
// buffer per device and stream, kept at 0 between launches).
//
// Epilogue: each int32 sum converts to f32 (round to nearest,
// __int2float_rn), times sx[m], times sw[n], one rounding to the output
// type: the plain version's sequence of operations, so the kernel is
// bit-exact against it at every shape and split.
//
// Shared memory: 4 stages x 48 KB + 1 KB for the 1024-byte alignment the
// swizzle needs (197,632 bytes of dynamic shared memory), one CTA an SM;
// 384 threads.
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int TM = 128;               // output rows per CTA: 2 x wgmma M
constexpr int TN = 128;               // output columns per CTA: wgmma N
constexpr int TK = 128;               // bytes of K per block (one panel row)
constexpr int NS = 4;                 // stages in the ring
constexpr int LAG = NS - 1;           // blocks in flight ahead of the one
                                      // being transposed
constexpr int PANEL = TM * TK;        // 16 KB
constexpr int STAGE = 3 * PANEL;      // x panel, w panel, w staging
constexpr int SMEM_BYTES = NS * STAGE + 1024;
constexpr int PRODUCERS = 128;
constexpr int CONSUMERS = 256;
constexpr int I8_THREADS = PRODUCERS + CONSUMERS;
constexpr int ACC = TN / 2;           // int32 accumulators per thread

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

#define R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define R8(i) R4(i), R4(i + 4)

// d (64 x 128, s32) += A (64 x 32) B (128 x 32)^T, int8, both from shared
// memory, K-major
__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef R8
#undef R4

template <int N>
__device__ __forceinline__ void fence_iregs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// V bytes global -> shared at byte ``off`` of the panel at ``dst`` (its
// generic address ``gdst``); with ``in`` false the V bytes are zeros and
// nothing is read
template <int V>
__device__ __forceinline__ void copy(uint32_t dst, unsigned char* gdst,
                                     uint32_t off, const int8_t* src,
                                     bool in) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + off),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else if constexpr (V == 8 || V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     dst + off),
                 "l"(src), "n"(V), "r"(in ? V : 0)
                 : "memory");
  } else {
    gdst[off] = in ? (unsigned char)*src : 0;
  }
}

// byte offset of byte ``col`` of row ``row`` in a 128-byte-row panel whose
// 16-byte units are swizzled by ``phase``
__device__ __forceinline__ uint32_t swz(int row, int col, int phase) {
  return (uint32_t)(row * 128 + ((((col >> 4) ^ phase) & 7) << 4) +
                    (col & 15));
}

// x[m0:m0+128, kb:kb+128] (zero past M and k_hi) into the A panel
template <int V>
__device__ __forceinline__ void load_x(uint32_t dst, unsigned char* gdst,
                                       const int8_t* __restrict__ x, int M,
                                       int K, int m0, int kb, int k_hi,
                                       int ptid) {
  constexpr int PER_ROW = TK / V;
#pragma unroll 4
  for (int c = ptid; c < TM * PER_ROW; c += PRODUCERS) {
    const int row = c / PER_ROW, col = c % PER_ROW * V;
    const int m = m0 + row, k = kb + col;
    const bool in = m < M && k < k_hi;
    copy<V>(dst, gdst, swz(row, col, row & 7),
            in ? x + (size_t)m * K + k : x, in);
  }
}

// w[kb:kb+128, n0:n0+128] (zero past k_hi and N) into the staging buffer
template <int V>
__device__ __forceinline__ void load_w(uint32_t dst, unsigned char* gdst,
                                       const int8_t* __restrict__ w, int N,
                                       int n0, int kb, int k_hi, int ptid) {
  constexpr int PER_ROW = TN / V;
#pragma unroll 4
  for (int c = ptid; c < TK * PER_ROW; c += PRODUCERS) {
    const int kk = c / PER_ROW, col = c % PER_ROW * V;
    const int k = kb + kk, n = n0 + col;
    const bool in = k < k_hi && n < N;
    copy<V>(dst, gdst, swz(kk, col, kk >> 2),
            in ? w + (size_t)k * N + n : w, in);
  }
}

// the copy width is uniform over the launch: one branch per block
__device__ __forceinline__ void load_block(
    int vx, int vw, uint32_t stage, unsigned char* gstage,
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
    int K, int m0, int n0, int kb, int k_hi, int ptid) {
  const uint32_t xs = stage, st = stage + 2 * PANEL;
  unsigned char* gx = gstage;
  unsigned char* gs = gstage + 2 * PANEL;
  switch (vx) {
    case 16: load_x<16>(xs, gx, x, M, K, m0, kb, k_hi, ptid); break;
    case 8: load_x<8>(xs, gx, x, M, K, m0, kb, k_hi, ptid); break;
    case 4: load_x<4>(xs, gx, x, M, K, m0, kb, k_hi, ptid); break;
    default: load_x<1>(xs, gx, x, M, K, m0, kb, k_hi, ptid); break;
  }
  switch (vw) {
    case 16: load_w<16>(st, gs, w, N, n0, kb, k_hi, ptid); break;
    case 8: load_w<8>(st, gs, w, N, n0, kb, k_hi, ptid); break;
    case 4: load_w<4>(st, gs, w, N, n0, kb, k_hi, ptid); break;
    default: load_w<1>(st, gs, w, N, n0, kb, k_hi, ptid); break;
  }
}

// the staged w block (row k, 128 bytes of n) into the K-major B panel (row
// n, 128 bytes of k): 1024 blocks of 4 k x 4 n bytes, 8 per producer
__device__ __forceinline__ void transpose_w(uint32_t stg, uint32_t bp,
                                            int ptid) {
  const int warp = ptid >> 5, lane = ptid & 31;
  const int lk = lane >> 2, nwl = lane & 3;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int kq = 8 * (it & 3) + lk;                 // k 4kq .. 4kq + 3
    const int nw = 4 * (2 * warp + (it >> 2)) + nwl;  // n 4nw .. 4nw + 3
    uint32_t in[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)   // byte b of in[i]: w[4kq + i][4nw + b]
      in[i] = lds32(stg + swz(4 * kq + i, 4 * nw, kq));
    const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
    const uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);
    const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
    const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
    const uint32_t out[4] = {__byte_perm(t0, t2, 0x5410),
                             __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410),
                             __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // byte i of out[j]: w[4kq + i][4nw + j]
      const int n = 4 * nw + j;
      sts32(bp + swz(n, 4 * kq, n), out[j]);
    }
  }
}

template <typename TOut>
__device__ __forceinline__ void store_pair(TOut* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename TOut> __device__ __forceinline__ TOut cast_out(float v);
template <> __device__ __forceinline__ float cast_out<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 cast_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc[4 j + 2 i + c] is row r0 + 8 i, column c0 + 8 j + c
template <typename TOut>
__device__ __forceinline__ void epilogue(const int* acc,
                                         const float* __restrict__ sx,
                                         const float* __restrict__ sw,
                                         TOut* __restrict__ out, int M, int N,
                                         int r0, int c0) {
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = r0 + 8 * i;
    if (m >= M) continue;
    const float s_m = sx[m];
    TOut* row = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {
      const int n = c0 + 8 * j;
      if (n >= N) break;
      const float a = __fmul_rn(
          __fmul_rn(__int2float_rn(acc[4 * j + 2 * i]), s_m), sw[n]);
      if (n + 1 < N) {
        const float b = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[4 * j + 2 * i + 1]), s_m),
            sw[n + 1]);
        if (pairs) {
          store_pair<TOut>(row + n, a, b);
        } else {
          row[n] = cast_out<TOut>(a);
          row[n + 1] = cast_out<TOut>(b);
        }
      } else {
        row[n] = cast_out<TOut>(a);
      }
    }
  }
}

__global__ void __launch_bounds__(I8_THREADS, 1)
int8_mm_wgmma(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ sx, const float* __restrict__ sw,
              void* __restrict__ out, int4* __restrict__ part,
              int* __restrict__ tickets, int M, int N, int K, int k_split,
              int vx, int vw, bool out_f32) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NS];   // full[s], empty[s]
  __shared__ int ticket;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full = smem_u32(&bars[0]);
  const uint32_t empty = smem_u32(&bars[NS]);

  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k_lo = split * k_split;
  const int k_hi = min(K, k_lo + k_split);
  const int n_k = k_hi > k_lo ? (k_hi - k_lo + TK - 1) / TK : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, PRODUCERS);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < PRODUCERS) {
    // producers: copy block i, transpose block i - LAG; a cp.async group
    // is committed every turn (empty past the last block), so "block t has
    // landed" is always "at most LAG - 1 groups pending"
    for (int i = 0; i < n_k + LAG; ++i) {
      if (i >= LAG) {
        const int t = i - LAG;
        const uint32_t stage = base + t % NS * STAGE;
        cp_async_wait<LAG - 1>();
        named_sync(1, PRODUCERS);      // every producer's copies of t
        transpose_w(stage + 2 * PANEL, stage + PANEL, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + 8 * (t % NS));
      }
      if (i < n_k) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(empty + 8 * s, (uint32_t)(i / NS - 1) & 1u);
        load_block(vx, vw, base + s * STAGE, gbase + s * STAGE, x, w, M, N,
                   K, m0, n0, k_lo + i * TK, k_hi, tid);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    return;
  }

  // consumers: warpgroup g owns rows 64 g .. 64 g + 63 of the tile
  const int ct = tid - PRODUCERS;
  const int g = ct >> 7;
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  int acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;
  for (int t = 0; t < n_k; ++t) {
    const int s = t % NS;
    mbar_wait(full + 8 * s, (uint32_t)(t / NS) & 1u);
    const uint32_t xa = base + s * STAGE + g * 64 * TK;
    const uint32_t wb = base + s * STAGE + PANEL;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 32; ++kk)
      wgmma_s8_n128(acc, desc(xa + 32 * kk, 16, 8 * TK, 1),
                    desc(wb + 32 * kk, 16, 8 * TK, 1));
    wgmma_commit();
    wgmma_wait1();                     // block t - 1's products retired
    if (t > 0 && lane == 0) mbar_arrive(empty + 8 * ((t - 1) % NS));
  }
  wgmma_wait();
  fence_iregs<ACC>(acc);

  if (splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int tiles = gridDim.x * gridDim.y;
    int4* mine = part + (size_t)(split * tiles + tile) * (ACC / 4) * CONSUMERS;
#pragma unroll
    for (int q = 0; q < ACC / 4; ++q)
      mine[q * CONSUMERS + ct] =
          make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                    acc[4 * q + 3]);
    // the ticket: this split's partial is visible device-wide before the
    // counter moves
    __threadfence();
    named_sync(2, CONSUMERS);
    if (ct == 0) ticket = atomicAdd(&tickets[tile], 1);
    named_sync(2, CONSUMERS);
    if (ticket != splits - 1) return;
    __threadfence();
    for (int z = 0; z < splits; ++z) {
      if (z == split) continue;
      const int4* other =
          part + (size_t)(z * tiles + tile) * (ACC / 4) * CONSUMERS;
#pragma unroll
      for (int q = 0; q < ACC / 4; ++q) {
        const int4 v = __ldcg(other + q * CONSUMERS + ct);
        acc[4 * q] += v.x;
        acc[4 * q + 1] += v.y;
        acc[4 * q + 2] += v.z;
        acc[4 * q + 3] += v.w;
      }
    }
    if (ct == 0) tickets[tile] = 0;    // ready for the next launch
  }

  const int r0 = m0 + 64 * g + 16 * warp + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
  if (out_f32)
    epilogue<float>(acc, sx, sw, static_cast<float*>(out), M, N, r0, c0);
  else
    epilogue<bf16>(acc, sx, sw, static_cast<bf16*>(out), M, N, r0, c0);
}

// the widest copy (16, 8, 4 or 1 bytes) that rows of ``len`` bytes from
// ``p`` allow
int width(const void* p, int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v >= 4; v /= 2)
    if (len % v == 0 && a % v == 0) return v;
  return 1;
}

}  // namespace

// out_dtype: DT_F32 or DT_BF16 (common.cuh).  K is split into ``splits``
// ranges of ``k_split`` bytes (a multiple of 128; the last may be short,
// none empty); with splits > 1, ``part`` holds splits x tiles x 128 x 128
// int32 and ``tickets`` one int32 per 128 x 128 output tile, 0 on entry
// and left 0.  Returns a cudaError_t.
extern "C" int int8_matmul(const void* x, const void* w, const void* sx,
                           const void* sw, void* out, void* part,
                           void* tickets, int M, int N, int K, int splits,
                           int k_split, int out_dtype, void* stream) {
  if (M < 0 || N < 0 || K < 0 || splits < 1 || k_split < TK ||
      k_split % TK != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  if (out_dtype != DT_F32 && out_dtype != DT_BF16)
    return (int)cudaErrorInvalidValue;
  const int needed = K == 0 ? 1 : (K + k_split - 1) / k_split;
  if (splits != needed || (splits > 1 && (part == nullptr ||
                                          tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
  if (grid.y > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB shared memory is dynamic only, and per device: set on
  // every launch (a host-side attribute, no device work)
  const cudaError_t err = cudaFuncSetAttribute(
      int8_mm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int8_mm_wgmma<<<grid, I8_THREADS, SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw), out,
      static_cast<int4*>(part), static_cast<int*>(tickets), M, N, K, k_split,
      width(x, K), width(w, N), out_dtype == DT_F32);
  return (int)cudaGetLastError();
}
