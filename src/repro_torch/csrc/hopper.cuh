// Hopper (sm_90a) building blocks shared by the tensor-core attention
// kernels (flash_attention.cu, flash_attention_bwd.cu, paged_prefill.cuh):
// the tile shapes and their shared-memory panels per head dim, mbarriers,
// TMA loads and the host-side tensor maps they read through, wgmma
// descriptors and instructions, and the P V product that takes P from
// registers.  See flash_attention.cu's note for the layouts.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace repro {

constexpr int BQ = 128;               // query rows per CTA: 2 warpgroups
constexpr int BK = 64;                // keys per tile
constexpr int NST = 2;                // K/V stages in the ring
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {                      // element strides of (B, H, S); D is 1
  long long b, h, s;
};

template <int D>
struct Tiles {
  static constexpr int E = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int SW = 2 * E;    // bytes per swizzled row of a panel
  static constexpr int NB = D / E;    // panels per tile
  static constexpr int MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // desc
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int SMEM = Q_BYTES + NST * 2 * KV_BYTES + 1024;  // + align
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  static_assert(D % 16 == 0 && Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0,
                "panels must start on 1024 bytes");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t phase) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(phase)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity ``phase`` to complete.  A copy that never
// lands (a fault in a tensor map) traps after 2 s instead of hanging the
// card: the launch then fails with an error the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  if (mbar_try_wait(bar, phase)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, phase)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 2000000000ull) __trap();
  }
}

// one box of a 4-d tensor map (D, S, heads, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s), "r"(h),
      "r"(b)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units), swizzle mode (1: 128B, 2: 64B, 3: 32B)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)mode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define R8(i) R4(i), R4(i + 4)

// d (64 x 64, f32) {=, +=} A (64 x 16) B (16 x 64)^T, both from shared
// memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 pairs in registers) B (16 x N) from
// shared memory, MN-major (the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : R8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef R8
#undef R4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// O[:, N0:] += P V[:, N0:] for one k16 step of keys whose V rows start at
// ``sv``: wgmma pieces of at most 64 columns, each starting on a panel
template <int D, int N0>
__device__ __forceinline__ void pv(float* oacc, const uint32_t* a,
                                   uint32_t sv) {
  if constexpr (N0 < D) {
    using T = Tiles<D>;
    constexpr int N = D - N0 >= 64 ? 64 : D - N0;
    static_assert(N0 % T::E == 0, "a piece starts on a panel");
    wgmma_rs<N>(oacc + N0 / 2, a,
                desc(sv + N0 / T::E * BK * T::SW, BK * T::SW, 8 * T::SW,
                     T::MODE));
    pv<D, N0 + N>(oacc, a, sv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d map over (D, S, heads, B) of bf16 with boxes of E x rows, swizzled
// at 2 E bytes; rows and keys past S read as zeros.  A dimension of size 1
// takes a stride of 16 bytes: its coordinate is always 0.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int D, int S,
                       int heads, int B, Strides st, int E, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)st.s * 2 : 16,
                                 heads > 1 ? (cuuint64_t)st.h * 2 : 16,
                                 B > 1 ? (cuuint64_t)st.b * 2 : 16};
  const cuuint32_t box[4] = {(cuuint32_t)E, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      E == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : E == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace repro
