// Paged chunked-prefill attention (kernel 3) for Hopper (sm_90a): the C
// entry of its plain form.  The bodies and their design: paged_prefill.cuh.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode_attention.py:255
// (paged_prefill_attention); paged_verify_attention (:308) is the same kernel
// with starts = positions.
#include "paged_prefill.cuh"

using namespace repro;

// q/out (B, C, H, D); k_pool/v_pool (n_blocks, bs, K, D); tables (B, T)
// int32; starts (B,) int32.  All contiguous.  Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* starts, void* out, int B, int C, int H, int K, int D,
    int n_blocks, int bs, int T, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  const Args a{B, C, H, K, n_blocks, bs, T, scale, nullptr, nullptr,
               nullptr, nullptr, 0, 0};
  return launch_form<false>(q, k_pool, v_pool, tables, starts, out, D,
                            q_dtype, kv_dtype, a, stream);
}

