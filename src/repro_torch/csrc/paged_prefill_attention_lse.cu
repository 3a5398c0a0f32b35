// Paged chunked-prefill attention for Hopper (sm_90a), its owned/LSE form
// (kernel 3 over one stripe of the block-striped pool, returning o and lse):
// the C entry.  The bodies and their design: paged_prefill.cuh.
//
// Replaces the per-rank attention of the reference's sharded chunk prefill
// (src/repro/models/attention.py:677, _paged_prefill_core) over the Pallas
// kernel src/repro/kernels/paged_decode_attention.py:255.
#include "paged_prefill.cuh"

using namespace repro;

// The owned/LSE form over one stripe: k_pool/v_pool (n_blocks, bs, K, D)
// the stripe; tables (B, T) local ids clamped into it; owned (B, T) int32,
// nonzero where the stripe holds the slot's block; lse (B, C, H) f32.  The
// bf16 route splits each lane's owned walk into pieces of L keys (a
// multiple of 64; splits pieces, at most 16): part holds B * K * query
// tiles * splits partials of 128 * (D + 2) f32 and tickets B * K * query
// tiles counters, zero between launches.  The f32 route reads neither.
extern "C" int paged_prefill_attention_lse(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* starts, const int* owned, void* out, float* lse, float* part,
    int* tickets, int B, int C, int H, int K, int D, int n_blocks, int bs,
    int T, int L, int splits, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  const Args a{B, C, H, K, n_blocks, bs, T, scale, owned, lse, part, tickets,
               L, splits};
  return launch_form<true>(q, k_pool, v_pool, tables, starts, out, D,
                           q_dtype, kv_dtype, a, stream);
}
