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
// sees every pair, twice the flops, and passes it near S = 600.  This
// first kernel runs on the CUDA cores (f32 FMA, ~67 TFLOP/s at best), so
// in practice it is bound by operations at every prompt length the engine
// serves; wgmma tiles are later work.  With a window W the pairs are S*W -
// W*(W-1)/2 when causal (for S > W): the work grows as S*W, not S^2.
//
// Design.  On the TPU the grid is (B, H, q block, k block) with the k axis
// walked in order, carrying (m, l, acc) in VMEM scratch.  Here one CTA owns
// one 64-row query tile of one (batch, head) and loops over key tiles
// itself: when causal it stops at the diagonal, so tiles strictly above it
// are never read (the reference's @pl.when skip); bidirectional it walks
// to S.  With a window the loop starts at the tile holding key q0 - W + 1,
// the first key the CTA's first row sees: tiles wholly before every row's
// window are never read either (the reference's second skip).  Later rows
// of the tile see fewer of those leading keys, so a row can meet whole
// tiles outside its window while its running max is still the finite
// sentinel -1e30; a masked key therefore adds exactly 0 to l and acc (p is
// set to 0, not exp(s - m), which would be exp(0) = 1 there).  Four threads
// share a query row; each holds a quarter of q and of the f32 accumulator
// in registers, with the head dim interleaved (d = c + 4*i) so the
// shared-memory reads of a key or value row are conflict-free.  Partial
// dot products meet by two warp shuffles.  The online softmax runs in f32
// and P is rounded to v's dtype before the PV product, as the reference
// model's _attn_block does (src/repro/models/attention.py:175); that rounds
// the normalised softmax, while here the unnormalised exp(s - m) of the
// running max is rounded.  (The Pallas kernel casts v to f32 at
// flash_attention.py:53, so its p.astype(v.dtype) does not round.)  q/k/v/o
// are read and written through their strides, so the model's (B, S, H, D)
// activations are used in place (no transpose copy); head h reads KV head
// h*K/H.  The ragged edge is masked instead of asserting S % tile == 0:
// rows past S are not written, and keys past S are zeros in shared memory
// that every valid row masks: causal rows by the diagonal, bidirectional
// rows by their last key S - 1 (a zero key would score 0 and take weight
// exp(0 - m)).  Each row's bounds kmin < kpos <= kmax are set once, so a
// key costs the two compares of the causal form in every form.
//
// Head dims: every D a registered config or smoke config uses, {16, 32, 64,
// 80, 96, 128, 256}.  A key tile is 32 rows, 16 at D = 256, where the two
// f32 tiles of 32 rows would take 64 KiB, past the 48 KB of static shared
// memory a block may hold; 16 rows keep them at 32 KiB and the scores at
// 16 registers beside q's and the accumulator's 2 x 64.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int BQ = 64;                // query rows per CTA
constexpr int TPR = 4;                // threads per query row
constexpr int THREADS = BQ * TPR;     // 256

struct Strides {                      // element strides of (B, H, S); D is 1
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int K, int S,
             int window, bool causal, Strides qs, Strides ks_, Strides vs_,
             Strides os, float scale) {
  constexpr int BK = D > 128 ? 16 : 32;  // keys per tile
  constexpr int DPT = D / TPR;        // head dims per thread
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = D / VEC;        // 16-byte vectors per key row
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = (int)((long long)h * K / H);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int c = tid % TPR;
  const int qpos = q0 + row;
  const bool valid = qpos < S;

  float qr[DPT], acc[DPT];
  const T* qp = q + b * qs.b + h * qs.h + (long long)qpos * qs.s;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = valid ? to_f(qp[c + TPR * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const T* kb = k + b * ks_.b + kh * ks_.h;
  const T* vb = v + b * vs_.b + kh * vs_.h;
  // the row sees keys kmin < kpos <= kmax: the causal bound, or the last
  // key (a zero key past S would score 0, not be masked); the window's
  const int kmax = causal ? qpos : S - 1;
  const int kmin = window > 0 ? qpos - window : -1;
  // causal: later keys are above the diagonal
  const int k_end = causal ? min(S, q0 + BQ) : S;
  // with a window, earlier keys are outside every row's window
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                  // the previous tile's readers are done
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int t = i / VPR;
      const int cc = (i - t * VPR) * VEC;
      const int kpos = k0 + t;
      float kv[VEC], vv[VEC];
      if (kpos < S) {
        Vec<T>::load(kb + (long long)kpos * ks_.s + cc, kv);
        Vec<T>::load(vb + (long long)kpos * vs_.s + cc, vv);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        *reinterpret_cast<float4*>(&ks[t][cc + j]) =
            make_float4(kv[j], kv[j + 1], kv[j + 2], kv[j + 3]);
        *reinterpret_cast<float4*>(&vs[t][cc + j]) =
            make_float4(vv[j], vv[j + 1], vv[j + 2], vv[j + 3]);
      }
    }
    __syncthreads();

    float s[BK];
    unsigned live = 0u;               // bit t: key k0 + t is seen by the row
    float m_tile = NEG_INF;
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[t][c + TPR * i];
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
      const float pv = round_to<T>(p);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += pv * vs[t][c + TPR * i];
    }
    l = l * corr + l_tile;
    m = m_new;
  }

  if (valid) {
    T* op = o + b * os.b + h * os.h + (long long)qpos * os.s;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[c + TPR * i] = from_f<T>(acc[i] * inv);
  }
}

struct Args {                         // one launch's shape and flags
  int B, H, K, S, window;
  bool causal;
  Strides qs, ks, vs, os;
  float scale;
};

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Args& a, cudaStream_t stream) {
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  flash_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a.H, a.K, a.S, a.window,
      a.causal, a.qs, a.ks, a.vs, a.os, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int D,
               const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, a, stream);
    case 32: return launch<T, 32>(q, k, v, o, a, stream);
    case 64: return launch<T, 64>(q, k, v, o, a, stream);
    case 80: return launch<T, 80>(q, k, v, o, a, stream);
    case 96: return launch<T, 96>(q, k, v, o, a, stream);
    case 128: return launch<T, 128>(q, k, v, o, a, stream);
    case 256: return launch<T, 256>(q, k, v, o, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o (B, H, S, D), k/v (B, K, S, D), each given by its (B, H, S) element
// strides with a unit stride on D; causal != 0 attends keys k <= q only,
// causal == 0 every key; window 0 sets no lower bound, a window W > 0 keeps
// keys k > q - W.  Returns the cudaError_t of the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H, int K,
    int S, int D, int causal, int window, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K <= 0 || H % K != 0 || window < 0) return (int)cudaErrorInvalidValue;
  const Args a{B, H, K, S, window, causal != 0, {q_sb, q_sh, q_ss},
               {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
               scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return dispatch_d<bf16>(q, k, v, o, D, a, s);
  if (dtype == DT_F32) return dispatch_d<float>(q, k, v, o, D, a, s);
  return (int)cudaErrorInvalidValue;
}
