// Split-KV flash-decode for Hopper (sm_90a): one new query token per lane
// attends to a dense KV cache with per-lane lengths and an optional window.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/decode_attention.py
// (decode_attention_bhsd, pallas_call at :94) and the XLA log-sum-exp merge
// that follows it (:116-122).
//
// Design. Pass 1 (decode_partial_kernel): one block per (KV chunk, KV head and
// group of up to 8 query heads, lane). Its four warps walk the chunk's rows,
// four rows per warp per step so eight K/V row loads are in flight per warp;
// a lane holds D/32 columns of q, k and v, a dot product is a warp reduction,
// and each warp keeps its own online-softmax state (m, l, acc) in registers
// for every query head of the group. The four warps merge through shared
// memory and the block writes one partial (m, l, acc) per query head in fp32.
// Pass 2 (lse_merge_kernel, common.cuh) merges the partials of the chunks
// by log-sum-exp, one block per (query head, lane). Rows at or past the lane's
// length, or before its window, are never read: a chunk wholly outside them
// writes the empty partial (NEG_INF, 0, 0) without touching K/V.
//
// The cache is read in the serving engine's layout, [lane, position, KV head,
// head_dim] per layer, through strides: no transpose to BHSD (the JAX
// wrapper, decode_attention/ops.py:27-31, transposes the whole cache).
//
// Bound on the H100: bytes. A decode step does 4 * D FLOPs per (query head,
// cached row) against 2 * D * itemsize bytes of K and V per (KV head, row),
// far below the card's ~295 FLOP/byte ridge. The design keeps every K/V row
// read exactly once per query-head group and keeps many loads in flight; the
// wrapper sizes the chunk so that lanes x KV heads x chunks gives every SM at
// least two blocks at the serving shapes (see ops.py).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerStep = 4;  // rows each warp loads before computing
constexpr int kMaxGroup = 8;     // query heads per block

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, int S, int H, int KV,
    int G, int n_gblk, int chunk, Strides4 qs, Strides4 ks, Strides4 vs,
    int window, float scale) {
  constexpr int NC = D / 32;
  const int c = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int kvh = blockIdx.y / n_gblk;
  const int g0 = (blockIdx.y % n_gblk) * kMaxGroup;
  const int ng = min(kMaxGroup, G - g0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int len = min(lengths[b], S);
  int lo = c * chunk;
  const int hi = min(lo + chunk, len);
  if (window > 0) lo = max(lo, len - window);

  // Query rows of the group, pre-scaled, D/32 columns per lane.
  float qr[kMaxGroup][NC];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      qr[g][i] = g < ng
          ? to_float(q[b * qs.b + (kvh * G + g0 + g) * qs.h + lane + 32 * i]) * scale
          : 0.f;
    }
  }

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][NC];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[g][i] = 0.f;
  }

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int t0 = lo + warp * kRowsPerStep; t0 < hi; t0 += kWarps * kRowsPerStep) {
    float kr[kRowsPerStep][NC], vr[kRowsPerStep][NC];
    bool ok[kRowsPerStep];
#pragma unroll
    for (int j = 0; j < kRowsPerStep; ++j) {
      const int t = t0 + j;
      ok[j] = t < hi;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        kr[j][i] = ok[j] ? to_float(kb[t * ks.s + lane + 32 * i]) : 0.f;
        vr[j][i] = ok[j] ? to_float(vb[t * vs.s + lane + 32 * i]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= ng) break;
      float s[kRowsPerStep];
      float smax = NEG_INF;
#pragma unroll
      for (int j = 0; j < kRowsPerStep; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NC; ++i) part = fmaf(qr[g][i], kr[j][i], part);
        const float dot = warp_sum(part);  // every lane of the warp takes part
        s[j] = ok[j] ? dot : NEG_INF;
        smax = fmaxf(smax, s[j]);
      }
      const float m_new = fmaxf(m[g], smax);
      const float corr = expf(m[g] - m_new);
      float psum = 0.f;
      float p[kRowsPerStep];
#pragma unroll
      for (int j = 0; j < kRowsPerStep; ++j) {
        p[j] = ok[j] ? expf(s[j] - m_new) : 0.f;
        psum += p[j];
      }
      l[g] = l[g] * corr + psum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        float a = acc[g][i] * corr;
#pragma unroll
        for (int j = 0; j < kRowsPerStep; ++j) a = fmaf(p[j], vr[j][i], a);
        acc[g][i] = a;
      }
    }
  }

  // Merge the four warps' states through shared memory.
  __shared__ float sm[kWarps][kMaxGroup];
  __shared__ float sl[kWarps][kMaxGroup];
  __shared__ float sacc[kWarps][kMaxGroup][D];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (lane == 0) {
      sm[warp][g] = m[g];
      sl[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) sacc[warp][g][lane + 32 * i] = acc[g][i];
  }
  __syncthreads();

  // Partials: m/l [B, KV, C, G], acc [B, KV, C, G, D].
  const long long base = ((long long)(b * KV + kvh) * n_chunks + c) * G;
  for (int e = threadIdx.x; e < ng * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(sm[w][g] - mx);
      lsum += wt * sl[w][g];
      a += wt * sacc[w][g][d];
    }
    acc_out[(base + g0 + g) * D + d] = a;
    if (d == 0) {
      m_out[base + g0 + g] = mx;
      l_out[base + g0 + g] = lsum;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   float* m_part, float* l_part, float* acc_part, void* o, int B,
                   int S, int H, int KV, int chunk, int n_chunks, Strides4 qs,
                   Strides4 ks, Strides4 vs, Strides4 os, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  const int n_gblk = (G + kMaxGroup - 1) / kMaxGroup;
  dim3 grid(n_chunks, KV * n_gblk, B);
  decode_partial_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, m_part, l_part, acc_part, S, H, KV, G, n_gblk, chunk, qs, ks, vs,
      window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lse_merge_kernel<T><<<dim3(H, B), D, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(o), KV, G, n_chunks, D, os);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q [B, 1, H, D]; k/v [B, S, KV, D] (strides of batch, position, head);
// lengths [B] int32 = valid rows including the new token; partials
// m/l [B, KV, n_chunks, G] and acc [B, KV, n_chunks, G, D] fp32 scratch;
// o [B, 1, H, D]. window <= 0 means no window. dtype: 0 = fp32, 1 = bf16.
// Returns cudaGetLastError().
extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* m_part,
    void* l_part, void* acc_part, void* o, int B, int S, int H, int KV, int D,
    int chunk, int n_chunks, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, int window, float scale, int dtype,
    void* stream) {
  using namespace repro;
  const Strides4 qs{q_sb, 0, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, 0, o_sh};
  const int* lens = static_cast<const int*>(lengths);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 64)
    return launch<float, 64>(q, k, v, lens, mp, lp, ap, o, B, S, H, KV, chunk, n_chunks, qs, ks, vs, os, window, scale, st);
  if (dtype == kFloat32 && D == 128)
    return launch<float, 128>(q, k, v, lens, mp, lp, ap, o, B, S, H, KV, chunk, n_chunks, qs, ks, vs, os, window, scale, st);
  if (dtype == kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, lens, mp, lp, ap, o, B, S, H, KV, chunk, n_chunks, qs, ks, vs, os, window, scale, st);
  if (dtype == kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, lens, mp, lp, ap, o, B, S, H, KV, chunk, n_chunks, qs, ks, vs, os, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
