// Paged split-KV flash-decode for Hopper (sm_90a): one new query token per
// lane attends to its context scattered over a shared page pool, named row
// by row through the lane's block table, with an optional window and
// optional int8 pages dequantized on load.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged.py
// (paged_decode_attention, pallas_call at :143) and the XLA log-sum-exp
// merge that follows it (:154-159).
//
// Design. decode_attention.cu's split-KV design with a page lookup. Pass 1
// (paged_decode_partial_kernel): one block per (chunk of whole pages, KV
// head and group of up to 8 query heads, lane). Its four warps walk the
// chunk's rows, four rows per warp per step; row t of the lane lives at
// pool[bt[b, t / page], t % page], so each row costs one block-table read
// (cached) before its K/V loads. int8 pages multiply each loaded row by its
// fp32 scale[page, row] (the plain version's pages[bt] * scales[bt]). The
// TPU kernel runs one grid cell per (lane, KV head, logical page) and masks
// every page past the lane's length; here a chunk wholly past the length,
// or before the window, writes the empty partial (NEG_INF, 0, 0) without
// reading the table or K/V, so the bytes read follow the lengths. Pass 2 is
// lse_merge_kernel (common.cuh), shared with the dense decode kernel.
//
// The pool is read in the engine's per-layer view of [n_layers, P+1, page,
// KV, head_dim] through strides (no copy); the scales likewise from
// [n_layers, P+1, page].
//
// Bound on the H100: bytes. A decode step does 4 * D FLOPs per (query head,
// cached row) against 2 * D * itemsize bytes of K and V per (KV head, row)
// (plus 8 bytes of scales for int8 rows), far below the ~295 FLOP/byte ridge.
// Each K/V row is read once per query-head group; the wrapper sizes chunks
// from the SM count (as split_chunks does) so every SM gets about two blocks.
//
// Lengths are clamped to [.., NB * page]: a row past the block table is
// never addressed, and a length <= 0 reads nothing (output 0).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerStep = 4;  // rows each warp loads before computing
constexpr int kMaxGroup = 8;     // query heads per block

// Element strides of a page pool [page id, row, KV head, head_dim] whose
// head_dim is contiguous (the wrapper checks it).
struct PoolStrides {
  long long p, r, h;
};

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_partial_kernel(
    const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ lengths,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, int NB, int page, int KV, int G, int n_gblk,
    int chunk, long long bt_sb, Strides4 qs, PoolStrides ks, PoolStrides vs,
    long long sc_p, long long sc_r, int window, float scale) {
  constexpr int NC = D / 32;
  constexpr bool kQuant = sizeof(KT) == 1;
  const int c = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int kvh = blockIdx.y / n_gblk;
  const int g0 = (blockIdx.y % n_gblk) * kMaxGroup;
  const int ng = min(kMaxGroup, G - g0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int len = min(lengths[b], NB * page);
  int lo = c * chunk;
  const int hi = min(lo + chunk, len);
  if (window > 0) lo = max(lo, len - window);

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

  const int* bt = block_tables + b * bt_sb;
  const KT* kb = k + kvh * ks.h;
  const KT* vb = v + kvh * vs.h;
  for (int t0 = lo + warp * kRowsPerStep; t0 < hi; t0 += kWarps * kRowsPerStep) {
    float kr[kRowsPerStep][NC], vr[kRowsPerStep][NC];
    bool ok[kRowsPerStep];
#pragma unroll
    for (int j = 0; j < kRowsPerStep; ++j) {
      const int t = t0 + j;
      ok[j] = t < hi;
      if (ok[j]) {
        const int blk = t / page;
        const int row = t - blk * page;
        const long long pg = bt[blk];
        const KT* kp = kb + pg * ks.p + row * ks.r;
        const KT* vp = vb + pg * vs.p + row * vs.r;
        float ksc = 1.f, vsc = 1.f;
        if constexpr (kQuant) {
          ksc = k_scale[pg * sc_p + row * sc_r];
          vsc = v_scale[pg * sc_p + row * sc_r];
        }
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          kr[j][i] = kQuant ? to_float(kp[lane + 32 * i]) * ksc : to_float(kp[lane + 32 * i]);
          vr[j][i] = kQuant ? to_float(vp[lane + 32 * i]) * vsc : to_float(vp[lane + 32 * i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < NC; ++i) kr[j][i] = vr[j][i] = 0.f;
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

template <typename T, typename KT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* block_tables, const int* lengths,
                   float* m_part, float* l_part, float* acc_part, void* o, int B, int NB,
                   int page, int H, int KV, int chunk, int n_chunks, long long bt_sb,
                   Strides4 qs, PoolStrides ks, PoolStrides vs, long long sc_p,
                   long long sc_r, Strides4 os, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  const int n_gblk = (G + kMaxGroup - 1) / kMaxGroup;
  dim3 grid(n_chunks, KV * n_gblk, B);
  paged_decode_partial_kernel<T, KT, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      k_scale, v_scale, block_tables, lengths, m_part, l_part, acc_part, NB, page,
      KV, G, n_gblk, chunk, bt_sb, qs, ks, vs, sc_p, sc_r, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lse_merge_kernel<T><<<dim3(H, B), D, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(o), KV, G, n_chunks, D, os);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q [B, 1, H, D]; k/v pools [P, page, KV, D] (strides of page, row, head)
// in q's dtype, or int8 with fp32 scales [P, page] (strides sc_p, sc_r;
// null pointers for unquantized pools); block_tables [B, NB] int32 (row
// stride bt_sb); lengths [B] int32 = valid rows including the new token;
// chunk = rows per pass-1 block (whole pages); partials m/l [B, KV,
// n_chunks, G] and acc [B, KV, n_chunks, G, D] fp32 scratch; o [B, 1, H, D].
// window <= 0 means no window. dtype of q/o: 0 = fp32, 1 = bf16; kv_int8:
// 1 = int8 pools. Returns cudaGetLastError().
extern "C" int repro_paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* lengths,
    void* m_part, void* l_part, void* acc_part, void* o, int B, int NB, int page,
    int H, int KV, int D, int chunk, int n_chunks, long long bt_sb, long long q_sb,
    long long q_sh, long long k_sp, long long k_sr, long long k_sh, long long v_sp,
    long long v_sr, long long v_sh, long long sc_p, long long sc_r, long long o_sb,
    long long o_sh, int window, float scale, int dtype, int kv_int8, void* stream) {
  using namespace repro;
  const Strides4 qs{q_sb, 0, q_sh}, os{o_sb, 0, o_sh};
  const PoolStrides ks{k_sp, k_sr, k_sh}, vs{v_sp, v_sr, v_sh};
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED_DECODE(T, KT, DIM)                                                  \
  return launch<T, KT, DIM>(q, k, v, ksc, vsc, bt, lens, mp, lp, ap, o, B, NB, page, H, \
                            KV, chunk, n_chunks, bt_sb, qs, ks, vs, sc_p, sc_r, os,     \
                            window, scale, st)
  if (dtype == kFloat32 && !kv_int8 && D == 64) REPRO_PAGED_DECODE(float, float, 64);
  if (dtype == kFloat32 && !kv_int8 && D == 128) REPRO_PAGED_DECODE(float, float, 128);
  if (dtype == kBFloat16 && !kv_int8 && D == 64) REPRO_PAGED_DECODE(__nv_bfloat16, __nv_bfloat16, 64);
  if (dtype == kBFloat16 && !kv_int8 && D == 128) REPRO_PAGED_DECODE(__nv_bfloat16, __nv_bfloat16, 128);
  if (dtype == kFloat32 && kv_int8 && D == 64) REPRO_PAGED_DECODE(float, int8_t, 64);
  if (dtype == kFloat32 && kv_int8 && D == 128) REPRO_PAGED_DECODE(float, int8_t, 128);
  if (dtype == kBFloat16 && kv_int8 && D == 64) REPRO_PAGED_DECODE(__nv_bfloat16, int8_t, 64);
  if (dtype == kBFloat16 && kv_int8 && D == 128) REPRO_PAGED_DECODE(__nv_bfloat16, int8_t, 128);
#undef REPRO_PAGED_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}
