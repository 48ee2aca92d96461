// Paged prefill attention for Hopper (sm_90a): a chunk of C new query
// positions per lane attends causally over the lane's whole paged prefix
// (query i sits at position off + i and sees kv_pos <= off + i), reading the
// pages through the block table, with optional int8 pages dequantized on
// load.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged_prefill.py
// (paged_prefill_attention_pallas, pallas_call at :157) and the XLA
// log-sum-exp merge that follows it (:168-174).
//
// Design. Flash-style, one thread block per (tile of 64 rows, KV head,
// lane), where a row is one (query position, query head of the KV head's
// group) pair, position-major: all G heads of a GQA group share each K/V
// tile. The TPU kernel runs one grid cell per (lane, KV head, logical page)
// and merges the per-page partials afterwards; here a loop inside the block
// walks 64-row KV tiles from position 0 to the tile's last query position,
// so pages wholly past the causal edge (which add exp(-inf) = 0 on the TPU)
// are never read and no partials or merge pass exist. Per KV tile, 64
// threads first resolve each row's pool offset (bt[b, t / page], t % page)
// and int8 scales into shared memory, then the block stages the tile's K/V
// as fp32 (dequantized) and runs flash_attention.cu's online softmax: four
// warps own 16 rows each, a lane owns two score columns and D/32 output
// columns, (m, l, acc) live in registers. C is arbitrary (the serving
// chunk, or a whole prompt for int8 whole prefill): rows past C * G are
// masked and never written. Rows past the caller's valid count still see
// their causal prefix and stay finite; a row with no visible position
// (a negative offset) writes 0.
//
// Bound on the H100: bytes at the serving chunk (C = 32 queries against a
// short prefix: the K/V rows and q dominate), operations at long prefixes
// (4 * D FLOPs per visible (query head, kv row) pair on the CUDA cores in
// fp32; tensor cores are later work, as for the flash kernel).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;   // rows (query position x group head) per block
constexpr int kBKV = 64;  // KV rows per tile (two score columns per lane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;  // rows per warp

struct PoolStrides {
  long long p, r, h;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBKV * (D + 1) + kBKV * D + kBQ * kBKV);
}

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ offsets,
    T* __restrict__ o, int C, int NB, int page, int G, long long bt_sb, Strides4 qs,
    PoolStrides ks, PoolStrides vs, long long sc_p, long long sc_r, Strides4 os,
    float scale) {
  constexpr int NC = D / 32;  // output columns per lane
  constexpr bool kQuant = sizeof(KT) == 1;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [kBQ][D], pre-scaled
  float* sK = sQ + kBQ * D;          // [kBKV][D + 1]
  float* sV = sK + kBKV * (D + 1);   // [kBKV][D]
  float* sP = sV + kBKV * D;         // [kBQ][kBKV] probabilities of the tile
  __shared__ long long sKoff[kBKV], sVoff[kBKV];  // pool offset of each tile row, -1 = none
  __shared__ float sKsc[kBKV], sVsc[kBKV];

  const int r0 = blockIdx.x * kBQ;  // first row of the tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = C * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRows;  // first tile row owned by this warp
  const int off = offsets[b];
  const int S = NB * page;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int ri = r0 + r;
    float x = 0.f;
    if (ri < n_rows) {
      const int h = kvh * G + ri % G;
      x = to_float(q[b * qs.b + (ri / G) * qs.s + h * qs.h + d]) * scale;
    }
    sQ[i] = x;
  }

  // Last position any row of this tile can see, and the KV tiles up to it.
  const int q_max = off + (min(r0 + kBQ, n_rows) - 1) / G;
  const int kv_end = min(q_max + 1, S);  // rows [0, kv_end) may be visible
  const int n_tiles = kv_end > 0 ? (kv_end + kBKV - 1) / kBKV : 0;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int* bt = block_tables + b * bt_sb;
  const KT* kb = k + kvh * ks.h;
  const KT* vb = v + kvh * vs.h;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBKV;
    __syncthreads();  // Q staged (first tile) / previous tile fully consumed
    if (tid < kBKV) {
      const int t = kv0 + tid;
      long long koff = -1, voff = -1;
      float ksc = 1.f, vsc = 1.f;
      if (t < kv_end) {
        const int blk = t / page;
        const int row = t - blk * page;
        const long long pg = bt[blk];
        koff = pg * ks.p + row * ks.r;
        voff = pg * vs.p + row * vs.r;
        if constexpr (kQuant) {
          ksc = k_scale[pg * sc_p + row * sc_r];
          vsc = v_scale[pg * sc_p + row * sc_r];
        }
      }
      sKoff[tid] = koff;
      sVoff[tid] = voff;
      sKsc[tid] = ksc;
      sVsc[tid] = vsc;
    }
    __syncthreads();
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (sKoff[r] >= 0) {
        kx = to_float(kb[sKoff[r] + d]);
        vx = to_float(vb[sVoff[r] + d]);
        if constexpr (kQuant) {
          kx *= sKsc[r];
          vx *= sVsc[r];
        }
      }
      sK[r * (D + 1) + d] = kx;
      sV[i] = vx;
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0 = sK[lane * (D + 1) + d];
      const float k1 = sK[(lane + 32) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = sQ[(row0 + r) * D + d];
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int ri = r0 + row0 + r;
      const int qp = off + ri / G;
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = kv0 + lane + 32 * c;
        ok[c] = ri < n_rows && kp < kv_end && kp <= qp;
        if (!ok[c]) s[r][c] = NEG_INF;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = ok[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[r][1] - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      sP[(row0 + r) * kBKV + lane] = p0;
      sP[(row0 + r) * kBKV + lane + 32] = p1;
    }
    __syncwarp();

    for (int c = 0; c < kBKV; ++c) {
      float vv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) vv[i] = sV[c * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = sP[(row0 + r) * kBKV + c];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ri = r0 + row0 + r;
    if (ri >= n_rows) continue;
    const int h = kvh * G + ri % G;
    T* ob = o + b * os.b + (ri / G) * os.s + h * os.h;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) ob[lane + 32 * i] = from_float<T>(acc[r][i] / denom);
  }
}

template <typename T, typename KT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* block_tables, const int* offsets,
                   void* o, int B, int C, int NB, int page, int H, int KV, long long bt_sb,
                   Strides4 qs, PoolStrides ks, PoolStrides vs, long long sc_p,
                   long long sc_r, Strides4 os, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  dim3 grid((C * G + kBQ - 1) / kBQ, KV, B);
  paged_prefill_kernel<T, KT, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      k_scale, v_scale, block_tables, offsets, static_cast<T*>(o), C, NB, page, G,
      bt_sb, qs, ks, vs, sc_p, sc_r, os, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q [B, C, H, D] and o [B, C, H, D] (strides of batch, position, head); k/v
// pools [P, page, KV, D] (strides of page, row, head) in q's dtype, or int8
// with fp32 scales [P, page] (strides sc_p, sc_r; null pointers for
// unquantized pools); block_tables [B, NB] int32 (row stride bt_sb);
// offsets [B] int32 = absolute position of q[:, 0]. dtype of q/o: 0 = fp32,
// 1 = bf16; kv_int8: 1 = int8 pools. Returns cudaGetLastError().
extern "C" int repro_paged_prefill_attention_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* offsets, void* o,
    int B, int C, int NB, int page, int H, int KV, int D, long long bt_sb,
    long long q_sb, long long q_ss, long long q_sh, long long k_sp, long long k_sr,
    long long k_sh, long long v_sp, long long v_sr, long long v_sh, long long sc_p,
    long long sc_r, long long o_sb, long long o_ss, long long o_sh, float scale,
    int dtype, int kv_int8, void* stream) {
  using namespace repro;
  const Strides4 qs{q_sb, q_ss, q_sh}, os{o_sb, o_ss, o_sh};
  const PoolStrides ks{k_sp, k_sr, k_sh}, vs{v_sp, v_sr, v_sh};
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED_PREFILL(T, KT, DIM)                                                 \
  return launch<T, KT, DIM>(q, k, v, ksc, vsc, bt, offs, o, B, C, NB, page, H, KV,      \
                            bt_sb, qs, ks, vs, sc_p, sc_r, os, scale, st)
  if (dtype == kFloat32 && !kv_int8 && D == 64) REPRO_PAGED_PREFILL(float, float, 64);
  if (dtype == kFloat32 && !kv_int8 && D == 128) REPRO_PAGED_PREFILL(float, float, 128);
  if (dtype == kBFloat16 && !kv_int8 && D == 64) REPRO_PAGED_PREFILL(__nv_bfloat16, __nv_bfloat16, 64);
  if (dtype == kBFloat16 && !kv_int8 && D == 128) REPRO_PAGED_PREFILL(__nv_bfloat16, __nv_bfloat16, 128);
  if (dtype == kFloat32 && kv_int8 && D == 64) REPRO_PAGED_PREFILL(float, int8_t, 64);
  if (dtype == kFloat32 && kv_int8 && D == 128) REPRO_PAGED_PREFILL(float, int8_t, 128);
  if (dtype == kBFloat16 && kv_int8 && D == 64) REPRO_PAGED_PREFILL(__nv_bfloat16, int8_t, 64);
  if (dtype == kBFloat16 && kv_int8 && D == 128) REPRO_PAGED_PREFILL(__nv_bfloat16, int8_t, 128);
#undef REPRO_PAGED_PREFILL
  return static_cast<int>(cudaErrorInvalidValue);
}
