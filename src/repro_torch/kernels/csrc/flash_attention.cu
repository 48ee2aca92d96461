// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_bhsd, pallas_call at :153): online-softmax attention with
// causal masking, a static sliding window that trims the KV tile range, GQA
// (query head h reads KV head h / G) and ragged tails.
//
// Design. One thread block per (q tile of BQ rows, query head, batch). On the
// TPU the KV tiles are the sequential innermost grid axis carrying (m, l, acc)
// in VMEM scratch; here blocks run in parallel in no order, so a loop inside
// the block walks the KV tiles [j_first, j_last] and the running state lives in
// registers, in fp32. Each of the four warps owns BQ/4 query rows; a lane owns
// two score columns of the current KV tile and D/32 output columns. Q, the
// K/V tile and the tile's probabilities are staged in shared memory as fp32
// (K padded by one column so a warp reading 32 different K rows hits 32
// banks). Q/K/V are read in the model layout [B, S, H, D] through strides, so
// the caller never transposes to BHSD; ragged tails are masked in-kernel
// instead of padding the inputs.
//
// Bound on the H100. At the serving shapes (prompts of 8..128 tokens) the
// work is a few MFLOP per head and the inputs a few MB, so the bound is bytes:
// Q, K, V read once and O written once. Inside a block each K/V tile is read
// from device memory once and reused by all BQ query rows from shared memory.
// The arithmetic runs on the CUDA cores in fp32 (no wgmma / tensor cores
// yet), which is what limits long prompts: at S=4096 this kernel is
// compute-bound far below the tensor-core rate. Tensor cores, TMA and warp
// specialisation are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBKV = 64;        // KV rows per tile (two score columns per lane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBKV * (D + 1) + kBKV * D + kBQ * kBKV);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Skv, int G, Strides4 qs, Strides4 ks,
    Strides4 vs, Strides4 os, int causal, int window, float scale) {
  constexpr int NC = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* sQ = smem;                  // [kBQ][D], pre-scaled
  float* sK = sQ + kBQ * D;          // [kBKV][D + 1]
  float* sV = sK + kBKV * (D + 1);   // [kBKV][D]
  float* sP = sV + kBKV * D;         // [kBQ][kBKV] probabilities of the tile

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRows;  // first tile row owned by this warp

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    sQ[i] = qp < Sq ? to_float(qb[qp * qs.s + d]) * scale : 0.f;
  }

  // KV tile range this q tile can see (flash_attention.py:50-58).
  const int n_kv = (Skv + kBKV - 1) / kBKV;
  int j_last = n_kv - 1;
  if (causal) j_last = min((q0 + kBQ - 1) / kBKV, n_kv - 1);
  int j_first = 0;
  if (window > 0) j_first = max(q0 - window + 1, 0) / kBKV;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int j = j_first; j <= j_last; ++j) {
    const int kv0 = j * kBKV;
    __syncthreads();  // Q staged (first tile) / previous tile fully consumed
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int kp = kv0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        kx = to_float(kb[kp * ks.s + d]);
        vx = to_float(vb[kp * vs.s + d]);
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
      const int qp = q0 + row0 + r;
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = kv0 + lane + 32 * c;
        bool valid = kp < Skv && qp < Sq;
        if (causal) valid = valid && qp >= kp;
        if (window > 0) valid = valid && (qp - kp < window);
        ok[c] = valid;
        if (!valid) s[r][c] = NEG_INF;
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

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + row0 + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) ob[qp * os.s + lane + 32 * i] = from_float<T>(acc[r][i] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int KV, Strides4 qs, Strides4 ks,
                   Strides4 vs, Strides4 os, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H / KV, qs, ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q [B, Sq, H, D], k/v [B, Skv, KV, D], o [B, Sq, H, D]: element strides of
// the batch, sequence and head dims (the head_dim stride is 1). window <= 0
// means no window. dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError().
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
    int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    int window, float scale, int dtype, void* stream) {
  using namespace repro;
  const Strides4 qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  if (dtype == kFloat32 && D == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  if (dtype == kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  if (dtype == kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
