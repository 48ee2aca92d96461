// Flash-attention backward for Hopper (sm_90a), fp32.
//
// The JAX package has no TPU kernel for this: its trainer differentiates
// XLA's attention (attn_impl="xla"), and its Pallas forward,
// src/repro/kernels/flash_attention/flash_attention.py (flash_attention_bhsd),
// has no custom_vjp. The port runs training's attention through its own
// forward kernel (flash_attention.cu), so the gradient is this kernel: the
// FlashAttention-2 backward, recomputing the probabilities from q, k and the
// forward's row log-sum-exp instead of storing them.
//
//   D    = rowsum(dO * O)                     [B, H, Sq]   (dot kernel)
//   P    = exp(scale * Q K^T - lse)           masked as the forward
//   dV   = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dQ   = scale * dS K,  dK = scale * dS^T Q
//
// Two passes, no atomics, so a step is bit-reproducible:
//  * dK / dV: one block per (64 KV rows, KV head, batch). It holds its K and
//    V tile in shared memory and dK, dV in registers, and walks the G query
//    heads of its group and the query tiles the mask lets see the tile, so
//    GQA's sum over the group happens in registers, in a fixed order.
//  * dQ: one block per (64 query rows, query head, batch), walking the KV
//    tiles its rows see, as the forward does.
// Q, K, V, O and dO are read in the model layout [B, S, heads, D] through
// strides; dQ [B, Sq, H, D] and dK, dV [B, Skv, KV, D] are written through
// theirs. The mask (attn_visible) and the tile ranges come from common.cuh,
// shared with the forward.
//
// Tiles are 64 x 64, 256 threads as 16 x 16: thread (tx, ty) owns rows
// ty + 16 r (r < 4) and columns tx + 16 c of every product's output, fp32 on
// the CUDA cores (fp32 on the tensor cores would be TF32). Tiles sit in
// shared memory with rows padded to D + 1 floats, so the 16 rows a
// half-warp reads at once fall in 16 banks. Bound on the H100: operations,
// 2.5 times the forward's matmul FLOPs over the 67 TFLOP/s fp32 peak; the
// design reads two shared-memory operands per four FMAs and reaches a part
// of that (PERF.md, row 7).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kT = 64;           // rows of a query tile and of a KV tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLDP = kT + 1;     // row stride of the [64][64] score tile

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * kT * (D + 1) + kT * kLDP + 2 * kT);
}

// acc[r][c] += sum_k A(ty + 16 r, k) * B(k, tx + 16 c), with A(i, k) =
// a[i * ai + k * ak] and B(k, j) = b[k * bk + j * bj] in shared memory.
template <int RI, int RJ, int K>
__device__ __forceinline__ void tile_product(float (&acc)[RI][RJ], const float* a, int ai,
                                             int ak, const float* b, int bk, int bj, int tx,
                                             int ty) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RI], bv[RJ];
#pragma unroll
    for (int r = 0; r < RI; ++r) av[r] = a[(ty + 16 * r) * ai + k * ak];
#pragma unroll
    for (int c = 0; c < RJ; ++c) bv[c] = b[k * bk + (tx + 16 * c) * bj];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// 64 rows from row0 of one head of a [B, S, heads, D] tensor (base points at
// the batch and head) into dst [64][D + 1]; rows past S read as 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long s_stride,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < kT * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int p = row0 + r;
    dst[r * (D + 1) + d] = p < S ? base[p * s_stride + d] : 0.f;
  }
}

// 64 values of a [B, H, Sq] row vector from row0 (rows past Sq read as 0).
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int Sq) {
  for (int i = threadIdx.x; i < kT; i += kThreads) dst[i] = row0 + i < Sq ? src[row0 + i] : 0.f;
}

// D = rowsum(dO * O), one warp per (batch, head, query) row.
__global__ void flash_bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                     float* __restrict__ dvec, int n_rows, int Sq, int H, int D,
                                     Strides4 os, Strides4 dos) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int qp = row % Sq, h = (row / Sq) % H, b = row / (Sq * H);
  const float* orow = o + b * os.b + qp * os.s + h * os.h;
  const float* drow = dout + b * dos.b + qp * dos.s + h * dos.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(orow[d], drow[d], acc);
  acc = warp_sum(acc);
  if (lane == 0) dvec[row] = acc;
}

// The recomputed probabilities of a (query tile, KV tile) pair, and with
// them dS: P in p, dS = P * (dP - D) in ds.
template <int D>
__device__ __forceinline__ void scores(float (&p)[4][4], float (&ds)[4][4], const float* sQ,
                                       const float* sK, const float* sV, const float* sdO,
                                       const float* sL, const float* sDv, int q0, int kv0,
                                       int Sq, int Skv, int causal, int window, float scale,
                                       int tx, int ty) {
  constexpr int LD = D + 1;
  float s[4][4] = {}, dp[4][4] = {};
  tile_product<4, 4, D>(s, sQ, LD, 1, sK, 1, LD, tx, ty);     // Q K^T
  tile_product<4, 4, D>(dp, sdO, LD, 1, sV, 1, LD, tx, ty);   // dO V^T
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const int qp = q0 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = qp < Sq && attn_visible(qp, kv0 + tx + 16 * c, Skv, causal, window);
      p[r][c] = ok ? expf(s[r][c] * scale - sL[i]) : 0.f;
      ds[r][c] = p[r][c] * (dp[r][c] - sDv[i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, float* __restrict__ dk, float* __restrict__ dv, int Sq,
    int Skv, int H, int G, Strides4 qs, Strides4 ks, Strides4 vs, Strides4 dos,
    Strides4 dks, Strides4 dvs, int causal, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int RJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kT * LD;
  float* sQ = sV + kT * LD;
  float* sdO = sQ + kT * LD;
  float* sP = sdO + kT * LD;  // P, then dS, of the current pair [64][kLDP]
  float* sL = sP + kT * kLDP;
  float* sDv = sL + kT;

  const int kv0 = blockIdx.x * kT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<D>(sK, k + b * ks.b + kvh * ks.h, ks.s, kv0, Skv);
  load_tile<D>(sV, v + b * vs.b + kvh * vs.h, vs.s, kv0, Skv);

  float dK[4][RJ] = {}, dV[4][RJ] = {};
  int i_first, i_last;
  q_tile_range(kv0, min(kv0 + kT, Skv) - 1, Sq, kT, causal, window, i_first, i_last);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lrow = lse + (static_cast<long long>(b) * H + h) * Sq;
    const float* drow = dvec + (static_cast<long long>(b) * H + h) * Sq;
    for (int i = i_first; i <= i_last; ++i) {
      const int q0 = i * kT;
      __syncthreads();  // the previous pair's tiles fully consumed
      load_tile<D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
      load_tile<D>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
      load_vec(sL, lrow, q0, Sq);
      load_vec(sDv, drow, q0, Sq);
      __syncthreads();
      float p[4][4], ds[4][4];
      scores<D>(p, ds, sQ, sK, sV, sdO, sL, sDv, q0, kv0, Sq, Skv, causal, window, scale, tx,
                ty);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sP[(ty + 16 * r) * kLDP + tx + 16 * c] = p[r][c];
      __syncthreads();
      tile_product<4, RJ, kT>(dV, sP, 1, kLDP, sdO, LD, 1, tx, ty);  // P^T dO
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sP[(ty + 16 * r) * kLDP + tx + 16 * c] = ds[r][c];
      __syncthreads();
      tile_product<4, RJ, kT>(dK, sP, 1, kLDP, sQ, LD, 1, tx, ty);  // dS^T Q
    }
  }
  float* dkb = dk + b * dks.b + kvh * dks.h;
  float* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = kv0 + ty + 16 * r;
    if (kp >= Skv) continue;
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      dkb[kp * dks.s + tx + 16 * c] = dK[r][c] * scale;
      dvb[kp * dvs.s + tx + 16 * c] = dV[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, float* __restrict__ dq, int Sq, int Skv, int H, int G,
    Strides4 qs, Strides4 ks, Strides4 vs, Strides4 dos, Strides4 dqs, int causal,
    int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int RJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kT * LD;
  float* sK = sdO + kT * LD;
  float* sV = sK + kT * LD;
  float* sP = sV + kT * LD;  // dS of the current pair [64][kLDP]
  float* sL = sP + kT * kLDP;
  float* sDv = sL + kT;

  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<D>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  load_vec(sL, lse + (static_cast<long long>(b) * H + h) * Sq, q0, Sq);
  load_vec(sDv, dvec + (static_cast<long long>(b) * H + h) * Sq, q0, Sq);

  float dQ[4][RJ] = {};
  int j_first, j_last;
  kv_tile_range(q0, min(q0 + kT, Sq) - 1, Skv, kT, causal, window, j_first, j_last);
  for (int j = j_first; j <= j_last; ++j) {
    const int kv0 = j * kT;
    __syncthreads();  // the previous tile fully consumed (and Q, dO staged)
    load_tile<D>(sK, k + b * ks.b + kvh * ks.h, ks.s, kv0, Skv);
    load_tile<D>(sV, v + b * vs.b + kvh * vs.h, vs.s, kv0, Skv);
    __syncthreads();
    float p[4][4], ds[4][4];
    scores<D>(p, ds, sQ, sK, sV, sdO, sL, sDv, q0, kv0, Sq, Skv, causal, window, scale, tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sP[(ty + 16 * r) * kLDP + tx + 16 * c] = ds[r][c];
    __syncthreads();
    tile_product<4, RJ, kT>(dQ, sP, kLDP, 1, sK, LD, 1, tx, ty);  // dS K
  }
  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty + 16 * r;
    if (qp >= Sq) continue;
#pragma unroll
    for (int c = 0; c < RJ; ++c) dqb[qp * dqs.s + tx + 16 * c] = dQ[r][c] * scale;
  }
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* dout, const float* lse, float* dvec, float* dq, float* dk,
                       float* dv, int B, int Sq, int Skv, int H, int KV, const Strides4* st,
                       int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D>();
  const int G = H / KV;
  const int n_rows = B * H * Sq;
  flash_bwd_dot_kernel<<<(n_rows + 7) / 8, 256, 0, stream>>>(o, dout, dvec, n_rows, Sq, H, D,
                                                             st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid_kv((Skv + kT - 1) / kT, KV, B);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, Sq, Skv, H, G, st[0], st[1], st[2], st[4], st[6],
      st[7], causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid_q((Sq + kT - 1) / kT, H, B);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dvec, dq, Sq, Skv, H, G, st[0], st[1], st[2], st[4], st[5], causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// fp32 q, o, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Skv, KV, D]; lse (the
// forward's) and dvec (scratch) [B, H, Sq] contiguous. strides: 24 element
// strides, (batch, seq, head) of q, k, v, o, dout, dq, dk, dv in that order
// (the head_dim stride is 1). D is 16, 64 or 128; causal, window and scale
// as the forward's. Returns cudaGetLastError().
extern "C" int repro_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* o, const float* dout,
    const float* lse, float* dvec, float* dq, float* dk, float* dv, int B, int Sq, int Skv,
    int H, int KV, int D, const long long* strides, int causal, int window, float scale,
    void* stream) {
  using namespace repro;
  if (Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides4 st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides4{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD(DIM)                                                                  \
  return launch_bwd<DIM>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Sq, Skv, H, KV, st, causal, \
                         window, scale, s)
  if (D == 16) REPRO_FLASH_BWD(16);
  if (D == 64) REPRO_FLASH_BWD(64);
  if (D == 128) REPRO_FLASH_BWD(128);
#undef REPRO_FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
