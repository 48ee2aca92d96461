// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_bhsd, pallas_call at :153): online-softmax attention with
// causal masking, a static sliding window that trims the KV tile range, GQA
// (query head h reads KV head h / G) and ragged tails.
//
// On the TPU the KV tiles are the sequential innermost grid axis carrying
// (m, l, acc) in VMEM scratch; here blocks run in parallel in no order, so a
// loop inside the block walks the KV tiles [j_first, j_last] and the running
// state lives in registers, in fp32. Q/K/V are read in the model layout
// [B, S, H, D] through strides, so the caller never transposes to BHSD;
// ragged tails are masked in-kernel instead of padding the inputs. The
// dispatch at the bottom picks one of three designs by head_dim and dtype.
//
// bf16: the tensor cores (attention_tc.cuh). One warpgroup per (64 rows,
// KV head, batch), where a row is one (query position, query head of the KV
// head's group) pair, position-major, so the G heads of a group share each
// K/V tile and read it from device memory once. Q and the K/V tiles arrive
// by 16-byte cp.async into 128-byte-swizzled shared memory, K/V in a 2-stage
// ring (tile j + 1 in flight while tile j computes); rows past Skv are
// zero-filled and masked. Shared memory: 41 KB at D = 64 and 81 KB at
// D = 128, so 4 and 2 blocks share an SM (registers allow as many). Bound
// on the H100: bytes at the serving shapes (prompts of 8..128 tokens: a few
// MFLOP per head against a few MB), where the time is the latency of a
// block's first loads; operations at long prompts, where the tensor cores
// and the exponentials on the special-function units take about equal
// time at D = 64.
//
// head_dim 8 and 16 (the paper's Sec. V block has 100 heads of 8), fp32 and
// bf16: the CUDA cores (flash_small_kernel). A K row of 8 or 16 elements is
// below wgmma's 16-element contraction step and the 128-byte swizzle of the
// tensor-core tiles, and the work is small: at the paper's shape (B = 64,
// S = 16, 100 heads) q, k, v and o come to 6.6 MB in bf16, ~2 us at
// 3.35 TB/s, below a launch's ~5 us. One thread owns one row (query
// position, query head of the KV head's group), holds its q and its output
// in registers, and walks tiles of 32 K/V rows staged in shared memory as
// fp32, every thread reading the same row at once (a broadcast). Bound:
// bytes; the launch's fixed cost at the served shapes.
//
// fp32, head_dim 64 and 128 (training's forward, with the lse, and the
// parity path). One block of four warps per (64 rows, KV head, batch), rows
// packed per KV head as in the bf16 kernel, so a group's heads share each
// K/V tile; a warp owns 16 rows, a thread two of them. K/V tiles arrive by
// cp.async in a 2-stage ring (tf32x3_tiles.cuh). S = Q K^T runs on the CUDA
// cores as fp32 FMAs over d in order, Q scaled as the plain version scales
// it, into the registers of an mma.sync accumulator; the online softmax
// runs per fragment row, its exponentials on ex2; O += P V runs on the
// tensor cores as 3xTF32 (tf32x3.cuh, mma.sync m16n8k8; one TF32 product
// keeps ~3 decimal digits), P the A operand straight from S's registers.
// S stays in fp32 because, as 3xTF32, its rounding parted from the plain
// version's enough that a 3-layer full-width model carried the difference
// past chip_smoke.py phase 25's gradient tolerance (PERF.md). Bound
// on the H100: bytes at the trained shapes (B=4, S=256), about equal to the
// products at 495 / 3 TFLOP/s; what holds the kernel above it is the fp32
// FMAs of S and the instruction issue around the mma.sync.
#include <algorithm>

#include "attention_tc.cuh"
#include "common.cuh"
#include "tf32x3.cuh"
#include "tf32x3_tiles.cuh"

namespace repro {
namespace {

// ---- fp32, head_dim 64 / 128: P V as 3xTF32 on the tensor cores -----------

using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::row_stride;

namespace f32 {

constexpr int kRows = 64;  // rows of a block: (query position, query head of the group) pairs
constexpr int kWarps = 4;  // each owns 16 rows
constexpr int kThreads = 32 * kWarps;

// The choices per head width, from ptxas and timed runs (PERF.md):
// K/V rows per tile (kKV) and the blocks an SM should hold, for the
// register budget (kMinBlocks). At D = 64: 52.2 KB of shared memory and
// 168 registers (8 bytes spilled; at two blocks an SM, 211 registers and
// none, stablelm-1.6b's trained shape ran 6% slower); 64-row K/V tiles
// were slower too. At D = 128: 101.4 KB, 255 registers, 24 bytes spilled.
template <int D>
struct Tiles;
template <>
struct Tiles<64> {
  static constexpr int kKV = 32;
  static constexpr int kMinBlocks = 3;
};
template <>
struct Tiles<128> {
  static constexpr int kKV = 32;
  static constexpr int kMinBlocks = 2;
};

// Q and a 2-stage ring of K and V tiles.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * row_stride<D>() * (kRows + 4 * Tiles<D>::kKV);
}

// The block's kRows rows of Q into dst [kRows][D + 4]: row r is query
// position (r0 + r) / G of head kvh * G + (r0 + r) % G; rows past n_rows
// are zero-filled.
template <int D>
__device__ __forceinline__ void load_q(float* dst, const float* qb, const Strides4& qs, int r0,
                                       int n_rows, int G, int kvh, bool vec16) {
  constexpr int LD = row_stride<D>();
  constexpr int W = 4;  // floats a 16-byte copy moves
  const int per = vec16 ? D / W : D;
  for (int i = threadIdx.x; i < kRows * per; i += kThreads) {
    const int r = i / per, c = i % per, row = r0 + r;
    const bool ok = row < n_rows;
    const float* src = ok ? qb + (row / G) * qs.s + (kvh * G + row % G) * qs.h : qb;
    if (vec16)
      tf32x3::cp_async_16(tf32x3::smem_addr(dst + r * LD + W * c), src + (ok ? W * c : 0), ok);
    else
      tf32x3::cp_async_4(tf32x3::smem_addr(dst + r * LD + c), src + (ok ? c : 0), ok);
  }
}

}  // namespace f32

// One block per (64 rows, KV head, batch) of a 1-D grid, row tile slowest
// and reversed: under a causal mask the last rows see the most K/V tiles,
// and their blocks launch first. A row is one (query position, query head
// of the KV head's group) pair, position-major, so the G heads of a group
// share every K/V tile, which is read from device memory once per group.
template <int D>
__global__ void __launch_bounds__(f32::kThreads, f32::Tiles<D>::kMinBlocks) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int B, int Sq, int Skv, int H, int KV,
    Strides4 qs, Strides4 ks, Strides4 vs, Strides4 os, int causal, int window, float scale,
    bool vec16) {
  using T = f32::Tiles<D>;
  constexpr int LD = row_stride<D>();
  constexpr int BKV = T::kKV;
  constexpr int STILE = BKV * LD;
  constexpr int NT = BKV / 8;  // n-tiles of S, k-steps of P V
  constexpr int ND = D / 8;    // n-tiles of O
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // Q * scale
  float* ring = sQ + f32::kRows * LD;    // 2 stages of {K, V [BKV][LD]}

  const int G = H / KV;
  const int n_rows = Sq * G;
  int idx = blockIdx.x;
  const int kvh = idx % KV;
  idx /= KV;
  const int b = idx % B;
  const int r0 = ((n_rows + f32::kRows - 1) / f32::kRows - 1 - idx / B) * f32::kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wr = 16 * warp;  // the warp's first row in the block

  int j_first, j_last;
  kv_tile_range(r0 / G, (min(r0 + f32::kRows, n_rows) - 1) / G, Skv, BKV, causal, window,
                j_first, j_last);
  const int n_kv = max(j_last - j_first + 1, 0);

  // This thread's rows, gid and gid + 8 of the warp's: position, head, and
  // whether the row exists; and the positions of the warp's live rows.
  int qp[2], head[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + wr + gid + 8 * h;
    live[h] = r < n_rows;
    qp[h] = r / G;
    head[h] = kvh * G + r % G;
  }
  const bool warp_live = r0 + wr < n_rows;
  const int wq_first = (r0 + wr) / G;
  const int wq_last = (min(r0 + wr + 16, n_rows) - 1) / G;

  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  auto issue = [&](int n) {  // K/V tile j_first + n into stage n % 2
    float* st = ring + (n % 2) * 2 * STILE;
    const int kv0 = (j_first + n) * BKV;
    tf32x3::load_tile<D, BKV, f32::kThreads>(st, kb, ks.s, kv0, Skv, vec16);
    tf32x3::load_tile<D, BKV, f32::kThreads>(st + STILE, vb, vs.s, kv0, Skv, vec16);
  };

  f32::load_q<D>(sQ, q + b * qs.b, qs, r0, n_rows, G, kvh, vec16);
  tf32x3::cp_async_commit();
  if (n_kv > 0) issue(0);
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<1>();  // Q landed
  __syncthreads();
  // Each warp scales its own 16 rows of Q, as the plain version scales q.
  for (int i = lane; i < 16 * D / 4; i += 32) {
    float4* x = reinterpret_cast<float4*>(sQ + (wr + i / (D / 4)) * LD + 4 * (i % (D / 4)));
    const float4 y = *x;
    *x = make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
  }
  __syncwarp();

  float acc[ND][4] = {};
  float m[2] = {NEG_INF, NEG_INF};  // running row max of the scores
  float l[2] = {0.f, 0.f};          // this thread's part of the running row sum
  const float* q_row[2] = {sQ + (wr + gid) * LD, sQ + (wr + gid + 8) * LD};
  for (int n = 0; n < n_kv; ++n) {
    if (n + 1 < n_kv) issue(n + 1);  // in flight while tile n computes
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();  // tile n landed
    __syncthreads();
    const float* sK = ring + (n % 2) * 2 * STILE;
    const float* sV = sK + STILE;
    const int kv0 = (j_first + n) * BKV;
    // A warp whose rows see none of the tile's keys skips it.
    const bool sees = warp_live && !(causal && wq_last < kv0) &&
                      !(window > 0 && wq_first - (kv0 + BKV - 1) >= window);
    if (sees) {
      // S = Q K^T for the warp's 16 rows x BKV keys, in the accumulator
      // layout of mma.sync (rows gid and gid + 8, columns 8 t + 2 tig and
      // + 1), by fp32 FMAs over d in order, as the plain version's matmul
      // sums them; 16-byte shared reads, free of bank conflicts.
      float s[NT][4] = {};
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(q_row[0] + d);
        const float4 qb = *reinterpret_cast<const float4*>(q_row[1] + d);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float4 ka = *reinterpret_cast<const float4*>(sK + (8 * t + 2 * tig) * LD + d);
          const float4 kc = *reinterpret_cast<const float4*>(sK + (8 * t + 2 * tig + 1) * LD + d);
          const float4 qq[2] = {qa, qb}, kk[2] = {ka, kc};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 x = qq[e >> 1], y = kk[e & 1];
            s[t][e] = fmaf(x.x, y.x, s[t][e]);
            s[t][e] = fmaf(x.y, y.y, s[t][e]);
            s[t][e] = fmaf(x.z, y.z, s[t][e]);
            s[t][e] = fmaf(x.w, y.w, s[t][e]);
          }
        }
      }
      // Masked scores to -inf (exp2 gives 0 against the finite running max).
      if (!tf32x3::tile_visible(wq_first, wq_last - wq_first + 1, kv0, BKV, Sq, Skv, causal,
                                window)) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, kp = kv0 + 8 * t + 2 * tig + (e & 1);
            if (!(live[h] && attn_visible(qp[h], kp, Skv, causal, window))) s[t][e] = -INFINITY;
          }
      }
      // The online softmax per row, the max over the row's quad of lanes,
      // the exponentials on ex2 (base 2: the differences times log2 e).
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2_ftz((m[h] - mx[h]) * LOG2E);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] *= corr[e >> 1];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] = exp2_ftz((s[t][e] - m[e >> 1]) * LOG2E);
          l[e >> 1] += s[t][e];
        }
      // O += P V over the tile's keys on the tensor cores, P the A operand
      // straight from S's registers. Each 8-column slice of O sums the
      // tile's products in fresh registers, the big product and the small
      // ones apart, and adds them to O in fp32 (tf32x3::mma3_apart).
      FragA ap[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) tf32x3::a_from_acc(ap[t], s[t]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        float pv[4] = {}, pvc[4] = {};
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          FragB bv;
          tf32x3::b_cols<D, true>(bv, sV, 8 * t, 8 * nd, gid, tig);
          tf32x3::mma3_apart(pv, pvc, ap[t], bv);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += pv[e] + pvc[e];
      }
    }
    __syncthreads();  // stage n % 2 consumed: tile n + 2 may land there
  }
  tf32x3::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (!live[h]) continue;
    // A row that sees nothing has l = 0 and outputs 0.
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    float* orow = o + b * os.b + qp[h] * os.s + head[h] * os.h;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(orow + 8 * nd + 2 * tig) =
          make_float2(acc[nd][2 * h] * inv, acc[nd][2 * h + 1] * inv);
    // The row's log-sum-exp for the backward; a row that sees nothing gets
    // -NEG_INF, so that its recomputed probabilities exp(s - lse) are 0.
    if (lse && tig == 0)
      lse[(static_cast<long long>(b) * H + head[h]) * Sq + qp[h]] =
          l[h] > 0.f ? m[h] + logf(l[h]) : -NEG_INF;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int KV, Strides4 qs, Strides4 ks,
                   Strides4 vs, Strides4 os, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = f32::smem_bytes<D>();
  const long long blocks =
      static_cast<long long>((Sq * (H / KV) + f32::kRows - 1) / f32::kRows) * KV * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const bool vec16 =
      tf32x3::rows_16b(qf, qs) && tf32x3::rows_16b(kf, ks) && tf32x3::rows_16b(vf, vs);
  flash_fwd_kernel<D><<<static_cast<unsigned>(blocks), f32::kThreads, smem, stream>>>(
      qf, kf, vf, static_cast<float*>(o), lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal,
      window, scale, vec16);
  return cudaGetLastError();
}

// ---- head_dim 8 / 16: the CUDA cores, fp32 and bf16 --------------------------

constexpr int kSmallKV = 32;       // K/V rows per shared-memory tile (one bit each in a mask)
constexpr int kSmallThreads = 128;  // the most rows per block

// One block per (up to 128 rows, KV head, batch), a row being one (query
// position, query head of the group) pair, position-major as in the bf16
// kernel, so the G heads of a group share each K/V tile. Each thread owns
// one row: q (pre-scaled by scale * log2 e) and the output in registers, the
// online softmax in exp2.
template <typename T, int D>
__global__ void __launch_bounds__(kSmallThreads) flash_small_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int G, Strides4 qs,
    Strides4 ks, Strides4 vs, Strides4 os, int causal, int window, float scale_log2) {
  __shared__ float sK[kSmallKV][D];
  __shared__ float sV[kSmallKV][D];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = Sq * G;
  const int r0 = blockIdx.x * blockDim.x;
  const int r = r0 + threadIdx.x;
  const bool live = r < n_rows;
  const int qp = live ? r / G : 0;
  const int h = kvh * G + (live ? r % G : 0);
  const int q_first = r0 / G;
  const int q_last = (min(r0 + static_cast<int>(blockDim.x), n_rows) - 1) / G;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_float(q[b * qs.b + qp * qs.s + h * qs.h + d]) * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // K/V rows these rows can see (flash_attention.py:50-58), in whole tiles.
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = (window > 0 ? max(0, q_first - window + 1) : 0) / kSmallKV * kSmallKV;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kSmallKV) {
    __syncthreads();  // the previous tile fully consumed
    for (int i = threadIdx.x; i < kSmallKV * D; i += blockDim.x) {
      const int row = i / D, d = i % D;
      const int kp = kv0 + row;
      sK[row][d] = kp < Skv ? to_float(kb[kp * ks.s + d]) : 0.f;
      sV[row][d] = kp < Skv ? to_float(vb[kp * vs.s + d]) : 0.f;
    }
    __syncthreads();
    float s[kSmallKV];
    uint32_t ok = 0u;
    float mx = m;
#pragma unroll
    for (int c = 0; c < kSmallKV; ++c) {
      const bool valid = attn_visible(qp, kv0 + c, Skv, causal, window);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], sK[c][d], dot);
      s[c] = dot;
      if (valid) {
        ok |= 1u << c;
        mx = fmaxf(mx, dot);
      }
    }
    const float corr = exp2f(m - mx);
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int c = 0; c < kSmallKV; ++c) {
      const float p = (ok >> c) & 1u ? exp2f(s[c] - mx) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, sV[c][d], acc[d]);
    }
    m = mx;
  }
  if (live) {
    T* orow = o + b * os.b + qp * os.s + h * os.h;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_float<T>(acc[d] * inv);
    // The row's log-sum-exp in natural units (m and l are in base 2).
    if (lse)
      lse[(static_cast<long long>(b) * gridDim.y * G + h) * Sq + qp] =
          l > 0.f ? (m + log2f(l)) / LOG2E : -NEG_INF;
  }
}

template <typename T, int D>
cudaError_t launch_small(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int Sq,
                         int Skv, int H, int KV, Strides4 qs, Strides4 ks, Strides4 vs,
                         Strides4 os, int causal, int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int n_rows = Sq * G;
  // A warp at least; no more threads than rows, up to kSmallThreads.
  const int threads = std::min(kSmallThreads, std::max(32, (n_rows + 31) / 32 * 32));
  dim3 grid((n_rows + threads - 1) / threads, KV, B);
  flash_small_kernel<T, D><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Skv, G, qs, ks, vs, os, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

// ---- bf16: tensor cores (attention_tc.cuh) ----------------------------------

// Alignment slack, Q, and two stages of K and V.
template <int D>
constexpr size_t tc_smem_bytes() {
  return 1024 + 5 * tc::tile_bytes<D>();
}

// One block (one warpgroup) per (tile of 64 rows, KV head, batch), where a
// row is one (query position, query head of the KV head's group) pair,
// position-major: the G heads of a group share every K/V tile, which is read
// from device memory once per group.
template <int D>
__global__ void __launch_bounds__(tc::kThreads) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq, int Skv,
    int G, Strides4 qs, Strides4 ks, Strides4 vs, Strides4 os, int causal, int window,
    float scale) {
  constexpr uint32_t kTile = tc::tile_bytes<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = (tc::smem_addr(smem_raw) + 1023) & ~1023u;
  auto sK = [&](int st) { return sQ + kTile * (1 + 2 * st); };
  auto sV = [&](int st) { return sQ + kTile * (2 + 2 * st); };

  // The last row tiles see the most K/V tiles under a causal mask: start them first.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * tc::kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = Sq * G;
  const int q_first = r0 / G;
  const int q_last = (min(r0 + tc::kRows, n_rows) - 1) / G;

  int j_first, j_last;
  kv_tile_range(q_first, q_last, Skv, tc::kCols, causal, window, j_first, j_last);

  // This thread's two rows: query position and output row pointer.
  int qp[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + tc::frag_row(h);
    qp[h] = r / G;
    orow[h] = r < n_rows ? o + b * os.b + qp[h] * os.s + (kvh * G + r % G) * os.h : nullptr;
  }

  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
  auto load_kv = [&](int j, int st) {
    const int kv0 = j * tc::kCols;
    tc::load_tiles_async<D>(sK(st), sV(st), [&](int row) {
      const int kp = kv0 + row;
      return kp < Skv ? tc::RowPair{kb + kp * ks.s, vb + kp * vs.s} : tc::RowPair{nullptr, nullptr};
    });
    tc::cp_async_commit();
  };

  tc::Softmax<D> sm;
  sm.init();
  const float scale_log2 = scale * tc::kLog2e;
  if (j_first <= j_last) {
    tc::load_tile_async<D>(sQ, [&](int row) {
      const int r = r0 + row;
      return r < n_rows ? q + b * qs.b + (r / G) * qs.s + (kvh * G + r % G) * qs.h : nullptr;
    });
    load_kv(j_first, 0);
  }
  for (int j = j_first; j <= j_last; ++j) {
    const int st = (j - j_first) & 1;
    tc::cp_async_wait_all();  // tile j (and Q) landed
    tc::fence_async_smem();
    __syncthreads();  // ... for every thread; and tile j - 1's stage is free
    if (j < j_last) load_kv(j + 1, st ^ 1);  // in flight while tile j computes
    const int kv0 = j * tc::kCols;
    const bool need_mask = kv0 + tc::kCols > Skv ||
                           (causal && kv0 + tc::kCols - 1 > q_first) ||
                           (window > 0 && q_last - kv0 >= window);
    tc::tile_step<D, false>(
        sm, sQ, sK(st), sV(st), scale_log2, need_mask,
        [&](int h, int col) { return attn_visible(qp[h], kv0 + col, Skv, causal, window); },
        nullptr, nullptr);
  }
  tc::epilogue<D>(sm, [&](int h, int col, float x0, float x1) {
    if (orow[h]) *reinterpret_cast<__nv_bfloat162*>(orow[h] + col) = __floats2bfloat162_rn(x0, x1);
  });
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int H, int KV, Strides4 qs, Strides4 ks, Strides4 vs,
                      Strides4 os, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  dim3 grid((Sq * G + tc::kRows - 1) / tc::kRows, KV, B);
  flash_fwd_tc_kernel<D><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, G, qs,
      ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q [B, Sq, H, D], k/v [B, Skv, KV, D], o [B, Sq, H, D]: element strides of
// the batch, sequence and head dims (the head_dim stride is 1); D is 8, 16,
// 64 or 128, and Sq may differ from Skv (cross-attention; a causal mask then
// compares the two positions from 0, as the plain version does). window <= 0
// means no window. dtype: 0 = fp32, 1 = bf16. lse, when not null, receives
// each row's fp32 log-sum-exp of the scaled scores, [B, H, Sq] contiguous,
// for the backward (flash_attention_bwd.cu); fp32 only. Returns
// cudaGetLastError().
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Skv,
    int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    int window, float scale, int dtype, void* stream) {
  using namespace repro;
  const Strides4 qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || B > 65535 || KV > 65535 ||
      (lse && dtype != kFloat32))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_SMALL(T, DIM) \
  return launch_small<T, DIM>(q, k, v, o, lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, \
                              window, scale, st)
  if (dtype == kFloat32 && D == 8) REPRO_FLASH_SMALL(float, 8);
  if (dtype == kFloat32 && D == 16) REPRO_FLASH_SMALL(float, 16);
  if (dtype == kBFloat16 && D == 8) REPRO_FLASH_SMALL(__nv_bfloat16, 8);
  if (dtype == kBFloat16 && D == 16) REPRO_FLASH_SMALL(__nv_bfloat16, 16);
#undef REPRO_FLASH_SMALL
  if (dtype == kFloat32 && D == 64)
    return launch<64>(q, k, v, o, lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  if (dtype == kFloat32 && D == 128)
    return launch<128>(q, k, v, o, lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  if (dtype == kBFloat16 && D == 64)
    return launch_tc<64>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  if (dtype == kBFloat16 && D == 128)
    return launch_tc<128>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
