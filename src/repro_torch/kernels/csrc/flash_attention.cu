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
// fp32: the CUDA cores, the parity path (fp32 on the tensor cores would be
// TF32, ~3 decimal digits). One block per (64 query rows, query head,
// batch); each of the four warps owns 16 rows; a lane owns two score
// columns of the current KV tile and D/32 output columns. Q, the K/V tile
// and the tile's probabilities are staged in shared memory as fp32 (K
// padded by one column so a warp reading 32 different K rows hits 32
// banks). Bound: bytes at the serving shapes; at long prompts the fp32 FMAs
// (67 TFLOP/s), which this design reaches only in part.
#include <algorithm>

#include "attention_tc.cuh"
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int G, Strides4 qs,
    Strides4 ks, Strides4 vs, Strides4 os, int causal, int window, float scale) {
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    sQ[i] = qp < Sq ? qb[qp * qs.s + d] * scale : 0.f;
  }

  int j_first, j_last;
  kv_tile_range(q0, q0 + kBQ - 1, Skv, kBKV, causal, window, j_first, j_last);

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
        kx = kb[kp * ks.s + d];
        vx = vb[kp * vs.s + d];
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
        const bool valid = qp < Sq && attn_visible(qp, kv0 + lane + 32 * c, Skv, causal, window);
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

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + row0 + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) ob[qp * os.s + lane + 32 * i] = acc[r][i] / denom;
    // The row's log-sum-exp for the backward; a row that sees nothing gets
    // -NEG_INF, so that its recomputed probabilities exp(s - lse) are 0.
    if (lse && lane == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qp] =
          l[r] > 0.f ? m[r] + logf(l[r]) : -NEG_INF;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int KV, Strides4 qs, Strides4 ks,
                   Strides4 vs, Strides4 os, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Skv, H / KV, qs, ks, vs, os, causal, window, scale);
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
