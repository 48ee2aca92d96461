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
// dispatch at the bottom picks one of two designs by head_dim and dtype:
// bf16 at head_dim 64 / 128 on wgmma, everything else (fp32 at every
// head_dim, bf16 at 8 / 16) computing in fp32 with P V as 3xTF32.
//
// bf16, head_dim 64 / 128: the tensor cores (attention_tc.cuh). One
// warpgroup per (64 rows, KV head, batch), where a row is one (query
// position, query head of the KV head's group) pair, position-major, so the
// G heads of a group share each K/V tile and read it from device memory
// once. Q and the K/V tiles arrive by 16-byte cp.async into
// 128-byte-swizzled shared memory, K/V in a 2-stage ring (tile j + 1 in
// flight while tile j computes); rows past Skv are zero-filled and masked.
// Shared memory: 41 KB at D = 64 and 81 KB at D = 128, so 4 and 2 blocks
// share an SM (registers allow as many). Bound on the H100: bytes at the
// serving shapes (prompts of 8..128 tokens: a few MFLOP per head against a
// few MB), where the time is the latency of a block's first loads;
// operations at long prompts, where the tensor cores and the exponentials
// on the special-function units take about equal time at D = 64.
//
// fp32 compute (flash_fwd_kernel<D, T, W>): training's forward, with the
// lse, and the parity path at head_dim 64 / 128; every call at head_dim 8
// and 16 (the paper's Sec. V block has 100 heads of 8), fp32 or bf16. One
// block of W warps per (16 W rows, KV head, batch), rows packed per KV head
// as in the bf16 kernel, so a group's heads share each K/V tile; a warp
// owns 16 rows, a thread two of them. W is 4, or 1 at head_dim 8 / 16 when
// a KV head has at most 16 rows (paper-block served: 16 positions of one
// head), so that no warp of a block idles. K/V tiles of 32 rows arrive by
// cp.async in a 2-stage ring (tf32x3_tiles.cuh; bf16 rows as they are, 48
// bytes apart, converted when read), Q once, as fp32. S = Q K^T runs on the
// CUDA cores as fp32 FMAs over d in order, Q scaled as the plain version
// scales it, into the registers of an mma.sync accumulator; the online
// softmax runs per fragment row, its exponentials on ex2; O += P V runs on
// the tensor cores as 3xTF32 (tf32x3.cuh, mma.sync m16n8k8, D / 8 n-tiles;
// one TF32 product keeps ~3 decimal digits), P the A operand straight from
// S's registers. S stays in fp32 because, as 3xTF32, its rounding parted
// from the plain version's enough that a 3-layer full-width model carried
// the difference past chip_smoke.py phase 25's gradient tolerance
// (PERF.md). A K row of 8 or 16 elements is below wgmma's 16-element
// contraction step and the 128-byte swizzle of the bf16 tiles, so bf16 at
// head_dim 8 / 16 computes here too. Bound on the H100: bytes at the
// trained shapes at head_dim 64 (B=4, S=256), about equal to the products
// at 495 / 3 TFLOP/s; fp32 operations at head_dim 8 (paper-block trained),
// where S's FMAs are a third of the work and the softmax and the splits of
// P the rest; the launch's fixed cost at the served 16-row heads. What
// holds the kernel above its bound is the fp32 FMAs of S and the
// instruction issue around the mma.sync.
#include <type_traits>

#include "attention_tc.cuh"
#include "common.cuh"
#include "tf32x3.cuh"
#include "tf32x3_tiles.cuh"

namespace repro {
namespace {

// ---- fp32 compute, every head_dim but bf16 64 / 128: P V as 3xTF32 ---------

using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::row_stride;

namespace f32 {

// A block is W warps, each owning 16 rows: (query position, query head of
// the group) pairs.
template <int W>
__host__ __device__ constexpr int rows() { return 16 * W; }

// The choices per head width, from ptxas and timed runs (PERF.md):
// K/V rows per tile of a four-warp block (kKV) and the four-warp blocks an
// SM should hold, for the register budget (kMinBlocks). At D = 64: 52.2 KB
// of shared memory and 168 registers (8 bytes spilled; at two blocks an SM,
// 211 registers and none, stablelm-1.6b's trained shape ran 6% slower);
// 64-row K/V tiles were slower too. At D = 128: 101.4 KB, 255 registers, 24
// bytes spilled. At D = 8 and 16 a 32-row tile is too little work between
// two barriers: 64 rows ran paper-block's trained shapes 9-16% faster, and
// five blocks an SM (102 registers) 0-3% faster still; one-warp blocks take
// 24 an SM (85 registers), 6-9% faster at the served shape than 16.
template <int D>
struct Tiles;
template <>
struct Tiles<8> {
  static constexpr int kKV = 64;
  static constexpr int kMinBlocks = 5;
};
template <>
struct Tiles<16> {
  static constexpr int kKV = 64;
  static constexpr int kMinBlocks = 5;
};
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

// K/V rows per tile: a one-warp block (at most 16 rows of a KV head, the
// served encoder-decoders' 16 keys) takes 32.
template <int D, int W>
__host__ __device__ constexpr int kv_rows() { return W == 1 ? 32 : Tiles<D>::kKV; }

// Shared row stride of a K / V tile, in elements: fp32 rows row_stride<D>()
// (D + 4) apart; bf16 rows (head_dim 8 and 16 only) 48 bytes apart, on 16
// bytes for cp.async, which keeps the fragment reads below on distinct
// banks (rows 2 tig, 2 tig + 1 of a step start 24 and 12 banks apart).
template <int D, typename T>
__host__ __device__ constexpr int kv_stride() {
  static_assert(std::is_same<T, float>::value || D <= 16, "bf16 takes head_dim 8 / 16 here");
  return std::is_same<T, float>::value ? row_stride<D>() : 24;
}

// Q (fp32, scaled in place) and a 2-stage ring of K and V tiles.
template <int D, typename T, int W>
constexpr size_t smem_bytes() {
  return sizeof(float) * row_stride<D>() * rows<W>() +
         sizeof(T) * kv_stride<D, T>() * 4 * kv_rows<D, W>();
}

// The block's rows of Q into dst [rows][D + 4] as fp32: row r is query
// position (r0 + r) / G of head kvh * G + (r0 + r) % G; rows past n_rows
// are zero-filled. fp32 by cp.async; bf16 (rows on 16 bytes, as the
// wrapper checks) by 16-byte loads converted in registers.
template <int D, typename T, int W>
__device__ __forceinline__ void load_q(float* dst, const T* qb, const Strides4& qs, int r0,
                                       int n_rows, int G, int kvh, bool vec16) {
  constexpr int LD = row_stride<D>();
  constexpr int ROWS = rows<W>(), THREADS = 32 * W;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int V = 4;  // floats a 16-byte copy moves
    const int per = vec16 ? D / V : D;
    for (int i = threadIdx.x; i < ROWS * per; i += THREADS) {
      const int r = i / per, c = i % per, row = r0 + r;
      const bool ok = row < n_rows;
      const float* src = ok ? qb + (row / G) * qs.s + (kvh * G + row % G) * qs.h : qb;
      if (vec16)
        tf32x3::cp_async_16(tf32x3::smem_addr(dst + r * LD + V * c), src + (ok ? V * c : 0), ok);
      else
        tf32x3::cp_async_4(tf32x3::smem_addr(dst + r * LD + c), src + (ok ? c : 0), ok);
    }
  } else {
    constexpr int per = D / 8;  // 16-byte pieces of a row
    for (int i = threadIdx.x; i < ROWS * per; i += THREADS) {
      const int r = i / per, c = i % per, row = r0 + r;
      float f[8] = {};
      if (row < n_rows) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            qb + (row / G) * qs.s + (kvh * G + row % G) * qs.h + 8 * c);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          f[2 * e] = p.x, f[2 * e + 1] = p.y;
        }
      }
      float4* out = reinterpret_cast<float4*>(dst + r * LD + 8 * c);
      out[0] = make_float4(f[0], f[1], f[2], f[3]);
      out[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// ROWS rows of one head of a bf16 [B, S, heads, D] tensor (base points at
// the batch and head) into dst [ROWS][24], 16 bytes a copy; rows past S
// are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                               long long s_stride, int row0, int S) {
  constexpr int LDK = kv_stride<D, __nv_bfloat16>(), C = D / 8;
  for (int i = threadIdx.x; i < ROWS * C; i += THREADS) {
    const int r = i / C, c = i % C, p = row0 + r;
    tf32x3::cp_async_16(tf32x3::smem_addr(dst + r * LDK + 8 * c),
                        p < S ? base + p * s_stride + 8 * c : base, p < S);
  }
}

// Four consecutive elements of a shared K row, as fp32.
__device__ __forceinline__ float4 kv4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 kv4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The B operand of P V from a shared V tile (tf32x3::b_cols, for either
// element type): rows k0 + 2 tig and + 1 at column n0 + gid, split
// keeping NaNs.
template <int D>
__device__ __forceinline__ void v_cols(FragB& f, const float* s, int k0, int n0, int gid,
                                       int tig) {
  tf32x3::b_cols<D, true>(f, s, k0, n0, gid, tig);
}
template <int D>
__device__ __forceinline__ void v_cols(FragB& f, const __nv_bfloat16* s, int k0, int n0,
                                       int gid, int tig) {
  constexpr int LDK = kv_stride<D, __nv_bfloat16>();
  const __nv_bfloat16* p = s + (k0 + 2 * tig) * LDK + n0 + gid;
  const float x[2] = {__bfloat162float(p[0]), __bfloat162float(p[LDK])};
  tf32x3::split_parts<true>(f, x);
}

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace f32

// One block of W warps per (16 W rows, KV head, batch) of a 1-D grid, row
// tile slowest and reversed: under a causal mask the last rows see the most
// K/V tiles, and their blocks launch first. A row is one (query position,
// query head of the KV head's group) pair, position-major, so the G heads
// of a group share every K/V tile, which is read from device memory once
// per group. T is the element type of q, k, v and o (fp32; bf16 at head_dim
// 8 / 16); the arithmetic is fp32 for both.
template <int D, typename T, int W>
__global__ void __launch_bounds__(32 * W, W == 4 ? f32::Tiles<D>::kMinBlocks : 24)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int B, int Sq, int Skv, int H,
                     int KV, Strides4 qs, Strides4 ks, Strides4 vs, Strides4 os, int causal,
                     int window, float scale, bool vec16) {
  constexpr int LD = row_stride<D>();
  constexpr int LDK = f32::kv_stride<D, T>();
  constexpr int ROWS = f32::rows<W>(), THREADS = 32 * W;
  constexpr int BKV = f32::kv_rows<D, W>();
  constexpr int STILE = BKV * LDK;
  constexpr int NT = BKV / 8;  // n-tiles of S, k-steps of P V
  constexpr int ND = D / 8;    // n-tiles of O
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                                     // Q * scale
  T* ring = reinterpret_cast<T*>(sQ + ROWS * LD);       // 2 stages of {K, V [BKV][LDK]}

  const int G = H / KV;
  const int n_rows = Sq * G;
  int idx = blockIdx.x;
  const int kvh = idx % KV;
  idx /= KV;
  const int b = idx % B;
  const int r0 = ((n_rows + ROWS - 1) / ROWS - 1 - idx / B) * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wr = 16 * warp;  // the warp's first row in the block

  int j_first, j_last;
  kv_tile_range(r0 / G, (min(r0 + ROWS, n_rows) - 1) / G, Skv, BKV, causal, window, j_first,
                j_last);
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

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  auto issue = [&](int n) {  // K/V tile j_first + n into stage n % 2
    T* st = ring + (n % 2) * 2 * STILE;
    const int kv0 = (j_first + n) * BKV;
    if constexpr (std::is_same<T, float>::value) {
      tf32x3::load_tile<D, BKV, THREADS>(st, kb, ks.s, kv0, Skv, vec16);
      tf32x3::load_tile<D, BKV, THREADS>(st + STILE, vb, vs.s, kv0, Skv, vec16);
    } else {
      f32::load_tile_bf16<D, BKV, THREADS>(st, kb, ks.s, kv0, Skv);
      f32::load_tile_bf16<D, BKV, THREADS>(st + STILE, vb, vs.s, kv0, Skv);
    }
  };

  f32::load_q<D, T, W>(sQ, q + b * qs.b, qs, r0, n_rows, G, kvh, vec16);
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
    const T* sK = ring + (n % 2) * 2 * STILE;
    const T* sV = sK + STILE;
    const int kv0 = (j_first + n) * BKV;
    // A warp whose rows see none of the tile's keys skips it.
    const bool sees = warp_live && !(causal && wq_last < kv0) &&
                      !(window > 0 && wq_first - (kv0 + BKV - 1) >= window);
    if (sees) {
      // S = Q K^T for the warp's 16 rows x BKV keys, in the accumulator
      // layout of mma.sync (rows gid and gid + 8, columns 8 t + 2 tig and
      // + 1), by fp32 FMAs over d in order, as the plain version's matmul
      // sums them; 16-byte shared reads (8-byte in bf16), free of bank
      // conflicts.
      float s[NT][4] = {};
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(q_row[0] + d);
        const float4 qb = *reinterpret_cast<const float4*>(q_row[1] + d);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float4 ka = f32::kv4(sK + (8 * t + 2 * tig) * LDK + d);
          const float4 kc = f32::kv4(sK + (8 * t + 2 * tig + 1) * LDK + d);
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
          f32::v_cols<D>(bv, sV, 8 * t, 8 * nd, gid, tig);
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
    T* orow = o + b * os.b + qp[h] * os.s + head[h] * os.h;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      f32::store2(orow + 8 * nd + 2 * tig, acc[nd][2 * h] * inv, acc[nd][2 * h + 1] * inv);
    // The row's log-sum-exp for the backward; a row that sees nothing gets
    // -NEG_INF, so that its recomputed probabilities exp(s - lse) are 0.
    if (lse && tig == 0)
      lse[(static_cast<long long>(b) * H + head[h]) * Sq + qp[h]] =
          l[h] > 0.f ? m[h] + logf(l[h]) : -NEG_INF;
  }
}

template <int D, typename T, int W>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int KV, Strides4 qs, Strides4 ks,
                   Strides4 vs, Strides4 os, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = f32::smem_bytes<D, T, W>();
  constexpr int ROWS = f32::rows<W>();
  const long long blocks = static_cast<long long>((Sq * (H / KV) + ROWS - 1) / ROWS) * KV * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  bool vec16 = true;  // bf16 rows are on 16 bytes: the wrapper checks
  if constexpr (std::is_same<T, float>::value)
    vec16 = tf32x3::rows_16b(qt, qs) && tf32x3::rows_16b(kt, ks) && tf32x3::rows_16b(vt, vs);
  flash_fwd_kernel<D, T, W><<<static_cast<unsigned>(blocks), 32 * W, smem, stream>>>(
      qt, kt, vt, static_cast<T*>(o), lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window,
      scale, vec16);
  return cudaGetLastError();
}

// head_dim 8 / 16: blocks of one warp when a KV head's rows fit 16 (the
// served encoder-decoders' 16 positions of a head), so that no warp of a
// block idles; else four.
template <int D, typename T>
cudaError_t launch_fit(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Skv, int H, int KV, Strides4 qs, Strides4 ks, Strides4 vs,
                       Strides4 os, int causal, int window, float scale, cudaStream_t stream) {
  if (Sq * (H / KV) <= 16)
    return launch<D, T, 1>(q, k, v, o, lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window,
                           scale, stream);
  return launch<D, T, 4>(q, k, v, o, lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window,
                         scale, stream);
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
#define REPRO_FLASH_FIT(T, DIM) \
  return launch_fit<DIM, T>(q, k, v, o, lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, \
                            window, scale, st)
  if (dtype == kFloat32 && D == 8) REPRO_FLASH_FIT(float, 8);
  if (dtype == kFloat32 && D == 16) REPRO_FLASH_FIT(float, 16);
  if (dtype == kBFloat16 && D == 8) REPRO_FLASH_FIT(__nv_bfloat16, 8);
  if (dtype == kBFloat16 && D == 16) REPRO_FLASH_FIT(__nv_bfloat16, 16);
#undef REPRO_FLASH_FIT
  if (dtype == kFloat32 && D == 64)
    return launch<64, float, 4>(q, k, v, o, lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal,
                                window, scale, st);
  if (dtype == kFloat32 && D == 128)
    return launch<128, float, 4>(q, k, v, o, lse, B, Sq, Skv, H, KV, qs, ks, vs, os, causal,
                                 window, scale, st);
  if (dtype == kBFloat16 && D == 64)
    return launch_tc<64>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  if (dtype == kBFloat16 && D == 128)
    return launch_tc<128>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
