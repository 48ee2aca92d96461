// Flash-attention backward for Hopper (sm_90a), fp32, products on the
// tensor cores as 3xTF32.
//
// The JAX package has no TPU kernel for this: its trainer differentiates
// XLA's attention (attn_impl="xla"), and its Pallas forward,
// src/repro/kernels/flash_attention/flash_attention.py (flash_attention_bhsd),
// has no custom_vjp. The port runs training's attention through its own
// forward kernel (flash_attention.cu), so the gradient is this kernel: the
// FlashAttention-2 backward, recomputing the probabilities from q, k and the
// forward's row log-sum-exp instead of storing them.
//
//   D    = rowsum(dO * O)                     [B, H, Sq]
//   P    = exp(scale * Q K^T - lse)           masked as the forward
//   dV   = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dQ   = scale * dS K,  dK = scale * dS^T Q
//
// Bound on the H100, at stablelm-1.6b's trained shape (B=4, S=256, 32 heads
// of 64, causal): bytes, 0.0201 ms (q, o, dO, k, v and the lse read once,
// dq, dk, dv written once, at 3.35 TB/s). The five products are 2.5 times
// the forward's matmul FLOPs; as 3xTF32 they take three TF32 products each
// at 495 TFLOP/s, 0.0163 ms. On the CUDA cores in fp32 (67 TFLOP/s) they
// would take 0.0402 ms, the bound of this kernel's first design, which this
// one is no longer held to. What holds it above the bound is instruction
// issue: per tensor-core instruction a warp issues about six others, half
// of them the operand splits (PERF.md, the flash backward's findings).
//
// Design:
//  * Every product runs on mma.sync m16n8k8 TF32 as 3xTF32 (tf32x3.cuh):
//    close to fp32 accuracy, the old kernel's tolerance kept. A block is
//    four warps; each owns 16 rows of the block's 64-row tile.
//  * A NaN in any input reaches the gradients where it reaches the plain
//    version's, and only the operands that carry it split with
//    tf32x3::split, one compare an element more than split_parts<false>:
//    Q and K in S, so a NaN there makes P NaN (the forward's lse may not
//    carry it); P and dS, computed in registers; and dO in dV = P^T dO. In
//    dP = dO V^T a NaN reaches dS through D = rowsum(dO * O) instead: dO's
//    directly, V's through o = P V, which the formulas presuppose. Q in dK
//    and K in dQ meet dS already NaN where their NaN counts.
//  * dQ runs first: one block per (64 query rows, query head, batch). It
//    computes D for its rows (two threads a row, O read once) into dvec for
//    the dK / dV pass, then walks the 32-row KV tiles its rows see: S = Q
//    K^T and dP = dO V^T, P and dS = P * (dP - D) in registers, dQ += dS K
//    with dS as the A operand straight from the accumulator (the k order
//    inside an accumulator's 8 columns matches B's rows; tf32x3.cuh).
//    Blocks whose rows see the most KV tiles launch first, so the causal
//    tail does not idle the card.
//  * dK / dV: one block per (64 KV rows, KV head, batch, split of the
//    group's query heads), walking (query head, 32-row query tile) pairs. A
//    warp computes S^T = K Q^T and dP^T = V dO^T for its 16 KV rows, so P^T
//    and dS^T come out with KV rows as rows and feed dV += P^T dO and dK +=
//    dS^T Q from registers: P and dS never leave them. dK, dV accumulate in
//    registers over the split's heads and tiles, in a fixed order. S and dP
//    are computed in both passes (7 products for the formula's 5: cheap on
//    the tensor cores, and no atomics).
//  * Grid: when (KV tiles x KV heads x batch) blocks would not give every SM
//    two, the wrapper splits each group's G heads over several blocks
//    (bwd_head_splits in ops.py). A split writes its partial dK, dV to an
//    fp32 scratch [2, splits, B, Skv, KV, D] and a sum pass adds the splits
//    in order: no atomics, so two calls give equal bits.
//  * Streamed tiles arrive by cp.async in a two-stage ring: the next pair's
//    Q, dO, lse and D in the dK / dV pass, the next K and V tile in the dQ
//    pass, while the current one computes; one barrier pair per step.
//    16-byte copies where the rows allow (every operand's pointer and
//    strides on 16 bytes, as the trainer's are), 4-byte ones otherwise. At
//    32 rows the ring leaves 68.5 KB of shared memory and at most 168
//    registers a thread at D = 64: three blocks to an SM (64-row tiles fit
//    two, 1.17x slower at stablelm's shape). Shared rows are D + 4 floats,
//    so both fragment reads (row r, column k: bank 4 r + k; and row k,
//    column n: bank 8 k + n for the 2-row steps of B in an accumulator's
//    order) hit 32 banks.
//  * Head widths 8 (the paper's Sec. V block, paper-block), 16, 64 and 128.
//    At D = 8 a product's depth is one m16n8k8 step and dK, dV, dQ one
//    n-tile; shared rows of 12 floats start on 16 bytes, and the fragment
//    reads stay free of bank conflicts (row r, column k in bank 12 r + k;
//    rows 2 tig, column gid in bank 24 tig + gid).
// Q, K, V, O and dO are read in the model layout [B, S, heads, D] through
// strides; dQ [B, Sq, H, D] and dK, dV [B, Skv, KV, D] are written through
// theirs. The mask (attn_visible) and the tile ranges come from common.cuh,
// the copies and the fragment reads from tf32x3_tiles.cuh, both shared with
// the fp32 forward; rows past S are zero-filled and masked.
#include "common.cuh"
#include "tf32x3.cuh"
#include "tf32x3_tiles.cuh"

namespace repro {
namespace {

using tf32x3::a_rows;
using tf32x3::b_cols;
using tf32x3::b_rows;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::row_stride;
using tf32x3::rows_16b;
using tf32x3::tile_visible;

constexpr int kT = 64;          // rows of a block's own tile (KV in dK / dV, queries in dQ)
constexpr int kS = 32;          // rows of a streamed tile (queries in dK / dV, KV in dQ)
constexpr int kWarps = 4;       // each owns 16 rows of the block's tile
constexpr int kThreads = 32 * kWarps;

// Two fixed [64][D] tiles and a two-stage ring of two [32][D] tiles and two
// 32-float row vectors (dQ keeps its two row vectors beside its fixed
// tiles): 68.5 KB at D = 64, three blocks to an SM.
template <int D>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * kT * row_stride<D>() + 4 * kS * row_stride<D>() + 4 * kS);
}
// Blocks an SM should hold at once, for the register budget: three at D <= 64.
template <int D>
__host__ __device__ constexpr int min_blocks() { return D <= 64 ? 3 : 1; }

template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks<D>()) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ scratch, int B, int Sq, int Skv, int H, int KV, int splits,
    int heads_per_split, Strides4 qs, Strides4 ks, Strides4 vs, Strides4 dos, Strides4 dks,
    Strides4 dvs, int causal, int window, float scale, bool vec16) {
  constexpr int LD = row_stride<D>();
  constexpr int TILE = kT * LD;
  constexpr int STILE = kS * LD;
  constexpr int NT = kS / 8;   // n-tiles of S^T
  constexpr int ND = D / 8;    // n-tiles of dK, dV
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + TILE;
  float* ring = sV + TILE;  // 2 stages of {Q, dO [32][LD]; lse, D [32]}
  constexpr int STAGE = 2 * STILE + 2 * kS;

  // Tile index slowest: under a causal mask the first KV tiles see the most
  // query tiles, and their blocks launch first.
  int idx = blockIdx.x;
  const int split = idx % splits;
  idx /= splits;
  const int kvh = idx % KV;
  idx /= KV;
  const int b = idx % B;
  const int kv0 = (idx / B) * kT;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int r0 = 16 * warp;  // the warp's KV rows in the tile
  const float scale_log2 = scale * LOG2E;  // P = 2^(S scale log2 e - lse log2 e)

  int i_first, i_last;
  q_tile_range(kv0, min(kv0 + kT, Skv) - 1, Sq, kS, causal, window, i_first, i_last);
  const int n_q = max(i_last - i_first + 1, 0);
  const int g_first = split * heads_per_split;
  const int n_pairs = n_q * max(min(G, g_first + heads_per_split) - g_first, 0);

  auto issue = [&](int n) {  // pair n's tiles into stage n % 2
    const int h = kvh * G + g_first + n / n_q, q0 = (i_first + n % n_q) * kS;
    float* st = ring + (n % 2) * STAGE;
    tf32x3::load_tile<D, kS, kThreads>(st, q + b * qs.b + h * qs.h, qs.s, q0, Sq, vec16);
    tf32x3::load_tile<D, kS, kThreads>(st + STILE, dout + b * dos.b + h * dos.h, dos.s, q0, Sq,
                                       vec16);
    const long long row = (static_cast<long long>(b) * H + h) * Sq;
    tf32x3::load_vec<kS, kThreads>(st + 2 * STILE, lse + row, q0, Sq);
    tf32x3::load_vec<kS, kThreads>(st + 2 * STILE + kS, dvec + row, q0, Sq);
  };

  float dK[ND][4] = {}, dV[ND][4] = {};
  if (n_pairs > 0) {
    tf32x3::load_tile<D, kT, kThreads>(sK, k + b * ks.b + kvh * ks.h, ks.s, kv0, Skv, vec16);
    tf32x3::load_tile<D, kT, kThreads>(sV, v + b * vs.b + kvh * vs.h, vs.s, kv0, Skv, vec16);
    issue(0);
  }
  cp_async_commit();
  for (int n = 0; n < n_pairs; ++n) {
    if (n + 1 < n_pairs) issue(n + 1);
    cp_async_commit();
    cp_async_wait<1>();  // pair n (and K, V) landed
    __syncthreads();
    const float* sQ = ring + (n % 2) * STAGE;
    const float* sdO = sQ + STILE;
    const float* sL = sQ + 2 * STILE;
    const float* sDv = sL + kS;
    const int q0 = (i_first + n % n_q) * kS;
    const bool all = tile_visible(q0, kS, kv0, kT, Sq, Skv, causal, window);
    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 KV rows x 32 queries.
    float st[NT][4] = {}, dpt[NT][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      FragA ak, av;
      a_rows<D, true>(ak, sK, r0, k0, gid, tig);
      a_rows<D>(av, sV, r0, k0, gid, tig);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        FragB bq, bo;
        b_rows<D, true>(bq, sQ, 8 * t, k0, gid, tig);
        b_rows<D>(bo, sdO, 8 * t, k0, gid, tig);
        tf32x3::mma3(st[t], ak, bq);
        tf32x3::mma3(dpt[t], av, bo);
      }
    }
    // P^T and dS^T = P^T * (dP^T - D) in place; column c is query q0 + c.
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = 8 * t + 2 * tig;
      const float2 L = *reinterpret_cast<const float2*>(sL + c);
      const float2 Dv = *reinterpret_cast<const float2*>(sDv + c);
      const float L2[2] = {L.x * LOG2E, L.y * LOG2E};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kv0 + r0 + gid + 8 * (e >> 1), qp = q0 + c + (e & 1);
        const bool ok = all || (qp < Sq && attn_visible(qp, kp, Skv, causal, window));
        const float p = exp2_ftz(fmaf(st[t][e], scale_log2, -L2[e & 1]));
        st[t][e] = ok ? p : 0.f;
        dpt[t][e] = st[t][e] * (dpt[t][e] - ((e & 1) ? Dv.y : Dv.x));
      }
    }
    // dV += P^T dO and dK += dS^T Q over the pair's queries.
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      FragA ap, ads;
      tf32x3::a_from_acc(ap, st[t]);
      tf32x3::a_from_acc(ads, dpt[t]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        FragB bo, bq;
        b_cols<D, true>(bo, sdO, 8 * t, 8 * nd, gid, tig);
        b_cols<D>(bq, sQ, 8 * t, 8 * nd, gid, tig);
        tf32x3::mma3(dV[nd], ap, bo);
        tf32x3::mma3(dK[nd], ads, bq);
      }
    }
    __syncthreads();  // stage n % 2 consumed: pair n + 2 may land there
  }
  cp_async_wait<0>();

  // dK (scaled) and dV of the warp's rows: to dk, dv, or to this split's
  // slice of the scratch.
  float *kb, *vb;
  long long k_row, v_row;
  if (splits == 1) {
    kb = dk + b * dks.b + kvh * dks.h;
    vb = dv + b * dvs.b + kvh * dvs.h;
    k_row = dks.s;
    v_row = dvs.s;
  } else {
    const long long part = static_cast<long long>(B) * Skv * KV * D;
    kb = scratch + split * part + (static_cast<long long>(b) * Skv * KV + kvh) * D;
    vb = kb + splits * part;
    k_row = v_row = static_cast<long long>(KV) * D;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = kv0 + r0 + gid + 8 * half;
    if (kp >= Skv) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int d = 8 * nd + 2 * tig;
      *reinterpret_cast<float2*>(kb + kp * k_row + d) =
          make_float2(dK[nd][2 * half] * scale, dK[nd][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(vb + kp * v_row + d) =
          make_float2(dV[nd][2 * half], dV[nd][2 * half + 1]);
    }
  }
}

// dk, dv = the splits' partials summed in split order, 4 floats a thread.
__global__ void flash_bwd_sum_kernel(const float* __restrict__ scratch, float* __restrict__ dk,
                                     float* __restrict__ dv, int B, int Skv, int KV, int D,
                                     int splits, Strides4 dks, Strides4 dvs) {
  const long long part = static_cast<long long>(B) * Skv * KV * D;
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * part) return;
  const bool is_v = i >= part;
  const long long j = is_v ? i - part : i;
  const float* src = scratch + (is_v ? splits * part : 0) + j;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * part);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const int d = j % D;
  const long long row = j / D;  // (b, kv position, kv head)
  const int kvh = row % KV, p = (row / KV) % Skv, b = row / (static_cast<long long>(KV) * Skv);
  const Strides4 st = is_v ? dvs : dks;
  float* dst = (is_v ? dv : dk) + b * st.b + p * st.s + kvh * st.h + d;
  dst[0] = acc.x;
  dst[1] = acc.y;
  dst[2] = acc.z;
  dst[3] = acc.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks<D>()) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dvec, float* __restrict__ dq, int B, int Sq, int Skv, int H, int KV,
    Strides4 qs, Strides4 ks, Strides4 vs, Strides4 os, Strides4 dos, Strides4 dqs, int causal,
    int window, float scale, bool vec16) {
  constexpr int LD = row_stride<D>();
  constexpr int TILE = kT * LD;
  constexpr int STILE = kS * LD;
  constexpr int NT = kS / 8;   // n-tiles of S
  constexpr int ND = D / 8;    // n-tiles of dQ
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + TILE;
  float* sL = sdO + TILE;
  float* sDv = sL + kT;
  float* ring = sDv + kT;  // 2 stages of {K, V [32][LD]}

  // Tile index slowest and reversed: under a causal mask the last query
  // tiles see the most KV tiles, and their blocks launch first.
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int b = idx % B;
  const int n_tiles = (Sq + kT - 1) / kT;
  const int q0 = (n_tiles - 1 - idx / B) * kT;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int r0 = 16 * warp;  // the warp's query rows in the tile
  const float scale_log2 = scale * LOG2E;  // P = 2^(S scale log2 e - lse log2 e)

  int j_first, j_last;
  kv_tile_range(q0, min(q0 + kT, Sq) - 1, Skv, kS, causal, window, j_first, j_last);
  const int n_kv = max(j_last - j_first + 1, 0);
  auto issue = [&](int n) {  // KV tile j_first + n into stage n % 2
    float* st = ring + (n % 2) * 2 * STILE;
    const int kv0 = (j_first + n) * kS;
    tf32x3::load_tile<D, kS, kThreads>(st, k + b * ks.b + kvh * ks.h, ks.s, kv0, Skv, vec16);
    tf32x3::load_tile<D, kS, kThreads>(st + STILE, v + b * vs.b + kvh * vs.h, vs.s, kv0, Skv,
                                       vec16);
  };

  const long long row = (static_cast<long long>(b) * H + h) * Sq;
  tf32x3::load_tile<D, kT, kThreads>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, vec16);
  tf32x3::load_tile<D, kT, kThreads>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq, vec16);
  tf32x3::load_vec<kT, kThreads>(sL, lse + row, q0, Sq);
  cp_async_commit();
  if (n_kv > 0) issue(0);
  cp_async_commit();
  cp_async_wait<1>();  // Q, dO and lse landed
  __syncthreads();
  {
    // D = rowsum(dO * O) of the tile's rows, two threads a row, into sDv
    // (read after the loop's first barrier) and dvec (for the dK / dV pass).
    const int r = threadIdx.x / 2, half = threadIdx.x % 2, qp = q0 + r;
    float acc = 0.f;
    if (qp < Sq) {
      const float* orow = o + b * os.b + qp * os.s + h * os.h + half * (D / 2);
      const float* drow = sdO + r * LD + half * (D / 2);
      if (vec16) {
#pragma unroll
        for (int d = 0; d < D / 2; d += 4) {
          const float4 x = *reinterpret_cast<const float4*>(orow + d);
          acc = fmaf(x.x, drow[d], acc);
          acc = fmaf(x.y, drow[d + 1], acc);
          acc = fmaf(x.z, drow[d + 2], acc);
          acc = fmaf(x.w, drow[d + 3], acc);
        }
      } else {
#pragma unroll
        for (int d = 0; d < D / 2; ++d) acc = fmaf(orow[d], drow[d], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sDv[r] = acc;
      if (qp < Sq) dvec[row + qp] = acc;
    }
  }
  float dQ[ND][4] = {};
  for (int n = 0; n < n_kv; ++n) {
    if (n + 1 < n_kv) issue(n + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile n landed
    __syncthreads();
    const float* sK = ring + (n % 2) * 2 * STILE;
    const float* sV = sK + STILE;
    const int kv0 = (j_first + n) * kS;
    const bool all = tile_visible(q0, kT, kv0, kS, Sq, Skv, causal, window);
    const float L2[2] = {sL[r0 + gid] * LOG2E, sL[r0 + gid + 8] * LOG2E};
    const float Dv[2] = {sDv[r0 + gid], sDv[r0 + gid + 8]};
    // S = Q K^T and dP = dO V^T: the warp's 16 query rows x 32 keys.
    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      FragA aq, ao;
      a_rows<D, true>(aq, sQ, r0, k0, gid, tig);
      a_rows<D>(ao, sdO, r0, k0, gid, tig);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        FragB bk, bv;
        b_rows<D, true>(bk, sK, 8 * t, k0, gid, tig);
        b_rows<D>(bv, sV, 8 * t, k0, gid, tig);
        tf32x3::mma3(s[t], aq, bk);
        tf32x3::mma3(dp[t], ao, bv);
      }
    }
    // dS = P * (dP - D) in place of dP; column c is key kv0 + c.
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + r0 + gid + 8 * (e >> 1), kp = kv0 + 8 * t + 2 * tig + (e & 1);
        const bool ok = all || (qp < Sq && attn_visible(qp, kp, Skv, causal, window));
        const float p = ok ? exp2_ftz(fmaf(s[t][e], scale_log2, -L2[e >> 1])) : 0.f;
        dp[t][e] = p * (dp[t][e] - Dv[e >> 1]);
      }
    }
    // dQ += dS K over the tile's keys.
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      FragA ads;
      tf32x3::a_from_acc(ads, dp[t]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        FragB bk;
        b_cols<D>(bk, sK, 8 * t, 8 * nd, gid, tig);
        tf32x3::mma3(dQ[nd], ads, bk);
      }
    }
    __syncthreads();  // stage n % 2 consumed: tile n + 2 may land there
  }
  cp_async_wait<0>();

  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = q0 + r0 + gid + 8 * half;
    if (qp >= Sq) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(dqb + qp * dqs.s + 8 * nd + 2 * tig) =
          make_float2(dQ[nd][2 * half] * scale, dQ[nd][2 * half + 1] * scale);
  }
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* dout, const float* lse, float* dvec, float* dq, float* dk,
                       float* dv, float* scratch, int B, int Sq, int Skv, int H, int KV,
                       int splits, int per_split, const Strides4* st, int causal, int window,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D>();
  const bool vec16 = rows_16b(q, st[0]) && rows_16b(k, st[1]) && rows_16b(v, st[2]) &&
                     rows_16b(o, st[3]) && rows_16b(dout, st[4]);
  // dQ first: it also writes D = rowsum(dO * O), which dK / dV reads.
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<((Sq + kT - 1) / kT) * H * B, kThreads, smem, stream>>>(
      q, k, v, o, dout, lse, dvec, dq, B, Sq, Skv, H, KV, st[0], st[1], st[2], st[3], st[4],
      st[5], causal, window, scale, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int kv_tiles = (Skv + kT - 1) / kT;
  flash_bwd_dkdv_kernel<D><<<kv_tiles * KV * B * splits, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, scratch, B, Sq, Skv, H, KV, splits, per_split, st[0],
      st[1], st[2], st[4], st[6], st[7], causal, window, scale, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long n4 = 2LL * B * Skv * KV * D / 4;
    flash_bwd_sum_kernel<<<(n4 + 255) / 256, 256, 0, stream>>>(scratch, dk, dv, B, Skv, KV, D,
                                                               splits, st[6], st[7]);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// fp32 q, o, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Skv, KV, D]; lse (the
// forward's) and dvec (scratch) [B, H, Sq] contiguous. splits: how many
// blocks share each group of G = H / KV query heads in the dK / dV pass,
// per_split heads each (the last split takes the rest): every split must
// take a head, (splits - 1) * per_split < G <= splits * per_split. Above 1
// split, scratch is a contiguous fp32 [2, splits, B, Skv, KV, D] (else
// unused). strides: 24 element strides, (batch, seq, head) of q, k, v, o,
// dout, dq, dk, dv in that order (the head_dim stride is 1; dq, dk and dv
// rows on 8 bytes). D is 8, 16, 64 or 128; causal, window and scale as the
// forward's. Returns the first launch's error, else cudaGetLastError().
extern "C" int repro_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* o, const float* dout,
    const float* lse, float* dvec, float* dq, float* dk, float* dv, float* scratch, int B,
    int Sq, int Skv, int H, int KV, int D, int splits, int per_split, const long long* strides,
    int causal, int window, float scale, void* stream) {
  using namespace repro;
  if (Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || splits < 1 || per_split < 1 ||
      (splits - 1) * per_split >= H / KV || splits * per_split < H / KV ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>((Skv + kT - 1) / kT) * KV * B * splits;
  if (blocks > 0x7fffffffLL || static_cast<long long>((Sq + kT - 1) / kT) * H * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides4 st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides4{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD(DIM)                                                                   \
  return launch_bwd<DIM>(q, k, v, o, dout, lse, dvec, dq, dk, dv, scratch, B, Sq, Skv, H, KV,  \
                         splits, per_split, st, causal, window, scale, s)
  if (D == 8) REPRO_FLASH_BWD(8);
  if (D == 16) REPRO_FLASH_BWD(16);
  if (D == 64) REPRO_FLASH_BWD(64);
  if (D == 128) REPRO_FLASH_BWD(128);
#undef REPRO_FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
