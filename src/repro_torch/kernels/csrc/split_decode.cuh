// Split-KV flash-decode body for Hopper (sm_90a), shared by the dense and
// the paged decode kernels: one new query token per lane attends to the
// lane's cached rows with per-lane lengths, an optional window and, for
// paged pools, int8 rows dequantized on load.
//
// A lane's rows come in tiles of whole rows, and the two kernels differ only
// in how a warp finds its tile's first row (kTable): a paged pool's tile is a
// page, named by the lane's block-table row; a dense cache's tile j is
// positions [16 j, 16 j + 16) of the lane's own rows, found by position.
//
// Bound on the H100: bytes. A decode step does 4 * D FLOPs per (query head,
// cached row) against 2 * D * itemsize bytes of K and V per (KV head, row)
// (plus 8 bytes of scales for int8 rows), far below the ~295 FLOP/byte
// ridge. At serving sizes (a few MB) the call is short, so what bounds it in
// practice is the fixed cost of a launch and the longest lane's chain of
// dependent loads. The design:
//
// - One block per (lane, KV head, group of GB query heads) and chunk of the
//   lane's tiles (the wrappers' split_tiles, from the launch shape that the
//   C entries' *_launch_shape export, so the constants below are named in
//   this file only). A row is split only where each warp still walks a few
//   tiles. A split row's chunks (at most 8) form one thread-block cluster,
//   which merges them itself; a row of one chunk is a plain launch. A chunk
//   wholly past the length, or before the window, reads nothing.
// - A warp owns whole tiles (the chunk's tiles dealt round robin to its
//   warps). Under a block table it reads the ids of up to 32 of its tiles
//   with one load, issued beside the loads of the lane's length and of q
//   (lane j holds tile j's id), and takes each by a shuffle, so the table is
//   off the path of every K/V load.
// - 16-byte loads: each lane loads 8 elements of a row (bf16: one 16-byte
//   load, fp32 two, int8 one 8-byte load), D / 8 lanes per row, so one
//   warp instruction covers 4 rows at D = 64. A step loads all K and V rows
//   of its NL instructions (16 rows at D = 64 bf16) before using any; the
//   next step's loads are issued before this step's arithmetic.
// - A row's score is reduced over the D / 8 lanes of the row (3 shuffles at
//   D = 64); exponentials are ex2.approx.ftz with scale * log2(e) folded
//   into q. Each lane keeps its own online-softmax state (m, l, acc) over
//   its rows; the warp merges them at the end, then the block, then the
//   cluster through distributed shared memory, whose ranks split the output
//   and write it. One launch, no partials in global memory.
//
// A lane sees rows [length - window, length), as the TPU kernels and the
// plain versions mask them, cut to the rows it holds (n_rows): a row past
// them is never addressed, and a length <= 0 reads nothing (output 0, as
// the TPU kernels give). Where the dense kernel is asked for it, the cluster
// merge writes the output in fp32 and each head's log-sum-exp (m + log l,
// fp32; -inf for a lane that reads nothing), so that a decode over one shard
// of a cache's rows merges with the other shards' and rounds once, as JAX
// merges fp32 partials; the paged kernel passes no lse pointer, and its only
// cost there is one branch per output element. Rows start on 16-byte
// boundaries (the wrappers check it).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kElems = 8;       // elements of a K / V row per lane
constexpr int kMaxChunks = 8;   // blocks per cluster (the portable limit)
constexpr int kGroupHeads = 4;  // query heads per block under GQA
constexpr int kDenseTile = 16;  // rows of a dense cache's tile

// Query heads per block: one under MHA keeps the registers of one; GQA
// takes kGroupHeads.
constexpr int heads_per_block(int G) { return G == 1 ? 1 : kGroupHeads; }

// Element strides of K or V: lane (dense caches; 0 for a pool), tile (a
// pool's page; kDenseTile rows of a dense cache), row within the tile, KV
// head. head_dim is contiguous (the wrappers check it).
struct TileStrides {
  long long b, p, r, h;
};

// One call's operands. q / o: T [B, 1, H, D]; k / v: KT rows; scales: int8
// rows' fp32 scales by (tile id, row), strides sc_p / sc_r (null otherwise);
// block_tables: [B, n_tiles] int32 tile ids, row stride bt_sb (null for a
// dense cache); lengths [B] int32 = valid rows including the new token;
// lse: null, or [B, H] fp32 (lane stride lse_sb) for each head's log-sum-exp
// of its scaled scores over the visible rows (-inf where none is), and then
// o is fp32.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* lengths;
  void* o;
  float* lse;
  long long lse_sb;
  int n_tiles;    // tiles of one lane
  int tile;       // rows of a tile
  int n_rows;     // rows a lane holds: longer lengths are clamped to it
  int G;          // query heads per KV head
  int n_gblk;     // query-head groups per KV head
  int per_chunk;  // tiles per chunk
  long long bt_sb, sc_p, sc_r;
  Strides4 qs, os;
  TileStrides ks, vs;
  int window;    // <= 0: none
  float qscale;  // scale * log2(e)
};

// kElems elements of a row as raw 32-bit words.
template <typename KT>
struct RowWords {
  static constexpr int n = kElems * sizeof(KT) / 4;
  uint32_t w[n];
};

template <typename KT>
__device__ __forceinline__ void load_row(RowWords<KT>& r, const KT* p) {
  if constexpr (sizeof(KT) == 1) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x, r.w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < RowWords<KT>::n / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      r.w[4 * i] = v.x, r.w[4 * i + 1] = v.y, r.w[4 * i + 2] = v.z, r.w[4 * i + 3] = v.w;
    }
  }
}

template <typename KT>
__device__ __forceinline__ void to_floats(const RowWords<KT>& r, float (&f)[kElems]) {
  if constexpr (sizeof(KT) == 1) {
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      f[e] = static_cast<float>(static_cast<int8_t>((r.w[e / 4] >> (8 * (e % 4))) & 0xff));
  } else if constexpr (sizeof(KT) == 2) {  // bf16: element 2i is the low half
#pragma unroll
    for (int i = 0; i < kElems / 2; ++i) {
      f[2 * i] = __uint_as_float(r.w[i] << 16);
      f[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kElems; ++e) f[e] = __uint_as_float(r.w[e]);
  }
}

// One step's K / V rows for one lane: NL row slots, NL * RPI rows per warp.
template <typename KT, int NL>
struct Step {
  RowWords<KT> k[NL], v[NL];
  float ksc[NL], vsc[NL];
  bool ok[NL];
};

template <typename T, typename KT, int D, int GB, bool kTable>
__global__ void __launch_bounds__(kThreads) split_decode_kernel(const DecodeArgs a) {
  constexpr bool kQuant = sizeof(KT) == 1;
  constexpr int LPR = D / kElems;               // lanes per row
  constexpr int RPI = 32 / LPR;                 // rows per warp load instruction
  constexpr int NL = sizeof(KT) == 4 ? 2 : 4;   // row slots per lane per step
  constexpr int RS = NL * RPI;                  // rows per warp step
  const int page = kTable ? a.tile : kDenseTile;
  const T* q = static_cast<const T*>(a.q);

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());  // chunk
  const int n_chunks = static_cast<int>(cluster.num_blocks());
  const int kvh = blockIdx.y / a.n_gblk;
  const int g0 = (blockIdx.y % a.n_gblk) * GB;
  const int ng = min(GB, a.G - g0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / LPR;  // which row of a load instruction
  const int col = lane % LPR;   // which 8 elements of the row

  // This warp's tiles of the chunk: c * per_chunk + warp + k * kWarps. Under
  // a block table their ids (lane j: tile k = j of each batch of 32) and q
  // are loaded before the length is known, so the three loads run side by side.
  const int c_first = c * a.per_chunk + warp;
  const int c_end = min((c + 1) * a.per_chunk, a.n_tiles);
  // Tile k's id is bt[k * kWarps].
  const int* bt = kTable ? a.block_tables + b * a.bt_sb + c_first : nullptr;
  int batch = 0;  // k of lane 0's id
  int ids = 0;
  if constexpr (kTable) ids = c_first + lane * kWarps < c_end ? __ldg(bt + lane * kWarps) : 0;
  const int raw = __ldg(a.lengths + b);

  float qr[GB][kElems], m[GB], l[GB], acc[GB][kElems];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < ng
          ? to_float(q[b * a.qs.b + (kvh * a.G + g0 + g) * a.qs.h + col * kElems + e]) * a.qscale
          : 0.f;
    }
  }

  const int hi = min(raw, a.n_rows);
  const int lo = a.window > 0 ? max(0, raw - a.window) : 0;
  // This warp's tiles holding visible rows: k in [k_lo, k_hi).
  const int p_lo = max(c * a.per_chunk, lo / page);
  const int p_hi = min(c_end, hi > 0 ? (hi + page - 1) / page : 0);
  const int k_lo = max(0, (p_lo - c_first + kWarps - 1) / kWarps);
  const int k_hi = p_hi > c_first ? (p_hi - c_first + kWarps - 1) / kWarps : 0;
  const int spp = (page + RS - 1) / RS;  // steps per tile
  const int n_steps = k_hi > k_lo ? (k_hi - k_lo) * spp : 0;

  const KT* kb = static_cast<const KT*>(a.k) + b * a.ks.b + kvh * a.ks.h + col * kElems;
  const KT* vb = static_cast<const KT*>(a.v) + b * a.vs.b + kvh * a.vs.h + col * kElems;

  auto load_step = [&](Step<KT, NL>& st, int s) {
    const int kq = s / spp;
    const int kp = k_lo + kq;
    const int r0 = (s - kq * spp) * RS;
    long long pg;  // the tile's id: its page, or its index in the lane's rows
    if constexpr (kTable) {
      if ((kp & ~31) != batch) {  // the next 32 tiles' ids
        batch = kp & ~31;
        ids = c_first + (batch + lane) * kWarps < c_end ? __ldg(bt + (batch + lane) * kWarps) : 0;
      }
      pg = __shfl_sync(0xffffffffu, ids, kp & 31);
    } else {
      pg = c_first + kp * kWarps;
    }
    const int t_page = (c_first + kp * kWarps) * page;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int row = r0 + i * RPI + slot;
      const int t = t_page + row;
      st.ok[i] = row < page && t >= lo && t < hi;
      if (st.ok[i]) {
        load_row<KT>(st.k[i], kb + pg * a.ks.p + row * a.ks.r);
        load_row<KT>(st.v[i], vb + pg * a.vs.p + row * a.vs.r);
        if constexpr (kQuant) {
          st.ksc[i] = a.k_scale[pg * a.sc_p + row * a.sc_r];
          st.vsc[i] = a.v_scale[pg * a.sc_p + row * a.sc_r];
        }
      } else {
#pragma unroll
        for (int w = 0; w < RowWords<KT>::n; ++w) st.k[i].w[w] = st.v[i].w[w] = 0u;
        if constexpr (kQuant) st.ksc[i] = st.vsc[i] = 0.f;
      }
    }
  };

  Step<KT, NL> cur, nxt;
  if (n_steps > 0) load_step(cur, 0);
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) load_step(nxt, s + 1);
    // Scores of the step's rows for each query head, one row slot at a time
    // (one slot's K in floats at once keeps the registers down).
    float sc[GB][NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float kf[kElems];
      to_floats<KT>(cur.k[i], kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kElems; ++e) part = fmaf(qr[g][e], kf[e], part);
        sc[g][i] = part;
      }
    }
    float p[GB][NL];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= ng) break;
      float smax = NEG_INF;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float part = sc[g][i];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if constexpr (kQuant) part *= cur.ksc[i];
        sc[g][i] = cur.ok[i] ? part : NEG_INF;
        smax = fmaxf(smax, sc[g][i]);
      }
      const float m_new = fmaxf(m[g], smax);
      const float corr = exp2_ftz(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        p[g][i] = cur.ok[i] ? exp2_ftz(sc[g][i] - m_new) : 0.f;
        psum += p[g][i];
        if constexpr (kQuant) p[g][i] *= cur.vsc[i];
      }
      l[g] = fmaf(l[g], corr, psum);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float vf[kElems];
      to_floats<KT>(cur.v[i], vf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= ng) break;
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[g][e] = fmaf(p[g][i], vf[e], acc[g][e]);
      }
    }
    if (s + 1 < n_steps) cur = nxt;
  }

  // Merge the warp's row slots (lanes LPR apart), then the block's warps.
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], m_o);
      const float w = exp2_ftz(m[g] - mx), w_o = exp2_ftz(m_o - mx);
      l[g] = l[g] * w + l_o * w_o;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * w + a_o * w_o;
      }
    }
  }
  __shared__ float wm[kWarps][GB], wl[kWarps][GB];
  __shared__ float wacc[kWarps][GB][D];
  __shared__ float bm[GB], bl[GB];  // the block's partial, read by the cluster
  __shared__ float bacc[GB][D];
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (col == 0) wm[warp][g] = m[g], wl[warp][g] = l[g];
#pragma unroll
      for (int e = 0; e < kElems; ++e) wacc[warp][g][col * kElems + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < GB * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float ls = 0.f, acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2_ftz(wm[w][g] - mx);
      ls = fmaf(wt, wl[w][g], ls);
      acc_d = fmaf(wt, wacc[w][g][d], acc_d);
    }
    bacc[g][d] = acc_d;
    if (d == 0) bm[g] = mx, bl[g] = ls;
  }
  cluster.sync();  // every chunk's partial is in its block's shared memory

  // The cluster's blocks split the group's outputs and merge the chunks.
  T* o = static_cast<T*>(a.o);
  for (int e = c * kThreads + threadIdx.x; e < ng * D; e += n_chunks * kThreads) {
    const int g = e / D, d = e % D;
    float mc[kMaxChunks];
    float mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < kMaxChunks; ++r) {
      mc[r] = r < n_chunks ? cluster.map_shared_rank(&bm[0], r)[g] : NEG_INF;
      mx = fmaxf(mx, mc[r]);
    }
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxChunks; ++r) {
      if (r < n_chunks) {
        const float wt = exp2_ftz(mc[r] - mx);
        den = fmaf(wt, cluster.map_shared_rank(&bl[0], r)[g], den);
        num = fmaf(wt, cluster.map_shared_rank(&bacc[0][0], r)[g * D + d], num);
      }
    }
    const long long oi = b * a.os.b + (kvh * a.G + g0 + g) * a.os.h + d;
    if (a.lse == nullptr) {
      o[oi] = from_float<T>(num / fmaxf(den, 1e-30f));
    } else {
      // A shard's partial for the merge across shards: the output in fp32,
      // so that the merge rounds once, and its log-sum-exp, back from base 2.
      static_cast<float*>(a.o)[oi] = num / fmaxf(den, 1e-30f);
      if (d == 0)
        a.lse[b * a.lse_sb + kvh * a.G + g0 + g] =
            den > 0.f ? (mx + log2f(den)) * LN2 : -INFINITY;
    }
  }
  cluster.sync();  // keep this block's shared memory until every rank has read it
}

template <typename T, typename KT, int D, int GB, bool kTable>
cudaError_t launch_blocks(const DecodeArgs& a, int B, int KV, int n_chunks, cudaStream_t stream) {
  const dim3 grid(n_chunks, KV * a.n_gblk, B);
  if (n_chunks == 1) {  // a block is its own cluster: a plain launch
    split_decode_kernel<T, KT, D, GB, kTable><<<grid, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, split_decode_kernel<T, KT, D, GB, kTable>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Launch the instantiation that heads_per_block picks for a.G; fills in
// a.n_gblk and a.qscale.
template <typename T, typename KT, int D, bool kTable>
cudaError_t launch_split_decode(DecodeArgs a, int B, int KV, int n_chunks, float scale,
                                cudaStream_t stream) {
  const int GB = heads_per_block(a.G);
  a.n_gblk = (a.G + GB - 1) / GB;
  a.qscale = scale * LOG2E;
  if (GB == 1) return launch_blocks<T, KT, D, 1, kTable>(a, B, KV, n_chunks, stream);
  return launch_blocks<T, KT, D, kGroupHeads, kTable>(a, B, KV, n_chunks, stream);
}

// The launch shape launch_split_decode takes for G, which the wrappers
// split rows by: shape[0] blocks of the instantiation per SM (registers,
// shared memory), shape[1] warps per block, shape[2] the most chunks of one
// row (the blocks of a cluster), shape[3] query heads per block. Returns 0
// or the error.
template <typename T, typename KT, int D, bool kTable>
cudaError_t split_decode_launch_shape(int G, int* shape) {
  int n = -1;
  const cudaError_t err =
      heads_per_block(G) == 1
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, split_decode_kernel<T, KT, D, 1, kTable>, kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, split_decode_kernel<T, KT, D, kGroupHeads, kTable>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  shape[0] = n;
  shape[1] = kWarps;
  shape[2] = kMaxChunks;
  shape[3] = heads_per_block(G);
  return cudaSuccess;
}

}  // namespace
}  // namespace repro
