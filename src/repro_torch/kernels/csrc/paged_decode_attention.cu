// Paged split-KV flash-decode for Hopper (sm_90a): one new query token per
// lane attends to its context scattered over a shared page pool, named page
// by page through the lane's block table, with an optional window and
// optional int8 pages dequantized on load.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged.py
// (paged_decode_attention, pallas_call at :143) and the XLA log-sum-exp
// merge that follows it (:154-159).
//
// Bound on the H100: bytes. A decode step does 4 * D FLOPs per (query head,
// cached row) against 2 * D * itemsize bytes of K and V per (KV head, row)
// (plus 8 bytes of scales for int8 rows), far below the ~295 FLOP/byte
// ridge. At serving sizes (a few MB) the call is short, so what bounds it in
// practice is the fixed cost of a launch and the longest lane's chain of
// dependent loads. The design:
//
// - One block per (lane, KV head, group of GB query heads) and chunk of the
//   lane's block-table row (whole pages: the wrapper's split_pages, from
//   the launch shape that repro_paged_decode_attention_launch_shape
//   exports, so the constants below are named in this file only). A row
//   is split only where each warp still walks a few pages: a block's eight
//   warps cover a 16-page row at two pages each. A split row's chunks
//   (at most 8) form one thread-block cluster, which merges them itself; a
//   row of one chunk is a plain launch. A chunk wholly past the length, or
//   before the window, reads nothing.
// - A warp owns whole pages (the chunk's pages dealt round robin to its
//   warps). It reads the ids of up to 32 of its pages with one load, issued
//   beside the loads of the lane's length and of q (lane j holds page j's
//   id), and takes each by a shuffle, so the block table is off the path of
//   every K/V load: the first waits on one load, as it must.
// - 16-byte loads: each lane loads 8 elements of a row (bf16: one 16-byte
//   load, fp32 two, int8 one 8-byte load), D / 8 lanes per row, so one
//   warp instruction covers 4 rows at D = 64. A step loads all K and V rows
//   of its NL instructions (16 rows of a page at D = 64 bf16) before using
//   any; the next step's loads are issued before this step's arithmetic.
// - A row's score is reduced over the D / 8 lanes of the row (3 shuffles at
//   D = 64); exponentials are ex2.approx.ftz with scale * log2(e) folded
//   into q. Each lane keeps its own online-softmax state (m, l, acc) over
//   its rows; the warp merges them at the end, then the block, then the
//   cluster through distributed shared memory, whose ranks split the output
//   and write it. One launch, no partials in global memory.
//
// The pool is read in the engine's per-layer view of [n_layers, P+1, page,
// KV, head_dim] through strides (no copy); the scales likewise from
// [n_layers, P+1, page]. Pool rows start on 16-byte boundaries (the wrapper
// checks it).
//
// Lengths are clamped to [.., NB * page]: a row past the block table is
// never addressed, and a length <= 0 reads nothing (output 0).
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

// Query heads per block: one under MHA keeps the registers of one; GQA
// takes kGroupHeads.
constexpr int heads_per_block(int G) { return G == 1 ? 1 : kGroupHeads; }

// Element strides of a page pool [page id, row, KV head, head_dim] whose
// head_dim is contiguous (the wrapper checks it).
struct PoolStrides {
  long long p, r, h;
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

template <typename T, typename KT, int D, int GB>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ lengths, T* __restrict__ o,
    int NB, int page, int G, int n_gblk, int per_chunk, long long bt_sb, Strides4 qs,
    PoolStrides ks, PoolStrides vs, long long sc_p, long long sc_r, Strides4 os, int window,
    float qscale) {
  constexpr bool kQuant = sizeof(KT) == 1;
  constexpr int LPR = D / kElems;               // lanes per row
  constexpr int RPI = 32 / LPR;                 // rows per warp load instruction
  constexpr int NL = sizeof(KT) == 4 ? 2 : 4;   // row slots per lane per step
  constexpr int RS = NL * RPI;                  // rows per warp step

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());  // chunk
  const int n_chunks = static_cast<int>(cluster.num_blocks());
  const int kvh = blockIdx.y / n_gblk;
  const int g0 = (blockIdx.y % n_gblk) * GB;
  const int ng = min(GB, G - g0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / LPR;  // which row of a load instruction
  const int col = lane % LPR;   // which 8 elements of the row

  // This warp's pages of the chunk: c * per_chunk + warp + k * kWarps. Their
  // ids (lane j: page k = j of each batch of 32) and q are loaded before the
  // length is known, so the three loads run side by side.
  const int c_first = c * per_chunk + warp;
  const int c_end = min((c + 1) * per_chunk, NB);
  const int* bt = block_tables + b * bt_sb + c_first;  // page k's id: bt[k * kWarps]
  int batch = 0;  // k of lane 0's id
  int ids = c_first + lane * kWarps < c_end ? __ldg(bt + lane * kWarps) : 0;
  const int raw = __ldg(lengths + b);

  float qr[GB][kElems], m[GB], l[GB], acc[GB][kElems];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < ng
          ? to_float(q[b * qs.b + (kvh * G + g0 + g) * qs.h + col * kElems + e]) * qscale
          : 0.f;
    }
  }

  const int hi = min(raw, NB * page);
  const int lo = window > 0 ? max(0, raw - window) : 0;
  // This warp's pages holding visible rows: k in [k_lo, k_hi).
  const int p_lo = max(c * per_chunk, lo / page);
  const int p_hi = min(c_end, hi > 0 ? (hi + page - 1) / page : 0);
  const int k_lo = max(0, (p_lo - c_first + kWarps - 1) / kWarps);
  const int k_hi = p_hi > c_first ? (p_hi - c_first + kWarps - 1) / kWarps : 0;
  const int spp = (page + RS - 1) / RS;  // steps per page
  const int n_steps = k_hi > k_lo ? (k_hi - k_lo) * spp : 0;

  const KT* kb = k + kvh * ks.h + col * kElems;
  const KT* vb = v + kvh * vs.h + col * kElems;

  auto load_step = [&](Step<KT, NL>& st, int s) {
    const int kq = s / spp;
    const int kp = k_lo + kq;
    const int r0 = (s - kq * spp) * RS;
    if ((kp & ~31) != batch) {  // the next 32 pages' ids
      batch = kp & ~31;
      ids = c_first + (batch + lane) * kWarps < c_end ? __ldg(bt + (batch + lane) * kWarps) : 0;
    }
    const long long pg = __shfl_sync(0xffffffffu, ids, kp & 31);
    const int t_page = (c_first + kp * kWarps) * page;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int row = r0 + i * RPI + slot;
      const int t = t_page + row;
      st.ok[i] = row < page && t >= lo && t < hi;
      if (st.ok[i]) {
        load_row<KT>(st.k[i], kb + pg * ks.p + row * ks.r);
        load_row<KT>(st.v[i], vb + pg * vs.p + row * vs.r);
        if constexpr (kQuant) {
          st.ksc[i] = k_scale[pg * sc_p + row * sc_r];
          st.vsc[i] = v_scale[pg * sc_p + row * sc_r];
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
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2_ftz(wm[w][g] - mx);
      ls = fmaf(wt, wl[w][g], ls);
      a = fmaf(wt, wacc[w][g][d], a);
    }
    bacc[g][d] = a;
    if (d == 0) bm[g] = mx, bl[g] = ls;
  }
  cluster.sync();  // every chunk's partial is in its block's shared memory

  // The cluster's blocks split the group's outputs and merge the chunks.
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
    o[b * os.b + (kvh * G + g0 + g) * os.h + d] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
  cluster.sync();  // keep this block's shared memory until every rank has read it
}

template <typename T, typename KT, int D, int GB>
cudaError_t launch(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* block_tables, const int* lengths, void* o,
                   int B, int NB, int page, int H, int KV, int per_chunk, int n_chunks,
                   long long bt_sb, Strides4 qs, PoolStrides ks, PoolStrides vs, long long sc_p,
                   long long sc_r, Strides4 os, int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int n_gblk = (G + GB - 1) / GB;
  const T* qt = static_cast<const T*>(q);
  const KT* kt = static_cast<const KT*>(k);
  const KT* vt = static_cast<const KT*>(v);
  T* ot = static_cast<T*>(o);
  const float qscale = scale * LOG2E;
  if (n_chunks == 1) {  // a block is its own cluster: a plain launch
    paged_decode_kernel<T, KT, D, GB><<<dim3(1, KV * n_gblk, B), kThreads, 0, stream>>>(
        qt, kt, vt, k_scale, v_scale, block_tables, lengths, ot, NB, page, G, n_gblk,
        per_chunk, bt_sb, qs, ks, vs, sc_p, sc_r, os, window, qscale);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_chunks, KV * n_gblk, B);
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
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_decode_kernel<T, KT, D, GB>, qt, kt, vt, k_scale, v_scale, block_tables,
      lengths, ot, NB, page, G, n_gblk, per_chunk, bt_sb, qs, ks, vs, sc_p, sc_r, os, window,
      qscale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Blocks of the instantiation launch_group picks for G that an SM holds at
// once (registers, shared memory), or -1 on an error.
template <typename T, typename KT, int D>
int blocks_per_sm(int G) {
  int n = -1;
  const cudaError_t err =
      heads_per_block(G) == 1
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, paged_decode_kernel<T, KT, D, 1>,
                                                          kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, paged_decode_kernel<T, KT, D, kGroupHeads>, kThreads, 0);
  return err == cudaSuccess ? n : -1;
}

template <typename T, typename KT, int D>
cudaError_t launch_group(int G, const void* q, const void* k, const void* v,
                         const float* k_scale, const float* v_scale, const int* bt,
                         const int* lens, void* o, int B, int NB, int page, int H, int KV,
                         int per_chunk, int n_chunks, long long bt_sb, Strides4 qs,
                         PoolStrides ks, PoolStrides vs, long long sc_p, long long sc_r,
                         Strides4 os, int window, float scale, cudaStream_t stream) {
  if (heads_per_block(G) == 1)
    return launch<T, KT, D, 1>(q, k, v, k_scale, v_scale, bt, lens, o, B, NB, page, H, KV,
                               per_chunk, n_chunks, bt_sb, qs, ks, vs, sc_p, sc_r, os, window,
                               scale, stream);
  return launch<T, KT, D, kGroupHeads>(q, k, v, k_scale, v_scale, bt, lens, o, B, NB, page, H,
                                       KV, per_chunk, n_chunks, bt_sb, qs, ks, vs, sc_p, sc_r,
                                       os, window, scale, stream);
}

}  // namespace
}  // namespace repro

// q [B, 1, H, D]; k/v pools [P, page, KV, D] (strides of page, row, head)
// in q's dtype, or int8 with fp32 scales [P, page] (strides sc_p, sc_r;
// null pointers for unquantized pools); block_tables [B, NB] int32 (row
// stride bt_sb); lengths [B] int32 = valid rows including the new token;
// per_chunk = pages per chunk, n_chunks (1..8) chunks per block-table row
// with per_chunk * n_chunks >= NB; o [B, 1, H, D]. window <= 0 means no
// window. dtype of q/o: 0 = fp32, 1 = bf16; kv_int8: 1 = int8 pools. Pool
// rows must start on 16-byte boundaries. Returns the launch's error.
extern "C" int repro_paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* lengths, void* o, int B,
    int NB, int page, int H, int KV, int D, int per_chunk, int n_chunks, long long bt_sb,
    long long q_sb, long long q_sh, long long k_sp, long long k_sr, long long k_sh,
    long long v_sp, long long v_sr, long long v_sh, long long sc_p, long long sc_r,
    long long o_sb, long long o_sh, int window, float scale, int dtype, int kv_int8,
    void* stream) {
  using namespace repro;
  if (n_chunks < 1 || n_chunks > kMaxChunks || per_chunk < 1 || page < 1 || KV < 1 ||
      H % KV != 0 || (long long)per_chunk * n_chunks < NB || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides4 qs{q_sb, 0, q_sh}, os{o_sb, 0, o_sh};
  const PoolStrides ks{k_sp, k_sr, k_sh}, vs{v_sp, v_sr, v_sh};
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
#define REPRO_PAGED_DECODE(T, KT, DIM)                                                      \
  return launch_group<T, KT, DIM>(G, q, k, v, ksc, vsc, bt, lens, o, B, NB, page, H, KV,    \
                                  per_chunk, n_chunks, bt_sb, qs, ks, vs, sc_p, sc_r, os,   \
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

// The launch shape the entry above takes for these arguments, which the
// wrapper splits block-table rows by: shape[0] blocks of the instantiation
// per SM, shape[1] warps per block, shape[2] the most chunks of one row (the
// blocks of a cluster), shape[3] query heads per block. Returns 0, or the
// error for arguments the entry refuses.
extern "C" int repro_paged_decode_attention_launch_shape(int D, int G, int dtype, int kv_int8,
                                                          int* shape) {
  using namespace repro;
  int n = -1;
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32 && !kv_int8 && D == 64) n = blocks_per_sm<float, float, 64>(G);
  else if (dtype == kFloat32 && !kv_int8 && D == 128) n = blocks_per_sm<float, float, 128>(G);
  else if (dtype == kBFloat16 && !kv_int8 && D == 64) n = blocks_per_sm<__nv_bfloat16, __nv_bfloat16, 64>(G);
  else if (dtype == kBFloat16 && !kv_int8 && D == 128) n = blocks_per_sm<__nv_bfloat16, __nv_bfloat16, 128>(G);
  else if (dtype == kFloat32 && kv_int8 && D == 64) n = blocks_per_sm<float, int8_t, 64>(G);
  else if (dtype == kFloat32 && kv_int8 && D == 128) n = blocks_per_sm<float, int8_t, 128>(G);
  else if (dtype == kBFloat16 && kv_int8 && D == 64) n = blocks_per_sm<__nv_bfloat16, int8_t, 64>(G);
  else if (dtype == kBFloat16 && kv_int8 && D == 128) n = blocks_per_sm<__nv_bfloat16, int8_t, 128>(G);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  shape[0] = n;
  shape[1] = kWarps;
  shape[2] = kMaxChunks;
  shape[3] = heads_per_block(G);
  return 0;
}
