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
// Flash-style, one thread block per (tile of 64 rows, KV head, lane), where
// a row is one (query position, query head of the KV head's group) pair,
// position-major: all G heads of a GQA group share each K/V tile. The TPU
// kernel runs one grid cell per (lane, KV head, logical page) and merges the
// per-page partials afterwards; here a loop inside the block walks 64-row KV
// tiles from position 0 to the tile's last query position, so pages wholly
// past the causal edge (which add exp(-inf) = 0 on the TPU) are never read
// and no partials or merge pass exist. C is arbitrary (the serving chunk,
// or a whole prompt for int8 whole prefill): rows past C * G are masked and
// never written. Rows past the caller's valid count still see their causal
// prefix and stay finite; a row with no visible position (a negative
// offset) writes 0. The dispatch at the bottom picks one of two designs by
// the query dtype.
//
// bf16 queries: the tensor cores (attention_tc.cuh). At block start the
// lane's block-table entries up to the last visible page go into shared
// memory in one pass. K/V tiles are gathered row by row from
// pool[bt[t / page], t % page, kvh, :] into a 2-stage ring of 128-byte-
// swizzled tiles, tile j + 1 in flight while tile j computes: bf16 pages by
// 16-byte cp.async (rows past the visible end zero-filled), int8 pages by
// 16-byte loads into registers one tile ahead, converted to bf16 (exact)
// when stored, with each row's scales beside the tile (k_scale on the
// scores; v_scale folded into P, carried as two bf16 operands). Bound on
// the H100: bytes at the serving chunk (C = 32 queries against a short
// prefix), where the time is the latency of a block's loads; operations at
// long prefixes, where one block walks up to 64 tiles in sequence.
//
// fp32 queries: the CUDA cores, the parity path (fp32 on the tensor cores
// would be TF32). Per KV tile, 64 threads first resolve each row's pool
// offset and int8 scales into shared memory, then the block stages the
// tile's K/V as fp32 (dequantized) and runs flash_attention.cu's fp32 online
// softmax: four warps own 16 rows each, a lane owns two score columns and
// D/32 output columns, (m, l, acc) live in registers. Bound: bytes at the
// serving chunk; the fp32 FMAs (67 TFLOP/s) at long prefixes.
#include "attention_tc.cuh"
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

template <typename KT, int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const float* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ offsets,
    float* __restrict__ o, int C, int NB, int page, int G, long long bt_sb, Strides4 qs,
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
      x = q[b * qs.b + (ri / G) * qs.s + h * qs.h + d] * scale;
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
    float* ob = o + b * os.b + (ri / G) * os.s + h * os.h;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) ob[lane + 32 * i] = acc[r][i] / denom;
  }
}

template <typename KT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* block_tables, const int* offsets,
                   void* o, int B, int C, int NB, int page, int H, int KV, long long bt_sb,
                   Strides4 qs, PoolStrides ks, PoolStrides vs, long long sc_p,
                   long long sc_r, Strides4 os, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  dim3 grid((C * G + kBQ - 1) / kBQ, KV, B);
  paged_prefill_kernel<KT, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      k_scale, v_scale, block_tables, offsets, static_cast<float*>(o), C, NB, page, G,
      bt_sb, qs, ks, vs, sc_p, sc_r, os, scale);
  return cudaGetLastError();
}

// ---- bf16 queries: tensor cores (attention_tc.cuh) ---------------------------

// Alignment slack, Q, two stages of K and V, two stages of the K and V
// scales (int8 pools), and the block's block-table entries.
template <int D, bool kQuant>
size_t tc_smem_bytes(int NB) {
  return 1024 + 5 * tc::tile_bytes<D>() + (kQuant ? 4 * tc::kCols * sizeof(float) : 0) +
         NB * sizeof(int);
}

// One block (one warpgroup) per (tile of 64 rows, KV head, lane), rows as in
// the fp32 kernel. bf16 pools arrive by cp.async straight into the swizzled
// tiles; int8 pools by 16-byte loads into registers one tile ahead,
// converted to bf16 (exact) when they are stored.
template <int D, bool kQuant>
__global__ void __launch_bounds__(tc::kThreads) paged_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
    const void* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ offsets, __nv_bfloat16* __restrict__ o, int C, int NB, int page,
    int G, long long bt_sb, Strides4 qs, PoolStrides ks, PoolStrides vs, long long sc_p,
    long long sc_r, Strides4 os, float scale) {
  constexpr uint32_t kTile = tc::tile_bytes<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  unsigned char* tail = smem_raw + (sQ - raw) + 5 * kTile;
  float* sKsc = reinterpret_cast<float*>(tail);  // [2][kCols] (int8 pools)
  float* sVsc = sKsc + 2 * tc::kCols;
  int* sBT = reinterpret_cast<int*>(tail + (kQuant ? 4 * tc::kCols * sizeof(float) : 0));
  auto sK = [&](int st) { return sQ + kTile * (1 + 2 * st); };
  auto sV = [&](int st) { return sQ + kTile * (2 + 2 * st); };

  const int r0 = (gridDim.x - 1 - blockIdx.x) * tc::kRows;  // longest prefixes first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_rows = C * G;
  const int off = offsets[b];
  const int q_min = off + r0 / G;
  const int q_max = off + (min(r0 + tc::kRows, n_rows) - 1) / G;
  const int kv_end = min(q_max + 1, NB * page);  // rows [0, kv_end) may be visible
  const int n_tiles = kv_end > 0 ? (kv_end + tc::kCols - 1) / tc::kCols : 0;
  const int n_pages = kv_end > 0 ? (kv_end + page - 1) / page : 0;

  // The lane's pages up to the last visible one, once.
  const int* bt = block_tables + b * bt_sb;
  for (int i = tid; i < n_pages; i += tc::kThreads) sBT[i] = bt[i];
  __syncthreads();

  int qp[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + tc::frag_row(h);
    qp[h] = off + r / G;
    orow[h] = r < n_rows ? o + b * os.b + (r / G) * os.s + (kvh * G + r % G) * os.h : nullptr;
  }
  // Pool element offset of position t's row for this KV head (t < kv_end).
  auto pool_row = [&](const PoolStrides& ps, int t) {
    const int blk = t / page;
    return sBT[blk] * ps.p + (t - blk * page) * ps.r + kvh * ps.h;
  };

  // int8 pools: tile j + 1 waits in registers while tile j computes.
  constexpr int kChunks8 = D / 16;  // 16-byte int8 chunks per row
  constexpr int kPer = tc::kRows * kChunks8 / tc::kThreads;
  int4 kr[kPer], vr[kPer];
  float scr = 0.f;  // thread t < 64: k_scale of row t; else v_scale of row t - 64
  auto fetch_int8 = [&](int j) {
    const int8_t* kp = static_cast<const int8_t*>(k);
    const int8_t* vp = static_cast<const int8_t*>(v);
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int c = tid + n * tc::kThreads;
      const int t = j * tc::kCols + c / kChunks8, ch = c % kChunks8;
      kr[n] = vr[n] = make_int4(0, 0, 0, 0);
      if (t < kv_end) {
        kr[n] = __ldg(reinterpret_cast<const int4*>(kp + pool_row(ks, t) + ch * 16));
        vr[n] = __ldg(reinterpret_cast<const int4*>(vp + pool_row(vs, t) + ch * 16));
      }
    }
    const int t = j * tc::kCols + (tid % tc::kCols);
    scr = 0.f;
    if (t < kv_end) {
      const int blk = t / page;
      const long long idx = sBT[blk] * sc_p + (t - blk * page) * sc_r;
      scr = tid < tc::kCols ? k_scale[idx] : v_scale[idx];
    }
  };
  auto stash_int8 = [&](int st) {
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int c = tid + n * tc::kThreads;
      const int row = c / kChunks8, ch = c % kChunks8;
      tc::store_int8_as_bf16(sK(st), row, 2 * ch, kr[n]);
      tc::store_int8_as_bf16(sV(st), row, 2 * ch, vr[n]);
    }
    (tid < tc::kCols ? sKsc : sVsc)[st * tc::kCols + tid % tc::kCols] = scr;
  };
  auto load_bf16 = [&](int j, int st) {
    const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
    const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
    tc::load_tiles_async<D>(sK(st), sV(st), [&](int row) {
      const int t = j * tc::kCols + row;
      return t < kv_end ? tc::RowPair{kp + pool_row(ks, t), vp + pool_row(vs, t)}
                        : tc::RowPair{nullptr, nullptr};
    });
    tc::cp_async_commit();
  };

  tc::Softmax<D> sm;
  sm.init();
  const float scale_log2 = scale * tc::kLog2e;
  if (n_tiles > 0) {
    tc::load_tile_async<D>(sQ, [&](int row) {
      const int r = r0 + row;
      return r < n_rows ? q + b * qs.b + (r / G) * qs.s + (kvh * G + r % G) * qs.h : nullptr;
    });
    if constexpr (kQuant) {
      tc::cp_async_commit();
      fetch_int8(0);
    } else {
      load_bf16(0, 0);
    }
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if constexpr (kQuant) stash_int8(st);  // tile j, from registers
    tc::cp_async_wait_all();               // Q, and tile j of bf16 pools
    tc::fence_async_smem();
    __syncthreads();  // tile j visible to all; tile j - 1's stage free
    if (j + 1 < n_tiles) {  // in flight while tile j computes
      if constexpr (kQuant) {
        fetch_int8(j + 1);
      } else {
        load_bf16(j + 1, st ^ 1);
      }
    }
    const int kv0 = j * tc::kCols;
    const bool need_mask = kv0 + tc::kCols - 1 > q_min || kv0 + tc::kCols > kv_end;
    tc::tile_step<D, kQuant>(
        sm, sQ, sK(st), sV(st), scale_log2, need_mask,
        [&](int h, int col) {
          const int t = kv0 + col;
          return t < kv_end && t <= qp[h];
        },
        sKsc + st * tc::kCols, sVsc + st * tc::kCols);
  }
  tc::epilogue<D>(sm, [&](int h, int col, float x0, float x1) {
    if (orow[h]) *reinterpret_cast<__nv_bfloat162*>(orow[h] + col) = __floats2bfloat162_rn(x0, x1);
  });
}

template <int D, bool kQuant>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* k_scale,
                      const float* v_scale, const int* block_tables, const int* offsets,
                      void* o, int B, int C, int NB, int page, int H, int KV, long long bt_sb,
                      Strides4 qs, PoolStrides ks, PoolStrides vs, long long sc_p,
                      long long sc_r, Strides4 os, float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D, kQuant>(NB);
  cudaError_t err = cudaFuncSetAttribute(paged_prefill_tc_kernel<D, kQuant>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  dim3 grid((C * G + tc::kRows - 1) / tc::kRows, KV, B);
  paged_prefill_tc_kernel<D, kQuant><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, k_scale, v_scale, block_tables, offsets,
      static_cast<__nv_bfloat16*>(o), C, NB, page, G, bt_sb, qs, ks, vs, sc_p, sc_r, os, scale);
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
#define REPRO_PAGED_PREFILL(KT, DIM)                                                    \
  return launch<KT, DIM>(q, k, v, ksc, vsc, bt, offs, o, B, C, NB, page, H, KV, bt_sb,  \
                         qs, ks, vs, sc_p, sc_r, os, scale, st)
  if (dtype == kFloat32 && !kv_int8 && D == 64) REPRO_PAGED_PREFILL(float, 64);
  if (dtype == kFloat32 && !kv_int8 && D == 128) REPRO_PAGED_PREFILL(float, 128);
  if (dtype == kFloat32 && kv_int8 && D == 64) REPRO_PAGED_PREFILL(int8_t, 64);
  if (dtype == kFloat32 && kv_int8 && D == 128) REPRO_PAGED_PREFILL(int8_t, 128);
#undef REPRO_PAGED_PREFILL
#define REPRO_PAGED_PREFILL_TC(DIM, QUANT)                                              \
  return launch_tc<DIM, QUANT>(q, k, v, ksc, vsc, bt, offs, o, B, C, NB, page, H, KV,    \
                               bt_sb, qs, ks, vs, sc_p, sc_r, os, scale, st)
  if (dtype == kBFloat16 && !kv_int8 && D == 64) REPRO_PAGED_PREFILL_TC(64, false);
  if (dtype == kBFloat16 && !kv_int8 && D == 128) REPRO_PAGED_PREFILL_TC(128, false);
  if (dtype == kBFloat16 && kv_int8 && D == 64) REPRO_PAGED_PREFILL_TC(64, true);
  if (dtype == kBFloat16 && kv_int8 && D == 128) REPRO_PAGED_PREFILL_TC(128, true);
#undef REPRO_PAGED_PREFILL_TC
  return static_cast<int>(cudaErrorInvalidValue);
}
