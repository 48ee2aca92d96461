// Tensor-core tile step shared by the bf16 prefill-attention kernels
// (flash_attention.cu, paged_prefill_attention.cu) on Hopper (sm_90a).
//
// Replaces the inner step of the TPU kernels
// src/repro/kernels/flash_attention/flash_attention.py (_attn_kernel, under
// flash_attention_bhsd) and src/repro/kernels/decode_attention/paged_prefill.py
// (_paged_prefill_kernel, under paged_prefill_attention_pallas): one Q tile
// against one K/V tile, folded into a running online softmax.
//
// Bound on the H100. Per 64 x 64 tile the two products take 2 * 64 * 64 * D
// FLOPs each on the tensor cores (989 TFLOP/s bf16) and the softmax 64 * 64
// exponentials on the special-function units (16 per clock per SM), which
// at D = 64 take about as long as the products; everything else is
// instruction slots on the CUDA cores. Long prompts are bound by operations, short ones
// (the serving shapes) by the latency of a block's first loads.
//
// Design. One warpgroup (128 threads, four warps) owns one 64-row Q tile in
// shared memory; each warp owns 16 rows and each thread two of them (rows
// lane / 4 and lane / 4 + 8 of its warp), the layout of the wgmma
// accumulator. Per 64-row K/V tile:
// - S = Q K^T runs as wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulate),
//   D / 16 of them, both operands read from shared memory through
//   descriptors; K is K-major (D-contiguous, as stored).
// - The online softmax runs on the accumulator fragment in registers: the
//   row max of the raw scores takes a 4-lane shuffle within the row's quad,
//   the scores are scaled by D^-0.5 * log2(e) in the same fp32 multiply-add
//   that subtracts the max, and exponentiated by ex2.approx.ftz; the row sum
//   stays per thread until the epilogue. Masked entries take the finite
//   NEG_INF of common.cuh, and a row that has seen nothing but masked
//   entries exponentiates against 0, so a fully masked tile adds 0 and never
//   NaN.
// - P is rounded to bf16 in registers and fed as the register A operand of
//   O += P V (m64nDk16, four of them); V stays in shared memory as an
//   MN-major B operand (the transpose bit, which bf16 allows).
// - int8 pages (the paged kernel): the int8 values are exact in bf16, so the
//   tiles hold them as bf16; column j's scores are multiplied by k_scale[j]
//   in fp32 before the softmax, and v_scale[j] is folded into p_j before P is
//   rounded (l sums the unscaled p). P then goes in as two bf16 operands,
//   the rounded value and its rounding error (two P V products), so the
//   folded scale costs no precision.
// - The epilogue divides by max(l, 1e-30) and hands each pair of output
//   columns to the caller, which stores them as bf16 through its strides.
// The callers keep K/V tiles in a 2-stage ring filled 16 bytes per thread
// (cp.async, or vector loads for int8 pages), tile j + 1 in flight while
// tile j computes, and several blocks share an SM, so one block's softmax
// runs while another's products do.
//
// Shared-memory tiles hold 64 rows of D bf16 as D / 64 panels of
// [64 rows][128 bytes], each panel 128-byte swizzled (16-byte chunk c of
// row r sits at chunk c ^ (r % 8)): the canonical wgmma SWIZZLE_128B layout
// for K-major Q and K, and for MN-major V. Loads write 16-byte chunks, so
// the swizzle costs no bank conflicts on either side. Tiles start on
// 1024-byte boundaries (the swizzle period).
//
// Descriptors, fences and commit/wait are raw PTX (no CuTe/CUTLASS include),
// so a source that includes this header builds in seconds.
#pragma once

#include "common.cuh"

namespace repro {
namespace tc {
namespace {

constexpr int kRows = 64;       // Q rows per block: one wgmma M
constexpr int kCols = 64;       // K/V rows per tile: the N of S
constexpr int kThreads = 128;   // one warpgroup
constexpr int kPanelBytes = 64 * 128;  // one [64 rows][64 bf16] swizzled panel
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return kRows * D * 2; }

// Byte offset of 16-byte chunk `chunk` (along D) of row `row` in a tile.
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return (chunk >> 3) * kPanelBytes + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to wgmma (the async proxy);
// a barrier after it makes everyone's visible.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared_16(uint32_t dst, uint4 x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(x.x), "r"(x.y),
               "r"(x.z), "r"(x.w)
               : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand (Q, K): 8-row groups 1024 bytes apart; the leading offset
// is unused under a swizzle.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc(addr, 16, 1024); }
// MN-major operand (V): 64-column panels kPanelBytes apart, 8-row (k) groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc(addr, kPanelBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin register values in program order around the asynchronous wgmma (the
// compiler sees no dependence between the wait and the registers).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define REPRO_F8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_F32(i) REPRO_F8(i), REPRO_F8(i + 8), REPRO_F8(i + 16), REPRO_F8(i + 24)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_F32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N]: A from registers, B MN-major in shared
// memory (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_F32(0), REPRO_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef REPRO_F32
#undef REPRO_F8

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s = Q K^T for one K tile: sQ, sK are tile addresses in shared memory.
template <int D>
__device__ __forceinline__ void qk_scores(float (&s)[32], uint32_t sQ, uint32_t sK) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    // k-slice of 16 columns: panel k / 4, 32 bytes per slice inside a panel.
    const uint32_t off = (k >> 2) * kPanelBytes + (k & 3) * 32;
    wgmma_ss_n64(s, desc_k(sQ + off), desc_k(sK + off), k > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// o += P V for one V tile: a[kk] is P's columns 16 kk .. 16 kk + 15 as the
// wgmma register A fragment.
template <int D>
__device__ __forceinline__ void pv_accumulate(float (&o)[D / 2], uint32_t (&a)[4][4],
                                              uint32_t sV) {
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, a[kk], desc_mn(sV + kk * 16 * 128));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
}

// A thread's running state: its two rows' max (of the raw scores) and
// (thread-partial) sum of the unscaled probabilities, and its share of O.
template <int D>
struct Softmax {
  float o[D / 2];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }
};

// This thread's rows in the tile (h = 0, 1) and first column in each
// 8-column group of the accumulator.
__device__ __forceinline__ int frag_row(int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return warp * 16 + lane / 4 + 8 * h;
}
__device__ __forceinline__ int frag_col0() { return 2 * (threadIdx.x % 4); }

// One K/V tile folded into the running state. valid(h, col) says whether
// this thread's row h (tile row frag_row(h), h = 0, 1) may see tile column
// `col`; it is asked only when need_mask. With kScaled, ksc / vsc are the tile's 64 per-row K and V
// dequantization scales (shared memory).
template <int D, bool kScaled, class Valid>
__device__ __forceinline__ void tile_step(Softmax<D>& st, uint32_t sQ, uint32_t sK,
                                          uint32_t sV, float scale_log2, bool need_mask,
                                          Valid valid, const float* ksc, const float* vsc) {
  float s[32];
  qk_scores<D>(s, sQ, sK);

  const int c0 = frag_col0();
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + c0 + (e & 1);
      float x = s[4 * i + e];
      if constexpr (kScaled) x *= ksc[col];
      if (need_mask && !valid(e >> 1, col)) x = NEG_INF;
      s[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2], base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = exp2_ftz((st.m[h] - mx[h]) * scale_log2);
    st.m[h] = mx[h];
    // Nothing visible yet: every score is NEG_INF, and exp2(NEG_INF * c - 0) = 0.
    base[h] = (mx[h] == NEG_INF ? 0.f : mx[h]) * scale_log2;
    st.l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(fmaf(s[4 * i + e], scale_log2, -base[e >> 1]));
      st.l[e >> 1] += p;
      if constexpr (kScaled) {
        s[4 * i + e] = p * vsc[8 * i + c0 + (e & 1)];
      } else {
        s[4 * i + e] = p;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    st.o[4 * i + 0] *= corr[0];
    st.o[4 * i + 1] *= corr[0];
    st.o[4 * i + 2] *= corr[1];
    st.o[4 * i + 3] *= corr[1];
  }
  // The S accumulator's columns 16 kk .. 16 kk + 15 are, register for
  // register, the A fragment of the k-slice kk.
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
  pv_accumulate<D>(st.o, a, sV);
  if constexpr (kScaled) {
    // p * v_scale's rounding error as a second bf16 operand: P is carried to
    // ~16 bits, so a row that sees a single key returns that key's V row to
    // the output's own rounding (one bf16 P would add up to 2^-8 of it).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a[kk][r]));
        a[kk][r] = pack_bf16(s[8 * kk + 2 * r] - hi.x, s[8 * kk + 2 * r + 1] - hi.y);
      }
    }
    pv_accumulate<D>(st.o, a, sV);
  }
}

// Normalize and hand out the results: store(h, col, x0, x1) for columns
// col and col + 1 of this thread's row h (tile row frag_row(h)), for every
// column this thread holds.
template <int D, class Store>
__device__ __forceinline__ void epilogue(Softmax<D>& st, Store store) {
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / fmaxf(l, 1e-30f);
  }
  const int c0 = frag_col0();
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    store(0, 8 * i + c0, st.o[4 * i + 0] * inv[0], st.o[4 * i + 1] * inv[0]);
    store(1, 8 * i + c0, st.o[4 * i + 2] * inv[1], st.o[4 * i + 3] * inv[1]);
  }
}

// Asynchronous copy of two 64-row bf16 tiles (K and V) into their swizzled
// layouts: rows(row) gives the row's first element in each source, or
// nullptr in the first for a row past the data (both zero-filled).
struct RowPair {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
};
template <int D, class Rows>
__device__ __forceinline__ void load_tiles_async(uint32_t dst_a, uint32_t dst_b, Rows rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int n = 0; n < kRows * kChunks / kThreads; ++n) {
    const int c = threadIdx.x + n * kThreads;
    const int row = c / kChunks, ch = c % kChunks;
    const RowPair p = rows(row);
    const bool ok = p.a != nullptr;
    cp_async_16(dst_a + swizzled(row, ch), ok ? p.a + ch * 8 : nullptr, ok);
    cp_async_16(dst_b + swizzled(row, ch), ok ? p.b + ch * 8 : nullptr, ok);
  }
}

// The same for one tile (Q): row_ptr(row) or nullptr.
template <int D, class RowPtr>
__device__ __forceinline__ void load_tile_async(uint32_t dst, RowPtr row_ptr) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int n = 0; n < kRows * kChunks / kThreads; ++n) {
    const int c = threadIdx.x + n * kThreads;
    const int row = c / kChunks, ch = c % kChunks;
    const __nv_bfloat16* p = row_ptr(row);
    cp_async_16(dst + swizzled(row, ch), p ? p + ch * 8 : nullptr, p != nullptr);
  }
}

// Convert 16 int8 values to bf16 (exact: |x| <= 127 needs 7 significant
// bits) and store them as chunks `ch2`, `ch2 + 1` of tile row `row`.
__device__ __forceinline__ void store_int8_as_bf16(uint32_t tile, int row, int ch2, int4 x) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&x);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack_bf16(static_cast<float>(b[2 * i]), static_cast<float>(b[2 * i + 1]));
  st_shared_16(tile + swizzled(row, ch2), make_uint4(w[0], w[1], w[2], w[3]));
  st_shared_16(tile + swizzled(row, ch2 + 1), make_uint4(w[4], w[5], w[6], w[7]));
}

}  // namespace
}  // namespace tc
}  // namespace repro
