// fp32 tiles in shared memory for the 3xTF32 products (tf32x3.cuh) of the
// flash-attention kernels: the fp32 forward (flash_attention.cu,
// flash_fwd_kernel) and the backward (flash_attention_bwd.cu).
//
// Tiles arrive by cp.async, 16 bytes a copy where a tensor's pointer and
// strides allow (rows_16b), 4 bytes otherwise; rows past the sequence are
// zero-filled. A shared row holds D + 4 floats (row_stride), so rows start
// on 16 bytes and, at D = 64 and 128 (D + 4 = 4 mod 32), the fragment reads
// below are free of bank conflicts: row r, column k sits in bank 4 r + k for
// the operands read along rows, and row k, column n in bank 8 k + n for B
// read down the columns, two rows a step in an accumulator's k order. At
// D = 8 and 16 (rows of 12 and 20 floats) the rows 2 tig and 2 tig + 1 that
// a step reads start on banks 24 tig and 40 tig (mod 32) plus 12 or 20:
// distinct for the four tig, so those reads are free of conflicts too.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "tf32x3.cuh"

namespace repro {
namespace tf32x3 {

// Shared row stride in floats.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 4; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Asynchronous global -> shared copies, zero-filled when !valid (the source
// is then not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether a [B, S, heads, D] fp32 tensor's rows can be copied 16 bytes at a
// time: its pointer and its three strides on 16 bytes.
inline bool rows_16b(const float* p, const Strides4& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 && s.s % 4 == 0 &&
         s.h % 4 == 0;
}

// ROWS rows from row0 of one head of a [B, S, heads, D] tensor (base points
// at the batch and head) into dst [ROWS][D + 4], by a block of THREADS
// threads; rows past S are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long s_stride,
                                          int row0, int S, bool vec16) {
  constexpr int LD = row_stride<D>();
  if (vec16) {
    constexpr int C = D / 4;  // 16-byte chunks of a row
    for (int i = threadIdx.x; i < ROWS * C; i += THREADS) {
      const int r = i / C, c = i % C, p = row0 + r;
      cp_async_16(smem_addr(dst + r * LD + 4 * c), p < S ? base + p * s_stride + 4 * c : base,
                  p < S);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
      const int r = i / D, d = i % D, p = row0 + r;
      cp_async_4(smem_addr(dst + r * LD + d), p < S ? base + p * s_stride + d : base, p < S);
    }
  }
}

// ROWS values of a [B, H, Sq] row vector from row0 (rows past Sq read as 0).
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int Sq) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS)
    cp_async_4(smem_addr(dst + i), row0 + i < Sq ? src + row0 + i : src, row0 + i < Sq);
}

// The A operand of rows r0 + gid (+ 8) of a [rows][D + 4] shared tile at
// columns k0 + tig (+ 4), split keeping its NaNs when kKeepNaN.
template <int D, bool kKeepNaN = false>
__device__ __forceinline__ void a_rows(FragA& f, const float* s, int r0, int k0, int gid,
                                       int tig) {
  constexpr int LD = row_stride<D>();
  const float* p = s + (r0 + gid) * LD + k0 + tig;
  const float x[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
  split_parts<kKeepNaN>(f, x);
}

// The B operand (k = column, n = row) of rows n0 + gid of a shared tile at
// columns k0 + tig (+ 4): the transpose of the tile's rows, split keeping
// its NaNs when kKeepNaN.
template <int D, bool kKeepNaN = false>
__device__ __forceinline__ void b_rows(FragB& f, const float* s, int n0, int k0, int gid,
                                       int tig) {
  constexpr int LD = row_stride<D>();
  const float* p = s + (n0 + gid) * LD + k0 + tig;
  const float x[2] = {p[0], p[4]};
  split_parts<kKeepNaN>(f, x);
}

// The B operand (k = row, n = column) of a shared tile, rows k0 + 2 tig and
// k0 + 2 tig + 1 (an accumulator's k order) at column n0 + gid, split
// keeping its NaNs when kKeepNaN.
template <int D, bool kKeepNaN = false>
__device__ __forceinline__ void b_cols(FragB& f, const float* s, int k0, int n0, int gid,
                                       int tig) {
  constexpr int LD = row_stride<D>();
  const float* p = s + (k0 + 2 * tig) * LD + n0 + gid;
  const float x[2] = {p[0], p[LD]};
  split_parts<kKeepNaN>(f, x);
}

// Whether every (query, key) pair of nq queries from q0 and nkv keys from
// kv0 is visible: then the element-wise mask is skipped.
__device__ __forceinline__ bool tile_visible(int q0, int nq, int kv0, int nkv, int Sq, int Skv,
                                             int causal, int window) {
  return q0 + nq <= Sq && kv0 + nkv <= Skv && (!causal || q0 >= kv0 + nkv - 1) &&
         (window <= 0 || q0 + nq - 1 - kv0 < window);
}

}  // namespace tf32x3
}  // namespace repro
