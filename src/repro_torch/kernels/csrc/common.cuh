// Helpers shared by the kernels: element conversion, strides, warp
// reductions, exp2 on the special-function units. Every kernel reads fp32,
// bf16 or int8 elements and does its arithmetic in fp32.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Finite "minus infinity", as in the TPU kernels: a fully masked tile
// then adds exp(NEG_INF - m) = 0 and never produces inf - inf = NaN.
constexpr float NEG_INF = -1e30f;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of a [batch, seq, heads, head_dim] tensor whose last
// dim is contiguous (the wrappers check it).
struct Strides4 {
  long long b, s, h;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 2^x on the special-function unit (one MUFU.EX2, no range reduction);
// results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The attention mask of flash_attention.py, shared by the flash forward
// and backward kernels: query position qp sees key position kp when kp is
// a real row, kp <= qp under a causal mask (the two positions compared
// from 0, also when Sq != Skv), and qp - kp < window when window > 0.
__device__ __forceinline__ bool attn_visible(int qp, int kp, int Skv, int causal, int window) {
  bool ok = kp < Skv;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

// The KV tiles of `tile` rows that query positions [q_first, q_last] can
// see (flash_attention.py:50-58); empty when j_first > j_last.
__device__ __forceinline__ void kv_tile_range(int q_first, int q_last, int Skv, int tile,
                                              int causal, int window, int& j_first,
                                              int& j_last) {
  j_last = (Skv + tile - 1) / tile - 1;
  if (causal) j_last = min(q_last / tile, j_last);
  j_first = window > 0 ? max(q_first - window + 1, 0) / tile : 0;
}

// The query tiles of `tile` rows that can see key positions [kv_first,
// kv_last]: the same mask read from the key side.
__device__ __forceinline__ void q_tile_range(int kv_first, int kv_last, int Sq, int tile,
                                             int causal, int window, int& i_first,
                                             int& i_last) {
  i_first = causal ? kv_first / tile : 0;
  i_last = (Sq + tile - 1) / tile - 1;
  if (window > 0) i_last = min(i_last, (kv_last + window - 1) / tile);
}

}  // namespace repro
