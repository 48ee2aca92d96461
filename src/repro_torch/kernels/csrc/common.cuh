// Helpers shared by the kernels: element conversion, strides, warp
// reductions, the split-KV log-sum-exp merge. Every kernel reads fp32,
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Pass 2 of the split-KV decode kernels: log-sum-exp merge of the chunk
// partials m/l [B, KV, n_chunks, G] and acc [B, KV, n_chunks, G, D] into
// o [B, 1, H, D] (the XLA merge after the TPU kernels,
// decode_attention.py:116-122 and paged.py:154-159). One block per
// (query head, lane), blockDim.x = D. Internal linkage: each source that
// launches it owns its copy.
namespace {
template <typename T>
__global__ void lse_merge_kernel(const float* __restrict__ m_in,
                                 const float* __restrict__ l_in,
                                 const float* __restrict__ acc_in,
                                 T* __restrict__ o, int KV, int G, int n_chunks,
                                 int D, Strides4 os) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / G, g = h % G;
  const long long base = (long long)(b * KV + kvh) * n_chunks * G + g;  // chunk 0
  float mx = NEG_INF;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, m_in[base + (long long)c * G]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float denom = 0.f, numer = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const long long idx = base + (long long)c * G;
      const float w = expf(m_in[idx] - mx);
      denom += w * l_in[idx];
      numer += w * acc_in[idx * D + d];
    }
    o[b * os.b + h * os.h + d] = from_float<T>(numer / fmaxf(denom, 1e-30f));
  }
}
}  // namespace

}  // namespace repro
