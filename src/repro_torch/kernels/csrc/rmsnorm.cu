// Row RMSNorm times a weight for Hopper (sm_90a): out[r] = x[r] *
// rsqrt(mean(x[r]^2) + eps) * w, fp32 accumulation, output in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py (rmsnorm_2d,
// pallas_call at :39), which normalizes a [block_rows, D] VMEM tile per grid
// cell. Here one block of 256 threads owns one row: each thread sums the
// squares of a strided slice of the row in fp32, the block reduces the sums
// through warp shuffles and shared memory, and every thread then scales its
// slice (the second read of the row hits L1/L2, not device memory).
//
// Bound on the H100: bytes. It reads each element once and writes it once
// and does 4 flops per element; a row of D = 4096 gives 16 elements per
// thread, so one block per row keeps every SM busy at the serving shapes
// (hundreds of rows).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(const T* __restrict__ x,
                                                           const W* __restrict__ w,
                                                           T* __restrict__ out, int D,
                                                           float eps) {
  __shared__ float part[kWarps];
  const long long row = (long long)blockIdx.x * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_float(x[row + i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += part[i];
  const float inv = rsqrtf(total / D + eps);
  for (int i = threadIdx.x; i < D; i += kThreads)
    out[row + i] = from_float<T>(to_float(x[row + i]) * inv * to_float(w[i]));
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, int R, int D, float eps,
                   cudaStream_t stream) {
  rmsnorm_kernel<T, W><<<R, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), D, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x, out [R, D] contiguous; w [D]. dtypes: 0 = fp32, 1 = bf16 (x and out
// share one; w has its own). Returns cudaGetLastError().
extern "C" int repro_rmsnorm_fwd(const void* x, const void* w, void* out, int R, int D,
                                 float eps, int x_dtype, int w_dtype, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kFloat32 && w_dtype == kFloat32)
    return launch<float, float>(x, w, out, R, D, eps, st);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(x, w, out, R, D, eps, st);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(x, w, out, R, D, eps, st);
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
