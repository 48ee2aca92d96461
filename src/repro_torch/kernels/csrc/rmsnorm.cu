// Row RMSNorm times a weight for Hopper (sm_90a): out[r] = x[r] *
// rsqrt(mean(x[r]^2) + eps) * w, fp32 accumulation, output in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py (rmsnorm_2d,
// pallas_call at :39), which normalizes a [block_rows, D] VMEM tile per grid
// cell.
//
// Bound on the H100: bytes. It reads each element once and writes it once
// and does 4 flops per element. The design reads x once, into registers:
// - A row belongs to TPR threads, each holding NV vectors of 16 bytes (8 bf16
//   or 4 fp32 elements, kept as raw words; 16-byte loads and stores,
//   neighbouring threads on neighbouring vectors). TPR and NV are sized to
//   D: up to 256 threads a row with one vector each, then 2, 4 or 8 vectors
//   a thread, so a row of up to 16384 bf16 or 8192 fp32 elements stays in
//   registers. A longer row is walked in spans of that size, twice (sum,
//   then scale), re-reading x. Blocks of at most 256 threads let an SM
//   hold several rows at once.
// - Short rows share a block (several rows of TPR threads, 256 threads a
//   block), so that a block keeps enough bytes in flight.
// - The weights are loaded beside x, before the sum, so that the scaling
//   waits on no load after it.
// - The squares are summed in fp32: xor shuffles within a warp, then the
//   row's warps through shared memory; each thread then scales the values it
//   holds and stores them.
// - Where x, out or w does not start on 16 bytes, or a row's bytes are not a
//   multiple of 16 (so some rows start off 16 bytes), the same kernel loads
//   and stores element by element (kVec false).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRowThreads = 256;  // threads of a row at most, and of a block of short rows
constexpr int kMaxVectors = 8;    // 16-byte vectors of x a thread holds

__device__ __forceinline__ uint32_t raw_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t raw_bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// N consecutive elements of E as raw 32-bit words.
template <typename E, int N>
struct Words {
  static constexpr int n = N * sizeof(E) / 4;
  uint32_t w[n];

  // Element e as a float (bf16: element 2i is the low half of word i).
  __device__ __forceinline__ float at(int e) const {
    if constexpr (sizeof(E) == 4) return __uint_as_float(w[e]);
    return __uint_as_float(e % 2 == 0 ? w[e / 2] << 16 : w[e / 2] & 0xffff0000u);
  }
};

// The N elements at p: 16-byte loads (one 8-byte load for 8 bytes) where
// kVec, else element by element, elements at or past n_valid reading as 0.
template <bool kVec, typename E, int N>
__device__ __forceinline__ void load_words(Words<E, N>& r, const E* p, int n_valid) {
  constexpr int n = Words<E, N>::n;
  if constexpr (kVec && n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      r.w[4 * i] = v.x, r.w[4 * i + 1] = v.y, r.w[4 * i + 2] = v.z, r.w[4 * i + 3] = v.w;
    }
  } else if constexpr (kVec) {  // 8 bytes: four bf16 weights of an fp32 row
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x, r.w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) r.w[i] = 0u;
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < n_valid) r.w[e * sizeof(E) / 4] |= raw_bits(p[e]) << (8 * (e * sizeof(E) % 4));
  }
}

// N = 16 / sizeof(T) floats into T at p: one 16-byte store where kVec, else
// element by element below n_valid.
template <bool kVec, typename T, int N>
__device__ __forceinline__ void store_vector(T* p, int n_valid, const float (&f)[N]) {
  if constexpr (kVec) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(f[i]);
      } else {
        w[i] = raw_bits(__float2bfloat16(f[2 * i])) |
               (raw_bits(__float2bfloat16(f[2 * i + 1])) << 16);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < n_valid) p[e] = from_float<T>(f[e]);
  }
}

// blockDim = (TPR, rows per block); TPR is a power of two up to 32 or a
// multiple of 32 up to kRowThreads.
template <typename T, typename W, int NV, bool kVec>
__global__ void __launch_bounds__(kRowThreads) rmsnorm_kernel(const T* __restrict__ x,
                                                              const W* __restrict__ w,
                                                              T* __restrict__ out, int R, int D,
                                                              float eps) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte vector of x
  __shared__ float part[kRowThreads / 32];
  const int tpr = blockDim.x;
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int span = NV * VEC * tpr;  // elements of the row held at once
  const bool resident = D <= span;
  const T* xr = x + row * D;
  T* orow = out + row * D;

  // The thread's vectors of the row and their weights, raw. The weights are
  // loaded beside x, so no load follows the sum where the row is resident.
  Words<T, VEC> xv[NV];
  Words<W, VEC> wv[NV];
  auto load_span = [&](int base, bool weights) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e0 = base + (i * tpr + tid) * VEC;
      if (e0 < D) {
        load_words<kVec>(xv[i], xr + e0, D - e0);
        if (weights) load_words<kVec>(wv[i], w + e0, D - e0);
      } else {
#pragma unroll
        for (int j = 0; j < Words<T, VEC>::n; ++j) xv[i].w[j] = 0u;
      }
    }
  };
  auto store_span = [&](int base, float inv) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e0 = base + (i * tpr + tid) * VEC;
      if (e0 >= D) continue;
      float y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[e] = xv[i].at(e) * inv * wv[i].at(e);
      store_vector<kVec>(orow + e0, D - e0, y);
    }
  };

  float ss = 0.f;
  if (row < R) {
    for (int base = 0; base < D; base += span) {
      load_span(base, resident);
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss = fmaf(xv[i].at(e), xv[i].at(e), ss);
    }
  }
  // The row's sum: its lanes of a warp, then its warps.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < tpr) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {
    const int row_warps = tpr / 32;
    if (tid % 32 == 0) part[threadIdx.y * row_warps + tid / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < row_warps; ++i) ss += part[threadIdx.y * row_warps + i];
  }
  if (row >= R) return;
  const float inv = rsqrtf(ss / D + eps);
  if (resident) {
    store_span(0, inv);
  } else {
    for (int base = 0; base < D; base += span) {
      load_span(base, true);
      store_span(base, inv);
    }
  }
}

template <typename T, typename W, int NV, bool kVec>
cudaError_t launch(const void* x, const void* w, void* out, int R, int D, float eps, int tpr,
                   cudaStream_t stream) {
  const int rows = kRowThreads / tpr;
  const unsigned blocks = static_cast<unsigned>((R + rows - 1) / rows);
  rmsnorm_kernel<T, W, NV, kVec><<<blocks, dim3(tpr, rows), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), R, D, eps);
  return cudaGetLastError();
}

// Vectors per thread (1, 2, 4 or 8: the fewest that give a row at most
// kRowThreads threads) and threads per row for a row of D elements of T,
// then the launch.
template <typename T, typename W>
cudaError_t dispatch(const void* x, const void* w, void* out, int R, int D, float eps,
                     cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int n_vec = (D + VEC - 1) / VEC;
  int nv = 1;
  while (nv < kMaxVectors && nv * kRowThreads < n_vec) nv *= 2;
  const int need = min((n_vec + nv - 1) / nv, kRowThreads);
  int tpr = 1;
  while (tpr < need && tpr < 32) tpr *= 2;
  if (need > 32) tpr = (need + 31) / 32 * 32;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = (addr(x) | addr(w) | addr(out)) % 16 == 0 && D * sizeof(T) % 16 == 0;
#define REPRO_RMSNORM(NV)                                                                      \
  if (nv == NV)                                                                                \
    return vec ? launch<T, W, NV, true>(x, w, out, R, D, eps, tpr, stream)                     \
               : launch<T, W, NV, false>(x, w, out, R, D, eps, tpr, stream);
  REPRO_RMSNORM(1)
  REPRO_RMSNORM(2)
  REPRO_RMSNORM(4)
  REPRO_RMSNORM(8)
#undef REPRO_RMSNORM
  return cudaErrorInvalidValue;
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
    return static_cast<int>(dispatch<float, float>(x, w, out, R, D, eps, st));
  if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    return static_cast<int>(dispatch<float, __nv_bfloat16>(x, w, out, R, D, eps, st));
  if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    return static_cast<int>(dispatch<__nv_bfloat16, float>(x, w, out, R, D, eps, st));
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    return static_cast<int>(dispatch<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
