// Selective scan (the Mamba-1 recurrence) for Hopper (sm_90a):
//
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = <h_t, C_t>
//
// over x, dt [B, S, Din], B_t/C_t [B, S, N], A [Din, N] and an optional
// initial state h0 [B, Din, N]; writes y [B, S, Din] and the final state
// h_final [B, Din, N], all fp32.
//
// Replaces the TPU kernel src/repro/kernels/selective_scan/selective_scan.py
// (selective_scan_pallas, pallas_call at :102). That kernel walks a
// (batch, Din / block_d, S / chunk) grid whose last axis runs in order on one
// core, carries the [block_d, N] state across chunks in VMEM scratch and
// evaluates each chunk as an associative scan over a [chunk, block_d, N]
// tile. Here blocks run in parallel and in no order, so the sequential axis
// becomes a loop inside the block and the state lives in registers.
//
// Design. One thread per state element (b, d, n): a block holds 16 channels x
// 16 state lanes (256 threads), so a warp covers 2 channels and the grid is
// (Din / 16, B) blocks, enough to fill the card even at B = 1 (512 blocks at
// Din = 8192). Each thread keeps h[b, d, n] and A[d, n] in registers and runs
// sequentially over t. The block stages a run of 64 time steps in shared
// memory: x and dt for its 16 channels (loaded along Din) and B_t / C_t (one
// row each per step, shared by all 16 channels). y_t[b, d] is a shuffle
// reduction over the 16 lanes of a channel; the block collects a tile of y
// in shared memory and writes it back along Din. Lanes n >= N hold h = 0 and
// contribute nothing, so any N <= 16 works; channels past Din and steps past
// S are masked.
//
// Bound on the H100: per (b, t, d) the kernel reads x and dt and writes y
// (12 bytes) and does N exponentials and ~6N other flops. The exponentials
// go through the special-function units, 16 per clock per SM against 128
// fp32 lanes, so at N = 16 their time is about level with the bytes' time
// (chip_smoke.py's scan_case computes both bounds from the run's shapes).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kLanes = 16;     // state lanes per channel (N <= 16)
constexpr int kChannels = 16;  // channels per block
constexpr int kThreads = kLanes * kChannels;
constexpr int kSteps = 64;     // time steps staged per tile

__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_out, int S, int Din, int N) {
  __shared__ float xs[kSteps][kChannels];
  __shared__ float dts[kSteps][kChannels];
  __shared__ float bs[kSteps][kLanes];
  __shared__ float cs[kSteps][kLanes];
  __shared__ float ys[kSteps][kChannels];

  const int c = threadIdx.x / kLanes;
  const int n = threadIdx.x % kLanes;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < Din && n < N;
  const long long state = ((long long)b * Din + d) * N + n;

  const float a_dn = live ? A[(long long)d * N + n] : 0.f;
  float h = (live && h0 != nullptr) ? h0[state] : 0.f;

  const long long seq = (long long)b * S;  // row of (b, t = 0)
  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int T = min(kSteps, S - t0);
    for (int i = threadIdx.x; i < kSteps * kChannels; i += kThreads) {
      const int tt = i / kChannels, cc = i % kChannels;
      const bool ok = tt < T && d0 + cc < Din;
      const long long off = (seq + t0 + tt) * Din + d0 + cc;
      xs[tt][cc] = ok ? x[off] : 0.f;
      dts[tt][cc] = ok ? dt[off] : 0.f;
    }
    for (int i = threadIdx.x; i < kSteps * kLanes; i += kThreads) {
      const int tt = i / kLanes, nn = i % kLanes;
      const bool ok = tt < T && nn < N;
      const long long off = (seq + t0 + tt) * N + nn;
      bs[tt][nn] = ok ? Bm[off] : 0.f;
      cs[tt][nn] = ok ? Cm[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < T; ++tt) {
      const float dtv = dts[tt][c];
      h = expf(dtv * a_dn) * h + dtv * xs[tt][c] * bs[tt][n];
      float p = h * cs[tt][n];
      // Sum over the 16 lanes of this channel: xor offsets < 16 stay inside
      // the channel's half of the warp.
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[tt][c] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T * kChannels; i += kThreads) {
      const int tt = i / kChannels, cc = i % kChannels;
      if (d0 + cc < Din) y[(seq + t0 + tt) * Din + d0 + cc] = ys[tt][cc];
    }
    __syncthreads();  // the next tile's staging overwrites xs..ys
  }
  if (live) h_out[state] = h;
}

}  // namespace
}  // namespace repro

// x, dt, y [B, S, Din]; Bm, Cm [B, S, N]; A [Din, N]; h0 (or null) and
// h_out [B, Din, N]; all contiguous fp32, N <= 16. Returns cudaGetLastError().
extern "C" int repro_selective_scan_fwd(const void* x, const void* dt, const void* Bm,
                                        const void* Cm, const void* A, const void* h0,
                                        void* y, void* h_out, int B, int S, int Din,
                                        int N, void* stream) {
  using namespace repro;
  if (N < 1 || N > kLanes || B < 1 || Din < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Din + kChannels - 1) / kChannels, B);
  selective_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), S, Din, N);
  return static_cast<int>(cudaGetLastError());
}
