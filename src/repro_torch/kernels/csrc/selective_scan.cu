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
// becomes a loop inside the thread and the state lives in its registers.
//
// Bound on the H100: per (b, t, d) the kernel reads x and dt and writes y
// (12 bytes) and does N exponentials and ~5N other flops. The exponentials
// go through the special-function units (MUFU), 16 per clock per SM against
// 128 fp32 lanes, so at N = 16 their time is about level with the bytes'
// time (chip_smoke.py's scan_case computes both bounds from the run's
// shapes). The design keeps every other instruction off that path:
//
// - Threads own channels, not state elements. A thread holds K of a
//   channel's 16 state slots (K = 16, 8 or 4, a template parameter the
//   wrapper picks so the grid fills the card: 16 / K threads per channel)
//   and A * log2(e) for them in registers, and sums its K products for y_t
//   itself; log2(16 / K) xor shuffles finish the sum. Slots n >= N carry
//   A = B = C = 0 and stay 0.
// - exp(dt * A) is one FMUL and one ex2.approx.ftz (MUFU.EX2): A is
//   pre-scaled by log2(e), so no range reduction runs around the SFU.
// - No barrier on the step path. x and dt are read straight from global
//   memory, consecutive threads on consecutive channels (128 B per warp
//   load), into registers a group of 128 / K steps ahead of use (about as
//   many issue cycles ahead for every K); y is written straight back the
//   same way. B_t and C_t (N floats per step, shared by every channel of a
//   batch row) go by cp.async into a double-buffered shared tile of kTile
//   steps, one barrier per tile, and are read as broadcasts. A full group
//   of steps is one branch-free block of code, so the compiler overlaps
//   the steps' loads, exponentials and shuffles; only the h chain (one FMA
//   per step) is sequential.
//
// Lanes (b, d) past Din are masked; steps past S are never computed.
//
// Under grad the wrapper also passes `ckpt` [B, ceil(S / kChunk), Din, N]:
// the state entering every kChunk-th step (h0 or zeros first), from which
// the backward (selective_scan_bwd.cu) rebuilds each chunk's states. That
// is a second instantiation (kCkpt), so the served forward runs the code
// it ran before.
#include "common.cuh"
#include "selective_scan.cuh"

namespace repro {
namespace {

constexpr int kSlots = scan::kSlots;  // state slots per channel (N <= 16)
constexpr int kThreads = 128;
constexpr int kTile = 64;     // steps of B_t / C_t per shared-memory stage

// 4 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

template <int K, bool kCkpt>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_out, float* __restrict__ ckpt, int S, int Din,
    int N) {
  constexpr int kPerChannel = kSlots / K;  // threads per channel
  constexpr int kChannels = 32 / kPerChannel;  // channels per warp
  constexpr int kAhead = 128 / K;  // steps per group of x / dt loads
  static_assert(kTile % kAhead == 0, "a tile holds whole groups");
  // [stage][B, C][step][slot]; slots n >= N are zero-filled.
  __shared__ __align__(16) float bc[2][2][kTile][kSlots];

  const int lane = threadIdx.x % 32;
  const int sub = lane / kChannels;  // which K slots of the channel
  const int d = (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * kChannels + lane % kChannels;
  const int b = blockIdx.y;
  const bool live = d < Din;
  const int n0 = sub * K;
  const long long state = ((long long)b * Din + d) * N + n0;  // h[b, d, n0]
  const long long row0 = (long long)b * S;  // row of (b, t = 0)
  // A, h0 and h_out rows as float4 where they are 16-byte aligned.
  const bool vec = N % 4 == 0 && live && n0 < N &&
                   ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(h0) |
                     reinterpret_cast<uintptr_t>(h_out) |
                     (kCkpt ? reinterpret_cast<uintptr_t>(ckpt) : 0)) %
                    16) == 0;

  float a2[K], h[K];
#pragma unroll
  for (int j = 0; j < K; j += 4) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), hv = av;
    if (vec && n0 + j < N) {
      av = *reinterpret_cast<const float4*>(A + (long long)d * N + n0 + j);
      if (h0 != nullptr) hv = *reinterpret_cast<const float4*>(h0 + state + j);
    } else if (!vec) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = live && n0 + j + i < N;
        (&av.x)[i] = ok ? A[(long long)d * N + n0 + j + i] : 0.f;
        (&hv.x)[i] = ok && h0 != nullptr ? h0[state + j + i] : 0.f;
      }
    }
    a2[j] = av.x * LOG2E, a2[j + 1] = av.y * LOG2E, a2[j + 2] = av.z * LOG2E,
    a2[j + 3] = av.w * LOG2E;
    h[j] = hv.x, h[j + 1] = hv.y, h[j + 2] = hv.z, h[j + 3] = hv.w;
  }

  // Stage B_t / C_t of steps [t0, t0 + T) into buffer `buf`.
  auto stage = [&](int buf, int t0, int T) {
    for (int e = threadIdx.x; e < T * kSlots; e += kThreads) {
      const int tt = e / kSlots, n = e % kSlots;
      const bool ok = n < N;
      const long long off = ok ? (row0 + t0 + tt) * N + n : 0;
      cp_async_4(&bc[buf][0][tt][n], Bm + off, ok);
      cp_async_4(&bc[buf][1][tt][n], Cm + off, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // x / dt of steps [t0, t0 + kAhead) into registers (0 past S or Din).
  auto fetch = [&](float (&xr)[kAhead], float (&dr)[kAhead], int t0) {
    const long long off = (row0 + t0) * Din + d;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const bool ok = live && t0 + u < S;
      xr[u] = ok ? x[off + (long long)u * Din] : 0.f;
      dr[u] = ok ? dt[off + (long long)u * Din] : 0.f;
    }
  };
  // The state entering step t into ckpt[b, t / kChunk, d, n0 ..], at every
  // kChunk-th step (kCkpt only): (b (n_chunks - 1) + t / kChunk) Din N floats
  // past h[b, d, n0]'s offset `state`.
  auto checkpoint = [&](int t) {
    if (!kCkpt || t % scan::kChunk != 0) return;
    const int n_chunks = (S + scan::kChunk - 1) / scan::kChunk;
    float* row = ckpt + ((long long)b * (n_chunks - 1) + t / scan::kChunk) * Din * N + state;
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      if (vec && n0 + j < N) {
        *reinterpret_cast<float4*>(row + j) = make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
      } else if (!vec) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (live && n0 + j + i < N) row[j + i] = h[j + i];
      }
    }
  };
  // One step: the state update, this thread's share of y_t, the sum over
  // the channel's threads, and the store. After the xor sum every thread
  // of the channel holds y_t and stores it (to the same address), so the
  // store is one predicated instruction at a pointer that moves one row a
  // step, and a group of steps stays one block of code.
  float* yp = y + row0 * Din + d;
  auto step = [&](const float (*bs)[kSlots], const float (*cs)[kSlots], int tt, float xv,
                  float dtv) {
    const float dx = dtv * xv;
    float bv[K], cv[K];
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 bq = *reinterpret_cast<const float4*>(&bs[tt][n0 + j]);
      const float4 cq = *reinterpret_cast<const float4*>(&cs[tt][n0 + j]);
      bv[j] = bq.x, bv[j + 1] = bq.y, bv[j + 2] = bq.z, bv[j + 3] = bq.w;
      cv[j] = cq.x, cv[j + 1] = cq.y, cv[j + 2] = cq.z, cv[j + 3] = cq.w;
    }
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      h[j] = fmaf(exp2_ftz(dtv * a2[j]), h[j], dx * bv[j]);
      if (j % 2 == 0) acc0 = fmaf(h[j], cv[j], acc0);
      else acc1 = fmaf(h[j], cv[j], acc1);
    }
    float acc = acc0 + acc1;
    // Threads of one channel sit kChannels lanes apart.
#pragma unroll
    for (int off = 16; off >= kChannels; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live) *yp = acc;
    yp += Din;
  };

  const int n_tiles = (S + kTile - 1) / kTile;
  if (n_tiles > 0) stage(0, 0, min(kTile, S));
  float xr[kAhead], dr[kAhead];
  fetch(xr, dr, 0);
  for (int i = 0; i < n_tiles; ++i) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile i landed; every thread is done with tile i - 1
    const int t0 = i * kTile;
    if (i + 1 < n_tiles) stage((i + 1) & 1, t0 + kTile, min(kTile, S - t0 - kTile));
    const float(*bs)[kSlots] = bc[i & 1][0];
    const float(*cs)[kSlots] = bc[i & 1][1];
    const int T = min(kTile, S - t0);
    for (int u0 = 0; u0 < T; u0 += kAhead) {
      float xc[kAhead], dc[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) xc[u] = xr[u], dc[u] = dr[u];
      fetch(xr, dr, t0 + u0 + kAhead);
      if (u0 + kAhead <= T) {  // a full group: no branch between its steps
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          checkpoint(t0 + u0 + u);
          step(bs, cs, u0 + u, xc[u], dc[u]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          if (u0 + u < T) {
            checkpoint(t0 + u0 + u);
            step(bs, cs, u0 + u, xc[u], dc[u]);
          }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; j += 4) {
    if (vec && n0 + j < N) {
      *reinterpret_cast<float4*>(h_out + state + j) = make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
    } else if (!vec) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (live && n0 + j + i < N) h_out[state + j + i] = h[j + i];
    }
  }
}

template <int K>
cudaError_t launch(const float* x, const float* dt, const float* Bm, const float* Cm,
                   const float* A, const float* h0, float* y, float* h_out, float* ckpt, int B,
                   int S, int Din, int N, cudaStream_t stream) {
  constexpr int kChannelsPerBlock = kThreads * K / kSlots;
  dim3 grid((Din + kChannelsPerBlock - 1) / kChannelsPerBlock, B);
  if (ckpt != nullptr)
    selective_scan_kernel<K, true><<<grid, kThreads, 0, stream>>>(x, dt, Bm, Cm, A, h0, y, h_out,
                                                                  ckpt, S, Din, N);
  else
    selective_scan_kernel<K, false><<<grid, kThreads, 0, stream>>>(x, dt, Bm, Cm, A, h0, y,
                                                                   h_out, nullptr, S, Din, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x, dt, y [B, S, Din]; Bm, Cm [B, S, N]; A [Din, N]; h0 (or null) and
// h_out [B, Din, N]; all contiguous fp32, N <= 16. states_per_thread (16,
// 8 or 4) is K above. ckpt (or null): a contiguous fp32 [B, ceil(S /
// scan::kChunk), Din, N] (repro_selective_scan_sizes) that receives the state
// entering every kChunk-th step, for the backward. Returns
// cudaGetLastError().
extern "C" int repro_selective_scan_fwd(const void* x, const void* dt, const void* Bm,
                                        const void* Cm, const void* A, const void* h0,
                                        void* y, void* h_out, void* ckpt, int B, int S, int Din,
                                        int N, int states_per_thread, void* stream) {
  using namespace repro;
  if (N < 1 || N > kSlots || B < 1 || B > 65535 || Din < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  const auto* af = static_cast<const float*>(A);
  const auto* hf = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(h_out);
  auto* kf = static_cast<float*>(ckpt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states_per_thread == 16)
    return launch<16>(xf, dtf, bf, cf, af, hf, yf, of, kf, B, S, Din, N, st);
  if (states_per_thread == 8)
    return launch<8>(xf, dtf, bf, cf, af, hf, yf, of, kf, B, S, Din, N, st);
  if (states_per_thread == 4)
    return launch<4>(xf, dtf, bf, cf, af, hf, yf, of, kf, B, S, Din, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
