// Selective-scan backward for Hopper (sm_90a): the gradient of
//
//   h_t = a_t h_{t-1} + dt_t x_t B_t,  a_t = exp(dt_t A),  y_t = <h_t, C_t>
//
// (selective_scan.cu) by the reverse recurrence. With g_t = dL/dh_t:
//
//   g_{S-1} = dh_final + dy_{S-1} C_{S-1},   g_t = dy_t C_t + a_{t+1} g_{t+1}
//   dx_t  = dt_t sum_n g_t B_t               ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
//   dB_t  = sum_d g_t dt_t x_t               dC_t  = sum_d dy_t h_t
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1}   dh0   = a_0 g_0
//
// over x, dt, dy, dx, ddt [B, S, Din], B_t/C_t, dB, dC [B, S, N], A, dA
// [Din, N], dh_final, dh0 [B, Din, N], all fp32. The plain version is
// kernels/selective_scan/ref.py:selective_scan_bwd_ref.
//
// The JAX package has no TPU kernel for this: its trainer differentiates
// the chunked XLA scan (src/repro/models/ssm.py:selective_scan), and its
// Pallas forward (src/repro/kernels/selective_scan/selective_scan.py,
// selective_scan_pallas) has no custom_vjp. The port's Mamba block runs
// through its own forward kernel, so the gradient is this kernel.
//
// Bound on the H100: per (b, t, d) it reads x, dt and dy and writes dx and
// ddt (20 bytes), and per (b, t) reads B_t, C_t and writes dB_t, dC_t; it
// evaluates exp(dt A) twice per (b, t, d, n) (rebuilding the states, then
// in the reverse step) on the special-function units, 16 a clock per SM.
// At N = 16 the exponentials' time is about level with the bytes'
// (chip_smoke.py's scan_bwd_bound computes both from the run's shapes).
//
// Design:
//  * The states in reverse. h_{t-1} is never recovered by dividing by a_t,
//    which underflows for a strongly negative A. Under grad the forward
//    writes the state entering every kChunk-th step (ckpt); this kernel walks
//    the chunks from last to first, rebuilds the chunk's kChunk states from
//    its checkpoint in registers, with the forward's own arithmetic (so the
//    same bits), then runs the chunk's reverse steps on them.
//  * Threads own channels as in the forward: a thread holds K = 4 of a
//    channel's 16 state slots, four threads a channel, eight channels a
//    warp. dx and ddt are per-thread sums that two xor shuffles finish
//    (one per value: a reduce-scatter over the channel's four threads).
//  * Sums across channels and batch rows use no atomics, so a second call
//    gives the same bits. dB_t and dC_t (8 values a thread, summed over the
//    warp's 8 channels) reduce-scatter in 7 shuffles: each lane ends with
//    one of the 8 sums, which it writes to shared memory; after a chunk the
//    block adds its 4 warps in order and writes its partial to a scratch
//    [B, blocks, S, N]. dA is summed over the thread's steps in registers
//    and written per batch row to a scratch [B, Din, N]. A second kernel
//    adds the partials in a fixed order (blocks for dB / dC, batch rows for
//    dA), as flash_attention_bwd.cu's flash_bwd_sum_kernel adds head splits.
//  * Padding needs no branch: steps past S read x = dt = dy = 0 and zero B,
//    C rows, so they leave the state, the carried gradient and every sum as
//    they are; slots n >= N carry A = B = C = 0 and stay 0. Only the stores
//    of dx, ddt and the partials are masked.
#include "common.cuh"
#include "selective_scan.cuh"

namespace repro {
namespace {

constexpr int kSlots = scan::kSlots;
constexpr int kChunk = scan::kChunk;
constexpr int K = 4;                          // state slots per thread
constexpr int kPerChannel = kSlots / K;       // threads per channel
constexpr int kChannels = 32 / kPerChannel;   // channels per warp
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockChannels = kWarps * kChannels;

// K floats of a state row (slots n0 .. n0 + K - 1; zeros past N, for a dead
// lane or a null row), 16 bytes at a time when `vec`.
__device__ __forceinline__ void load_slots(float (&v)[K], const float* row, int n0, int N,
                                           bool ok, bool vec) {
  if (vec && ok) {
    const float4 q = *reinterpret_cast<const float4*>(row + n0);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = ok && n0 + j < N ? row[n0 + j] : 0.f;
}

__device__ __forceinline__ void store_slots(float* row, const float (&v)[K], int n0, int N,
                                            bool ok, bool vec) {
  if (vec && ok) {
    *reinterpret_cast<float4*>(row + n0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (ok && n0 + j < N) row[n0 + j] = v[j];
}

// One step of a reduce-scatter over the lanes whose bit `O` of `ch`
// differs: the lane keeps the half of v[0 .. 2 O) its bit selects, added
// to its partner's same half.
template <int O>
__device__ __forceinline__ void scatter_step(float (&v)[2 * K], int ch) {
  const bool up = ch & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

__global__ void __launch_bounds__(kThreads) selective_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ ckpt,
    const float* __restrict__ dy, const float* __restrict__ dh_final, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dh0, float* __restrict__ part, int S, int Din,
    int N) {
  static_assert(K == 4 && kChannels == 8, "the reduce-scatters assume 4 slots, 8 channels");
  // This chunk's B_t and C_t (zero past S and N), and each warp's sums of
  // dB_t and dC_t over its 8 channels.
  __shared__ __align__(16) float bc[2][kChunk][kSlots];
  __shared__ float red[2][kWarps][kChunk][kSlots];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch = lane % kChannels, sub = lane / kChannels;
  const int d = blockIdx.x * kBlockChannels + warp * kChannels + ch;
  const int b = blockIdx.y;
  const int n_blocks = gridDim.x, n_batch = gridDim.y;
  const bool live = d < Din;
  const int n0 = sub * K;
  const bool mine = live && n0 < N;  // this thread holds real slots
  const bool vec = N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(ckpt) |
                     reinterpret_cast<uintptr_t>(dh_final) | reinterpret_cast<uintptr_t>(dh0) |
                     reinterpret_cast<uintptr_t>(part)) % 16) == 0;
  const long long row0 = static_cast<long long>(b) * S;  // row of (b, t = 0)
  const long long state = (static_cast<long long>(b) * Din + d) * N;  // h[b, d, 0]
  const long long dn = static_cast<long long>(Din) * N;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  float An[K], a2[K], carry[K], dA[K] = {};
  load_slots(An, A + static_cast<long long>(d) * N, n0, N, mine, vec);
#pragma unroll
  for (int j = 0; j < K; ++j) a2[j] = An[j] * LOG2E;
  // carry = a_{t+1} g_{t+1}, dh_final before the last step.
  load_slots(carry, dh_final != nullptr ? dh_final + state : A, n0, N,
             mine && dh_final != nullptr, vec);

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, T = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk's bc and red are consumed
    for (int e = threadIdx.x; e < kChunk * kSlots; e += kThreads) {
      const int tt = e / kSlots, n = e % kSlots;
      const bool ok = tt < T && n < N;
      const long long off = (row0 + t0 + tt) * N + n;
      bc[0][tt][n] = ok ? Bm[off] : 0.f;
      bc[1][tt][n] = ok ? Cm[off] : 0.f;
    }
    __syncthreads();

    // The chunk's states, hs[u + 1] = h_{t0 + u}, from its checkpoint.
    float hs[kChunk + 1][K], xr[kChunk], dr[kChunk];
    load_slots(hs[0], ckpt + (static_cast<long long>(b) * (n_chunks - 1) + c) * dn + state, n0,
               N, mine, vec);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const bool ok = live && u < T;
      const long long off = (row0 + t0 + u) * Din + d;
      xr[u] = ok ? x[off] : 0.f;
      dr[u] = ok ? dt[off] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float4 bq = *reinterpret_cast<const float4*>(&bc[0][u][n0]);
      const float bv[K] = {bq.x, bq.y, bq.z, bq.w};
      const float dxv = dr[u] * xr[u];
#pragma unroll
      for (int j = 0; j < K; ++j)  // the forward's update, operand for operand
        hs[u + 1][j] = fmaf(exp2_ftz(dr[u] * a2[j]), hs[u][j], dxv * bv[j]);
    }

    // The chunk's steps in reverse.
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const bool ok = live && u < T;
      const long long off = (row0 + t0 + u) * Din + d;
      const float dyv = ok ? dy[off] : 0.f;
      const float xv = xr[u], dtv = dr[u], dxv = dtv * xv;
      const float4 bq = *reinterpret_cast<const float4*>(&bc[0][u][n0]);
      const float4 cq = *reinterpret_cast<const float4*>(&bc[1][u][n0]);
      const float bv[K] = {bq.x, bq.y, bq.z, bq.w}, cv[K] = {cq.x, cq.y, cq.z, cq.w};
      float v[2 * K];  // this thread's dB_t (0 .. K) and dC_t (K .. 2K) terms
      float sum_gb = 0.f, sum_dt = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float a = exp2_ftz(dtv * a2[j]);
        const float g = fmaf(dyv, cv[j], carry[j]);
        const float ah = a * hs[u][j];
        v[j] = g * dxv;
        v[K + j] = dyv * hs[u + 1][j];
        sum_gb = fmaf(g, bv[j], sum_gb);
        sum_dt = fmaf(g, fmaf(An[j], ah, xv * bv[j]), sum_dt);
        dA[j] = fmaf(g * dtv, ah, dA[j]);
        carry[j] = a * g;
      }
      // dB_t, dC_t over the warp's 8 channels: lane ch ends with value ch.
      scatter_step<4>(v, ch);
      scatter_step<2>(v, ch);
      scatter_step<1>(v, ch);
      red[ch / K][warp][u][n0 + ch % K] = v[0];
      // dx_t and ddt_t over the channel's 4 threads (lanes 8 and 16 apart):
      // subs 0, 1 end with sum g B, subs 2, 3 with ddt.
      const bool hi = sub & 2;
      float s = (hi ? sum_dt : sum_gb) +
                __shfl_xor_sync(0xffffffffu, hi ? sum_gb : sum_dt, 2 * kChannels);
      s += __shfl_xor_sync(0xffffffffu, s, kChannels);
      if (ok && sub == 0) dx[off] = dtv * s;
      if (ok && sub == 2) ddt[off] = s;
    }
    __syncthreads();
    // The block's partial dB_t, dC_t of the chunk: its warps added in order.
    for (int e = threadIdx.x; e < T * kSlots; e += kThreads) {
      const int tt = e / kSlots, n = e % kSlots;
      if (n >= N) continue;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sb += red[0][w][tt][n], sc += red[1][w][tt][n];
      const long long o =
          ((static_cast<long long>(b) * n_blocks + blockIdx.x) * S + t0 + tt) * N + n;
      part[o] = sb;
      part[static_cast<long long>(n_batch) * n_blocks * S * N + o] = sc;
    }
  }
  if (dh0 != nullptr) store_slots(dh0 + state, carry, n0, N, mine, vec);
  store_slots(part + 2LL * n_batch * n_blocks * S * N + state, dA, n0, N, mine, vec);
}

// dB, dC [B, S, N] = the blocks' partials summed in block order; dA [Din, N]
// = the batch rows' partials summed in row order. One output a thread.
__global__ void selective_scan_bwd_sum_kernel(const float* __restrict__ part,
                                              float* __restrict__ dB, float* __restrict__ dC,
                                              float* __restrict__ dA, int n_batch, int S,
                                              int Din, int N, int n_blocks) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long sn = static_cast<long long>(S) * N, bsn = n_batch * sn;
  const long long dn = static_cast<long long>(Din) * N;
  if (i < 2 * bsn) {
    const bool is_c = i >= bsn;
    const long long j = is_c ? i - bsn : i, b = j / sn, r = j % sn;
    const float* src = part + (is_c ? n_blocks * bsn : 0) + b * n_blocks * sn + r;
    float acc = 0.f;
    for (int k = 0; k < n_blocks; ++k) acc += src[k * sn];
    (is_c ? dC : dB)[j] = acc;
  } else if (i < 2 * bsn + dn) {
    const long long j = i - 2 * bsn;
    const float* src = part + 2 * n_blocks * bsn + j;
    float acc = 0.f;
    for (int b = 0; b < n_batch; ++b) acc += src[b * dn];
    dA[j] = acc;
  }
}

}  // namespace
}  // namespace repro

namespace repro {
namespace {

bool shapes_ok(int B, int S, int Din, int N) {
  return N >= 1 && N <= kSlots && B >= 1 && B <= 65535 && Din >= 1 && S >= 0;
}

// The backward's scratch: each block's partial dB_t, dC_t, then each batch
// row's partial dA.
long long part_floats_for(int B, int S, int Din, int N) {
  const long long n_blocks = (Din + kBlockChannels - 1) / kBlockChannels;
  return 2LL * B * n_blocks * S * N + static_cast<long long>(B) * Din * N;
}

}  // namespace
}  // namespace repro

// The buffers that the wrappers allocate for these shapes: ckpt_chunks =
// ceil(S / scan::kChunk) checkpoints a batch row (the forward's ckpt [B,
// ckpt_chunks, Din, N]) and part_floats, the backward's scratch. Returns 0,
// or cudaErrorInvalidValue for shapes that the kernels refuse.
extern "C" int repro_selective_scan_sizes(int B, int S, int Din, int N, long long* ckpt_chunks,
                                          long long* part_floats) {
  using namespace repro;
  if (!shapes_ok(B, S, Din, N)) return static_cast<int>(cudaErrorInvalidValue);
  *ckpt_chunks = (S + kChunk - 1) / kChunk;
  *part_floats = part_floats_for(B, S, Din, N);
  return 0;
}

// x, dt, dy, dx, ddt [B, S, Din]; Bm, Cm, dB, dC [B, S, N]; A, dA [Din, N];
// ckpt [B, ceil(S / scan::kChunk), Din, N] from repro_selective_scan_fwd on
// the same operands; dh_final (or null: zeros) and dh0 (or null: not
// written) [B, Din, N]; part: scratch of part_floats floats, the size that
// repro_selective_scan_sizes gives; all contiguous fp32, 1 <= N <= 16.
// Returns the first launch's error, else cudaGetLastError().
extern "C" int repro_selective_scan_bwd(const float* x, const float* dt, const float* Bm,
                                        const float* Cm, const float* A, const float* ckpt,
                                        const float* dy, const float* dh_final, float* dx,
                                        float* ddt, float* dB, float* dC, float* dA, float* dh0,
                                        float* part, long long part_floats, int B, int S,
                                        int Din, int N, void* stream) {
  using namespace repro;
  if (!shapes_ok(B, S, Din, N) || part_floats != part_floats_for(B, S, Din, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = (Din + kBlockChannels - 1) / kBlockChannels;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  selective_scan_bwd_kernel<<<dim3(static_cast<unsigned>(n_blocks), B), kThreads, 0, st>>>(
      x, dt, Bm, Cm, A, ckpt, dy, dh_final, dx, ddt, dh0, part, S, Din, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long outputs = 2LL * B * S * N + static_cast<long long>(Din) * N;
  selective_scan_bwd_sum_kernel<<<static_cast<unsigned>((outputs + 255) / 256), 256, 0, st>>>(
      part, dB, dC, dA, B, S, Din, N, static_cast<int>(n_blocks));
  return static_cast<int>(cudaGetLastError());
}
