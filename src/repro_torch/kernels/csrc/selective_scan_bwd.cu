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
// evaluates exp(dt A) once per (b, t, d, n) on the special-function units,
// 16 a clock per SM. At N = 16 the bytes' time is about level with the
// fp32 operations' (chip_smoke.py's scan_bwd_bound computes both from the
// run's shapes).
//
// Design:
//  * The states in reverse. h_{t-1} is never recovered by dividing by a_t,
//    which underflows for a strongly negative A. Under grad the forward
//    writes the state entering every kChunk-th step (ckpt); this kernel walks
//    the chunks from last to first, rebuilds the chunk's kChunk states from
//    its checkpoint in registers, with the forward's own arithmetic (so the
//    same bits), keeps each a_t of the rebuild in shared memory (one
//    exponential per element), then runs the chunk's reverse steps on them.
//  * Segments of the sequence run in parallel. Since the states come from
//    the checkpoints, the only serial dependence is the carry a_{t+1}
//    g_{t+1}, which is affine in the carry entering a segment from its
//    right. So S is cut into segments of L steps (a multiple of kChunk;
//    default_seg_steps below; one segment when B Din alone fills the card). A
//    first kernel (selective_scan_bwd_carry_kernel) walks every segment but
//    the first with a zero carry in, giving its carry out and its decay
//    product prod a_t; the reverse kernel's block for segment s folds those
//    of the segments right of s, in order from the last, into its true
//    carry in, then walks its own chunks. That multiplies the blocks by
//    S / L, for one more exponential per element in the segments past the
//    first.
//  * Operands in flight. A chunk's x, dt, dy (the block's channels) and
//    B_t, C_t arrive by cp.async into a double-buffered shared stage while
//    the chunk before it computes, and its checkpoint into registers; one
//    barrier a chunk. dx and ddt go out through shared memory, 16 bytes
//    a store, a chunk at a time.
//  * Threads own channels as in the forward: a thread holds K = 4 of a
//    channel's 16 state slots, four threads a channel, eight channels a
//    warp. dx and ddt are per-thread sums that two xor shuffles finish
//    (one per value: a reduce-scatter over the channel's four threads).
//  * Sums across channels, segments and batch rows use no atomics, so a
//    second call gives the same bits. dB_t and dC_t (8 values a thread,
//    summed over the warp's 8 channels) reduce-scatter in 7 shuffles: each
//    lane ends with one of the 8 sums, which it writes to shared memory (a
//    table in shared memory, each lane adding a column, took 4% longer,
//    its stores and loads taking more of shared memory's bandwidth than
//    the shuffles and selects it saved took of the issue slots);
//    after a chunk the block adds its 4 warps in order and writes its
//    partial to a scratch [B, blocks, S, N]. dA is summed over the thread's steps in registers and
//    written per (batch row, segment) to a scratch [B, segments, Din, N]. A
//    third kernel adds the partials in a fixed order (over blocks for dB /
//    dC; over batch rows and segments for dA), eight warps an output group,
//    as flash_attention_bwd.cu's flash_bwd_sum_kernel adds head splits.
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
static_assert(kChunk * kSlots == kThreads, "a block's thread per (step, slot) of a chunk");
// Reverse-kernel blocks an SM holds (its launch bounds: 128 registers a
// thread; five an SM ran 8.7% slower), and the waves of them that the
// default cut of the sequence into segments aims at.
constexpr int kBlocksPerSm = 4, kWaves = 2;

// Asynchronous global -> shared copies, zero-filled when !valid (the source
// is then not read).
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// One chunk's operands in shared memory, zero past S, Din and N: per step
// the block's channels' dt, dy and x (op[0], [1], [2]) and the batch row's
// C_t and B_t (bc[0], [1]).
struct Chunk {
  float op[3][kChunk][kBlockChannels];
  float bc[2][kChunk][kSlots];
};

// Where a block's operands are: the batch row's first row (b S), its first
// channel, and whether rows can be copied 16 bytes at a time.
struct Operands {
  const float *dt, *dy, *x, *Cm, *Bm;
  long long row0;
  int S, Din, N, d0;
  bool vec_op, vec_bc;
};

// Copy a chunk's rows of G operands into dst[g][u][0 .. COLS) by cp.async,
// W floats a copy (16 or 4 bytes): step u's row of operand g starts at
// src(g) + (row + u) * stride + col0, and its floats from column `limit` -
// col0 on, like steps from T on, are zero-filled. The counts are powers of
// two, so a copy's indices are shifts and masks, and the loop over a
// thread's copies is unrolled (5% off the reverse kernel against a loop).
template <int W, int G, int COLS, typename Src>
__device__ __forceinline__ void copy_rows(float (*dst)[kChunk][COLS], Src src, long long row,
                                          int stride, int col0, int limit, int T) {
  constexpr unsigned Q = COLS / W, copies = G * kChunk * Q;
#pragma unroll
  for (unsigned i = 0; i < (copies + kThreads - 1) / kThreads; ++i) {
    const unsigned e = threadIdx.x + i * kThreads;
    if (e >= copies) break;
    const unsigned g = e / (kChunk * Q), u = e / Q % kChunk, c = e % Q * W;
    const bool ok = static_cast<int>(u) < T && col0 + static_cast<int>(c) < limit;
    const float* p = ok ? src(g) + (row + u) * stride + col0 + c : src(0);
    if constexpr (W == 4)
      cp_async_16(&dst[g][u][c], p, ok);
    else
      cp_async_4(&dst[g][u][c], p, ok);
  }
}

// Stage the chunk of steps [t0, t0 + kChunk) into `s` by cp.async: dt, dy
// and C_t, and with kXB also x and B_t.
template <bool kXB>
__device__ __forceinline__ void stage_chunk(Chunk& s, const Operands& o, int t0) {
  constexpr int n_op = kXB ? 3 : 2, n_bc = kXB ? 2 : 1;
  auto op = [&](unsigned g) { return g == 0 ? o.dt : g == 1 ? o.dy : o.x; };
  auto bc = [&](unsigned g) { return g == 0 ? o.Cm : o.Bm; };
  const int T = min(kChunk, o.S - t0);
  const long long row = o.row0 + t0;  // the chunk's first row
  if (o.vec_op)
    copy_rows<4, n_op>(s.op, op, row, o.Din, o.d0, o.Din, T);
  else
    copy_rows<1, n_op>(s.op, op, row, o.Din, o.d0, o.Din, T);
  if (o.vec_bc)
    copy_rows<4, n_bc>(s.bc, bc, row, o.N, 0, o.N, T);
  else
    copy_rows<1, n_bc>(s.bc, bc, row, o.N, 0, o.N, T);
}

// A ring of kStages chunk stages: chunk c lives in stage c % kStages and is
// staged kStages - 1 chunks before the walk (from the last chunk down)
// reaches it. Every step of the walk commits one group, empty or not, so
// that waiting for all but kStages - 2 groups waits for the chunk at hand.
// Two stages, one chunk ahead: four ran no faster, at either trained shape.
constexpr int kStages = 2;

template <bool kXB>
__device__ __forceinline__ void stage_ahead(Chunk (&ring)[kStages], const Operands& o, int c,
                                            int c_first) {
  if (c >= c_first) stage_chunk<kXB>(ring[c % kStages], o, c * kChunk);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_chunk() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ float4 slots4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

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

// This thread's place: channel d of the block's, slots n0 .., and A's row.
struct Lane {
  int ch, sub, dl, d, n0;
  bool live, mine;
  __device__ Lane(int d0, int Din, int N) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    ch = lane % kChannels, sub = lane / kChannels;
    dl = warp * kChannels + ch;
    d = d0 + dl;
    n0 = sub * K;
    live = d < Din;
    mine = live && n0 < N;  // this thread holds real slots
  }
};

// Segment s of L steps: [s L, min(S, (s + 1) L)).
// carries [B, n_seg - 1, 2, Din, N]: for segment s >= 1 (at s - 1), its
// carry out a_{s L} g_{s L} with a zero carry in, then prod_t a_t over it.
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_carry_kernel(
    const float* __restrict__ dt, const float* __restrict__ Cm, const float* __restrict__ A,
    const float* __restrict__ dy, float* __restrict__ carries, int S, int Din, int N, int L,
    bool vec_op, bool vec_bc) {
  __shared__ __align__(16) Chunk ops[kStages];
  const int b = blockIdx.z, seg = blockIdx.y + 1, n_seg = gridDim.y + 1;
  const Lane ln(blockIdx.x * kBlockChannels, Din, N);
  const bool vec = N % 4 == 0 && ((reinterpret_cast<uintptr_t>(A) |
                                   reinterpret_cast<uintptr_t>(carries)) % 16) == 0;
  const Operands o{dt, dy, nullptr, Cm, nullptr, static_cast<long long>(b) * S, S, Din, N,
                   static_cast<int>(blockIdx.x) * kBlockChannels, vec_op, vec_bc};
  float a2[K], c[K] = {}, P[K] = {1.f, 1.f, 1.f, 1.f};
  load_slots(a2, A + static_cast<long long>(ln.d) * N, ln.n0, N, ln.mine, vec);
#pragma unroll
  for (int j = 0; j < K; ++j) a2[j] *= LOG2E;

  const int c_first = seg * L / kChunk, c_last = (min(S, (seg + 1) * L) - 1) / kChunk;
  for (int i = 0; i < kStages - 1; ++i) stage_ahead<false>(ops, o, c_last - i, c_first);
  for (int cc = c_last; cc >= c_first; --cc) {
    wait_chunk();
    __syncthreads();  // chunk cc landed; chunk cc + 1's stage is consumed
    stage_ahead<false>(ops, o, cc - (kStages - 1), c_first);
    const Chunk& s = ops[cc % kStages];
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const float dtv = s.op[0][u][ln.dl], dyv = s.op[1][u][ln.dl];
      const float4 cq = slots4(&s.bc[0][u][ln.n0]);
      const float cv[K] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
      for (int j = 0; j < K; ++j) {  // the reverse kernel's g and carry, operand for operand
        const float a = exp2_ftz(dtv * a2[j]);
        c[j] = a * fmaf(dyv, cv[j], c[j]);
        P[j] *= a;
      }
    }
  }
  const long long dn = static_cast<long long>(Din) * N;
  float* out = carries + (static_cast<long long>(b) * (n_seg - 1) + seg - 1) * 2 * dn +
               static_cast<long long>(ln.d) * N;
  store_slots(out, c, ln.n0, N, ln.mine, vec);
  store_slots(out + dn, P, ln.n0, N, ln.mine, vec);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) selective_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ ckpt,
    const float* __restrict__ dy, const float* __restrict__ dh_final,
    const float* __restrict__ carries, float* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ dh0, float* __restrict__ part, int S, int Din, int N, int L,
    bool vec_op, bool vec_bc, bool vec_out) {
  static_assert(K == 4 && kChannels == 8, "the reduce-scatters assume 4 slots, 8 channels");
  __shared__ __align__(16) Chunk ops[kStages];
  // Each thread's a_t of the chunk's steps, from the rebuild to the reverse.
  __shared__ __align__(16) float4 a_saved[kChunk][kThreads];
  // Each warp's sums of dB_t and dC_t over its 8 channels, and the block's
  // dx_t and ddt_t, by chunk parity.
  __shared__ float red[2][2][kWarps][kChunk][kSlots];
  __shared__ __align__(16) float dxs[2][2][kChunk][kBlockChannels];

  const int cb = blockIdx.x, seg = blockIdx.y, b = blockIdx.z;
  const int n_blocks = gridDim.x, n_seg = gridDim.y, n_batch = gridDim.z;
  const int warp = threadIdx.x / 32;
  const Lane ln(cb * kBlockChannels, Din, N);
  const int ch = ln.ch, sub = ln.sub, n0 = ln.n0, d = ln.d;
  const bool mine = ln.mine;
  const bool vec = N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(ckpt) |
                     reinterpret_cast<uintptr_t>(dh_final) | reinterpret_cast<uintptr_t>(dh0) |
                     reinterpret_cast<uintptr_t>(part) | reinterpret_cast<uintptr_t>(carries)) %
                    16) == 0;
  const long long row0 = static_cast<long long>(b) * S;  // row of (b, t = 0)
  const long long dn = static_cast<long long>(Din) * N;
  const long long drow = static_cast<long long>(d) * N;  // [d, 0] of a [Din, N] plane
  const long long state = static_cast<long long>(b) * dn + drow;  // h[b, d, 0]
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const Operands o{dt, dy, x, Cm, Bm, row0, S, Din, N, cb * kBlockChannels, vec_op, vec_bc};

  float An[K], a2[K], carry[K], dA[K] = {};
  load_slots(An, A + drow, n0, N, mine, vec);
#pragma unroll
  for (int j = 0; j < K; ++j) a2[j] = An[j] * LOG2E;
  // carry = a_{t+1} g_{t+1} entering the segment's last step: dh_final,
  // folded through the segments right of this one, from the last.
  load_slots(carry, dh_final != nullptr ? dh_final + state : A, n0, N,
             mine && dh_final != nullptr, vec);
  for (int s = n_seg - 1; s > seg; --s) {
    const float* cs = carries + (static_cast<long long>(b) * (n_seg - 1) + s - 1) * 2 * dn + drow;
    float Ls[K], Ps[K];
    load_slots(Ls, cs, n0, N, mine, vec);
    load_slots(Ps, cs + dn, n0, N, mine, vec);
#pragma unroll
    for (int j = 0; j < K; ++j) carry[j] = fmaf(Ps[j], carry[j], Ls[j]);
  }

  // Chunk cc's results out of shared memory (buffer p = cc % 2): the
  // block's dx_t, ddt_t, 16 bytes a store where rows allow, and its partial
  // dB_t, dC_t, its warps added in order; one (step, slot) a thread.
  auto flush = [&](int cc) {
    const int p = cc & 1, t0 = cc * kChunk;
    {
      constexpr int Q = kBlockChannels / 4;
      const int a = threadIdx.x / (kChunk * Q), u = threadIdx.x / Q % kChunk,
                q = threadIdx.x % Q, dd = cb * kBlockChannels + 4 * q;
      static_assert(2 * kChunk * Q == kThreads, "a thread per 16 bytes of a chunk's dx, ddt");
      float* out = (a == 0 ? dx : ddt) + (row0 + t0 + u) * Din + dd;
      const float4 val = *reinterpret_cast<const float4*>(&dxs[p][a][u][4 * q]);
      if (t0 + u < S) {
        if (vec_out && dd < Din) {
          *reinterpret_cast<float4*>(out) = val;
        } else if (!vec_out) {
          const float vv[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (dd + i < Din) out[i] = vv[i];
        }
      }
    }
    const int tt = threadIdx.x / kSlots, n = threadIdx.x % kSlots;
    if (t0 + tt >= S || n >= N) return;
    float sb = 0.f, sc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sb += red[p][0][w][tt][n], sc += red[p][1][w][tt][n];
    const long long i = ((static_cast<long long>(b) * n_blocks + cb) * S + t0 + tt) * N + n;
    part[i] = sb;
    part[static_cast<long long>(n_batch) * n_blocks * S * N + i] = sc;
  };

  const int s0 = seg * L, s1 = min(S, s0 + L);
  if (s1 > s0) {
    const int c_first = s0 / kChunk, c_last = (s1 - 1) / kChunk;
    for (int i = 0; i < kStages - 1; ++i) stage_ahead<true>(ops, o, c_last - i, c_first);
    float h_next[K];
    load_slots(h_next, ckpt + (static_cast<long long>(b) * n_chunks + c_last) * dn + drow, n0, N,
               mine, vec);
    for (int c = c_last; c >= c_first; --c) {
      wait_chunk();
      __syncthreads();  // chunk c landed; chunk c + 1 is done, its red filled
      if (c < c_last) flush(c + 1);
      stage_ahead<true>(ops, o, c - (kStages - 1), c_first);
      // The chunk's states, hs[u + 1] = h_{t0 + u}, from its checkpoint.
      float hs[kChunk + 1][K];
#pragma unroll
      for (int j = 0; j < K; ++j) hs[0][j] = h_next[j];
      if (c > c_first)
        load_slots(h_next, ckpt + (static_cast<long long>(b) * n_chunks + c - 1) * dn + drow,
                   n0, N, mine, vec);
      const Chunk& s = ops[c % kStages];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float xv = s.op[2][u][ln.dl], dtv = s.op[0][u][ln.dl];
        const float4 bq = slots4(&s.bc[1][u][n0]);
        const float bv[K] = {bq.x, bq.y, bq.z, bq.w};
        const float dxv = dtv * xv;
        float av[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {  // the forward's update, operand for operand
          av[j] = exp2_ftz(dtv * a2[j]);
          hs[u + 1][j] = fmaf(av[j], hs[u][j], dxv * bv[j]);
        }
        a_saved[u][threadIdx.x] = make_float4(av[0], av[1], av[2], av[3]);
      }

      // The chunk's steps in reverse.
      float(*rd)[kWarps][kChunk][kSlots] = red[c & 1];
#pragma unroll
      for (int u = kChunk - 1; u >= 0; --u) {
        const float xv = s.op[2][u][ln.dl], dtv = s.op[0][u][ln.dl], dyv = s.op[1][u][ln.dl];
        const float dxv = dtv * xv;
        const float4 bq = slots4(&s.bc[1][u][n0]), cq = slots4(&s.bc[0][u][n0]);
        const float4 aq = a_saved[u][threadIdx.x];
        const float bv[K] = {bq.x, bq.y, bq.z, bq.w}, cv[K] = {cq.x, cq.y, cq.z, cq.w};
        const float av[K] = {aq.x, aq.y, aq.z, aq.w};
        float v[2 * K];  // this thread's dB_t (0 .. K) and dC_t (K .. 2K) terms
        // sum_n g B and sum_n A g a h_{t-1}: ddt's share is x times the
        // first plus the second.
        float sum_gb = 0.f, sum_ga = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float g = fmaf(dyv, cv[j], carry[j]);
          carry[j] = av[j] * g;
          const float w = carry[j] * hs[u][j];  // g a_t h_{t-1}
          v[j] = g * dxv;
          v[K + j] = dyv * hs[u + 1][j];
          sum_gb = fmaf(g, bv[j], sum_gb);
          sum_ga = fmaf(An[j], w, sum_ga);
          dA[j] = fmaf(dtv, w, dA[j]);
        }
        const float sum_dt = fmaf(xv, sum_gb, sum_ga);
        // dB_t, dC_t over the warp's 8 channels: lane ch ends with value ch.
        scatter_step<4>(v, ch);
        scatter_step<2>(v, ch);
        scatter_step<1>(v, ch);
        rd[ch / K][warp][u][n0 + ch % K] = v[0];
        // dx_t and ddt_t over the channel's 4 threads (lanes 8 and 16 apart):
        // subs 0, 1 end with sum g B, subs 2, 3 with ddt.
        const bool hi = sub & 2;
        float sm = (hi ? sum_dt : sum_gb) +
                   __shfl_xor_sync(0xffffffffu, hi ? sum_gb : sum_dt, 2 * kChannels);
        sm += __shfl_xor_sync(0xffffffffu, sm, kChannels);
        if (sub % 2 == 0) dxs[c & 1][sub / 2][u][ln.dl] = sub == 0 ? dtv * sm : sm;
      }
    }
    __syncthreads();
    flush(c_first);
  }
  if (seg == 0 && dh0 != nullptr) store_slots(dh0 + state, carry, n0, N, mine, vec);
  store_slots(part + 2LL * n_batch * n_blocks * S * N +
                  (static_cast<long long>(b) * n_seg + seg) * dn + drow,
              dA, n0, N, mine, vec);
}

// dB, dC [B, S, N] = the blocks' partials summed over the blocks; dA [Din,
// N] = the (batch row, segment) partials summed over them; in a fixed order.
// The first n_bc blocks take 32 consecutive dB / dC outputs each, a lane an
// output: warp w adds partials w, w + kSumWarps, ... in order (four loads
// in flight), then the first warp adds the warps' sums in order. The blocks
// after them take dA, 32 outputs a warp, each lane adding its few partials.
constexpr int kSumWarps = 8;

__global__ void __launch_bounds__(32 * kSumWarps) selective_scan_bwd_sum_kernel(
    const float* __restrict__ part, float* __restrict__ dB, float* __restrict__ dC,
    float* __restrict__ dA, int n_batch, int S, int Din, int N, int n_blocks, int n_seg,
    int n_bc) {
  __shared__ float sums[kSumWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long sn = static_cast<long long>(S) * N, bsn = n_batch * sn;
  const long long dn = static_cast<long long>(Din) * N;
  if (static_cast<int>(blockIdx.x) >= n_bc) {
    const long long j =
        (static_cast<long long>(blockIdx.x - n_bc) * kSumWarps + warp) * 32 + lane;
    if (j >= dn) return;
    const float* src = part + 2 * n_blocks * bsn + j;
    float acc = 0.f;
    for (int k = 0; k < n_batch * n_seg; ++k) acc += src[k * dn];
    dA[j] = acc;
    return;
  }
  const long long i = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool is_c = i >= bsn, live = i < 2 * bsn;
  const long long j = is_c ? i - bsn : i, b = j / sn, r = j % sn;
  const float* src = part + (is_c ? n_blocks * bsn : 0) + b * n_blocks * sn + r;
  const int count = live ? n_blocks : 0;
  float acc = 0.f;
  int k = warp;
  for (; k + 3 * kSumWarps < count; k += 4 * kSumWarps) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = src[(k + e * kSumWarps) * sn];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc += v[e];
  }
  for (; k < count; k += kSumWarps) acc += src[k * sn];
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && live) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) total += sums[w][lane];
    (is_c ? dC : dB)[j] = total;
  }
}

}  // namespace
}  // namespace repro

namespace repro {
namespace {

bool shapes_ok(int B, int S, int Din, int N, int seg_steps) {
  return N >= 1 && N <= kSlots && B >= 1 && B <= 65535 && Din >= 1 && S >= 0 &&
         seg_steps >= 0 && seg_steps % kChunk == 0;
}

// The default segment length on a card of n_sms SMs: the sequence cut into
// as many equal segments (of whole chunks) as fill kWaves waves of
// kBlocksPerSm blocks an SM, 0 (one segment) when one segment's B *
// ceil(Din / 32) blocks fill them already. Each segment past the first
// costs one more exponential per element, in the carry pass. Measured on
// the H100 at hymba-1.5b's trained shape (200 blocks a segment): 5
// segments of 256 steps ran 0.284 ms, against 0.398 for one and 0.288-0.341
// for 2, 4, 6, 8 or 10 (PERF.md).
int default_seg_steps(int B, int S, int Din, int n_sms) {
  const long long blocks =
      static_cast<long long>(B) * ((Din + kBlockChannels - 1) / kBlockChannels);
  const long long n_seg = min(static_cast<long long>(kWaves) * kBlocksPerSm * n_sms / blocks,
                              static_cast<long long>(S + kChunk - 1) / kChunk);
  if (n_seg <= 1) return 0;
  return static_cast<int>((S + n_seg * kChunk - 1) / (n_seg * kChunk) * kChunk);
}

// Steps a segment (seg_steps, or the whole sequence when 0) and the
// number of segments.
void segments(int S, int seg_steps, int& L, int& n_seg) {
  L = seg_steps > 0 ? seg_steps : max(kChunk, (S + kChunk - 1) / kChunk * kChunk);
  n_seg = max(1, (S + L - 1) / L);
}

// The backward's scratch: each block's partial dB_t, dC_t, then each (batch
// row, segment)'s partial dA, then the segments' carries.
long long part_floats_for(int B, int S, int Din, int N, int seg_steps) {
  int L, n_seg;
  segments(S, seg_steps, L, n_seg);
  const long long n_blocks = (Din + kBlockChannels - 1) / kBlockChannels;
  const long long dn = static_cast<long long>(Din) * N;
  return 2LL * B * n_blocks * S * N + static_cast<long long>(B) * n_seg * dn +
         2LL * B * (n_seg - 1) * dn;
}

}  // namespace
}  // namespace repro

// The buffers that the wrappers allocate for these shapes: ckpt_chunks =
// ceil(S / scan::kChunk) checkpoints a batch row (the forward's ckpt [B,
// ckpt_chunks, Din, N]) and part_floats, the backward's scratch with
// segments of seg_steps steps (a multiple of scan::kChunk; 0: one segment;
// -1: the default for a card of n_sms SMs), whose value goes to *seg_used.
// Returns 0, or cudaErrorInvalidValue for shapes that the kernels refuse.
extern "C" int repro_selective_scan_sizes(int B, int S, int Din, int N, int seg_steps,
                                          int n_sms, long long* ckpt_chunks,
                                          long long* part_floats, int* seg_used) {
  using namespace repro;
  if (seg_steps == -1 && B >= 1 && Din >= 1 && S >= 0 && n_sms >= 1)
    seg_steps = default_seg_steps(B, S, Din, n_sms);
  if (!shapes_ok(B, S, Din, N, seg_steps)) return static_cast<int>(cudaErrorInvalidValue);
  int L, n_seg;
  segments(S, seg_steps, L, n_seg);
  if (n_seg > 65535) return static_cast<int>(cudaErrorInvalidValue);
  *ckpt_chunks = (S + kChunk - 1) / kChunk;
  *part_floats = part_floats_for(B, S, Din, N, seg_steps);
  *seg_used = seg_steps;
  return 0;
}

// x, dt, dy, dx, ddt [B, S, Din]; Bm, Cm, dB, dC [B, S, N]; A, dA [Din, N];
// ckpt [B, ceil(S / scan::kChunk), Din, N] from repro_selective_scan_fwd on
// the same operands; dh_final (or null: zeros) and dh0 (or null: not
// written) [B, Din, N]; part: scratch of part_floats floats, the size that
// repro_selective_scan_sizes gives for seg_steps; all contiguous fp32,
// 1 <= N <= 16. Returns the first launch's error, else cudaGetLastError().
extern "C" int repro_selective_scan_bwd(const float* x, const float* dt, const float* Bm,
                                        const float* Cm, const float* A, const float* ckpt,
                                        const float* dy, const float* dh_final, float* dx,
                                        float* ddt, float* dB, float* dC, float* dA, float* dh0,
                                        float* part, long long part_floats, int B, int S,
                                        int Din, int N, int seg_steps, void* stream) {
  using namespace repro;
  if (!shapes_ok(B, S, Din, N, seg_steps) ||
      part_floats != part_floats_for(B, S, Din, N, seg_steps))
    return static_cast<int>(cudaErrorInvalidValue);
  int L, n_seg;
  segments(S, seg_steps, L, n_seg);
  if (n_seg > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = (Din + kBlockChannels - 1) / kBlockChannels;
  const long long dn = static_cast<long long>(Din) * N;
  float* carries = part + part_floats - 2LL * B * (n_seg - 1) * dn;
  // Rows of x / dt / dy, and of B / C, 16 bytes at a time where they allow.
  const bool vec_op = Din % 4 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                        reinterpret_cast<uintptr_t>(dt) |
                                        reinterpret_cast<uintptr_t>(dy)) % 16) == 0;
  const bool vec_bc = N % 4 == 0 && ((reinterpret_cast<uintptr_t>(Bm) |
                                      reinterpret_cast<uintptr_t>(Cm)) % 16) == 0;
  const bool vec_out = Din % 4 == 0 && ((reinterpret_cast<uintptr_t>(dx) |
                                         reinterpret_cast<uintptr_t>(ddt)) % 16) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg > 1) {
    selective_scan_bwd_carry_kernel<<<dim3(static_cast<unsigned>(n_blocks), n_seg - 1, B),
                                      kThreads, 0, st>>>(dt, Cm, A, dy, carries, S, Din, N, L,
                                                         vec_op, vec_bc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  selective_scan_bwd_kernel<<<dim3(static_cast<unsigned>(n_blocks), n_seg, B), kThreads, 0,
                              st>>>(x, dt, Bm, Cm, A, ckpt, dy, dh_final, carries, dx, ddt, dh0,
                                    part, S, Din, N, L, vec_op, vec_bc, vec_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_bc = (2LL * B * S * N + 31) / 32;  // blocks of 32 dB / dC outputs
  const long long n_da = (dn + 32 * kSumWarps - 1) / (32 * kSumWarps);
  selective_scan_bwd_sum_kernel<<<static_cast<unsigned>(n_bc + n_da), 32 * kSumWarps, 0, st>>>(
      part, dB, dC, dA, B, S, Din, N, static_cast<int>(n_blocks), n_seg,
      static_cast<int>(n_bc));
  return static_cast<int>(cudaGetLastError());
}
