// Split-KV flash-decode for Hopper (sm_90a): one new query token per lane
// attends to a dense KV cache with per-lane lengths and an optional window.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/decode_attention.py
// (decode_attention_bhsd, pallas_call at :94) and the XLA log-sum-exp merge
// that follows it (:116-122).
//
// The body is split_decode.cuh's (bound, design), shared with the paged
// decode kernel, with kDenseTile rows of a lane's cache as the tile: a warp
// finds its tile's first row by position, with no table to read. One launch
// per call; where the wrapper splits a lane's rows, the chunks merge inside
// their thread-block cluster, so no partials reach global memory.
//
// The cache is read in the serving engine's layout, [lane, position, KV head,
// head_dim] per layer, through strides: no transpose to BHSD (the JAX
// wrapper, decode_attention/ops.py:27-31, transposes the whole cache). Rows
// start on 16-byte boundaries (the wrapper checks it).
#include "split_decode.cuh"

// q [B, 1, H, D]; k/v [B, S, KV, D] (strides of lane, position, head);
// lengths [B] int32 = valid rows including the new token (rows past S are
// not read; a window still counts back from the length);
// per_chunk = tiles of kDenseTile rows per chunk, n_chunks (1..8) chunks per
// lane with per_chunk * n_chunks >= ceil(S / kDenseTile); o [B, 1, H, D].
// window <= 0 means no window. dtype: 0 = fp32, 1 = bf16. Returns the
// launch's error.
extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o, int B, int S,
    int H, int KV, int D, int per_chunk, int n_chunks, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, int window, float scale, int dtype,
    void* stream) {
  using namespace repro;
  const int n_tiles = (S + kDenseTile - 1) / kDenseTile;
  if (n_chunks < 1 || n_chunks > kMaxChunks || per_chunk < 1 || S < 0 || KV < 1 ||
      H % KV != 0 || (long long)per_chunk * n_chunks < n_tiles || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = {};
  a.q = q, a.k = k, a.v = v, a.o = o;
  a.lengths = static_cast<const int*>(lengths);
  a.n_tiles = n_tiles, a.tile = kDenseTile, a.n_rows = S;
  a.G = H / KV, a.per_chunk = per_chunk;
  a.qs = {q_sb, 0, q_sh};
  a.os = {o_sb, 0, o_sh};
  a.ks = {k_sb, kDenseTile * k_ss, k_ss, k_sh};
  a.vs = {v_sb, kDenseTile * v_ss, v_ss, v_sh};
  a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 64)
    return launch_split_decode<float, float, 64, false>(a, B, KV, n_chunks, scale, st);
  if (dtype == kFloat32 && D == 128)
    return launch_split_decode<float, float, 128, false>(a, B, KV, n_chunks, scale, st);
  if (dtype == kBFloat16 && D == 64)
    return launch_split_decode<__nv_bfloat16, __nv_bfloat16, 64, false>(a, B, KV, n_chunks,
                                                                         scale, st);
  if (dtype == kBFloat16 && D == 128)
    return launch_split_decode<__nv_bfloat16, __nv_bfloat16, 128, false>(a, B, KV, n_chunks,
                                                                          scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch shape the entry above takes for these arguments, which the
// wrapper splits a lane's rows by (shape[0..3]: split_decode_launch_shape's
// blocks of the instantiation per SM, warps per block, the most chunks of
// one lane, query heads per block), and shape[4] = kDenseTile, the rows of
// a tile. Returns 0, or the error for arguments the entry refuses.
extern "C" int repro_decode_attention_launch_shape(int D, int G, int dtype, int* shape) {
  using namespace repro;
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  shape[4] = kDenseTile;
  if (dtype == kFloat32 && D == 64)
    return static_cast<int>(split_decode_launch_shape<float, float, 64, false>(G, shape));
  if (dtype == kFloat32 && D == 128)
    return static_cast<int>(split_decode_launch_shape<float, float, 128, false>(G, shape));
  if (dtype == kBFloat16 && D == 64)
    return static_cast<int>(
        split_decode_launch_shape<__nv_bfloat16, __nv_bfloat16, 64, false>(G, shape));
  if (dtype == kBFloat16 && D == 128)
    return static_cast<int>(
        split_decode_launch_shape<__nv_bfloat16, __nv_bfloat16, 128, false>(G, shape));
  return static_cast<int>(cudaErrorInvalidValue);
}
