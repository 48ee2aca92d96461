// Paged split-KV flash-decode for Hopper (sm_90a): one new query token per
// lane attends to its context scattered over a shared page pool, named page
// by page through the lane's block table, with an optional window and
// optional int8 pages dequantized on load.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged.py
// (paged_decode_attention, pallas_call at :143) and the XLA log-sum-exp
// merge that follows it (:154-159).
//
// The body is split_decode.cuh's (bound, design), shared with the dense
// decode kernel, with a page as the tile: a warp takes its pages' ids from
// the lane's block-table row (kTable). The pool is read in the engine's
// per-layer view of [n_layers, P+1, page, KV, head_dim] through strides (no
// copy); the scales likewise from [n_layers, P+1, page]. Pool rows start on
// 16-byte boundaries (the wrapper checks it). Lengths are clamped to
// NB * page: a row past the block table is never addressed.
#include "split_decode.cuh"

// q [B, 1, H, D]; k/v pools [P, page, KV, D] (strides of page, row, head)
// in q's dtype, or int8 with fp32 scales [P, page] (strides sc_p, sc_r;
// null pointers for unquantized pools); block_tables [B, NB] int32 (row
// stride bt_sb); lengths [B] int32 = valid rows including the new token;
// per_chunk = pages per chunk, n_chunks (1..8) chunks per block-table row
// with per_chunk * n_chunks >= NB; o [B, 1, H, D]. window <= 0 means no
// window. dtype of q/o: 0 = fp32, 1 = bf16; kv_int8: 1 = int8 pools. Pool
// rows must start on 16-byte boundaries. Returns the launch's error.
extern "C" int repro_paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* lengths, void* o, int B,
    int NB, int page, int H, int KV, int D, int per_chunk, int n_chunks, long long bt_sb,
    long long q_sb, long long q_sh, long long k_sp, long long k_sr, long long k_sh,
    long long v_sp, long long v_sr, long long v_sh, long long sc_p, long long sc_r,
    long long o_sb, long long o_sh, int window, float scale, int dtype, int kv_int8,
    void* stream) {
  using namespace repro;
  if (n_chunks < 1 || n_chunks > kMaxChunks || per_chunk < 1 || page < 1 || KV < 1 ||
      H % KV != 0 || (long long)per_chunk * n_chunks < NB || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = {};
  a.q = q, a.k = k, a.v = v, a.o = o;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.block_tables = static_cast<const int*>(block_tables);
  a.lengths = static_cast<const int*>(lengths);
  a.n_tiles = NB, a.tile = page, a.n_rows = NB * page;
  a.G = H / KV, a.per_chunk = per_chunk;
  a.bt_sb = bt_sb, a.sc_p = sc_p, a.sc_r = sc_r;
  a.qs = {q_sb, 0, q_sh};
  a.os = {o_sb, 0, o_sh};
  a.ks = {0, k_sp, k_sr, k_sh};
  a.vs = {0, v_sp, v_sr, v_sh};
  a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED_DECODE(T, KT, DIM) \
  return launch_split_decode<T, KT, DIM, true>(a, B, KV, n_chunks, scale, st)
  if (dtype == kFloat32 && !kv_int8 && D == 64) REPRO_PAGED_DECODE(float, float, 64);
  if (dtype == kFloat32 && !kv_int8 && D == 128) REPRO_PAGED_DECODE(float, float, 128);
  if (dtype == kBFloat16 && !kv_int8 && D == 64) REPRO_PAGED_DECODE(__nv_bfloat16, __nv_bfloat16, 64);
  if (dtype == kBFloat16 && !kv_int8 && D == 128) REPRO_PAGED_DECODE(__nv_bfloat16, __nv_bfloat16, 128);
  if (dtype == kFloat32 && kv_int8 && D == 64) REPRO_PAGED_DECODE(float, int8_t, 64);
  if (dtype == kFloat32 && kv_int8 && D == 128) REPRO_PAGED_DECODE(float, int8_t, 128);
  if (dtype == kBFloat16 && kv_int8 && D == 64) REPRO_PAGED_DECODE(__nv_bfloat16, int8_t, 64);
  if (dtype == kBFloat16 && kv_int8 && D == 128) REPRO_PAGED_DECODE(__nv_bfloat16, int8_t, 128);
#undef REPRO_PAGED_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch shape the entry above takes for these arguments, which the
// wrapper splits block-table rows by (split_decode_launch_shape: blocks of
// the instantiation per SM, warps per block, the most chunks of one row,
// query heads per block). Returns 0, or the error for arguments the entry
// refuses.
extern "C" int repro_paged_decode_attention_launch_shape(int D, int G, int dtype, int kv_int8,
                                                          int* shape) {
  using namespace repro;
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_PAGED_SHAPE(T, KT, DIM) \
  return static_cast<int>(split_decode_launch_shape<T, KT, DIM, true>(G, shape))
  if (dtype == kFloat32 && !kv_int8 && D == 64) REPRO_PAGED_SHAPE(float, float, 64);
  if (dtype == kFloat32 && !kv_int8 && D == 128) REPRO_PAGED_SHAPE(float, float, 128);
  if (dtype == kBFloat16 && !kv_int8 && D == 64) REPRO_PAGED_SHAPE(__nv_bfloat16, __nv_bfloat16, 64);
  if (dtype == kBFloat16 && !kv_int8 && D == 128) REPRO_PAGED_SHAPE(__nv_bfloat16, __nv_bfloat16, 128);
  if (dtype == kFloat32 && kv_int8 && D == 64) REPRO_PAGED_SHAPE(float, int8_t, 64);
  if (dtype == kFloat32 && kv_int8 && D == 128) REPRO_PAGED_SHAPE(float, int8_t, 128);
  if (dtype == kBFloat16 && kv_int8 && D == 64) REPRO_PAGED_SHAPE(__nv_bfloat16, int8_t, 64);
  if (dtype == kBFloat16 && kv_int8 && D == 128) REPRO_PAGED_SHAPE(__nv_bfloat16, int8_t, 128);
#undef REPRO_PAGED_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}
