// fp32 products on the tensor cores as 3xTF32 (mma.sync m16n8k8, sm_80+).
//
// A TF32 operand keeps 10 mantissa bits, about three decimal digits. Each
// fp32 operand x is split into big = cvt.rna.tf32.f32(x) and small =
// cvt.rna.tf32.f32(x - big) (x - big is exact in fp32; to_tf32 below gives
// the conversion's bits), and a product accumulates small*big + big*small
// + big*big into fp32 accumulators, in that order: the dropped small*small
// term is ~2^-22 of the product, so the result is close to an fp32 product
// at a third of the TF32 rate (495 / 3 TFLOP/s dense on the H100). This is
// CUTLASS's OpMultiplyAddFastF32.
//
// Fragments are those of mma.m16n8k8.row.col.f32.tf32.tf32.f32, with
// gid = lane / 4 and tig = lane % 4:
//   A (16 x 8): a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4),
//               a3 (gid + 8, tig + 4)
//   B (8 x 8):  b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)
//   C (16 x 8): c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2 (gid + 8, 2 tig),
//               c3 (gid + 8, 2 tig + 1)
// The k order inside a step is free as long as A and B agree. So an
// accumulator C feeds the A operand of a next product without a shuffle,
// as {c0, c2, c1, c3}, when B's rows are read in the same order: slot tig
// holds k = 2 tig and slot tig + 4 holds k = 2 tig + 1 (a_from_acc, and
// the callers' B loads).
#pragma once

#include <cstdint>

namespace repro {
namespace tf32x3 {

// One operand fragment split in two TF32 parts.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};
using FragA = Frag<4>;
using FragB = Frag<2>;

// cvt.rna.tf32.f32: round to nearest, ties away from zero, at 10 mantissa
// bits (the 13 low bits cleared). Written on the integer pipe, with the
// same bits for every finite x (the sign-magnitude layout makes a carry out
// of the mantissa step the exponent, as rounding up does): the PTX
// instruction itself compiles to a 5-instruction sequence on sm_90a, and
// in the product loops that sequence took a quarter of the kernel's time
// (PERF.md). to_tf32_finite is the add and the mask alone: right for every
// x but a NaN whose magnitude is 0x7ffff000 or above, such as 0x7fffffff,
// the NaN that the card's arithmetic makes (carried into the sign bit as
// -0), or its negation 0xffffffff (wrapped to +0), which would drop out of
// the product. to_tf32 adds a compare and a select that keep every NaN as
// 0x7fffffff (still a NaN in its TF32 bits).
__device__ __forceinline__ uint32_t to_tf32_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return x != x ? 0x7fffffffu : to_tf32_finite(x);
}

// x into its two parts. The small part, x - big, is finite whenever big
// is, so it takes to_tf32_finite: a non-finite x reaches the product
// through big. With kKeepNaN, every NaN of x reaches the product; without,
// the compare is saved (2 of ~6 instructions an element), for operands
// whose NaNs reach the result by another path (the caller says which).
template <bool kKeepNaN, int N>
__device__ __forceinline__ void split_parts(Frag<N>& f, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.big[i] = kKeepNaN ? to_tf32(x[i]) : to_tf32_finite(x[i]);
    f.small[i] = to_tf32_finite(x[i] - __uint_as_float(f.big[i]));
  }
}
template <int N>
__device__ __forceinline__ void split(Frag<N>& f, const float (&x)[N]) {
  split_parts<true>(f, x);
}

// The A operand from an accumulator tile (its rows, its 8 columns as k in
// the order {2 tig, 2 tig + 1}).
__device__ __forceinline__ void a_from_acc(FragA& f, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split(f, x);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b to near fp32 accuracy: three TF32 products.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// The same with the big product and the two small ones summed apart, into
// big and small, for the caller to add in fp32. The tensor cores round each
// product's sum toward zero, up to a unit in the last place of the
// accumulator a product and always shrinking it: apart, the big sum takes
// a third of those, and the small sum's are ~2^-11 as large. Summed into
// the fp32 forward's O itself, tile after tile, they shrank O by ~1e-6 of
// its size (PERF.md).
__device__ __forceinline__ void mma3_apart(float (&big)[4], float (&small)[4], const FragA& a,
                                           const FragB& b) {
  mma(small, a.small, b.big);
  mma(small, a.big, b.small);
  mma(big, a.big, b.big);
}

}  // namespace tf32x3
}  // namespace repro
