// E2AFS / E2AFS-R integer datapath as __device__ functions, shared by every
// kernel of repro_torch (the elementwise unit kernel inlines it, and so do
// the fused RMSNorm, Sobel and K-means kernels).
//
// Mirrors repro_torch/core/e2afs.py (itself bit-identical to
// src/repro/core/e2afs.py) operation for operation:
//  * fields are signed 32-bit ints, so the right shifts of a negative
//    exponent offset r are arithmetic, as in the reference;
//  * compose builds the sign|exp|man word in 32 bits and truncates it to the
//    format's width (16 or 32 bits) before the bitcast, which reproduces the
//    reference's int32 -> uint16/uint32 wrap at out-of-range exponents;
//  * the Q-grid constants come from the generated e2afs_constants.h (Python's
//    half-to-even round; C's roundf would give 179 for bf16's 178.5).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "e2afs_constants.h"

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace e2afs {

struct Fp16 {
  using T = __half;
  using Bits = unsigned short;
  static constexpr int EXP = 5, MAN = 10;
  static constexpr int C_EVEN = E2AFS_FP16_C_EVEN, C_ODD = E2AFS_FP16_C_ODD;
  static constexpr int RS_00 = E2AFS_FP16_RS_00, RS_01 = E2AFS_FP16_RS_01;
  static constexpr int RS_10 = E2AFS_FP16_RS_10, RS_11 = E2AFS_FP16_RS_11;
  static constexpr Bits NAN_BITS = 0x7E00, INF_BITS = 0x7C00;
};

struct Bf16 {
  using T = __nv_bfloat16;
  using Bits = unsigned short;
  static constexpr int EXP = 8, MAN = 7;
  static constexpr int C_EVEN = E2AFS_BF16_C_EVEN, C_ODD = E2AFS_BF16_C_ODD;
  static constexpr int RS_00 = E2AFS_BF16_RS_00, RS_01 = E2AFS_BF16_RS_01;
  static constexpr int RS_10 = E2AFS_BF16_RS_10, RS_11 = E2AFS_BF16_RS_11;
  static constexpr Bits NAN_BITS = 0x7FC0, INF_BITS = 0x7F80;
};

struct Fp32 {
  using T = float;
  using Bits = unsigned int;
  static constexpr int EXP = 8, MAN = 23;
  static constexpr int C_EVEN = E2AFS_FP32_C_EVEN, C_ODD = E2AFS_FP32_C_ODD;
  static constexpr int RS_00 = E2AFS_FP32_RS_00, RS_01 = E2AFS_FP32_RS_01;
  static constexpr int RS_10 = E2AFS_FP32_RS_10, RS_11 = E2AFS_FP32_RS_11;
  static constexpr Bits NAN_BITS = 0x7FC00000u, INF_BITS = 0x7F800000u;
};

template <class F> __host__ __device__ constexpr int bias() { return (1 << (F::EXP - 1)) - 1; }
template <class F> __host__ __device__ constexpr int exp_mask() { return (1 << F::EXP) - 1; }
template <class F> __host__ __device__ constexpr int man_mask() { return (1 << F::MAN) - 1; }

// E2AFS sqrt: biased exponent + mantissa -> output fields (normal inputs).
template <class F>
__device__ __forceinline__ void sqrt_fields(int exp, int man, int& exp_out, int& man_out) {
  const int one = 1 << F::MAN;
  const int r = exp - bias<F>();
  const int odd = r & 1;
  const int y_hi = man >> (F::MAN - 1);
  exp_out = (odd == 1 ? (r - 1) >> 1 : r >> 1) + bias<F>();
  const int even_res = one + (man >> 1) - (y_hi == 1 ? F::C_EVEN : 0);
  const int man_adj = y_hi == 1 ? man + F::C_ODD : man;
  const int t = one + (man_adj >> 2);
  const int odd_res = t + (t >> 1);
  int res = odd == 1 ? odd_res : even_res;
  const int ovf = res >> (F::MAN + 1);
  res = ovf == 1 ? res >> 1 : res;
  exp_out += ovf;
  man_out = res - one;
}

// E2AFS-R rsqrt: four-region shift-add PWL of the mantissa.
template <class F>
__device__ __forceinline__ void rsqrt_fields(int exp, int man, int& exp_out, int& man_out) {
  const int one = 1 << F::MAN;
  const int r = exp - bias<F>();
  const int odd = r & 1;
  const int y_hi = man >> (F::MAN - 1);
  exp_out = (odd == 1 ? -((r + 1) >> 1) : -(r >> 1) - 1) + bias<F>();
  int res;
  if (odd == 1) {
    res = y_hi == 1 ? F::RS_11 - (man >> 2) - (man >> 4) : F::RS_10 - (man >> 1) - (man >> 8);
  } else {
    res = y_hi == 1 ? F::RS_01 - (man >> 2) - (man >> 3) : F::RS_00 - (man >> 1) - (man >> 2);
  }
  const int under = res < one ? 1 : 0;
  res = under == 1 ? res << 1 : res;
  exp_out -= under;
  man_out = (res - one) & man_mask<F>();
}

template <class F>
__device__ __forceinline__ typename F::Bits compose(int sign, int exp, int man) {
  const unsigned int word = (static_cast<unsigned int>(sign) << (F::EXP + F::MAN)) |
                            (static_cast<unsigned int>(exp) << F::MAN) |
                            static_cast<unsigned int>(man);
  return static_cast<typename F::Bits>(word);  // wrap to the format's width
}

// Full unit with the IEEE specials of repro_torch/core/numerics.py
// (apply_specials, ftz) and, for rsqrt, rsqrt(+-0 or positive subnormal) =
// +inf and rsqrt(+inf) = 0.
template <class F, bool RSQRT>
__device__ __forceinline__ typename F::Bits unit_bits(typename F::Bits x) {
  const int bits = static_cast<int>(x);
  const int sign = (bits >> (F::EXP + F::MAN)) & 1;
  const int exp = (bits >> F::MAN) & exp_mask<F>();
  const int man = bits & man_mask<F>();
  int exp_out, man_out;
  if (RSQRT) {
    rsqrt_fields<F>(exp, man, exp_out, man_out);
  } else {
    sqrt_fields<F>(exp, man, exp_out, man_out);
  }
  typename F::Bits out = compose<F>(0, exp_out, man_out);
  const bool is_zero = exp == 0 && man == 0;
  const bool is_sub = exp == 0 && man != 0;
  const bool is_inf = exp == exp_mask<F>() && man == 0;
  const bool is_nan = exp == exp_mask<F>() && man != 0;
  const bool is_neg = sign == 1 && !is_zero;
  if (is_sub || is_zero) out = 0;
  if (is_inf) out = F::INF_BITS;
  if (is_nan || is_neg) out = F::NAN_BITS;
  if (RSQRT) {
    if (is_zero || (exp == 0 && sign == 0)) out = F::INF_BITS;
    if (is_inf && sign == 0) out = 0;
  }
  return out;
}

// E2AFS-R rsqrt of a positive finite float32, no specials (the in-register
// datapath of the fused RMSNorm).
__device__ __forceinline__ float rsqrt_f32(float x) {
  const int bits = static_cast<int>(__float_as_uint(x));
  const int exp = (bits >> Fp32::MAN) & exp_mask<Fp32>();
  const int man = bits & man_mask<Fp32>();
  int exp_out, man_out;
  rsqrt_fields<Fp32>(exp, man, exp_out, man_out);
  return __uint_as_float(compose<Fp32>(0, exp_out, man_out));
}

// E2AFS sqrt of a known-positive float32, no specials (the in-register
// datapath of the fused Sobel and K-means kernels; the counterpart of
// repro_torch/core/e2afs.py::e2afs_sqrt_positive).  x <= 0, and a float32
// subnormal, give 0, as the reference's compare with denormals read as zero.
__device__ __forceinline__ float sqrt_positive_f32(float x) {
  const int bits = static_cast<int>(__float_as_uint(x));
  const int exp = (bits >> Fp32::MAN) & exp_mask<Fp32>();
  const int man = bits & man_mask<Fp32>();
  if (x <= 0.0f || exp == 0) return 0.0f;
  int exp_out, man_out;
  sqrt_fields<Fp32>(exp, man, exp_out, man_out);
  return __uint_as_float(compose<Fp32>(0, exp_out, man_out));
}

// E2AFS sqrt of a positive normal input word w (the format's bits, zero
// extended): the same bits as sqrt_fields and compose on every such input
// (chip_smoke.py phase 1 checks all of them) in fewer instructions.  There
// is no zero or subnormal test, and no overflow step: no format takes it
// (the odd path peaks at 2047 < 2^11 in fp16, 255 < 2^8 in bf16 and
// 16,777,110 < 2^24 in float32).  With bias B = 2^(EXP-1) - 1 (odd), the
// output word comes from w = exp 2^MAN + man, with w >> 1 = j 2^MAN +
// ((exp & 1) 2^MAN + man) >> 1 for j = exp >> 1:
//  * exp = 2j + 1 (r = exp - B even): the exponent is j + (B + 1)/2, so the
//    word is (j + (B + 1)/2) 2^MAN + (man >> 1) - y_hi C_EVEN = (w >> 1) +
//    (B + 1)/2 2^MAN - 2^(MAN-1) - y_hi C_EVEN;
//  * exp = 2j (r odd): the exponent is j + (B - 1)/2, and the mantissa
//    t + (t >> 1) carries the leading one, so the word is (j + (B - 3)/2)
//    2^MAN + t + (t >> 1) with t = 2^MAN + ((man + y_hi C_ODD) >> 2), and
//    (w >> 1) & (exponent field) = j 2^MAN.
// y_hi enters as a 0 or 1 multiplier, not a select.
template <class F>
__device__ __forceinline__ unsigned sqrt_normal_bits(unsigned w) {
  constexpr unsigned one = 1u << F::MAN;
  constexpr unsigned exps = static_cast<unsigned>(exp_mask<F>()) << F::MAN;
  constexpr unsigned half_bias = (bias<F>() + 1) / 2;
  const unsigned y_hi = (w >> (F::MAN - 1)) & 1u;
  const unsigned man = w & man_mask<F>();
  const unsigned even_word = (w >> 1) + (half_bias * one - (one >> 1)) - y_hi * F::C_EVEN;
  const unsigned t = ((man + y_hi * F::C_ODD) >> 2) + one;
  const unsigned odd_word = ((w >> 1) & exps) + (half_bias - 2) * one + t + (t >> 1);
  return (w & one) != 0 ? even_word : odd_word;
}

// The part of sqrt_normal_bits that depends on more than the low MAN + 1
// bits of w (the exponent's parity and the mantissa): j 2^MAN, from the
// note above.  The rest, sqrt_normal_bits(w) - sqrt_exponent_word(w), is
// a function of those bits alone: 2048 values in fp16, 256 in bf16.
template <class F>
__device__ __forceinline__ unsigned sqrt_exponent_word(unsigned w) {
  return (w >> 1) & (static_cast<unsigned>(exp_mask<F>()) << F::MAN);
}

// E2AFS sqrt of a positive normal float32: the in-register datapath of the
// fused Sobel and K-means kernels, which clamp their input to at least 1e-12
// or 1e-9 first (sqrt_normal_bits; 0x7F800000 is the exponent field, 64 and
// 62 the two paths' exponent offsets).  chip_smoke.py phase 1 holds it to
// sqrt_positive_f32 on every such input, and phase 5 reads what the K-means
// distance loop compiles to.
__device__ __forceinline__ float sqrt_normal_f32(float x) {
  return __uint_as_float(sqrt_normal_bits<Fp32>(__float_as_uint(x)));
}

// E2AFS-R rsqrt of a positive normal input word w: the same bits as
// rsqrt_fields and compose on every such input, in fewer instructions, as
// the sum of an exponent word and a mantissa term.
//  * The exponent is (3B - 1)/2 - ceil(exp / 2) in both parities, and
//    ((w + 2^MAN) >> 1) & (exponent field) = ceil(exp / 2) 2^MAN.
//  * The region (exponent parity, y_hi) picks the intercept and the second
//    shift: 8 >> y_hi when r is odd (shifts 1, 8 and 2, 4), 2 + y_hi when r
//    is even (1, 2 and 2, 3); the first shift is 1 + y_hi in all four.
//  * With d = res - 2^MAN, the word is exp_out 2^MAN + d; where res < 2^MAN
//    (only in region r odd, y_hi, near its top) the mantissa doubles and the
//    exponent drops by one: exp_out 2^MAN + 2d.  So the term is d + min(d, 0).
// The term depends on the low MAN + 1 bits of w only (the exponent's parity
// and the mantissa): 2048 values in fp16, 256 in bf16.
template <class F>
__device__ __forceinline__ unsigned rsqrt_exponent_word(unsigned w) {
  constexpr unsigned one = 1u << F::MAN;
  constexpr unsigned exps = static_cast<unsigned>(exp_mask<F>()) << F::MAN;
  constexpr unsigned exp_top = (3u * bias<F>() - 1u) / 2u * one;
  return exp_top - (((w + one) >> 1) & exps);
}

template <class F>
__device__ __forceinline__ int rsqrt_mantissa_term(unsigned w) {
  constexpr unsigned one = 1u << F::MAN;
  const unsigned y_hi = (w >> (F::MAN - 1)) & 1u;
  const unsigned man = w & man_mask<F>();
  const bool even = (w & one) != 0;  // r = exp - B even
  const int rs = even ? (y_hi ? F::RS_01 : F::RS_00) : (y_hi ? F::RS_11 : F::RS_10);
  const unsigned second = even ? 2u + y_hi : 8u >> y_hi;
  const int d = rs - static_cast<int>(one + (man >> (1u + y_hi)) + (man >> second));
  return d + (d < 0 ? d : 0);
}

template <class F>
__device__ __forceinline__ unsigned rsqrt_normal_bits(unsigned w) {
  return rsqrt_exponent_word<F>(w) + static_cast<unsigned>(rsqrt_mantissa_term<F>(w));
}

// Whether the word w (zero extended) is a positive normal value.
template <class F>
__device__ __forceinline__ bool positive_normal(unsigned w) {
  constexpr unsigned one = 1u << F::MAN;
  constexpr unsigned exps = static_cast<unsigned>(exp_mask<F>()) << F::MAN;
  return w - one < exps - one;
}

// unit_bits on a word that is not a positive normal: sqrt gives 0 for +-0
// and positive subnormals, +inf for +inf; rsqrt gives +inf and 0 there;
// both give NaN for NaN and every other negative input.
template <class F, bool RSQRT>
__device__ __forceinline__ unsigned special_bits(unsigned w) {
  constexpr unsigned one = 1u << F::MAN, sign = 1u << (F::EXP + F::MAN);
  if (w == F::INF_BITS) return RSQRT ? 0u : F::INF_BITS;
  const bool zero = w < one || w == sign;
  return zero ? (RSQRT ? F::INF_BITS : 0u) : F::NAN_BITS;
}

// The elementwise kernel's datapath, one word: unit_bits's bits on every
// input (chip_smoke.py phase 1 checks every pattern of each format).
template <class F, bool RSQRT>
__device__ __forceinline__ unsigned lean_unit_bits(unsigned w) {
  if (!positive_normal<F>(w)) return special_bits<F, RSQRT>(w);
  return RSQRT ? rsqrt_normal_bits<F>(w) : sqrt_normal_bits<F>(w);
}

}  // namespace e2afs
