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

// E2AFS sqrt of a positive normal float32: the in-register datapath of the
// fused Sobel and K-means kernels, which clamp their input to at least 1e-12
// or 1e-9 first.  The same bits as sqrt_positive_f32 on every such input
// (chip_smoke.py phase 1 checks all of them) in fewer instructions.  There is
// no zero or subnormal test, and no overflow step: float32 never takes it
// (the odd path peaks at 16,777,110 < 2^24).  The output word comes from the
// input word w = exp 2^23 + man, with w >> 1 = exp 2^22 + (man >> 1):
//  * exp = 2j + 1 (r = exp - bias even): the exponent is j + 63, so the word
//    is (j + 64) 2^23 + (man >> 1) - y_hi C_EVEN = (w >> 1) + 64 2^23 - 2^22
//    - y_hi C_EVEN;
//  * exp = 2j (r odd): the exponent is j + 62, so the word is (j + 62) 2^23
//    + t + (t >> 1) with t = 2^23 + ((man + y_hi C_ODD) >> 2), and
//    (w >> 1) & 0x7F800000 = j 2^23.
// y_hi enters as a 0 or 1 multiplier, not a select.  chip_smoke.py phase 5
// reads what the K-means distance loop compiles to.
__device__ __forceinline__ float sqrt_normal_f32(float x) {
  constexpr unsigned one = 1u << Fp32::MAN;
  const unsigned w = __float_as_uint(x);
  const unsigned y_hi = (w >> (Fp32::MAN - 1)) & 1u;
  const unsigned man = w & man_mask<Fp32>();
  const unsigned even_word = (w >> 1) + (64u * one - (one >> 1)) - y_hi * Fp32::C_EVEN;
  const unsigned t = ((man + y_hi * Fp32::C_ODD) >> 2) + one;
  const unsigned odd_word = ((w >> 1) & 0x7F800000u) + 62u * one + t + (t >> 1);
  return __uint_as_float((w & one) != 0 ? even_word : odd_word);
}

}  // namespace e2afs
