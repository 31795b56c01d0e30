// Fused RMSNorm with the E2AFS-R rsqrt in registers.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py (_kernel,
// reached through rmsnorm_kernel_call).  Per row of x (rows, d):
//   ms  = sum(float(x)^2) / d + eps          (float32)
//   inv = E2AFS-R rsqrt(ms), no specials     (e2afs.cuh, rsqrt_f32)
//   y   = T(T(float(x) * inv) * T(1 + float(scale)))
// where T is the activation dtype (bfloat16 or float32) and each T(...) is
// one round-to-nearest-even, the roundings of the reference.  Only the order
// of the float32 sum differs from the reference.
//
// Bound on the H100: bytes (each row read and written once, a few ops per
// element).  Design: one warp per row, 8 rows per block of 256 threads;
// lanes stride over the row so every load coalesces, the sum of squares is a
// per-lane float32 sum closed by a warp shuffle reduction, and the row is
// read a second time (from L1/L2) for the output instead of being held in
// shared memory.  At the decode shapes (8 rows of 2560) only 8 warps run, so
// the kernel is latency-bound there; splitting a row over a block is the
// next step.
#include "e2afs.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <class T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                               T* __restrict__ y, int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<long long>(row) * d;
  T* yr = y + static_cast<long long>(row) * d;
  float acc = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f(xr[i]);
    acc = __fadd_rn(acc, __fmul_rn(v, v));  // no fma: square, then add
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  const float ms = __fadd_rn(__fdiv_rn(acc, static_cast<float>(d)), eps);
  const float inv = e2afs::rsqrt_f32(ms);
  for (int i = lane; i < d; i += 32) {
    const float normed = to_f(from_f<T>(__fmul_rn(to_f(xr[i]), inv)));
    const float s = to_f(from_f<T>(__fadd_rn(1.f, to_f(scale[i]))));
    yr[i] = from_f<T>(__fmul_rn(normed, s));
  }
}

template <class T>
void launch(const void* x, const void* scale, void* y, int rows, int d, float eps,
            cudaStream_t stream) {
  constexpr int threads = 256;  // 8 warps = 8 rows per block
  const int blocks = (rows + 7) / 8;
  rmsnorm_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(y), rows, d, eps);
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float32.  Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, int rows, int d,
                              float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  switch (dtype) {
    case 1: launch<__nv_bfloat16>(x, scale, y, rows, d, eps, s); break;
    case 2: launch<float>(x, scale, y, rows, d, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
