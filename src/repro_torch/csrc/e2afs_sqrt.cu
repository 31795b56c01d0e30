// Elementwise E2AFS sqrt / E2AFS-R rsqrt with IEEE specials.
//
// Replaces the TPU kernel src/repro/kernels/e2afs_sqrt/e2afs_sqrt.py
// (_kernel, reached through e2afs_sqrt_kernel_call), registered there as
// e2afs_sqrt and e2afs_rsqrt.
//
// Bound on the H100: bytes.  Each element is read once and written once
// (2 or 4 bytes each way) and costs a few dozen integer ops, far below the
// card's ratio of operations to bytes.  Design: a grid-stride loop of one
// element per thread with consecutive threads on consecutive addresses, so
// loads and stores coalesce; no shared memory.  Vector loads of 16 bytes per
// thread are the obvious next step.
//
// Deliberate difference from the TPU kernel: a positive subnormal gives +inf
// under ftz, as the plain version (repro/core/e2afs.py::e2afs_rsqrt) does;
// the Pallas kernel returns 0 there.
#include "e2afs.cuh"

namespace {

template <class F, bool RSQRT>
__global__ void e2afs_kernel(const typename F::Bits* __restrict__ x,
                             typename F::Bits* __restrict__ y, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = e2afs::unit_bits<F, RSQRT>(x[i]);
  }
}

template <class F>
void launch(const void* x, void* y, long long n, int rsqrt, cudaStream_t stream) {
  constexpr int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  using B = typename F::Bits;
  if (rsqrt) {
    e2afs_kernel<F, true><<<blocks, threads, 0, stream>>>(static_cast<const B*>(x),
                                                          static_cast<B*>(y), n);
  } else {
    e2afs_kernel<F, false><<<blocks, threads, 0, stream>>>(static_cast<const B*>(x),
                                                           static_cast<B*>(y), n);
  }
}

// The number of float32 patterns in [first, last) on which sqrt_normal_f32
// and sqrt_positive_f32 differ, added to *mismatches (one atomic a warp).
__global__ void normal_check_kernel(unsigned first, unsigned last,
                                    unsigned long long* __restrict__ mismatches) {
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  unsigned bad = 0;
  for (unsigned long long i = first + static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
                              threadIdx.x;
       i < last; i += stride) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    bad += __float_as_uint(e2afs::sqrt_normal_f32(x)) !=
           __float_as_uint(e2afs::sqrt_positive_f32(x));
  }
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && bad != 0) atomicAdd(mismatches, static_cast<unsigned long long>(bad));
}

}  // namespace

// The check of the Sobel and K-means kernels' lean sqrt against the general
// one over the patterns [first, last); mismatches: one uint64 on the card,
// added to.  Returns cudaGetLastError().
extern "C" int e2afs_sqrt_normal_check(unsigned first, unsigned last, void* mismatches,
                                       void* stream) {
  if (last <= first) return 0;
  normal_check_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      first, last, static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float16, 1 = bfloat16, 2 = float32.  Returns cudaGetLastError().
extern "C" int e2afs_sqrt_launch(const void* x, void* y, long long n, int dtype, int rsqrt,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (dtype) {
    case 0: launch<e2afs::Fp16>(x, y, n, rsqrt, s); break;
    case 1: launch<e2afs::Bf16>(x, y, n, rsqrt, s); break;
    case 2: launch<e2afs::Fp32>(x, y, n, rsqrt, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
