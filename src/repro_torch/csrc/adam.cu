// Fused AdamW step with the E2AFS sqrt denominator, in place: p, m, v are
// read and written, g is read; sched = [lr, b1c, b2c] is read from device
// memory, so a captured step needs no host scalars.
//
// Replaces the TPU kernel src/repro/kernels/adam/adam.py (_kernel, reached
// through adam_kernel_call).
//
// Bound on the H100: bytes.  Four streams read and three written (28 bytes
// an element for float32 p and g) against about 15 float and 14 integer
// operations.  Design: one grid-stride pass, one thread per element, a few
// resident blocks per SM; nothing is staged, since no element is read twice.
// The tile, threads a block x blocks an SM, is a launch argument
// (kernels/adam/ops.py's TilingSpec; today's launch and the default: 256 x
// 8); every tile gives the same bits, each element's arithmetic being the
// same.
//
// Arithmetic: the plain version's order (kernels/adam/ref.py, the
// reference's ref_adam_update and TPU kernel), ((1 - b2) * g) * g included,
// every product, sum and quotient rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn) so that nvcc cannot contract them into FMAs.  The
// host passes 1 - b1 and 1 - b2 already rounded from double.  The sqrt is
// e2afs::sqrt_positive_f32: on v_hat >= 0 it equals the unit's e2afs_sqrt
// (zeros and float32 subnormals give 0 on both).
#include "e2afs.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <class P, class G, int THREADS>
__global__ void __launch_bounds__(THREADS)
adam_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
            float* __restrict__ v, const float* __restrict__ sched, long long n, float b1,
            float one_minus_b1, float b2, float one_minus_b2, float eps, float wd) {
  const float lr = sched[0], b1c = sched[1], b2c = sched[2];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float g32 = to_f32(g[i]);
    const float mi = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(one_minus_b1, g32));
    const float vi = __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(one_minus_b2, g32), g32));
    const float m_hat = __fdiv_rn(mi, b1c);
    const float v_hat = __fdiv_rn(vi, b2c);
    const float denom = __fadd_rn(e2afs::sqrt_positive_f32(v_hat), eps);
    const float p32 = to_f32(p[i]);
    const float step = __fmul_rn(lr, __fadd_rn(__fdiv_rn(m_hat, denom), __fmul_rn(wd, p32)));
    p[i] = from_f32<P>(__fsub_rn(p32, step));
    m[i] = mi;
    v[i] = vi;
  }
}

template <class P, class G, int THREADS>
int launch_tile(void* p, const void* g, void* m, void* v, const void* sched, long long n,
                float b1, float omb1, float b2, float omb2, float eps, float wd,
                int blocks_per_sm, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * blocks_per_sm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  adam_kernel<P, G, THREADS><<<blocks, THREADS, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<const float*>(sched), n, b1, omb1, b2, omb2, eps, wd);
  return static_cast<int>(cudaGetLastError());
}

// The threads a block the kernel is instantiated for: those of the
// TilingSpec's candidates of kernels/adam/ops.py.
template <class P, class G>
int launch(void* p, const void* g, void* m, void* v, const void* sched, long long n, float b1,
           float omb1, float b2, float omb2, float eps, float wd, int threads, int blocks_per_sm,
           cudaStream_t stream) {
  if (blocks_per_sm < 1 || blocks_per_sm > 64) return static_cast<int>(cudaErrorInvalidValue);
  switch (threads) {
    case 128: return launch_tile<P, G, 128>(p, g, m, v, sched, n, b1, omb1, b2, omb2, eps, wd, blocks_per_sm, stream);
    case 256: return launch_tile<P, G, 256>(p, g, m, v, sched, n, b1, omb1, b2, omb2, eps, wd, blocks_per_sm, stream);
    case 512: return launch_tile<P, G, 512>(p, g, m, v, sched, n, b1, omb1, b2, omb2, eps, wd, blocks_per_sm, stream);
    case 1024: return launch_tile<P, G, 1024>(p, g, m, v, sched, n, b1, omb1, b2, omb2, eps, wd, blocks_per_sm, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// p, g: n elements of float32 (code 0) or bfloat16 (code 1); m, v: n
// float32; sched: 3 float32 on the device.  All contiguous, n >= 1.  The
// tile: threads a block (128, 256, 512 or 1024) x blocks an SM (1-64).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what it does not
// take.
extern "C" int adam_launch(void* p, const void* g, void* m, void* v, const void* sched,
                           long long n, int p_code, int g_code, float b1, float omb1, float b2,
                           float omb2, float eps, float wd, int threads, int blocks_per_sm,
                           void* stream) {
  if (n < 1 || p_code < 0 || p_code > 1 || g_code < 0 || g_code > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_code == 0 && g_code == 0) return launch<float, float>(p, g, m, v, sched, n, b1, omb1, b2, omb2, eps, wd, threads, blocks_per_sm, s);
  if (p_code == 0) return launch<float, __nv_bfloat16>(p, g, m, v, sched, n, b1, omb1, b2, omb2, eps, wd, threads, blocks_per_sm, s);
  if (g_code == 0) return launch<__nv_bfloat16, float>(p, g, m, v, sched, n, b1, omb1, b2, omb2, eps, wd, threads, blocks_per_sm, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, sched, n, b1, omb1, b2, omb2, eps, wd, threads, blocks_per_sm, s);
}
