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
// Bound on the H100: bytes (each row read and written once, a few operations
// an element, far below the tensor cores' ~295 FLOP a byte).  At the decode
// shapes (8 rows of 2560, 256 rows of 128) the bytes are a few tens of KB,
// so the time is one round trip to memory plus the reduction: the design
// spreads the rows over as many SMs as it can and keeps every load 16 bytes
// wide.  A thread reads VEC elements at a time (8 bf16 or 4 float32 in 16
// bytes), keeps them in registers, so x is read from memory once, sums their
// squares in float32, and reads the matching 16 bytes of scale, whose
// T(1 + scale) it forms once for all its rows.  The layout is chosen from d
// in `launch_v`:
//  * d/VEC > 32 (the layer norms, d = 2560): one block a row, d/VEC
//    threads rounded up to a whole warp (320 for bf16 at 2560), at most
//    1024.  A warp shuffle sums a warp, and the warps' sums combine through
//    shared memory in warp order.  A row of more than 1024 vectors holds
//    kRegVecs a thread, and one wider than that reads the rest of x again.
//  * d/VEC <= 32 (the qk-norms, d = 128): a row a group of d/VEC lanes
//    rounded up to a power of two (16 lanes for bf16 at 128), several rows a
//    warp, 128 threads a block; the shuffle reduction stays inside the
//    group.  A group takes the tile's rows at once (a launch argument,
//    kernels/rmsnorm/ops.py's TilingSpec): 1, 2 or 4, or 0, the default,
//    for this source's own choice: four rows where one a group would still
//    give eight blocks an SM (prefill), else one.  In the one-row-a-block
//    layout the tile is one row.
// A d that is not a multiple of VEC, or a pointer that is not 16-byte
// aligned, runs the same kernel with one element a load (VEC = 1).  Each
// thread sums its own elements in order, then the fixed shuffle tree, then
// the warps in order: two calls on the same inputs are bit-identical.
#include <atomic>

#include "e2afs.cuh"

namespace {

constexpr int kRegVecs = 4;          // vectors of x a thread holds in registers
constexpr int kGroupThreads = 128;   // block size when several rows share a warp
constexpr int kMaxThreads = 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements as float: one 16-byte load, or one element
template <int V>
__device__ __forceinline__ void load(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    o[0] = f.x;
    o[1] = f.y;
    o[2] = f.z;
    o[3] = f.w;
  } else {
    o[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&o)[V]) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of a float32
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
    o[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&o)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    *p = o[0];
  }
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&o)[V]) {
  if constexpr (V == 8) {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned int lo = __bfloat16_as_ushort(__float2bfloat16_rn(o[2 * i]));
      const unsigned int hi = __bfloat16_as_ushort(__float2bfloat16_rn(o[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *p = __float2bfloat16_rn(o[0]);
  }
}

// T(1 + scale) of V elements, as float
template <class T, int V>
__device__ __forceinline__ void one_plus(const T* scale, float (&s1)[V]) {
  load<V>(scale, s1);
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = to_f(from_f<T>(__fadd_rn(1.f, s1[e])));
}

// y's V elements from x's (as float), T(1 + scale) and inv, in the
// reference's roundings; the values handed to store() are exact in T.
template <class T, int V>
__device__ __forceinline__ void normalise(const float (&xv)[V], const float (&s1)[V], float inv,
                                          T* y) {
  float out[V];
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = __fmul_rn(to_f(from_f<T>(__fmul_rn(xv[e], inv))), s1[e]);
  store<V>(y, out);
}

template <int V>
__device__ __forceinline__ float sum_squares(const float (&xv)[V], float acc) {
#pragma unroll
  for (int e = 0; e < V; ++e) acc = __fadd_rn(acc, __fmul_rn(xv[e], xv[e]));  // no fma
  return acc;
}

// A group of gs threads takes R consecutive rows: gs is a power of two <= 32
// (several groups a block) or the whole block (a multiple of 32).  A thread
// holds KV vectors of each of its rows in registers, and T(1 + scale) of its
// first vector, which its R rows share.
template <class T, int V, int R, int KV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ y,
               long long rows, int d, float eps, int gs) {
  __shared__ float red[R][kMaxThreads / 32];
  const int g = threadIdx.x / gs, gl = threadIdx.x - g * gs;
  const long long row0 = (static_cast<long long>(blockIdx.x) * (blockDim.x / gs) + g) * R;
  const int nv = d / V;  // vectors a row
  float s1[V];
  if (gl < nv) one_plus<T, V>(scale + gl * V, s1);
  float xv[R][KV][V];
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = 0.f;
    if (row0 + r >= rows) continue;  // no early return: the group reduces together
    const T* xr = x + (row0 + r) * d;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int i = gl + k * gs;
      if (i < nv) {
        load<V>(xr + i * V, xv[r][k]);
        acc[r] = sum_squares<V>(xv[r][k], acc[r]);
      }
    }
    for (int i = gl + KV * gs; i < nv; i += gs) {  // a row wider than the registers
      float t[V];
      load<V>(xr + i * V, t);
      acc[r] = sum_squares<V>(t, acc[r]);
    }
  }
  for (int off = (gs < 32 ? gs : 32) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(0xffffffffu, acc[r], off));
  }
  if (gs > 32) {  // one group a block: the warps' sums in warp order
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) red[r][threadIdx.x >> 5] = acc[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = 0.f;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) acc[r] = __fadd_rn(acc[r], red[r][w]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= rows) continue;
    const float ms = __fadd_rn(__fdiv_rn(acc[r], static_cast<float>(d)), eps);
    const float inv = e2afs::rsqrt_f32(ms);
    const T* xr = x + (row0 + r) * d;
    T* yr = y + (row0 + r) * d;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int i = gl + k * gs;
      if (i >= nv) continue;
      if (k == 0) {
        normalise<T, V>(xv[r][k], s1, inv, yr + i * V);
      } else {
        float sk[V];
        one_plus<T, V>(scale + i * V, sk);
        normalise<T, V>(xv[r][k], sk, inv, yr + i * V);
      }
    }
    for (int i = gl + KV * gs; i < nv; i += gs) {
      float t[V], sk[V];
      load<V>(xr + i * V, t);
      one_plus<T, V>(scale + i * V, sk);
      normalise<T, V>(t, sk, inv, yr + i * V);
    }
  }
}

template <class T, int V, int R, int KV>
int launch_rows(const T* x, const T* scale, T* y, long long rows, int d, float eps, int gs,
                int threads, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(threads / gs) * R;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_kernel<T, V, R, KV><<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
      x, scale, y, rows, d, eps, gs);
  return static_cast<int>(cudaGetLastError());
}

// SMs of the current device, asked once a device.
int sm_count(int& sms) {
  static std::atomic<int> cached[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && (sms = cached[dev].load(std::memory_order_relaxed)) > 0) return 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) cached[dev].store(sms, std::memory_order_relaxed);
  return 0;
}

// The layout from d (see the header).  A row of more vectors than the
// block has threads holds kRegVecs of them a thread in registers, else one.
// Where several rows share a warp, a group takes `group_rows` rows (one
// round trip to memory for them; one row a group measured faster for the
// layer-norm rows, which keep one); 0 takes four where one row a group
// would give at least eight blocks an SM, else one.
template <class T, int V>
int launch_v(const T* x, const T* scale, T* y, long long rows, int d, float eps, int group_rows,
             cudaStream_t stream) {
  const int nv = d / V;
  int gs = 1, threads;
  if (nv <= 32) {  // several rows a warp
    while (gs < nv) gs <<= 1;
    threads = kGroupThreads;
  } else {  // one row a block
    gs = threads = min(kMaxThreads, (nv + 31) / 32 * 32);
  }
  if (nv > threads) {
    return launch_rows<T, V, 1, kRegVecs>(x, scale, y, rows, d, eps, gs, threads, stream);
  }
  if (gs < threads && group_rows == 0) {
    int sms = 0;
    const int err = sm_count(sms);
    if (err != 0) return err;
    group_rows = rows >= 8LL * sms * (threads / gs) ? 4 : 1;
  }
  if (gs < threads && group_rows == 4) {
    return launch_rows<T, V, 4, 1>(x, scale, y, rows, d, eps, gs, threads, stream);
  }
  if (gs < threads && group_rows == 2) {
    return launch_rows<T, V, 2, 1>(x, scale, y, rows, d, eps, gs, threads, stream);
  }
  return launch_rows<T, V, 1, 1>(x, scale, y, rows, d, eps, gs, threads, stream);
}

template <class T>
int launch(const void* x, const void* scale, void* y, long long rows, int d, float eps,
           int group_rows, cudaStream_t stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  T* yt = static_cast<T*>(y);
  const bool aligned = ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(scale) |
                         reinterpret_cast<size_t>(y)) & 15) == 0;
  if (d % VEC == 0 && aligned) return launch_v<T, VEC>(xt, st, yt, rows, d, eps, group_rows, stream);
  return launch_v<T, 1>(xt, st, yt, rows, d, eps, group_rows, stream);
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float32; group_rows: the tile, 1, 2 or 4 rows a
// group where several rows share a warp, or 0 for this source's choice.
// Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, long long rows, int d,
                              float eps, int dtype, int group_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group_rows != 0 && group_rows != 1 && group_rows != 2 && group_rows != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0 || d <= 0) return 0;
  switch (dtype) {
    case 1: return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, group_rows, s);
    case 2: return launch<float>(x, scale, y, rows, d, eps, group_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
