// One-query decode attention per slot: GQA, float32 scores, int8 scales
// folded in, per-row validity from pos, float32 softmax, V-accumulate.
//
// Replaces the TPU kernel src/repro/kernels/attention/attention.py (_kernel
// and _kernel_quant, body _attend, reached through
// decode_attention_kernel_call).  The fold points are those of _attend and
// of layers/attention.py::_fold_masked_attention:
//   s   = T(sum_k q*k)                (float32 sum, rounded to the activation
//                                      dtype T, as the einsum returns T)
//   s   = float(s) * scale [* k_scale] + (valid ? 0 : -2e38)
//   w   = exp(s - max) / sum           (float32, two passes)
//   w   = T(w) [then T(w * T(v_scale))]
//   out = T(sum_t w * v)               (float32 accumulate)
// valid = t <= pos, or every line once wrap and pos >= cache length.
//
// Bound on the H100: bytes.  The K and V cache lines dominate (b*t*kv*hd
// elements each), against 4*g*hd operations per line.  Design: one block of
// 512 threads per (slot, KV head) serves its g = h/kv query heads, so each K
// and V line is read from device memory once.  A group of hd/VEC lanes
// covers one cache line with one vector load per lane (16 bytes of bf16 or
// float32, 8 of int8), so a warp reads 32/(hd/VEC) lines at a time and each
// warp keeps two such loads in flight.  Phase 1 reduces the g dot products
// of a line with shuffles inside its lane group.  The scores go to a
// float32 scratch row per query head, allocated by the wrapper, because the
// weights must be rounded to T after the full softmax: an online softmax
// would not reproduce that rounding.  Phase 2 is the two-pass softmax with
// all g rows reduced together.  Phase 3 streams V once with the same lane
// layout, accumulates per-lane float32 partials in registers, and sums them
// across lane groups and warps in a fixed order (deterministic, no
// atomics).  int8 caches are read as stored and converted in registers.
// At b = 8 and kv = 8 only 64 blocks run on 132 SMs; splitting the cache
// length over more blocks is the next step.
#include "e2afs.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;  // cache lines in flight per lane group
constexpr float kNegInf = -2.0e38f;  // the reference's additive mask
constexpr unsigned int kMinusInfBits = 0xff800000u;

// elements per vector load: 4 float32 (16 bytes), 8 bf16 (16) or 8 int8 (8)
template <class KV> __host__ __device__ constexpr int vec_of() { return sizeof(KV) == 4 ? 4 : 8; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load_vec(const float* p, float (&out)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned int words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of a float32
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void load_vec(const signed char* p, float (&out)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned int word = i < 4 ? u.x : u.y;
    out[i] = static_cast<float>(static_cast<signed char>((word >> (8 * (i & 3))) & 0xFFu));
  }
}

// Reduce G values over the block (max or sum); every thread gets the result.
// `red` holds G * kWarps floats.  Warps' partials combine in a fixed order.
template <int G, bool MAX>
__device__ __forceinline__ void block_reduce(float (&v)[G], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[j], off);
      v[j] = MAX ? fmaxf(v[j], o) : v[j] + o;
    }
    if (lane == 0) red[j * kWarps + warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float r = MAX ? __uint_as_float(kMinusInfBits) : 0.f;
    for (int w = 0; w < kWarps; ++w) r = MAX ? fmaxf(r, red[j * kWarps + w]) : r + red[j * kWarps + w];
    v[j] = r;
  }
  __syncthreads();
}

template <class T, class KV, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const int* __restrict__ pos,
                        const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                        float* __restrict__ scratch, T* __restrict__ out, int t_len, int kvh,
                        int hd, float scale, int wrap) {
  constexpr int VEC = vec_of<KV>();
  extern __shared__ float smem[];
  float* q_s = smem;                      // G * hd query values, as float
  float* part = q_s + G * hd;             // kWarps * G * hd output partials
  float* red = part + kWarps * G * hd;    // G * kWarps reduction slots
  const int h = kvh * G;
  const int bi = blockIdx.x / kvh;
  const int kh = blockIdx.x % kvh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lpl = hd / VEC;   // lanes per cache line: a power of two <= 32
  const int lpw = 32 / lpl;   // lines per warp
  const int sub = lane / lpl, sl = lane % lpl;
  const int d0 = sl * VEC;    // this lane's first head_dim element
  const int stride = kWarps * lpw;  // lines per block step
  const long long head0 = static_cast<long long>(bi) * h + static_cast<long long>(kh) * G;
  const long long line0 = static_cast<long long>(bi) * t_len * kvh + kh;  // line(tt) = line0 + tt*kvh

  for (int i = threadIdx.x; i < G * hd; i += kThreads) q_s[i] = to_f(q[head0 * hd + i]);
  __syncthreads();
  float qr[G][VEC];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[j][e] = q_s[j * hd + d0 + e];
  }
  const int p = pos[bi];
  const bool all_valid = wrap != 0 && p >= t_len;
  float* sc = scratch + head0 * t_len;  // row j at sc + j * t_len

  // Phase 1: scores.  t0 is uniform across the warp, so every lane takes
  // part in the shuffles; lanes past the end compute zeros and store none.
  for (int t0 = warp * lpw; t0 < t_len; t0 += stride * kUnroll) {
    float kx[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t0 + u * stride + sub;
      if (tt < t_len) {
        load_vec(k + (line0 + static_cast<long long>(tt) * kvh) * hd + d0, kx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kx[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t0 + u * stride + sub;
      float s[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc = fmaf(qr[j][e], kx[u][e], acc);
        s[j] = acc;
      }
      for (int off = lpl >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < G; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      }
      if (sl == 0 && tt < t_len) {
        const long long line = line0 + static_cast<long long>(tt) * kvh;
        const float ks = k_scale != nullptr ? k_scale[line] : 1.f;
        const float mask = (all_valid || tt <= p) ? 0.f : kNegInf;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          float val = __fmul_rn(round_to<T>(s[j]), scale);
          if (k_scale != nullptr) val = __fmul_rn(val, ks);
          sc[j * t_len + tt] = __fadd_rn(val, mask);
        }
      }
    }
  }
  __syncthreads();

  // Phase 2: float32 softmax of the G rows together, weights rounded to T.
  float m[G], sum[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = __uint_as_float(kMinusInfBits);
    sum[j] = 0.f;
  }
  for (int tt = threadIdx.x; tt < t_len; tt += kThreads) {
#pragma unroll
    for (int j = 0; j < G; ++j) m[j] = fmaxf(m[j], sc[j * t_len + tt]);
  }
  block_reduce<G, true>(m, red);
  for (int tt = threadIdx.x; tt < t_len; tt += kThreads) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float e = expf(__fsub_rn(sc[j * t_len + tt], m[j]));
      sc[j * t_len + tt] = e;
      sum[j] += e;
    }
  }
  block_reduce<G, false>(sum, red);
  for (int tt = threadIdx.x; tt < t_len; tt += kThreads) {
    const float vs = v_scale != nullptr
                         ? round_to<T>(v_scale[line0 + static_cast<long long>(tt) * kvh])
                         : 1.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float w = round_to<T>(__fdiv_rn(sc[j * t_len + tt], sum[j]));
      if (v_scale != nullptr) w = round_to<T>(__fmul_rn(w, vs));
      sc[j * t_len + tt] = w;
    }
  }
  __syncthreads();

  // Phase 3: out[j, d] = sum_t w[j, t] * v[t, d] with the phase-1 lane layout.
  float acc[G][VEC];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  }
  for (int t0 = warp * lpw; t0 < t_len; t0 += stride * kUnroll) {
    float vx[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t0 + u * stride + sub;
      if (tt < t_len) load_vec(v + (line0 + static_cast<long long>(tt) * kvh) * hd + d0, vx[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t0 + u * stride + sub;
      if (tt < t_len) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float w = sc[j * t_len + tt];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(w, vx[u][e], acc[j][e]);
        }
      }
    }
  }
  // combine the warp's lane groups (same sl), then the warps in order
  for (int off = lpl; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], off);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[(warp * G + j) * hd + d0 + e] = acc[j][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[w * G * hd + i];
    out[head0 * hd + i] = from_f<T>(s);
  }
}

template <class T, class KV, int G>
int launch_group(const void* q, const void* k, const void* v, const int* pos,
                 const float* k_scale, const float* v_scale, float* scratch, void* out, int b,
                 int t_len, int kvh, int hd, float scale, int wrap, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(G) * hd * (1 + kWarps) + G * kWarps) * sizeof(float);
  auto kernel = decode_attention_kernel<T, KV, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<b * kvh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), pos,
      k_scale, v_scale, scratch, static_cast<T*>(out), t_len, kvh, hd, scale, wrap);
  return static_cast<int>(cudaGetLastError());
}

template <class T, class KV>
int launch(const void* q, const void* k, const void* v, const int* pos, const float* k_scale,
           const float* v_scale, float* scratch, void* out, int b, int t_len, int h, int kvh,
           int hd, float scale, int wrap, cudaStream_t stream) {
  constexpr int VEC = vec_of<KV>();
  const int lpl = hd / VEC;
  if (hd % VEC != 0 || lpl < 1 || lpl > 32 || (lpl & (lpl - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (h / kvh) {
    case 1: return launch_group<T, KV, 1>(q, k, v, pos, k_scale, v_scale, scratch, out, b, t_len, kvh, hd, scale, wrap, stream);
    case 2: return launch_group<T, KV, 2>(q, k, v, pos, k_scale, v_scale, scratch, out, b, t_len, kvh, hd, scale, wrap, stream);
    case 4: return launch_group<T, KV, 4>(q, k, v, pos, k_scale, v_scale, scratch, out, b, t_len, kvh, hd, scale, wrap, stream);
    case 8: return launch_group<T, KV, 8>(q, k, v, pos, k_scale, v_scale, scratch, out, b, t_len, kvh, hd, scale, wrap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// act_dtype: 1 = bfloat16, 2 = float32; kv_int8: the cache holds int8 values
// (then k_scale and v_scale are given).  h / kv must be 1, 2, 4 or 8, and
// hd / VEC a power of two <= 32 (VEC = 4 for a float32 cache, else 8); the
// K/V base pointers must be 16-byte aligned.  Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, const void* k_scale,
                                       const void* v_scale, void* scratch, void* out, int b,
                                       int t_len, int h, int kvh, int hd, float scale, int wrap,
                                       int act_dtype, int kv_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvh <= 0 || h % kvh != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  const int* p = static_cast<const int*>(pos);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* sc = static_cast<float*>(scratch);
  if (act_dtype == 1 && !kv_int8)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, p, ks, vs, sc, out, b, t_len, h, kvh, hd, scale, wrap, s);
  if (act_dtype == 1 && kv_int8)
    return launch<__nv_bfloat16, signed char>(q, k, v, p, ks, vs, sc, out, b, t_len, h, kvh, hd, scale, wrap, s);
  if (act_dtype == 2 && !kv_int8)
    return launch<float, float>(q, k, v, p, ks, vs, sc, out, b, t_len, h, kvh, hd, scale, wrap, s);
  if (act_dtype == 2 && kv_int8)
    return launch<float, signed char>(q, k, v, p, ks, vs, sc, out, b, t_len, h, kvh, hd, scale, wrap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
