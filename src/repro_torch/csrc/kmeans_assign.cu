// One Lloyd iteration of K-means through the E2AFS sqrt, fused: for every
// pixel the squared distance to all K centroids, the E2AFS sqrt of
// max(d2, 1e-9), the first-index argmin; then per-centroid colour sums and
// member counts.  A leading batch dimension runs B images in one launch.
//
// Replaces the TPU kernel src/repro/kernels/kmeans/kmeans.py (_kernel,
// reached through kmeans_assign_kernel_call).
//
// Bound on the H100: operations on the INT32 lanes.  A pixel moves 16 bytes
// (12 read, 4 written) but costs 10 float and 16 integer operations per
// centroid, most of them the E2AFS datapath, so at K = 20 the operations
// take four times longer than the bytes.  Design: the distance loop spends
// nothing beyond the datapath.  The sqrt is e2afs::sqrt_normal_f32 (the
// clamp leaves a positive normal input, so no zero or subnormal test); the
// argmin is a compare and two selects, with no branch; each thread holds 8
// pixels and scores them against 4 centroids a pass (32 independent
// chains), the centroids read from shared memory as warp-wide broadcasts of
// one float4 each.  K is padded to a multiple of 4 with copies of the last
// centroid, which tie with it and so never win under the strict <.
//
// Arithmetic: d2 = d0*d0 + d1*d1 + d2*d2, left to right, each step rounded
// on its own (__fsub_rn, __fmul_rn, __fadd_rn), as the plain version
// (kernels/kmeans/ref.py) computes it, so distances and assignments are
// bit-identical to it on finite inputs; strict < over ascending k keeps the
// first index on ties, as argmin does.
//
// Deterministic sums, no float atomics.  Each block sums its pixels per
// centroid in a fixed order (a thread's 8 pixels in turn; a transposed
// butterfly of warp shuffles that leaves the warp's four sums in four
// quarters of the warp, skipped by a warp that holds no pixel of the
// centroid; then its 8 warps in turn) and writes a partial (B, grid, K, 4);
// a second kernel adds the partials of each (image, centroid, channel) in a
// fixed strided order and a fixed tree.  Two runs on the same inputs give
// the same bits; against the plain version only the order of float32
// additions differs.  Counts are float32 and exact below 2^24 pixels.
#include "e2afs.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, PPT = 8;  // PPT: pixels per thread
constexpr int CPP = 4;                                        // centroids a pass
constexpr int TILE = THREADS * PPT;
constexpr int MAX_K = 256;  // K x 16 bytes of centroids + WARPS x K x 16 of partials: 36 KB
constexpr int REDUCE_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

// (s0, s1, s2, s3) summed over the warp in a fixed order: lanes 8q..8q+7
// return the sum of s_q.  Lanes 16-31 keep (s2, s3) and send (s0, s1), lanes
// 0-15 the other way round; then each half of 16 keeps one of its two; then
// a butterfly over 8 lanes.  Six shuffles where four separate butterflies
// take twenty.
__device__ __forceinline__ float warp_sum4(float s0, float s1, float s2, float s3, int lane) {
  const bool hi16 = (lane & 16) != 0, hi8 = (lane & 8) != 0;
  const float u0 = (hi16 ? s2 : s0) + __shfl_xor_sync(FULL, hi16 ? s0 : s2, 16);
  const float u1 = (hi16 ? s3 : s1) + __shfl_xor_sync(FULL, hi16 ? s1 : s3, 16);
  float v = (hi8 ? u1 : u0) + __shfl_xor_sync(FULL, hi8 ? u0 : u1, 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS, 2)
assign_kernel(const float* __restrict__ px, const float* __restrict__ cent,
              int* __restrict__ assign, float* __restrict__ partial, long long n, int k) {
  extern __shared__ float4 smem[];
  const int k_pad = (k + CPP - 1) / CPP * CPP;
  float4* c_s = smem;                                        // (k_pad,) as (c0, c1, c2, 0)
  float* warp_part = reinterpret_cast<float*>(smem + k_pad);  // (WARPS, k, 4)
  const int b = blockIdx.y;
  const float* pxb = px + static_cast<long long>(b) * n * 3;
  const float* cb = cent + static_cast<long long>(b) * k * 3;
  for (int i = threadIdx.x; i < k_pad; i += THREADS) {
    const int c = i < k ? i : k - 1;
    c_s[i] = make_float4(cb[3 * c], cb[3 * c + 1], cb[3 * c + 2], 0.0f);
  }
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  float x0[PPT], x1[PPT], x2[PPT], best[PPT];
  int a[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const long long i = base + static_cast<long long>(p) * THREADS;
    const bool valid = i < n;
    x0[p] = valid ? pxb[3 * i] : 0.0f;
    x1[p] = valid ? pxb[3 * i + 1] : 0.0f;
    x2[p] = valid ? pxb[3 * i + 2] : 0.0f;
    // E2AFS distances are finite, so a valid pixel takes k = 0 first and the
    // padded tail (best -inf, a -1) never takes one and stays out of the sums
    best[p] = valid ? INFINITY : -INFINITY;
    a[p] = valid ? 0 : -1;
  }
  for (int k0 = 0; k0 < k_pad; k0 += CPP) {
    float4 c[CPP];
#pragma unroll
    for (int j = 0; j < CPP; ++j) c[j] = c_s[k0 + j];
#pragma unroll
    for (int j = 0; j < CPP; ++j) {
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const float d0 = __fsub_rn(x0[p], c[j].x), d1 = __fsub_rn(x1[p], c[j].y),
                    d2 = __fsub_rn(x2[p], c[j].z);
        const float s = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                  __fmul_rn(d2, d2));
        const float dist = e2afs::sqrt_normal_f32(fmaxf(s, 1e-9f));  // max(d2, 1e-9)
        const bool closer = dist < best[p];
        best[p] = closer ? dist : best[p];
        a[p] = closer ? k0 + j : a[p];
      }
    }
  }
  int* ab = assign + static_cast<long long>(b) * n;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    if (a[p] >= 0) ab[base + static_cast<long long>(p) * THREADS] = a[p];
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int kk = 0; kk < k; ++kk) {
    bool hit = false;
#pragma unroll
    for (int p = 0; p < PPT; ++p) hit |= a[p] == kk;
    float v = 0.0f;
    if (__any_sync(FULL, hit)) {  // else the warp holds no pixel of kk: its sums are 0
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, cnt = 0.0f;
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        if (a[p] == kk) {
          s0 += x0[p];
          s1 += x1[p];
          s2 += x2[p];
          cnt += 1.0f;
        }
      }
      v = warp_sum4(s0, s1, s2, cnt, lane);
    }
    if ((lane & 7) == 0) warp_part[(warp * k + kk) * 4 + (lane >> 3)] = v;
  }
  __syncthreads();
  float* out = partial + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * k * 4;
  for (int q = threadIdx.x; q < 4 * k; q += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += warp_part[w * 4 * k + q];
    out[q] = s;
  }
}

// One block per (centroid, channel) of one image: partial[b, :, kk, c]
// summed in a fixed strided order, then a fixed tree.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_kernel(const float* __restrict__ partial, float* __restrict__ sums,
              float* __restrict__ counts, int k, int grid) {
  __shared__ float ws[REDUCE_THREADS / 32];
  const int q = blockIdx.x, b = blockIdx.y;
  const float* p = partial + static_cast<long long>(b) * grid * k * 4 + q;
  float s = 0.0f;
  for (int g = threadIdx.x; g < grid; g += REDUCE_THREADS) s += p[static_cast<long long>(g) * k * 4];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < REDUCE_THREADS / 32; ++w) t += ws[w];
    const int kk = q / 4, c = q % 4;
    if (c < 3) {
      sums[(static_cast<long long>(b) * k + kk) * 3 + c] = t;
    } else {
      counts[static_cast<long long>(b) * k + kk] = t;
    }
  }
}

}  // namespace

// The tile (pixels per block) and the largest K, read once by the wrapper,
// which sizes the partials from the tile.
extern "C" int kmeans_assign_tile() { return TILE; }
extern "C" int kmeans_assign_max_k() { return MAX_K; }

// px: (b, n, 3) float32; cent: (b, k, 3) float32; assign: (b, n) int32;
// partial: (b, ceil(n / TILE), k, 4) float32 scratch; sums: (b, k, 3)
// float32; counts: (b, k) float32.  All contiguous.  Returns
// cudaGetLastError() after the second launch (the first one's error first).
extern "C" int kmeans_assign_launch(const void* px, const void* cent, void* assign,
                                    void* partial, void* sums, void* counts, long long n,
                                    int k, int b, void* stream) {
  const long long grid = (n + TILE - 1) / TILE;
  if (n <= 0 || k <= 0 || k > MAX_K || b <= 0 || b > 65535 || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_pad = (k + CPP - 1) / CPP * CPP;
  const size_t smem = static_cast<size_t>(k_pad + WARPS * k) * sizeof(float4);
  assign_kernel<<<dim3(static_cast<unsigned>(grid), b), THREADS, smem, s>>>(
      static_cast<const float*>(px), static_cast<const float*>(cent), static_cast<int*>(assign),
      static_cast<float*>(partial), n, k);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  reduce_kernel<<<dim3(4 * k, b), REDUCE_THREADS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(sums), static_cast<float*>(counts),
      k, static_cast<int>(grid));
  return static_cast<int>(cudaGetLastError());
}
