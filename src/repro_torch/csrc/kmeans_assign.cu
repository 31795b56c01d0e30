// One Lloyd iteration of K-means through the E2AFS sqrt, fused: for every
// pixel the squared distance to all K centroids, the E2AFS sqrt of
// max(d2, 1e-9), the first-index argmin; then per-centroid colour sums and
// member counts.  A leading batch dimension runs B images in one launch.
//
// Replaces the TPU kernel src/repro/kernels/kmeans/kmeans.py (_kernel,
// reached through kmeans_assign_kernel_call).
//
// Bound on the H100: operations.  A pixel moves 16 bytes (12 read, 4 written)
// but costs about 10 float and 25 integer operations per centroid, most of
// them the E2AFS datapath on the INT32 pipe, so at K = 20 the operations
// take several times longer than the bytes.  Design: the K x 3 centroids sit
// in shared memory and every thread reads them as a broadcast; each thread
// scores 8 pixels against one centroid at a time (8 independent chains in
// flight) and keeps their running minimum in registers.
//
// Arithmetic: d2 = d0*d0 + d1*d1 + d2*d2, left to right, each step rounded
// on its own (__fsub_rn, __fmul_rn, __fadd_rn), as the plain version
// (kernels/kmeans/ref.py) computes it, so distances and assignments are
// bit-identical to it; strict < over ascending k keeps the first index on
// ties, as argmin does.
//
// Deterministic sums, no float atomics.  Each block sums its pixels per
// centroid in a fixed order (a thread's 8 pixels in turn, a butterfly of
// warp shuffles, then its 8 warps in turn) and writes a partial
// (B, grid, K, 4); a second kernel adds the partials of each (image,
// centroid, channel) in a fixed strided order and a fixed tree.  Two runs on
// the same inputs give the same bits; against the plain version only the
// order of float32 additions differs.  Counts are float32 and exact below
// 2^24 pixels.
#include "e2afs.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, PPT = 8;  // PPT: pixels per thread
constexpr int TILE = THREADS * PPT;
constexpr int MAX_K = 256;  // WARPS x K x 4 partials + K x 3 centroids in 48 KB of shared memory
constexpr int REDUCE_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
assign_kernel(const float* __restrict__ px, const float* __restrict__ cent,
              int* __restrict__ assign, float* __restrict__ partial, long long n, int k) {
  extern __shared__ float smem[];
  float* c_s = smem;                 // (k, 3)
  float* warp_part = smem + 3 * k;   // (WARPS, k, 4)
  const int b = blockIdx.y;
  const float* pxb = px + static_cast<long long>(b) * n * 3;
  const float* cb = cent + static_cast<long long>(b) * k * 3;
  for (int i = threadIdx.x; i < 3 * k; i += THREADS) c_s[i] = cb[i];
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
  for (int kk = 0; kk < k; ++kk) {
    const float c0 = c_s[3 * kk], c1 = c_s[3 * kk + 1], c2 = c_s[3 * kk + 2];
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const float d0 = __fsub_rn(x0[p], c0), d1 = __fsub_rn(x1[p], c1), d2 = __fsub_rn(x2[p], c2);
      float s = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
      s = s < 1e-9f ? 1e-9f : s;  // max(d2, 1e-9)
      const float dist = e2afs::sqrt_positive_f32(s);
      if (dist < best[p]) {
        best[p] = dist;
        a[p] = kk;
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {  // every lane ends with the same sum
      s0 += __shfl_xor_sync(FULL, s0, off);
      s1 += __shfl_xor_sync(FULL, s1, off);
      s2 += __shfl_xor_sync(FULL, s2, off);
      cnt += __shfl_xor_sync(FULL, cnt, off);
    }
    if (lane == 0) {
      float* wp = warp_part + (warp * k + kk) * 4;
      wp[0] = s0;
      wp[1] = s1;
      wp[2] = s2;
      wp[3] = cnt;
    }
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
  const size_t smem = static_cast<size_t>(3 * k + WARPS * k * 4) * sizeof(float);
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
