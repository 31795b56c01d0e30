// Sobel gradient magnitude through the E2AFS sqrt, fused: (H, W) float32 ->
// (H-2, W-2) float32.
//
// Replaces the TPU kernel src/repro/kernels/sobel/sobel.py (_kernel, reached
// through sobel_kernel_call).
//
// Bound on the H100: bytes.  Each input pixel is read once and each output
// written once (8 bytes a pixel) against 40 float and 14 integer operations,
// below the card's ratio of operations to bytes.  Design: no shared memory
// and no barrier.  A thread takes a run of 4 outputs along a row and ROWS
// down its strip (the tile, ROWS x threads a block, is a launch argument:
// kernels/sobel/ops.py's TilingSpec; today's launch and the default 4 x
// 128; every tile gives the same bits, each output's arithmetic being the
// same); for the default tile: it loads the 6 x 6 input pixels under them into registers
// first, all loads in flight at once (a 16-byte and an 8-byte load where
// the row's address allows, which is every row of an image whose width is
// a multiple of 4; 4-byte loads otherwise), then computes and stores the 16
// outputs (16- or 8-byte stores where the address allows: the output rows
// of such an image, W - 2 wide, alternate between the two).  Neighbouring
// threads and strips share the 2-pixel halo through L1 and L2, so device
// memory sees each pixel about once.  The ragged right edge takes the
// 4-byte path, its columns past the image clamped to the last, and the
// bottom strip its rows likewise: clamped pixels feed only outputs that are
// not stored.
//
// Arithmetic: the 9-tap multiply-accumulate of the plain version
// (kernels/sobel/ref.py, the reference's ref_sobel) in (di, dj) order, zero
// taps included, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn) so that nvcc cannot contract them into FMAs; then the E2AFS
// sqrt of max(mag2, 1e-12) with the unit's specials.  That is bit-identical
// to the plain version on every image, NaN and infinities included.  The
// Pallas kernel's grouped shift-add form is not: on non-integer images it
// rounds in another order.
#include <cstdint>

#include "e2afs.cuh"

namespace {

constexpr int COLS = 4;       // outputs a thread takes along a row
constexpr int MAX_GRID_Y = 65535;
static_assert(COLS == 4, "load_run reads 4 + 2 columns as a float4 and a float2");

__device__ __forceinline__ unsigned low_bits(const float* p) {
  return static_cast<unsigned>(reinterpret_cast<uintptr_t>(p));
}

// Input columns j .. j + COLS + 1 of one row; `full` when they all lie in
// the row.
__device__ __forceinline__ void load_run(const float* __restrict__ row, int j, int w, bool full,
                                         float (&v)[COLS + 2]) {
  const float* p = row + j;
  if (full && (low_bits(p) & 15) == 0) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float2 hi = __ldg(reinterpret_cast<const float2*>(p + 4));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = lo.z;
    v[3] = lo.w;
    v[4] = hi.x;
    v[5] = hi.y;
  } else {
#pragma unroll
    for (int q = 0; q < COLS + 2; ++q) v[q] = __ldg(row + min(j + q, w - 1));
  }
}

// Outputs o[0 .. left) of one row at p (left < COLS only at the right edge).
__device__ __forceinline__ void store_run(float* __restrict__ p, int left, const float (&o)[COLS]) {
  if (left >= COLS && (low_bits(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else if (left >= COLS && (low_bits(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
    *reinterpret_cast<float2*>(p + 2) = make_float2(o[2], o[3]);
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      if (c < left) p[c] = o[c];
    }
  }
}

// The unit's sqrt of max(mag2, 1e-12) for a sum of squares (+0 or more,
// +inf or NaN), with the plain version's specials: +inf gives +inf, NaN
// its NaN.
__device__ __forceinline__ float magnitude(float mag2) {
  if (mag2 < INFINITY) return e2afs::sqrt_normal_f32(fmaxf(mag2, 1e-12f));
  return __uint_as_float(mag2 == INFINITY ? e2afs::Fp32::INF_BITS : e2afs::Fp32::NAN_BITS);
}

// THREADS threads of a block side by side along a row; ROWS outputs down a
// thread's strip
template <int ROWS, int THREADS>
__global__ void __launch_bounds__(THREADS)
sobel_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w) {
  const int j = (blockIdx.x * THREADS + threadIdx.x) * COLS;
  if (j >= w - 2) return;
  const bool full = j + COLS <= w - 2;
  const int i0 = blockIdx.y * ROWS;
  float v[ROWS + 2][COLS + 2];
#pragma unroll
  for (int r = 0; r < ROWS + 2; ++r) {
    load_run(img + static_cast<long long>(min(i0 + r, h - 1)) * w, j, w, full, v[r]);
  }
  const float kx[3][3] = {{-1.0f, 0.0f, 1.0f}, {-2.0f, 0.0f, 2.0f}, {-1.0f, 0.0f, 1.0f}};
  const float ky[3][3] = {{-1.0f, -2.0f, -1.0f}, {0.0f, 0.0f, 0.0f}, {1.0f, 2.0f, 1.0f}};
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    if (i0 + q >= h - 2) break;
    float o[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float gx = 0.0f, gy = 0.0f;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const float p = v[q + di][c + dj];
          gx = __fadd_rn(gx, __fmul_rn(kx[di][dj], p));
          gy = __fadd_rn(gy, __fmul_rn(ky[di][dj], p));
        }
      }
      const float mag2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
      o[c] = magnitude(mag2);
    }
    store_run(out + static_cast<long long>(i0 + q) * (w - 2) + j, w - 2 - j, o);
  }
}

template <int ROWS, int THREADS>
int launch_tile(const float* img, float* out, int h, int w, cudaStream_t stream) {
  if (h - 2 > static_cast<long long>(MAX_GRID_Y) * ROWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_row = (w - 2 + COLS - 1) / COLS;  // threads along a row
  const dim3 grid((per_row + THREADS - 1) / THREADS, (h - 2 + ROWS - 1) / ROWS);
  sobel_kernel<ROWS, THREADS><<<grid, THREADS, 0, stream>>>(img, out, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most strips the grid takes (its y extent): an image of h rows needs
// h - 2 <= sobel_max_strips() x the tile's rows.  Read once by the wrapper.
extern "C" int sobel_max_strips() { return MAX_GRID_Y; }

// img: (h, w) float32, h, w >= 3, h * w < 2^31, contiguous; out: (h-2, w-2)
// float32; the tile: rows down a strip x threads a block, one of the
// instantiated pairs (kernels/sobel/ops.py's candidates).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int sobel_launch(const void* img, void* out, int h, int w, int rows, int threads,
                            void* stream) {
  if (h < 3 || w < 3) return static_cast<int>(cudaErrorInvalidValue);
  const float* in = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows * 10000 + threads) {
    case 2 * 10000 + 512: return launch_tile<2, 512>(in, o, h, w, s);
    case 4 * 10000 + 128: return launch_tile<4, 128>(in, o, h, w, s);
    case 4 * 10000 + 256: return launch_tile<4, 256>(in, o, h, w, s);
    case 8 * 10000 + 64: return launch_tile<8, 64>(in, o, h, w, s);
    case 8 * 10000 + 128: return launch_tile<8, 128>(in, o, h, w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
