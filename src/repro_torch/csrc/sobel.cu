// Sobel gradient magnitude through the E2AFS sqrt, fused: (H, W) float32 ->
// (H-2, W-2) float32.
//
// Replaces the TPU kernel src/repro/kernels/sobel/sobel.py (_kernel, reached
// through sobel_kernel_call).
//
// Bound on the H100: bytes.  Each input pixel is read once and each output
// written once (8 bytes a pixel) against about 40 float and 20 integer
// operations, below the card's ratio of operations to bytes.  Design: one
// thread per output pixel; a 32 x 16 block stages its (16+2) x (32+2) halo
// window in shared memory, so a pixel comes from device memory once and from
// L2 for the neighbouring windows' halos.  Bounds checks replace the
// reference's edge padding, which only feeds output lanes that are cropped.
//
// Arithmetic: the 9-tap multiply-accumulate of the plain version
// (kernels/sobel/ref.py, the reference's ref_sobel) in (di, dj) order, zero
// taps included, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn) so that nvcc cannot contract them into FMAs.  That is
// bit-identical to the plain version.  The Pallas kernel's grouped shift-add
// form is not: on non-integer images it rounds in another order.
#include "e2afs.cuh"

namespace {

constexpr int BW = 32, BH = 16;

__global__ void __launch_bounds__(BW * BH)
sobel_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w) {
  __shared__ float win[BH + 2][BW + 2];
  const int i0 = blockIdx.y * BH, j0 = blockIdx.x * BW;
  for (int idx = threadIdx.y * BW + threadIdx.x; idx < (BH + 2) * (BW + 2); idx += BW * BH) {
    const int r = idx / (BW + 2), c = idx % (BW + 2);
    const int gi = i0 + r, gj = j0 + c;
    win[r][c] = (gi < h && gj < w) ? img[static_cast<long long>(gi) * w + gj] : 0.0f;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= h - 2 || j >= w - 2) return;
  const float kx[3][3] = {{-1.0f, 0.0f, 1.0f}, {-2.0f, 0.0f, 2.0f}, {-1.0f, 0.0f, 1.0f}};
  const float ky[3][3] = {{-1.0f, -2.0f, -1.0f}, {0.0f, 0.0f, 0.0f}, {1.0f, 2.0f, 1.0f}};
  float gx = 0.0f, gy = 0.0f;
#pragma unroll
  for (int di = 0; di < 3; ++di) {
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const float p = win[threadIdx.y + di][threadIdx.x + dj];
      gx = __fadd_rn(gx, __fmul_rn(kx[di][dj], p));
      gy = __fadd_rn(gy, __fmul_rn(ky[di][dj], p));
    }
  }
  float mag2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
  mag2 = mag2 < 1e-12f ? 1e-12f : mag2;  // max(mag2, 1e-12); NaN stays NaN
  out[static_cast<long long>(i) * (w - 2) + j] = e2afs::sqrt_positive_f32(mag2);
}

}  // namespace

// img: (h, w) float32, h, w >= 3, contiguous; out: (h-2, w-2) float32.
// Returns cudaGetLastError().
extern "C" int sobel_launch(const void* img, void* out, int h, int w, void* stream) {
  if (h < 3 || w < 3) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(BW, BH);
  const dim3 grid((w - 2 + BW - 1) / BW, (h - 2 + BH - 1) / BH);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  sobel_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
