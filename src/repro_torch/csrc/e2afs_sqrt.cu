// Elementwise E2AFS sqrt / E2AFS-R rsqrt with IEEE specials.
//
// Replaces the TPU kernel src/repro/kernels/e2afs_sqrt/e2afs_sqrt.py
// (_kernel, reached through e2afs_sqrt_kernel_call), registered there as
// e2afs_sqrt and e2afs_rsqrt.
//
// Bound on the H100: bytes.  Each element is read once and written once, 8
// bytes an element in float32 and 4 in fp16 and bf16.  To reach the HBM
// rate an SM needs about 16 KB of loads in flight (3.35 TB/s times the
// loaded latency, over 132 SMs); one 4-byte or 2-byte load a thread, as the
// first design made, keeps 8 KB or 4 KB there and reads at about half the
// rate.  Design:
//  * each thread moves 16 bytes a load and a store (4 float32 or 8 fp16/bf16
//    values) and issues kUnroll such loads before it computes on any of
//    them, its last batch too; consecutive threads take consecutive 16-byte
//    vectors;
//  * one grid of as many blocks as fit on the card at once walks the
//    vectors; offsets are 32-bit where the count allows;
//  * the wrapper gives y the same address mod 16 as x, so both are read and
//    written in 16-byte vectors from x's first 16-byte boundary; the few
//    elements before it and after the last whole vector take one element a
//    thread in the same launch;
//  * the datapath is e2afs.cuh's lean one: the words of sqrt_normal_bits and
//    rsqrt_normal_bits, with the IEEE specials (special_bits) only for a
//    vector that holds a value that is not a positive normal.  At 4 bytes a
//    value the integer lanes have half the time they have in float32, so
//    the 16-bit formats look the mantissa's share of the word up in a table
//    in shared memory (fill_terms below) instead of computing it.
// The tile, threads a block x loads in flight a thread, is a launch
// argument (kernels/e2afs_sqrt/ops.py's TilingSpec; today's launch and the
// default: 256 x 4).  kUnroll 2, 4 or 8 and 128 to 512 threads a block read
// within a few percent of each other on the H100 (PERF.md, section 6); every
// tile gives the same bits (each element's datapath is the same).
//
// Deliberate difference from the TPU kernel: a positive subnormal gives +inf
// under ftz, as the plain version (repro/core/e2afs.py::e2afs_rsqrt) does;
// the Pallas kernel returns 0 there.
#include <cstdint>
#include <cstring>

#include "e2afs.cuh"

namespace {

template <class F>
__host__ __device__ constexpr int values_per_vector() {
  return 16 / static_cast<int>(sizeof(typename F::Bits));
}

// Both E2AFS words split into an exponent word and a term that depends on
// the low MAN + 1 bits of the input alone (e2afs.cuh: sqrt_exponent_word,
// rsqrt_exponent_word, rsqrt_mantissa_term).  For the 16-bit formats the
// kernel looks the term up in a table of 2^(MAN + 1) values of 2 bytes (4 KB
// in fp16, 512 bytes in bf16) that each block fills in shared memory, in
// place of the dozen or so integer instructions that compute it: at 4 bytes
// a value the integer lanes have half the time they have in float32.
template <class F>
__host__ __device__ constexpr bool uses_terms() {
  return sizeof(typename F::Bits) == 2;
}

template <class F>
__host__ __device__ constexpr int term_count() {
  return uses_terms<F>() ? 2 << F::MAN : 1;
}

template <class F, bool RSQRT>
__device__ __forceinline__ unsigned normal_bits(unsigned w) {
  return RSQRT ? e2afs::rsqrt_normal_bits<F>(w) : e2afs::sqrt_normal_bits<F>(w);
}

template <class F, bool RSQRT>
__device__ __forceinline__ unsigned exponent_word(unsigned w) {
  return RSQRT ? e2afs::rsqrt_exponent_word<F>(w) : e2afs::sqrt_exponent_word<F>(w);
}

// Every thread of the block calls it.  Entry e is the term of every
// positive normal whose low MAN + 1 bits are e, taken at one of them.
template <class F, bool RSQRT>
__device__ __forceinline__ void fill_terms(short* terms) {
  if constexpr (uses_terms<F>()) {
    for (int e = threadIdx.x; e < term_count<F>(); e += blockDim.x) {
      const unsigned w = static_cast<unsigned>(e) + (2u << F::MAN);
      terms[e] = static_cast<short>(normal_bits<F, RSQRT>(w) - exponent_word<F, RSQRT>(w));
    }
    __syncthreads();
  }
}

// The datapath on one 16-byte vector: a float32 a 32-bit word, or two
// 16-bit values a word (low half first, as in memory).
template <class F, bool RSQRT>
__device__ __forceinline__ uint4 unit_vector(uint4 v, const short* terms) {
  constexpr int per_word = 4 / static_cast<int>(sizeof(typename F::Bits));
  constexpr int n = 4 * per_word;
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  unsigned w[n], out[n];
  bool special = false;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    w[k] = per_word == 1 ? words[k] : (k & 1 ? words[k / 2] >> 16 : words[k / 2] & 0xFFFFu);
    special |= !e2afs::positive_normal<F>(w[k]);
    if constexpr (uses_terms<F>()) {
      const int term = terms[w[k] & ((2u << F::MAN) - 1u)];
      out[k] = exponent_word<F, RSQRT>(w[k]) + static_cast<unsigned>(term);
    } else {
      out[k] = normal_bits<F, RSQRT>(w[k]);
    }
  }
  if (special) {
#pragma unroll
    for (int k = 0; k < n; ++k) {
      if (!e2afs::positive_normal<F>(w[k])) out[k] = e2afs::special_bits<F, RSQRT>(w[k]);
    }
  }
  unsigned packed[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    packed[q] = per_word == 1 ? out[q] : __byte_perm(out[2 * q], out[2 * q + 1], 0x5410);
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// A thread's batch: the vectors i, i + stride, ..., i + (U - 1) stride
// that lie below nvec, all loaded before any is computed on.
template <int U, class I>
__device__ __forceinline__ void load_batch(const uint4* __restrict__ xv, I i, I stride, I nvec,
                                           uint4 (&v)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (i + u * stride < nvec) v[u] = __ldcs(xv + i + u * stride);
  }
}

// x and y have the same address mod 16.  Elements [0, head) lie before x's
// first 16-byte boundary, then nvec whole vectors, then the rest up to n.
// A thread's first batch goes out before its block fills the table; the
// last batch of a thread may be partial, so every thread keeps loads in
// flight to the end.
template <class F, bool RSQRT, class I, int kThreads, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    unit_kernel(const typename F::Bits* __restrict__ x, typename F::Bits* __restrict__ y,
                long long n, I head, I nvec) {
  using B = typename F::Bits;
  __shared__ short terms[term_count<F>()];
  const I tid = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  uint4* __restrict__ yv = reinterpret_cast<uint4*>(y + head);
  uint4 v[kUnroll];
  load_batch(xv, tid, stride, nvec, v);
  fill_terms<F, RSQRT>(terms);
  for (I i = tid; i < nvec; i += kUnroll * stride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * stride < nvec) __stcs(yv + i + u * stride, unit_vector<F, RSQRT>(v[u], terms));
    }
    load_batch(xv, i + kUnroll * stride, stride, nvec, v);
  }
  const long long tail = static_cast<long long>(head) +
                         static_cast<long long>(nvec) * values_per_vector<F>();
  if (tid < head) y[tid] = static_cast<B>(e2afs::lean_unit_bits<F, RSQRT>(x[tid]));
  if (tid < static_cast<I>(values_per_vector<F>()) && tail + static_cast<long long>(tid) < n) {
    y[tail + tid] = static_cast<B>(e2afs::lean_unit_bits<F, RSQRT>(x[tail + tid]));
  }
}

template <class F, bool RSQRT, class I, int kThreads, int kUnroll>
int launch_unit(const void* x, void* y, long long n, cudaStream_t stream) {
  using B = typename F::Bits;
  constexpr int V = values_per_vector<F>();
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const long long to_boundary = static_cast<long long>((16 - addr % 16) % 16 / sizeof(B));
  const long long head = to_boundary < n ? to_boundary : n;
  const long long nvec = (n - head) / V;
  static int resident = 0;  // blocks an SM holds at once, asked once
  if (resident == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, unit_kernel<F, RSQRT, I, kThreads, kUnroll>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (nvec + kThreads - 1) / kThreads;
  const long long fit = static_cast<long long>(sms) * resident;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < fit ? want : fit));
  unit_kernel<F, RSQRT, I, kThreads, kUnroll><<<blocks, kThreads, 0, stream>>>(
      static_cast<const B*>(x), static_cast<B*>(y), n, static_cast<I>(head),
      static_cast<I>(nvec));
  return static_cast<int>(cudaGetLastError());
}

// The tiles the kernel is instantiated for (threads x unroll): the
// TilingSpec's candidates of kernels/e2afs_sqrt/ops.py.
template <class F, bool RSQRT>
int launch_tile(const void* x, void* y, long long n, int threads, int unroll,
                cudaStream_t stream) {
  // 32-bit offsets while vector indices, plus a pass of the grid, stay
  // below 2^31 (the grid is at most a few hundred thousand threads); past
  // that, the default tile on 64-bit offsets
  const long long nvec = n / values_per_vector<F>();
  if (nvec >= (1LL << 30)) {
    return launch_unit<F, RSQRT, unsigned long long, 256, 4>(x, y, n, stream);
  }
  const int tile = threads * 100 + unroll;
  switch (tile) {
    case 128 * 100 + 16: return launch_unit<F, RSQRT, unsigned, 128, 16>(x, y, n, stream);
    case 256 * 100 + 4: return launch_unit<F, RSQRT, unsigned, 256, 4>(x, y, n, stream);
    case 256 * 100 + 8: return launch_unit<F, RSQRT, unsigned, 256, 8>(x, y, n, stream);
    case 512 * 100 + 2: return launch_unit<F, RSQRT, unsigned, 512, 2>(x, y, n, stream);
    case 512 * 100 + 4: return launch_unit<F, RSQRT, unsigned, 512, 4>(x, y, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class F>
int launch_format(const void* x, void* y, long long n, int rsqrt, int threads, int unroll,
                  cudaStream_t stream) {
  return rsqrt ? launch_tile<F, true>(x, y, n, threads, unroll, stream)
               : launch_tile<F, false>(x, y, n, threads, unroll, stream);
}

// The first design, kept as phase 5's yardstick: a grid-stride loop of one
// element a thread over the general datapath unit_bits.
template <class F, bool RSQRT>
__global__ void scalar_kernel(const typename F::Bits* __restrict__ x,
                              typename F::Bits* __restrict__ y, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = e2afs::unit_bits<F, RSQRT>(x[i]);
  }
}

template <class F>
int launch_scalar(const void* x, void* y, long long n, int rsqrt, cudaStream_t stream) {
  constexpr int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  using B = typename F::Bits;
  if (rsqrt) {
    scalar_kernel<F, true><<<blocks, threads, 0, stream>>>(static_cast<const B*>(x),
                                                           static_cast<B*>(y), n);
  } else {
    scalar_kernel<F, false><<<blocks, threads, 0, stream>>>(static_cast<const B*>(x),
                                                            static_cast<B*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
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

// The number of F's bit patterns on which the kernel's datapath differs from
// the general one, unit_bits: each thread builds the vector of the next
// values_per_vector patterns, runs unit_vector on it as the kernel's body
// does (with the block's table of rsqrt terms where the format takes one)
// and lean_unit_bits on each as its head and tail do, and counts a pattern
// where either differs.  Added to *mismatches (one atomic a warp).
template <class F, bool RSQRT>
__global__ void unit_check_kernel(unsigned long long* __restrict__ mismatches) {
  using B = typename F::Bits;
  constexpr int V = values_per_vector<F>();
  constexpr unsigned long long patterns = 1ull << (8 * sizeof(B));
  __shared__ short terms[term_count<F>()];
  fill_terms<F, RSQRT>(terms);
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  unsigned bad = 0;
  for (unsigned long long i = static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
                              threadIdx.x;
       i < patterns / V; i += stride) {
    B in[V];
#pragma unroll
    for (int k = 0; k < V; ++k) in[k] = static_cast<B>(i * V + k);
    uint4 v;
    memcpy(&v, in, 16);
    const uint4 r = unit_vector<F, RSQRT>(v, terms);
    B out[V];
    memcpy(out, &r, 16);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const B want = e2afs::unit_bits<F, RSQRT>(in[k]);
      bad += out[k] != want || static_cast<B>(e2afs::lean_unit_bits<F, RSQRT>(in[k])) != want;
    }
  }
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && bad != 0) atomicAdd(mismatches, static_cast<unsigned long long>(bad));
}

template <class F>
void launch_check(int rsqrt, unsigned long long* mismatches, cudaStream_t stream) {
  if (rsqrt) {
    unit_check_kernel<F, true><<<132 * 8, 256, 0, stream>>>(mismatches);
  } else {
    unit_check_kernel<F, false><<<132 * 8, 256, 0, stream>>>(mismatches);
  }
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

// The check of the elementwise kernel's datapath against unit_bits over
// every pattern of the format (2^16 or 2^32); mismatches: one uint64 on the
// card, added to.  dtype as below.  Returns cudaGetLastError().
extern "C" int e2afs_sqrt_unit_check(int dtype, int rsqrt, void* mismatches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<unsigned long long*>(mismatches);
  switch (dtype) {
    case 0: launch_check<e2afs::Fp16>(rsqrt, out, s); break;
    case 1: launch_check<e2afs::Bf16>(rsqrt, out, s); break;
    case 2: launch_check<e2afs::Fp32>(rsqrt, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float16, 1 = bfloat16, 2 = float32.  x and y hold n elements
// each, on the element's alignment, at the same address mod 16.  The tile:
// threads a block x 16-byte loads in flight a thread, one of the
// instantiated pairs.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for what the kernel does not take.
extern "C" int e2afs_sqrt_launch(const void* x, void* y, long long n, int dtype, int rsqrt,
                                 int threads, int unroll, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x), b = reinterpret_cast<uintptr_t>(y);
  const uintptr_t size = dtype == 2 ? 4 : 2;
  if (a % size != 0 || (a - b) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch_format<e2afs::Fp16>(x, y, n, rsqrt, threads, unroll, s);
    case 1: return launch_format<e2afs::Bf16>(x, y, n, rsqrt, threads, unroll, s);
    case 2: return launch_format<e2afs::Fp32>(x, y, n, rsqrt, threads, unroll, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The first design (scalar_kernel) on the same arguments, for timing beside
// the kernel; any alignment.  Returns cudaGetLastError().
extern "C" int e2afs_sqrt_scalar_launch(const void* x, void* y, long long n, int dtype,
                                        int rsqrt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (dtype) {
    case 0: return launch_scalar<e2afs::Fp16>(x, y, n, rsqrt, s);
    case 1: return launch_scalar<e2afs::Bf16>(x, y, n, rsqrt, s);
    case 2: return launch_scalar<e2afs::Fp32>(x, y, n, rsqrt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
