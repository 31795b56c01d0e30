// One-query decode attention per slot, with the cache length split over
// blocks: GQA, float32 scores, int8 scales folded in, per-row validity from
// pos, float32 softmax, V-accumulate.
//
// Replaces the TPU kernel src/repro/kernels/attention/attention.py (_kernel
// and _kernel_quant, body _attend, reached through
// decode_attention_kernel_call), over its whole shape domain: any number of
// query heads a KV head, and any head_dim up to 256 that is a multiple of the
// vector width (8 elements of a bf16 or int8 line, 4 of a float32 line).  The
// fold points are those of _attend and of
// layers/attention.py::_fold_masked_attention:
//   s   = T(sum_k q*k)                (float32 sum, rounded to the activation
//                                      dtype T, as the einsum returns T)
//   s   = float(s) * scale [* k_scale] + (valid ? 0 : -2e38)
//   M   = max over all t of s          (exact in any order)
//   e   = exp(s - M); sum = one float32 sum of e over all t, fixed order
//   w   = T(e / sum) [then T(w * T(v_scale))]
//   out = T(sum_t w * v)               (float32 accumulate)
// valid = t <= pos, or every line once wrap and pos >= cache length.
//
// Why not the online softmax of flash-decoding: it rescales a chunk's
// exp(s - m_c) by exp(m_c - M) afterwards, which is not exp(s - M) to the
// last bit, and w is rounded to T right after the division, so a rescaled
// weight can land one ulp of T away on some lines.  Here every chunk waits
// for the global max before it exponentiates and for the global sum before
// it divides: two exchanges between the blocks of a (slot, KV head), and a
// third for their partial outputs.
//
// Bound on the H100: bytes.  The K and V cache lines (b*t*kv*hd elements
// each) dominate, against 4*g*hd operations a line, about 2 FLOP a byte at
// g = 4, far below the ~295 at which the tensor cores would bind; so no
// tensor cores, and the design is about filling the SMs and keeping bytes in
// flight.  A block of 128 threads takes one (slot, KV head, chunk of cache
// lines) and serves the g = h/kv query heads of that KV head, so each line
// is read from device memory once.
//
// One cooperative launch (cudaLaunchCooperativeKernel) runs every block of
// a call at once, and grid syncs separate the steps: the blocks write their
// chunk maxima, then their chunk sums, then their float32 partial outputs
// to a workspace that the wrapper allocates, and read the others' back in
// chunk order.  A chunk's scores stay in shared memory across the syncs.
// Its K tiles and then its V tiles stream through a ring of kRing tiles of
// shared memory with cp.async (16-byte copies; 8 bytes for an int8 line of
// an odd number of 8-byte vectors), so the first V tiles land while the
// scores' last tiles, the max, the exp and the sum are formed.  A group of
// lanes reads one K line from the ring (a 16-byte load a lane, 8 bytes of
// int8; a float32 line of more than 32 vectors takes two a lane, 32 vectors
// apart) and its g dot products meet in a transposing shuffle reduction
// (g - 1 + log2(lanes / g) shuffles, not g * log2(lanes), for g a power of
// two; g = 6, 10 and 12 shuffle each head).  Every sum, max and combine runs
// in a fixed order, so two calls on the same inputs are bit-identical (no
// atomics).
//
// The shape domain.  The kernel is instantiated for G = 1, 2, 4, 6, 8, 10, 12
// and 16 query heads a block (kGroups).  A group of another size runs as
// the next instantiated size with the extra heads masked (3 as 4, 5 as 6, 7
// as 8, 9 as 10, 11 as 12, 13-15 as 16): a masked head loads a zero query
// and stores nothing.  A group larger than 16 runs in passes of at most 16
// heads, each pass its own launch over the same (slot, KV head), so each
// pass reads the lines again and needs no more resident blocks than one
// group of 16: G = 48 is three passes of 16, G = 20 two of 10.  A line
// whose vector count is not a power of two takes the
// next power of two of lanes; the lanes past the line hold zeros, which
// add nothing to the shuffle reductions.  The workspace and the scores'
// room are sized for the padded group.  A head's output is a function of
// its own query and the lines alone; padding and passes add work, not
// terms.
//
// How the split is chosen (plan_of): as many chunks a (slot, KV head)
// as the blocks that fit on the card at once allow (asked of the occupancy
// API once a device), but no chunk shorter than a tile (32 lines of a bf16
// hd = 128 cache) and none longer than the scores' room (960 lines at
// G = 4).  Serving shape b = 8, kv = 8 on 132 SMs at 4 blocks an SM: t = 576
// gives 8 chunks of 72 lines (512 blocks), t = 4096 8 chunks of 512.  A
// cache no longer than a tile is one chunk (S = 1), whose output is written
// directly, with no sync.  Where the slots' chunks outnumber the resident
// blocks (a long cache, or a large batch), the call launches once for each
// run of slots that fits.
#include <cooperative_groups.h>

#include <atomic>

#include "e2afs.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 8192;     // most bytes of one tile of K or V lines
constexpr int kTileMaxLines = 128;
constexpr int kRing = 4;             // tiles in flight a block
constexpr int kScoreFloats = 3840;   // a chunk's g x cl scores (15 KB)
constexpr int kMaxDevices = 64;
constexpr int kMaxHeadDim = 256;     // the longest line a lane group takes
constexpr int kMaxGroup = 16;        // the most query heads a block serves (a pass)
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

// A lane's NV vectors of one line: vector n at p + n * part (part = lanes x
// VEC elements), so that each of the NV loads of a lane group covers one
// contiguous run of the line.  A vector past the line (has[n] false: a lane
// past a line of a non-power-of-two vector count) reads nothing and holds
// zeros.
template <int NV, class KV, int E>
__device__ __forceinline__ void load_lane(const KV* p, int part, const bool (&has)[NV],
                                          float (&out)[E]) {
  constexpr int V = E / NV;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    float v[V];
    if (has[n]) {
      load_vec(p + n * part, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) out[n * V + e] = v[e];
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `lines` cache lines of hd elements, `stride` elements apart in
// device memory, to consecutive lines of dst in shared memory.
template <class KV>
__device__ __forceinline__ void stage(KV* dst, const KV* src, long long stride, int lines, int hd) {
  const int line_bytes = hd * static_cast<int>(sizeof(KV));
  if (line_bytes % 16 == 0) {
    const int per = line_bytes / 16;
    for (int i = threadIdx.x; i < lines * per; i += kThreads) {
      const int l = i / per, u = i - l * per;
      const char* s = reinterpret_cast<const char*>(src + l * stride) + u * 16;
      const unsigned int d = static_cast<unsigned int>(
          __cvta_generic_to_shared(reinterpret_cast<char*>(dst + l * hd) + u * 16));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(s) : "memory");
    }
  } else {  // an int8 line of an odd number of 8-byte vectors: 8-byte copies
    const int per = line_bytes / 8;
    for (int i = threadIdx.x; i < lines * per; i += kThreads) {
      const int l = i / per, u = i - l * per;
      const char* s = reinterpret_cast<const char*>(src + l * stride) + u * 8;
      const unsigned int d = static_cast<unsigned int>(
          __cvta_generic_to_shared(reinterpret_cast<char*>(dst + l * hd) + u * 8));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(s) : "memory");
    }
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

// Hands the block's G values to the other chunks of its (slot, KV head)
// and replaces them with the reduction over all S chunks (max or sum):
// vals is (b, h, S) in device memory; a warp a head, lanes strided over the
// chunks, then the shuffle tree, so the order is fixed.  Every thread gets
// the results.  The grid sync inside makes every block's values visible.
template <int G, bool MAX>
__device__ __forceinline__ void across_chunks(float* vals, long long head0, int c, int S,
                                              float (&r)[G], float* slots) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (threadIdx.x == j) vals[(head0 + j) * S + c] = r[j];
  }
  cg::this_grid().sync();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < G; j += kWarps) {
    const float* p = vals + (head0 + j) * S;
    float v = MAX ? __uint_as_float(kMinusInfBits) : 0.f;
    for (int i = lane; i < S; i += 32) {
      const float x = __ldcg(p + i);  // written by other blocks: past L1
      v = MAX ? fmaxf(v, x) : v + x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = MAX ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) slots[j] = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < G; ++j) r[j] = slots[j];
  __syncthreads();
}

// Sums each of a lane group's G dot products over its lpl lanes (G and lpl
// powers of two, lpl >= G) with G - 1 + log2(lpl / G) shuffles instead of
// G * log2(lpl): each level hands half of the remaining heads to the partner
// lane, so a lane ends with one head, sl / (lpl / G), summed over the whole
// group, in s[0].  The order of the additions is fixed.
template <int G>
__device__ __forceinline__ void reduce_heads(float (&s)[G], int lpl, int sl) {
  static_assert((G & (G - 1)) == 0, "reduce_heads halves the heads: G must be a power of two");
  int off = lpl >> 1;
#pragma unroll
  for (int n = G; n > 1; n >>= 1) {
    const bool upper = (sl & off) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? s[i] : s[i + n / 2];
      const float keep = upper ? s[i + n / 2] : s[i];
      s[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    off >>= 1;
  }
  for (; off > 0; off >>= 1) s[0] += __shfl_xor_sync(0xffffffffu, s[0], off);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  const float* k_scale;  // null for float caches
  const float* v_scale;
  // workspace rows: (b, kvh, G) a padded head each, the pass's
  float* cmax;  // (rows, S) chunk maxima
  float* csum;  // (rows, S) chunk sums of exp(s - M)
  float* part;  // (rows, S, hd) partial outputs
  void* out;
  int b, t_len, h, kvh, hd;  // b: the slots of this launch
  int grp;     // query heads a KV head, h / kvh
  int passes;  // passes over a (slot, KV head), each of at most kMaxGroup heads
  int gp;      // query heads a pass (the last may hold fewer); G >= gp are instantiated
  int ps;      // the pass of this launch
  int vecs;    // vectors a line, hd / VEC
  int lanes;   // lanes a line: vecs rounded up to a power of two, at most 32
  int S;   // chunks a (slot, KV head, pass)
  int cl;  // cache lines a chunk (the last may be shorter)
  int tl;  // cache lines a tile
  float scale;
  int wrap;
};

// Blocks an SM the registers are budgeted for: 4 (128 registers a thread)
// up to G = 8; the q and accumulator rows of G = 10, 12 and 16 (G x EPL
// floats each) get 2 (255 registers), so that they do not spill.
template <class T, class KV, int G, int NV>
__global__ void __launch_bounds__(kThreads, (G <= 8 ? 4 : 2)) decode_attention_kernel(Args a) {
  constexpr int VEC = vec_of<KV>();
  constexpr int EPL = VEC * NV;  // elements a lane holds of a line
  __shared__ __align__(16) unsigned char ring[kRing * kTileBytes];
  __shared__ float sc[kScoreFloats];  // the chunk's scores, e, then w: row j at sc + j * cl
  __shared__ float red[G * kWarps];
  __shared__ float slots[G];
  const int hd = a.hd, tl = a.tl, cl = a.cl, S = a.S;
  const int lpl = a.lanes;   // lanes a cache line: a power of two <= 32
  const int lpw = 32 / lpl;  // lines a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / lpl, sl = lane % lpl;
  const int d0 = sl * VEC;         // this lane's first head_dim element
  const int part = lpl * VEC;      // its NV vectors sit part elements apart (dim(e) below)
  bool has[NV];                    // which of them lie inside the line
#pragma unroll
  for (int v = 0; v < NV; ++v) has[v] = v * lpl + sl < a.vecs;

  // this block: slot bi, KV head kh, chunk c of lines [c0, c0 + n), in
  // the launch's pass over the group's query heads
  const int c = blockIdx.x % S;
  const int row = blockIdx.x / S;  // (slot, KV head)
  const int kh = row % a.kvh, bi = row / a.kvh;
  const int c0 = c * cl, n = min(cl, a.t_len - c0);
  // the pass's heads jq .. jq + real - 1 of the group; heads real .. G - 1
  // of the block are padding (a zero query, nothing stored)
  const int jq = a.ps * a.gp, real = min(a.gp, a.grp - jq);
  const long long head0 = static_cast<long long>(row) * G;  // its first workspace row
  const long long out0 = (static_cast<long long>(bi) * a.kvh + kh) * a.grp + jq;  // output head
  const long long line0 = static_cast<long long>(bi) * a.t_len * a.kvh + kh;  // line(t) = line0 + t * kvh
  const long long stride = static_cast<long long>(a.kvh) * hd;
  const long long first = (line0 + static_cast<long long>(c0) * a.kvh) * hd;
  const KV* kc = static_cast<const KV*>(a.k) + first;
  const KV* vc = static_cast<const KV*>(a.v) + first;
  KV* ring_kv = reinterpret_cast<KV*>(ring);
  constexpr int kSlot = kTileBytes / static_cast<int>(sizeof(KV));  // elements a ring slot
  const int nt = (n + tl - 1) / tl;  // tiles of K, then as many of V

  // tile i of the stream K0 .. K(nt-1), V0 .. V(nt-1) into slot i % kRing;
  // past the stream an empty group, so that every wait counts the same
  auto fetch = [&](int i) {
    if (i < 2 * nt) {
      const int ti = i < nt ? i : i - nt;
      stage(ring_kv + (i % kRing) * kSlot, (i < nt ? kc : vc) + ti * tl * stride, stride,
            min(tl, n - ti * tl), hd);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kRing; ++i) fetch(i);

  // -- scores and the chunk's maxima --
  // the head_dim element that a lane's e-th value stands for
  auto dim = [&](int e) { return (e / VEC) * part + d0 + e % VEC; };
  float qr[G][EPL];
  const T* q = static_cast<const T*>(a.q) + out0 * hd;
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[j][e] = j < real && has[e / VEC] ? to_f(q[j * hd + dim(e)]) : 0.f;
    }
  }
  const int p = a.pos[bi];
  const bool all_valid = a.wrap != 0 && p >= a.t_len;
  // reduce_heads applies: G a power of two (G = 6, 10 and 12 take the
  // per-head shuffles below) no larger than the lanes of a line
  constexpr bool kPow2 = (G & (G - 1)) == 0;
  const bool split = kPow2 && lpl >= G;
  const int mine = split ? sl / (lpl / G) : 0;  // the head this lane ends with
  const bool writer = split ? sl % (lpl / G) == 0 : sl == 0;
  float m[G];
#pragma unroll
  for (int j = 0; j < G; ++j) m[j] = __uint_as_float(kMinusInfBits);
  for (int ti = 0; ti < nt; ++ti) {
    cp_async_wait<kRing - 1>();  // tile ti has landed (this thread's copies) ...
    __syncthreads();             // ... and everyone's
    const KV* tile = ring_kv + (ti % kRing) * kSlot;
    const int nl = min(tl, n - ti * tl);
    // l0 is uniform across the warp, so every lane takes part in the
    // shuffles; lanes past the tile compute zeros and store none
    for (int l0 = warp * lpw; l0 < nl; l0 += kWarps * lpw) {
      const int l = l0 + sub;
      float kx[EPL];
      if (l < nl) {
        load_lane<NV>(tile + l * hd + d0, part, has, kx);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kx[e] = 0.f;
      }
      float s[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc = fmaf(qr[j][e], kx[e], acc);
        s[j] = acc;
      }
      if (split) {
        if constexpr (kPow2) reduce_heads<G>(s, lpl, sl);
      } else {
        for (int off = lpl >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int j = 0; j < G; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
        }
      }
      if (writer && l < nl) {
        const int lc = ti * tl + l;  // line within the chunk
        const int tt = c0 + lc;
        const long long line = line0 + static_cast<long long>(tt) * a.kvh;
        const float ks = a.k_scale != nullptr ? a.k_scale[line] : 1.f;
        const float mask = (all_valid || tt <= p) ? 0.f : kNegInf;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (split && j > 0) break;  // one head a lane, in s[0]
          float val = __fmul_rn(round_to<T>(s[j]), a.scale);
          if (a.k_scale != nullptr) val = __fmul_rn(val, ks);
          val = __fadd_rn(val, mask);
          sc[(split ? mine : j) * cl + lc] = val;
          m[j] = fmaxf(m[j], val);
        }
      }
    }
    __syncthreads();  // the slot is free: the next tile of the stream goes there
    fetch(ti + kRing);
  }
  if (split) {  // this lane's maximum belongs to head `mine`
    const float own = m[0];
#pragma unroll
    for (int j = 0; j < G; ++j) m[j] = j == mine ? own : __uint_as_float(kMinusInfBits);
  }
  block_reduce<G, true>(m, red);
  if (S > 1) across_chunks<G, true>(a.cmax, head0, c, S, m, slots);

  // -- e = exp(s - M) in place, and the sums --
  float sum[G];
#pragma unroll
  for (int j = 0; j < G; ++j) sum[j] = 0.f;
  for (int l = threadIdx.x; l < n; l += kThreads) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float e = expf(__fsub_rn(sc[j * cl + l], m[j]));
      sc[j * cl + l] = e;
      sum[j] += e;
    }
  }
  block_reduce<G, false>(sum, red);
  if (S > 1) across_chunks<G, false>(a.csum, head0, c, S, sum, slots);

  // -- w = T(e / sum) [then T(w * T(v_scale))] in place --
  for (int l = threadIdx.x; l < n; l += kThreads) {
    const float vs = a.v_scale != nullptr
                         ? round_to<T>(a.v_scale[line0 + static_cast<long long>(c0 + l) * a.kvh])
                         : 1.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float wv = round_to<T>(__fdiv_rn(sc[j * cl + l], sum[j]));
      if (a.v_scale != nullptr) wv = round_to<T>(__fmul_rn(wv, vs));
      sc[j * cl + l] = wv;
    }
  }

  // -- sum_t w * v over the V tiles, a lane's share in registers --
  float acc[G][EPL];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
  }
  for (int ti = 0; ti < nt; ++ti) {
    cp_async_wait<kRing - 1>();
    __syncthreads();  // also orders the weights above before their first read
    const KV* tile = ring_kv + ((nt + ti) % kRing) * kSlot;
    const int nl = min(tl, n - ti * tl);
#pragma unroll 2
    for (int l = warp * lpw + sub; l < nl; l += kWarps * lpw) {
      float vx[EPL];
      load_lane<NV>(tile + l * hd + d0, part, has, vx);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float wj = sc[j * cl + ti * tl + l];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[j][e] = fmaf(wj, vx[e], acc[j][e]);
      }
    }
    __syncthreads();
    fetch(nt + ti + kRing);
  }
  cp_async_wait<0>();  // only empty groups are left; the ring takes the warps' sums
  // combine the warp's lane groups (same sl), then the warps in order
  for (int off = lpl; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], off);
    }
  }
  // The warps' partial outputs (kWarps x G x hd float32) go through the ring
  // in passes of as many heads as it holds (kWarps x hp x hd floats): one pass
  // up to G x hd = 2048, two at recurrentgemma-2b's G = 10, hd = 256 (40 KB of
  // partials against the 32 KB ring).  Passes rather than a larger buffer: the
  // static shared memory (ring, scores, red, slots) is already ~47 KB of the
  // 48 KB a block may hold without opting in to dynamic shared memory, and a
  // pass costs one more block barrier.  One pass sums exactly as before.
  float* wsum = reinterpret_cast<float*>(ring);
  const int hp = min(G, kRing * kTileBytes / (kWarps * hd * 4));
  T* out = static_cast<T*>(a.out);
  for (int j0 = 0; j0 < G; j0 += hp) {
    const int nh = min(hp, G - j0);
    if (sub == 0) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < j0 || j >= j0 + nh) continue;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          if (has[e / VEC]) wsum[(warp * nh + j - j0) * hd + dim(e)] = acc[j][e];
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nh * hd; i += kThreads) {
      float s = 0.f;
      for (int wp = 0; wp < kWarps; ++wp) s += wsum[wp * nh * hd + i];
      const int j = j0 + i / hd, d = i % hd;
      if (S == 1) {
        if (j < real) out[(out0 + j) * hd + d] = from_f<T>(s);
      } else {
        a.part[((head0 + j) * S + c) * hd + d] = s;
      }
    }
    __syncthreads();  // the ring is free for the next pass
  }
  if (S == 1) return;

  // -- out = T(sum over the chunks of the partials), in chunk order --
  cg::this_grid().sync();
  // the pass's outputs: head j < real of each (slot, KV head) bk
  const long long outs = static_cast<long long>(a.b) * a.kvh * real * hd;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < outs;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long ol = i / hd, bk = ol / real;
    const long long j = ol - bk * real, d = i - ol * hd;
    const float* pp = a.part + (bk * G + j) * S * hd + d;
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += __ldcg(pp + static_cast<long long>(k) * hd);
    out[(bk * a.grp + jq + j) * hd + d] = from_f<T>(s);
  }
}

// Blocks of the kernel that fit on the current device at once: asked of the
// occupancy API once a device.
template <class T, class KV, int G, int NV>
int capacity(int& cap) {
  static std::atomic<int> cached[kMaxDevices];  // 0: not asked yet
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && (cap = cached[dev].load(std::memory_order_relaxed)) > 0) return 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_attention_kernel<T, KV, G, NV>,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cap = per_sm * sms;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (dev < kMaxDevices) cached[dev].store(cap, std::memory_order_relaxed);
  return 0;
}

struct Plan {
  int S, cl, tl;
  int slots;  // slots a launch
  long long ws_floats;
  int passes, group;  // passes over a (slot, KV head); the group each runs as
};

template <class T, class KV, int G, int NV>
int plan_of(const Args& a, Plan& p) {
  int cap = 0;
  const int err = capacity<T, KV, G, NV>(cap);
  if (err != 0) return err;
  const int t_len = a.t_len, hd = a.hd;
  // a pass of the partial outputs through the ring holds at least one head
  if (static_cast<long long>(kWarps) * hd * 4 > kRing * kTileBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = a.kvh;  // block rows a slot
  p.tl = min(kTileMaxLines, kTileBytes / (hd * static_cast<int>(sizeof(KV))));
  const long long lines_max = kScoreFloats / G;  // the scores' room
  const long long s_min = (t_len + lines_max - 1) / lines_max;
  if (rows * s_min > cap) return static_cast<int>(cudaErrorInvalidValue);  // too long a cache
  // as many chunks as the resident blocks allow, none shorter than a tile
  long long s = min(static_cast<long long>((t_len + p.tl - 1) / p.tl),
                    cap / (static_cast<long long>(a.b) * rows));
  s = max(max(s, s_min), 1LL);
  // as even as the chunk count allows, no chunk empty
  p.cl = static_cast<int>((t_len + s - 1) / s);
  p.S = (t_len + p.cl - 1) / p.cl;
  p.slots = static_cast<int>(min(static_cast<long long>(a.b), cap / (rows * p.S)));
  p.ws_floats = p.S > 1 ? static_cast<long long>(p.slots) * rows * G * p.S * (hd + 2) : 0;
  return 0;
}

template <class T, class KV, int G, int NV>
int run(const Args& a, cudaStream_t stream) {
  Plan p;
  int err = plan_of<T, KV, G, NV>(a, p);
  if (err != 0) return err;
  const long long rows = static_cast<long long>(p.slots) * a.kvh * G;  // workspace
  // one launch for each run of slots that fits, and each pass over the group
  for (int b0 = 0; b0 < a.b; b0 += p.slots) {
    Args s = a;
    s.b = min(p.slots, a.b - b0);
    s.S = p.S;
    s.cl = p.cl;
    s.tl = p.tl;
    s.q = static_cast<const T*>(a.q) + static_cast<long long>(b0) * a.h * a.hd;
    s.out = static_cast<T*>(a.out) + static_cast<long long>(b0) * a.h * a.hd;
    const long long lines = static_cast<long long>(b0) * a.t_len * a.kvh;
    s.k = static_cast<const KV*>(a.k) + lines * a.hd;
    s.v = static_cast<const KV*>(a.v) + lines * a.hd;
    s.pos = a.pos + b0;
    if (a.k_scale != nullptr) {
      s.k_scale = a.k_scale + lines;
      s.v_scale = a.v_scale + lines;
    }
    s.csum = a.cmax + rows * p.S;
    s.part = s.csum + rows * p.S;
    for (s.ps = 0; s.ps < a.passes; ++s.ps) {
      void* args[] = {&s};
      err = static_cast<int>(cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(decode_attention_kernel<T, KV, G, NV>),
          dim3(static_cast<unsigned int>(s.b * a.kvh * p.S)), dim3(kThreads), args, 0, stream));
      if (err != 0) return err;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiated groups: the powers of two, and starcoder2-15b's 12,
// mixtral-8x22b's 6 and recurrentgemma-2b's 10 (qwen3-moe-235b-a22b's 16 is
// kMaxGroup).  A pass of gp heads runs as the first of them >= gp.
constexpr int kGroups[] = {1, 2, 4, 6, 8, 10, 12, 16};

constexpr int padded_group(int gp) {
  for (int g : kGroups) {
    if (g >= gp) return g;
  }
  return 0;
}

template <class T, class KV, int NV>
int dispatch_group(const Args& a, Plan* plan, cudaStream_t stream) {
#define REPRO_GROUP(G) \
  case G:              \
    return plan != nullptr ? plan_of<T, KV, G, NV>(a, *plan) : run<T, KV, G, NV>(a, stream);
  switch (padded_group(a.gp)) {
    REPRO_GROUP(1)
    REPRO_GROUP(2)
    REPRO_GROUP(4)
    REPRO_GROUP(6)
    REPRO_GROUP(8)
    REPRO_GROUP(10)
    REPRO_GROUP(12)
    REPRO_GROUP(16)
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_GROUP
}

// One vector a lane where a line has at most 32 of them, on the next power
// of two of lanes; a float32 line of 33 to 64 vectors (hd 132 to 256) takes
// two a lane on 32 lanes.
template <class T, class KV>
int dispatch_vectors(Args a, Plan* plan, cudaStream_t stream) {
  constexpr int VEC = vec_of<KV>();
  if (a.hd % VEC != 0 || a.hd < VEC || a.hd > kMaxHeadDim || a.t_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.vecs = a.hd / VEC;
  if constexpr (sizeof(KV) == 4) {
    if (a.vecs > 32) {
      a.lanes = 32;
      return dispatch_group<T, KV, 2>(a, plan, stream);
    }
  }
  for (a.lanes = 1; a.lanes < a.vecs;) a.lanes <<= 1;
  return dispatch_group<T, KV, 1>(a, plan, stream);
}

// Query heads a KV head (grp), passes of at most kMaxGroup heads over each
// (slot, KV head), and the heads a pass (gp): as even as the passes allow.
int dispatch(Args a, int act_dtype, int kv_int8, Plan* plan, cudaStream_t stream) {
  if (a.kvh <= 0 || a.h <= 0 || a.h % a.kvh != 0) return static_cast<int>(cudaErrorInvalidValue);
  a.grp = a.h / a.kvh;
  a.passes = (a.grp + kMaxGroup - 1) / kMaxGroup;
  a.gp = (a.grp + a.passes - 1) / a.passes;
  if (plan != nullptr) {
    plan->passes = a.passes;
    plan->group = padded_group(a.gp);
  }
  if (act_dtype == 1 && !kv_int8) return dispatch_vectors<__nv_bfloat16, __nv_bfloat16>(a, plan, stream);
  if (act_dtype == 1 && kv_int8) return dispatch_vectors<__nv_bfloat16, signed char>(a, plan, stream);
  if (act_dtype == 2 && !kv_int8) return dispatch_vectors<float, float>(a, plan, stream);
  if (act_dtype == 2 && kv_int8) return dispatch_vectors<float, signed char>(a, plan, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args args_of(int b, int t_len, int h, int kvh, int hd) {
  Args a = {};
  a.b = b;
  a.t_len = t_len;
  a.h = h;
  a.kvh = kvh;
  a.hd = hd;
  return a;
}

}  // namespace

// The split for these shapes on the current device: out[0] = float32
// workspace elements a launch needs, out[1] = S, out[2] = cache lines a
// chunk, out[3] = slots a launch, out[4] = passes over a (slot, KV head),
// out[5] = the instantiated group a pass runs as.  Returns a CUDA error code.
extern "C" int decode_attention_plan(int b, int t_len, int h, int kvh, int hd, int act_dtype,
                                     int kv_int8, long long* out) {
  Plan p = {};
  const int err = dispatch(args_of(b, t_len, h, kvh, hd), act_dtype, kv_int8, &p, nullptr);
  if (err != 0) return err;
  out[0] = p.ws_floats;
  out[1] = p.S;
  out[2] = p.cl;
  out[3] = p.slots;
  out[4] = p.passes;
  out[5] = p.group;
  return 0;
}

// act_dtype: 1 = bfloat16, 2 = float32; kv_int8: the cache holds int8 values
// (then k_scale and v_scale are given).  Any h / kv >= 1; hd a multiple of
// VEC (4 for a float32 cache, else 8) no larger than 256; the K/V base
// pointers must be 16-byte aligned; workspace holds the elements
// decode_attention_plan gives for the same shapes.  Returns the first launch
// error, or cudaGetLastError() after the last launch.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, const void* k_scale,
                                       const void* v_scale, void* workspace, void* out, int b,
                                       int t_len, int h, int kvh, int hd, float scale, int wrap,
                                       int act_dtype, int kv_int8, void* stream) {
  if (b <= 0) return 0;
  Args a = args_of(b, t_len, h, kvh, hd);
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.cmax = static_cast<float*>(workspace);
  a.out = out;
  a.scale = scale;
  a.wrap = wrap;
  return dispatch(a, act_dtype, kv_int8, nullptr, static_cast<cudaStream_t>(stream));
}
