// Comparator SNG + LSB-first bit packing for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sng_pack.py::sng_pack_pallas
// (_sng_pack_kernel).  Bit t of output word w of a level is
// (codes[32*w + t] < level); for streams shorter than 32 bits (N = 4, 8, 16)
// the one word holds N valid low bits and zeros above them, which add
// nothing to a later AND + popcount.
//
// Bound on the H100: bytes.  A stream depends only on its level, and levels
// in [0, N] give at most N + 1 distinct streams, so the function needs
// (N + 1) * N compares (one table) and then 4 bytes in and N/8 bytes out per
// level.  Design: each persistent CTA (about one per SM) builds the
// (N + 1) x nw stream table in shared memory, one warp making one word with
// one __ballot_sync(codes[32w + lane] < L) (8,224 B at N = 256, 68 B at
// N = 16), while its first levels are already in flight; it then
// grid-strides over 16-byte output chunks: consecutive threads load
// consecutive levels and store consecutive 16-byte chunks, each word one
// shared-memory read.  A level outside [0, N] takes a direct-comparison
// branch over the codes, so any int32 level and any codes give the plain
// version's words.  No runtime division: the chunk -> level map is a shift
// of a compile-time count.  No scratch, no allocation; launched on the
// caller's stream.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kMaxLength = 256;
constexpr int kMaxWords = kMaxLength / 32;
constexpr int kThreads = 512;

struct Table {
  uint32_t words[(kMaxLength + 1) * kMaxWords];
  int32_t codes[kMaxLength];
};

// Word w of the stream of ``level`` by direct comparison (any level).
__device__ __forceinline__ uint32_t direct_word(const int32_t* codes, int length,
                                             int w, int level) {
  const int base = 32 * w, nbits = min(32, length - base);
  uint32_t word = 0u;
  for (int t = 0; t < nbits; ++t)
    word |= (uint32_t)(codes[base + t] < level) << t;
  return word;
}

__device__ __forceinline__ uint32_t word_of(const Table& tb, int length, int nw,
                                            int level, int w) {
  return (unsigned)level <= (unsigned)length
             ? tb.words[level * nw + w]
             : direct_word(tb.codes, length, w, level);
}

// Words w .. w+3 of the stream of ``level`` (nw >= 4, w % 4 == 0).
__device__ __forceinline__ uint4 quad_of(const Table& tb, int length, int nw,
                                         int level, int w) {
  if ((unsigned)level <= (unsigned)length)
    return *reinterpret_cast<const uint4*>(&tb.words[level * nw + w]);
  return make_uint4(direct_word(tb.codes, length, w, level),
                    direct_word(tb.codes, length, w + 1, level),
                    direct_word(tb.codes, length, w + 2, level),
                    direct_word(tb.codes, length, w + 3, level));
}

// Every warp builds rows L = warp, warp + nwarps, ... of the table; lane v
// keeps word v of the row, so one store per row.
__device__ void build_table(Table& tb, const int32_t* __restrict__ codes,
                            int length, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t code[kMaxWords];
#pragma unroll
  for (int v = 0; v < kMaxWords; ++v) {
    const int t = 32 * v + lane;
    code[v] = t < length ? codes[t] : INT_MAX;     // INT_MAX < L never holds
    if (t < length) tb.codes[t] = code[v];
  }
  for (int L = warp; L <= length; L += kThreads / 32) {
    uint32_t mine = 0u;
#pragma unroll
    for (int v = 0; v < kMaxWords; ++v) {
      if (v < nw) {
        const uint32_t word = __ballot_sync(0xffffffffu, code[v] < L);
        if (lane == v) mine = word;
      }
    }
    if (lane < nw) tb.words[L * nw + lane] = mine;
  }
}

// NW in {1, 2, 4, 8}: item i is the 16-byte output chunk i.  NW <= 4: the
// chunk holds the words of 4 / NW levels, loaded as one vector; NW = 8: it
// holds half a level's words.
template <int NW>
struct Chunks {
  static constexpr int kLevels = NW <= 4 ? 4 / NW : 1;   // levels per chunk
  static constexpr int kShift = NW == 8 ? 1 : 0;         // chunks per level
  static constexpr int kUnroll = NW <= 2 ? 4 : 8;        // chunks in flight
  using Lv = typename std::conditional<
      kLevels == 4, int4, typename std::conditional<kLevels == 2, int2,
                                                    int>::type>::type;

  static __device__ __forceinline__ Lv load(const int32_t* __restrict__ lv,
                                            int i) {
    return reinterpret_cast<const Lv*>(lv)[i >> kShift];
  }

  static __device__ __forceinline__ uint4 make(const Table& tb, int length,
                                               const Lv& l, int i) {
    if constexpr (NW == 1) {
      return make_uint4(word_of(tb, length, 1, l.x, 0),
                        word_of(tb, length, 1, l.y, 0),
                        word_of(tb, length, 1, l.z, 0),
                        word_of(tb, length, 1, l.w, 0));
    } else if constexpr (NW == 2) {
      const uint2 a = (unsigned)l.x <= (unsigned)length
          ? *reinterpret_cast<const uint2*>(&tb.words[2 * l.x])
          : make_uint2(direct_word(tb.codes, length, 0, l.x),
                       direct_word(tb.codes, length, 1, l.x));
      const uint2 b = (unsigned)l.y <= (unsigned)length
          ? *reinterpret_cast<const uint2*>(&tb.words[2 * l.y])
          : make_uint2(direct_word(tb.codes, length, 0, l.y),
                       direct_word(tb.codes, length, 1, l.y));
      return make_uint4(a.x, a.y, b.x, b.y);
    } else {
      return quad_of(tb, length, NW, l, NW == 8 ? 4 * (i & 1) : 0);
    }
  }
};

template <int NW>
__global__ void __launch_bounds__(kThreads)
sng_pack_kernel(const int32_t* __restrict__ levels,
                const int32_t* __restrict__ codes, uint32_t* __restrict__ out,
                int n, int length, int nw_rt, int items) {
  __shared__ __align__(16) Table tb;
  const int nw = NW ? NW : nw_rt;
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (NW == 0) {
    // any stream length: item i is level i, its nw words stored one by one
    build_table(tb, codes, length, nw);
    __syncthreads();
    for (int i = first; i < n; i += stride) {
      const int level = levels[i];
      for (int w = 0; w < nw; ++w)
        out[(long long)i * nw + w] = word_of(tb, length, nw, level, w);
    }
  } else {
    using C = Chunks<NW>;
    typename C::Lv lv[C::kUnroll];
    // the first round's levels are in flight while the table is built
#pragma unroll
    for (int u = 0; u < C::kUnroll; ++u) {
      const int i = first + u * stride;
      if (i < items) lv[u] = C::load(levels, i);
    }
    build_table(tb, codes, length, nw);
    __syncthreads();
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (int base = first; base < items; base += C::kUnroll * stride) {
      typename C::Lv next[C::kUnroll];
#pragma unroll
      for (int u = 0; u < C::kUnroll; ++u) {
        const int i = base + (C::kUnroll + u) * stride;
        if (i < items) next[u] = C::load(levels, i);
      }
#pragma unroll
      for (int u = 0; u < C::kUnroll; ++u) {
        const int i = base + u * stride;
        if (i < items) out4[i] = C::make(tb, length, lv[u], i);
        lv[u] = next[u];
      }
    }
    // levels past the last whole chunk (n % (4 / NW) of them, NW <= 2)
    const int done = (items >> C::kShift) * C::kLevels;
    for (int i = done + first; i < n; i += stride)
      for (int w = 0; w < NW; ++w)
        out[(long long)i * NW + w] = word_of(tb, length, NW, levels[i], w);
  }
}

template <int NW>
cudaError_t launch(const void* levels, const void* codes, void* out, int n,
                   int length, int nw, int items, int ctas,
                   cudaStream_t stream) {
  sng_pack_kernel<NW><<<ctas, kThreads, 0, stream>>>(
      (const int32_t*)levels, (const int32_t*)codes, (uint32_t*)out, n, length,
      nw, items);
  return cudaGetLastError();
}

}  // namespace

// levels: (n,) int32; codes: (length,) int32; out: (n, nw) 32-bit words with
// nw = ceil(length / 32).  The launch plan comes from the wrapper
// (kernels/sng_pack.py, sng_pack_plan): ``route`` is the chunk kernel's word
// count (1, 2, 4, 8; it needs levels 16-byte aligned and the output too) or 0
// for the level-by-level kernel, ``items`` the 16-byte output chunks (route
// > 0) and ``ctas`` the persistent grid.  Returns cudaGetLastError().
extern "C" int sng_pack_launch(const void* levels, const void* codes, void* out,
                               int n, int length, int route, int items,
                               int ctas, void* stream) {
  const int nw = (length + 31) / 32;
  if (n <= 0 || length < 1 || length > kMaxLength || ctas < 1 ||
      (long long)n * nw + 16LL * ctas * kThreads > INT_MAX ||
      (route != 0 && route != nw) ||
      (route != 0 && (((uintptr_t)levels | (uintptr_t)out) & 15)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (route) {
    case 0: return (int)launch<0>(levels, codes, out, n, length, nw, 0, ctas, s);
    case 1: return (int)launch<1>(levels, codes, out, n, length, nw, items, ctas, s);
    case 2: return (int)launch<2>(levels, codes, out, n, length, nw, items, ctas, s);
    case 4: return (int)launch<4>(levels, codes, out, n, length, nw, items, ctas, s);
    case 8: return (int)launch<8>(levels, codes, out, n, length, nw, items, ctas, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
