// Stochastic dot product on packed streams for Hopper (sm_90a):
// AND + popcount over the words of each stream pair, then the TFF adder tree
// over the K leaves (or the ideal adder, sum >> depth).
//
// Replaces the TPU kernel src/repro/kernels/sc_dot.py::sc_dot_pallas
// (_sc_dot_kernel, _swar_popcount, _tree_reduce).  The TPU version needed a
// SWAR popcount and a sequential grid; here each popcount is the native
// __popc and the grid is a parallel 2-D launch.
//
// Shapes: x (M, K, Wd), w (K, O, Wd) 32-bit words, out (M, O) int32; K is a
// power of two in [2, 1024] (the wrapper pads it with zero streams), Wd in
// [1, 8] (streams of up to 256 bits).
//
// Bound on the H100: operations.  Each output needs K*Wd AND + __popc pairs,
// and __popc issues at a quarter of the plain integer rate (16 results per
// clock per SM on sm_90), while each output writes only 4 bytes and each X
// word is reused across all O outputs.  Design: one thread per (m, o)
// output; a block of 8 x 32 threads covers 8 windows x 32 outputs and stages
// chunks of 32 leaves of its X rows ([8][kc][Wd]) and W columns
// ([kc][Wd][32], transposed so a warp reads 32 consecutive words) in shared
// memory, so each X word is read from memory once per block and broadcast to
// the warp.  The TFF tree is evaluated as the leaves stream in: a stack of
// one pending left child per level (11 ints per thread), so the K leaf
// counts are never stored.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 8;        // windows (rows of X) per block
constexpr int kBO = 32;       // outputs per block: one warp wide
constexpr int kKC = 32;       // leaves staged per chunk
constexpr int kMaxWd = 8;     // words per stream (N <= 256)
constexpr int kMaxDepth = 10; // K <= 1024

enum Mode { kZero = 0, kOne = 1, kAlt = 2, kIdeal = 3 };

template <int MODE>
__global__ void __launch_bounds__(kBM * kBO)
sc_dot_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
              int32_t* __restrict__ out, int M, int K, int O, int Wd,
              int depth) {
  extern __shared__ uint32_t smem[];
  const int kc = min(K, kKC);
  uint32_t* xs = smem;                      // [kBM][kc][Wd]
  uint32_t* ws = smem + kBM * kc * Wd;      // [kc][Wd][kBO]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBO + tx;
  const int m0 = blockIdx.x * kBM, o0 = blockIdx.y * kBO;
  const int xrow = kc * Wd, wrow = kBO * Wd;

  int pend[kMaxDepth + 1];    // pending left child per tree level
  int sum = 0;                // ideal adder

  for (int k0 = 0; k0 < K; k0 += kc) {
    __syncthreads();
    for (int i = tid; i < kBM * xrow; i += kBM * kBO) {
      const int r = i / xrow, j = i - r * xrow;
      const int m = m0 + r;
      xs[i] = m < M ? x[((long long)m * K + k0) * Wd + j] : 0u;
    }
    for (int i = tid; i < kc * wrow; i += kBM * kBO) {
      const int kk = i / wrow, j = i - kk * wrow;
      const int c = j / Wd, v = j - c * Wd;
      const int o = o0 + c;
      ws[(kk * Wd + v) * kBO + c] =
          o < O ? w[((long long)(k0 + kk) * O + o) * Wd + v] : 0u;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      int c = 0;
      for (int v = 0; v < Wd; ++v)
        c += __popc(xs[(ty * kc + kk) * Wd + v] & ws[(kk * Wd + v) * kBO + tx]);
      if (MODE == kIdeal) {
        sum += c;
        continue;
      }
      // Leaf k0+kk enters at level 0.  A right child (odd index) merges with
      // its pending left sibling into node idx>>1 of the next level:
      // (left + right + s0) >> 1, s0 = 0 | 1 | ((idx>>1) + level) & 1.
      // Every thread of the block walks the same leaf order, so the carry
      // loop (one step on average) never diverges within a warp.
      int idx = k0 + kk, l = 0;
      while (idx & 1) {
        const int s0 = MODE == kZero ? 0
                       : MODE == kOne ? 1
                                      : (((idx >> 1) + l) & 1);
        c = (pend[l] + c + s0) >> 1;
        idx >>= 1;
        ++l;
      }
      pend[l] = c;
    }
  }
  const int m = m0 + ty, o = o0 + tx;
  if (m < M && o < O) {
    out[(long long)m * O + o] = MODE == kIdeal ? sum >> depth : pend[depth];
  }
}

template <int MODE>
cudaError_t launch(const void* x, const void* w, void* out, int M, int K,
                   int O, int Wd, int depth, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (O + kBO - 1) / kBO);
  const dim3 block(kBO, kBM);
  const size_t smem = (size_t)min(K, kKC) * Wd * (kBM + kBO) * sizeof(uint32_t);
  sc_dot_kernel<MODE><<<grid, block, smem, stream>>>(
      (const uint32_t*)x, (const uint32_t*)w, (int32_t*)out, M, K, O, Wd, depth);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 = tff s0 zero, 1 = tff s0 one, 2 = tff s0 alt, 3 = ideal adder.
// Returns cudaGetLastError() after the launch.
extern "C" int sc_dot_launch(const void* x, const void* w, void* out, int M,
                             int K, int O, int Wd, int mode, void* stream) {
  int depth = 0;
  while ((1 << depth) < K) ++depth;
  if (M <= 0 || O <= 0 || K < 2 || (1 << depth) != K || depth > kMaxDepth ||
      Wd < 1 || Wd > kMaxWd || (O + kBO - 1) / kBO > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kZero: return (int)launch<kZero>(x, w, out, M, K, O, Wd, depth, s);
    case kOne: return (int)launch<kOne>(x, w, out, M, K, O, Wd, depth, s);
    case kAlt: return (int)launch<kAlt>(x, w, out, M, K, O, Wd, depth, s);
    case kIdeal: return (int)launch<kIdeal>(x, w, out, M, K, O, Wd, depth, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
