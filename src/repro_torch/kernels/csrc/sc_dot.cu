// Stochastic dot product on packed streams for Hopper (sm_90a): AND +
// popcount over the words of each (window, output) stream pair, then the TFF
// adder tree over the K leaves (or the ideal adder, sum >> depth).
//
// Replaces the TPU kernel src/repro/kernels/sc_dot.py::sc_dot_pallas
// (_sc_dot_kernel, _swar_popcount, _tree_reduce).  The TPU version needed a
// SWAR popcount and a sequential grid; here each popcount is the native
// __popc (or a b1 tensor-core product) and the grid is persistent.
//
// Shapes: x (M, K, Wd) 32-bit words; w (K, O, Wd) (the split-weight layer
// passes both weight banks as one, side by side along O); out (M, O) int32.
// Any K >= 1: leaves from K up to the next power of two (at least 2) are
// zero leaves, as the plain version pads them.  Wd in [1, 8] (streams of up
// to 256 bits).
//
// Bound on the H100: bytes, at the main path's shapes.  Each output needs a
// count per pair of leaves (N <= 16) or per leaf; on __popc (16 results per
// clock per SM) that work would outweigh the bytes, but the b1 tensor cores
// (measured by chip_smoke.py) make the counts in less time than X takes to
// read.  Design (the launch plan comes from the wrapper, kernels/sc_dot.py:
// sc_dot_plan):
//
// * Persistent CTAs walk tiles of windows.  Each loads the W columns of its
//   O range into shared memory once (the whole W on the main path: 8 KB at
//   bits 4, 64 KB at bits 8; O is tiled on the grid only where W does not
//   fit) and streams X tiles through a two-stage cp.async ring, so the next
//   tile's load overlaps this tile's popcounts.  A tile of windows is
//   staged in chunks of 32 leaves, one subtree of depth 5.
// * The TFF tree stays in registers: the leaf loop is unrolled at compile
//   time (template recursion over the units of a chunk), so every pending
//   node of the stack has a compile-time level; the chunk roots of K > 32
//   fold into an upper stack unrolled over its 6 levels.  ptxas reports
//   0 bytes of stack frame (chip_smoke.py asserts it).  s0 of a node is a
//   register picked at compile time by the parity of (index + level):
//   "zero" 0/0, "one" 1/1, "alt" 0/1; only the chunk-root level needs the
//   chunk's index, at run time.  At N <= 16 a node is at most 16, so the
//   nodes of a window's 4 outputs share one register in byte lanes, and an
//   add, a shift and a mask fold four nodes: the tree's integer work, which
//   would otherwise outweigh the popcounts, drops by about half.
// * Popcount route: each thread owns 4 windows x 4 outputs, so a shared-
//   memory word feeds 4 AND + __popc pairs (W as one 16-byte load per
//   leaf word, X rows of the 4 windows as vector loads).  Lanes cover
//   O / 4 output groups, so O = 16 idles no lane.  At N <= 16 (one word,
//   N valid bits) two leaves share one popcount: the odd leaf's word sits
//   16 bits above the even one's in both X and W, and (x_e | x_o << 16) &
//   (w_e | w_o << 16) = (x_e & w_e) | (x_o & w_o) << 16, so one __popc
//   gives c_2i + c_2i+1 exactly, and the tree's first level needs only that
//   sum: (c_2i + c_2i+1 + s0) >> 1.  The ideal adder packs 32 / N leaves
//   per popcount.  This halves the popcounts; it needs words whose bits at
//   and above N are zero, as every packed stream of N < 32 bits has, and the
//   wrapper takes it only when told the stream length.
// * Tensor-core route (Wd = 8, N = 256): one mma.sync m16n8k256 b1 AND-POPC
//   with C = 0 gives a 16 x 8 tile of one leaf's counts; a 256-bit stream
//   is exactly one k256 step.  Every thread holds the same (window, output)
//   positions for every leaf, so the tree folds in its own registers.
//   Fragments come from ldmatrix over XOR-swizzled shared memory.
// * K > 1,024: the tree splits into subtrees of 1,024 leaves.  One launch
//   reduces them all (blockIdx.z picks the subtree, grid.z up to 65,535 per
//   launch) into a plane of partial roots each, then sc_dot_fold_kernel
//   folds the roots through the upper levels, 10 up to the tree's depth.
//   Every s0 takes the node's global index: within a subtree the parity of
//   a level-<= 8 index is the global one, but the subtree's own last merge
//   (level 9) makes node j, the subtree's number, so the chunks' global
//   index (c0 + c) drives the upper stack.  Subtrees past K are all-zero
//   leaves, whose roots are 0, and are not launched; their parents above
//   still add their s0 in the fold.  The ideal adder writes raw sums, and
//   the fold shifts their total by the whole tree's depth.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRm = 4, kRo = 4;    // popc route: a thread's windows, outputs
constexpr int kVals = 16;          // values per thread: 4 x 4, or 4 MMA tiles x 4
constexpr int kChunk = 32;         // leaves per X stage: a subtree of depth 5
constexpr int kChunkDepth = 5;
constexpr int kMaxDepth = 10;      // one tree of up to 1,024 leaves
constexpr int kMaxFold = 21;       // levels above the subtrees: K < 2^31
constexpr int kMaxGridZ = 65535;
constexpr int kUp = kMaxDepth - kChunkDepth + 1;   // levels 5..10 of the roots
constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;   // 227 KB, the most a block can take
constexpr int kMaxWd = 8;

enum Mode { kZero = 0, kOne = 1, kAlt = 2, kIdeal = 3 };

struct Args {
  const uint32_t* x;
  const uint32_t* w;
  int32_t* out;        // (M, O), or the (subtrees, M, O) partial roots
  int M, K, O, Wd;     // K: the leaves of this block's tree
  int kx;              // leaves per X row: the operand's K
  int s_even, s_odd;   // TFF s0 of a node whose (index + level) is even / odd
  int depth;           // levels of the block's tree (10 for a subtree)
  int shift;           // ideal adder: its sum >> shift (0 for a subtree)
  int sub;             // 1: blocks reduce subtrees of 1,024 leaves
  int z0;              // the launch's first subtree
  int c0;              // global index of the block's first chunk
  // the plan (sc_dot_plan)
  int ot;              // output columns per CTA (padded to the thread tiling)
  int groups;          // popc: window groups per tile; mma: warps along M
  int tm;              // windows per tile
  int x_stride;        // popc: words per staged X row
  int w_words;         // words of W in shared memory
  int stage_words;     // words per X stage
  int m_tiles;
};

// ---------------------------------------------------------------------------
// shared-memory copies and fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}
// d = popc(a AND b) + c: a 16 x 256 bits (row), b 256 x 8 bits (col)
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2],
                                       const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// The block's view of the operands: with ``sub``, subtree j = z0 +
// blockIdx.z, its leaves of X and W, its plane of partial roots and the
// global index of its first chunk.
__device__ __forceinline__ Args subtree(const Args& g) {
  Args a = g;
  if (a.sub) {
    const int j = a.z0 + (int)blockIdx.z;
    const int k0 = j << kMaxDepth;
    a.x += (long long)k0 * a.Wd;
    a.w += (long long)k0 * a.O * a.Wd;
    a.out += (long long)j * a.M * a.O;
    a.K = min(a.kx - k0, 1 << kMaxDepth);
    a.c0 = j << (kMaxDepth - kChunkDepth);
  }
  return a;
}

// Word pointer of leaf k of output column o, or null past K or O.
__device__ __forceinline__ const uint32_t* w_col(const Args& a, int k, int o,
                                                 int wd) {
  if (k >= a.K || o >= a.O) return nullptr;
  return a.w + ((long long)k * a.O + o) * wd;
}

// ---------------------------------------------------------------------------
// the TFF tree, folded in registers as the units of a chunk stream in
// ---------------------------------------------------------------------------

// A thread's 16 tree values in lanes of B bits: value k sits in register
// k / (32 / B) at bit B * (k % (32 / B)), and MASK clears the bit a shift
// brings down from the next lane.  At N <= 16 a node is at most 16 and the
// sum of two nodes and s0 at most 33, so bytes hold four values (B = 8);
// at N <= 256 a node is at most 256 and a sum at most 513, so half-words
// hold two (B = 16): one add, one shift and one mask fold two or four
// nodes, and the tree needs a quarter or half of the registers.
template <int B>
struct Lanes {
  static constexpr int L = 32 / B;          // values per register
  static constexpr int V = kVals / L;       // registers
  static constexpr uint32_t ONES =
      B == 8 ? 0x01010101u : B == 16 ? 0x00010001u : 1u;
  static constexpr uint32_t MASK =
      B == 8 ? 0x7F7F7F7Fu : B == 16 ? 0x7FFF7FFFu : 0xFFFFFFFFu;

  static __device__ __forceinline__ void pack(const uint32_t (&c)[kVals],
                                              uint32_t (&r)[V]) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      r[k] = c[k * L];
#pragma unroll
      for (int l = 1; l < L; ++l) r[k] += c[k * L + l] << (B * l);
    }
  }
  static __device__ __forceinline__ void unpack(const uint32_t (&r)[V],
                                                uint32_t (&c)[kVals]) {
#pragma unroll
    for (int k = 0; k < kVals; ++k) {
      if constexpr (L == 1) c[k] = r[k];
      else c[k] = (r[k / L] >> (B * (k % L))) & ((1u << B) - 1u);
    }
  }
};

template <int B>
struct Tree {
  uint32_t pend[kChunkDepth + 1][Lanes<B>::V];   // pending left child per level
  uint32_t up[kUp][Lanes<B>::V];                 // the same for chunk roots
};

// ``node`` sits at level L with index IDX inside the chunk: an odd index
// merges with its pending left sibling into level L + 1, an even one waits.
// The chunk root's merge (L = 4) takes s4, the s0 of the chunk's index.
// s_even, s_odd and s4 hold s0 in every lane.
template <int L, int IDX, int B>
__device__ __forceinline__ void fold_up(Tree<B>& t,
                                        uint32_t (&node)[Lanes<B>::V],
                                        uint32_t s_even, uint32_t s_odd,
                                        uint32_t s4) {
  constexpr int V = Lanes<B>::V;
  if constexpr (L == kChunkDepth || (IDX & 1) == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) t.pend[L][k] = node[k];
  } else {
    const uint32_t s = L == kChunkDepth - 1
                           ? s4
                           : ((((IDX >> 1) + L) & 1) ? s_odd : s_even);
#pragma unroll
    for (int k = 0; k < V; ++k)
      node[k] = ((t.pend[L][k] + node[k] + s) >> 1) & Lanes<B>::MASK;
    fold_up<L + 1, (IDX >> 1)>(t, node, s_even, s_odd, s4);
  }
}

// Units U .. NU - 1 of a chunk (PACK leaves each): count, fold, and stop
// after unit ``stop`` - 1 (the whole tree of K <= 32 leaves ends there).
// ``live`` leaves of the chunk hold data; later units are zero leaves.
template <int PACK, int U, int NU, int B, class Src>
__device__ __forceinline__ void fold_units(const Src& src, Tree<B>& t,
                                           int live, int stop,
                                           uint32_t s_even, uint32_t s_odd,
                                           uint32_t s4) {
  if constexpr (U < NU) {
    constexpr int V = Lanes<B>::V;
    uint32_t node[V];
    if (U * PACK < live) {
      uint32_t cnt[kVals];
      src.template count<U>(cnt);
      Lanes<B>::pack(cnt, node);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) node[k] = 0u;
    }
    if constexpr (PACK == 2) {    // the pair's node: (c_2i + c_2i+1 + s0) >> 1
      const uint32_t s = (U & 1) ? s_odd : s_even;
#pragma unroll
      for (int k = 0; k < V; ++k)
        node[k] = ((node[k] + s) >> 1) & Lanes<B>::MASK;
    }
    fold_up<(PACK == 2 ? 1 : 0), U>(t, node, s_even, s_odd, s4);
    if (U + 1 == stop) return;
    fold_units<PACK, U + 1, NU>(src, t, live, stop, s_even, s_odd, s4);
  }
}

// The ideal adder: the sum of every unit's count.
template <int U, int NU, int PACK, class Src>
__device__ __forceinline__ void sum_units(const Src& src,
                                          uint32_t (&sum)[kVals], int live) {
  if constexpr (U < NU) {
    if (U * PACK >= live) return;
    uint32_t node[kVals];
    src.template count<U>(node);
#pragma unroll
    for (int k = 0; k < kVals; ++k) sum[k] += node[k];
    sum_units<U + 1, NU, PACK>(src, sum, live);
  }
}

// Chunk c's root (level 5, index c in the block's tree, cg in the whole
// tree) joins the roots before it.  The carry follows c; s0 takes the
// parity of the merged node's global index, (cg >> 1) + level.  The carry
// runs a fixed number of steps, predicated (no early exit), so every level
// of the upper stack keeps a compile-time index.
template <int B>
__device__ __forceinline__ void fold_root(Tree<B>& t, int c, int cg,
                                          uint32_t s_even, uint32_t s_odd) {
  constexpr int V = Lanes<B>::V;
  uint32_t node[V];
#pragma unroll
  for (int k = 0; k < V; ++k) node[k] = t.pend[kChunkDepth][k];
  bool carry = true;
#pragma unroll
  for (int L = 0; L < kUp; ++L) {
    if (carry && !(c & 1)) {
#pragma unroll
      for (int k = 0; k < V; ++k) t.up[L][k] = node[k];
      carry = false;
    } else if (carry) {
      const uint32_t s = (((cg >> 1) + kChunkDepth + L) & 1) ? s_odd : s_even;
#pragma unroll
      for (int k = 0; k < V; ++k)
        node[k] = ((t.up[L][k] + node[k] + s) >> 1) & Lanes<B>::MASK;
      c >>= 1;
      cg >>= 1;
    }
  }
}

// The root after the last chunk: pend[depth] (K <= 32) or up[depth - 5].
// The 16 root values after the last chunk: pend[depth] (K <= 32) or
// up[depth - 5], out of their lanes.
template <bool CHUNKED, int B>
__device__ __forceinline__ void tree_root(const Tree<B>& t, int depth,
                                          uint32_t (&res)[kVals]) {
  constexpr int V = Lanes<B>::V;
  uint32_t root[V];
  if constexpr (CHUNKED) {
#pragma unroll
    for (int L = 1; L < kUp; ++L)
      if (L == depth - kChunkDepth) {
#pragma unroll
        for (int k = 0; k < V; ++k) root[k] = t.up[L][k];
      }
  } else {
#pragma unroll
    for (int L = 1; L <= kChunkDepth; ++L)
      if (L == depth) {
#pragma unroll
        for (int k = 0; k < V; ++k) root[k] = t.pend[L][k];
      }
  }
  Lanes<B>::unpack(root, res);
}

// ---------------------------------------------------------------------------
// popcount route
// ---------------------------------------------------------------------------

template <int VW>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&v)[VW]) {
  if constexpr (VW == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (VW == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

// Counts of one unit for a thread's 4 windows x 4 outputs.  X rows are
// [leaf][word] per window (stride x_stride words); W rows are [unit word]
// [output] (stride ot words), so the thread's 4 outputs are one uint4.
template <int WD, int PACK>
struct PopcSrc {
  const uint32_t* xrow[kRm];
  const uint32_t* wcol;   // W row of the chunk's first unit word, + 4 q
  int ot;
  int wd;                 // words per stream (WD == 0)

  template <int U>
  __device__ __forceinline__ void count(uint32_t (&cnt)[kVals]) const {
    if constexpr (PACK > 1) {          // Wd = 1: PACK leaves per word
      constexpr int S = 32 / PACK;
      uint32_t xv[kRm];
#pragma unroll
      for (int i = 0; i < kRm; ++i) {
        uint32_t lv[PACK];
        if constexpr (PACK == 8) {
          uint32_t a[4], b[4];
          load_words<4>(xrow[i] + U * 8, a);
          load_words<4>(xrow[i] + U * 8 + 4, b);
#pragma unroll
          for (int j = 0; j < 4; ++j) { lv[j] = a[j]; lv[4 + j] = b[j]; }
        } else {
          load_words<PACK>(xrow[i] + U * PACK, lv);
        }
        uint32_t word = lv[0];
#pragma unroll
        for (int j = 1; j < PACK; ++j) word |= lv[j] << (j * S);
        xv[i] = word;
      }
      const uint4 w = *reinterpret_cast<const uint4*>(wcol + U * ot);
#pragma unroll
      for (int i = 0; i < kRm; ++i) {
        cnt[4 * i + 0] = __popc(xv[i] & w.x);
        cnt[4 * i + 1] = __popc(xv[i] & w.y);
        cnt[4 * i + 2] = __popc(xv[i] & w.z);
        cnt[4 * i + 3] = __popc(xv[i] & w.w);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVals; ++k) cnt[k] = 0u;
      if constexpr (WD > 0) {
        constexpr int VW = WD < 4 ? WD : 4;
#pragma unroll
        for (int v0 = 0; v0 < WD; v0 += VW) {
          uint32_t xv[kRm][VW];
#pragma unroll
          for (int i = 0; i < kRm; ++i)
            load_words<VW>(xrow[i] + U * WD + v0, xv[i]);
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            const uint4 w =
                *reinterpret_cast<const uint4*>(wcol + (U * WD + v0 + v) * ot);
#pragma unroll
            for (int i = 0; i < kRm; ++i) {
              cnt[4 * i + 0] += __popc(xv[i][v] & w.x);
              cnt[4 * i + 1] += __popc(xv[i][v] & w.y);
              cnt[4 * i + 2] += __popc(xv[i][v] & w.z);
              cnt[4 * i + 3] += __popc(xv[i][v] & w.w);
            }
          }
        }
      } else {
        for (int v = 0; v < wd; ++v) {
          const uint4 w =
              *reinterpret_cast<const uint4*>(wcol + (U * wd + v) * ot);
#pragma unroll
          for (int i = 0; i < kRm; ++i) {
            const uint32_t xw = xrow[i][U * wd + v];
            cnt[4 * i + 0] += __popc(xw & w.x);
            cnt[4 * i + 1] += __popc(xw & w.y);
            cnt[4 * i + 2] += __popc(xw & w.z);
            cnt[4 * i + 3] += __popc(xw & w.w);
          }
        }
      }
    }
  }
};

// WD: words per stream (0: a.Wd at run time); PACK: leaves per popcount
// (2, 4, 8 only at Wd = 1); CHUNKED: K > 32 (the TFF tree's upper stack).
template <int WD, int PACK, bool IDEAL, bool CHUNKED>
__global__ void __launch_bounds__(kMaxThreads, 1)
sc_dot_popc_kernel(const Args args) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Args a = subtree(args);
  const int wd = WD ? WD : a.Wd;
  const int lo = a.ot / kRo;              // output groups (lanes per window group)
  const int g = threadIdx.x / lo, q = threadIdx.x - g * lo;
  const bool active = g < a.groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  uint32_t* const ws = smem;
  uint32_t* const xs0 = smem + a.w_words;
  const int o_base = blockIdx.y * a.ot;
  const int O = a.O;
  const int kp = 1 << a.depth;
  const int nch_log = a.depth > kChunkDepth ? a.depth - kChunkDepth : 0;
  const int items = ((a.m_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x) << nch_log;
  const bool vec16 = (wd & 3) == 0 && !((uintptr_t)a.x & 15);
  // words of a staged row that the units read: zero past the chunk's leaves
  const int extent = max(min(kp, kChunk), PACK) * wd;

  auto issue = [&](int it) {
    const int c = it & ((1 << nch_log) - 1);
    const int m0 = ((int)blockIdx.x + (it >> nch_log) * (int)gridDim.x) * a.tm;
    const int k0 = c * kChunk;
    const int words = max(0, min(a.K - k0, kChunk)) * wd;
    const int rows = min(a.tm, a.M - m0);
    uint32_t* xs = xs0 + (it & 1) * a.stage_words;
    for (int r = warp; r < rows; r += nwarps) {
      uint32_t* dst = xs + r * a.x_stride;
      const uint32_t* src = a.x + ((long long)(m0 + r) * a.kx + k0) * wd;
      if (vec16) {
        for (int p = 4 * lane; p < words; p += 128) cp_async16(dst + p, src + p);
      } else {
        for (int p = lane; p < words; p += 32) cp_async4(dst + p, src + p);
      }
      for (int p = words + lane; p < extent; p += 32) dst[p] = 0u;
    }
  };

  if (items > 0) issue(0);
  cp_async_commit();
  // W of this CTA's columns, once: rows [unit word][ot], zero past K and O
  if constexpr (PACK == 1) {
    for (int row = warp; row < kp * wd; row += nwarps) {
      const int k = row / wd, v = row - k * wd;
      for (int o = lane; o < a.ot; o += 32) {
        const uint32_t* src = w_col(a, k, o_base + o, wd);
        if (src) cp_async4(ws + row * a.ot + o, src + v);
        else ws[row * a.ot + o] = 0u;
      }
    }
  } else {
    constexpr int S = 32 / PACK;
    const int units = max(kp, PACK) / PACK;
    for (int u = warp; u < units; u += nwarps) {
      for (int o = lane; o < a.ot; o += 32) {
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < PACK; ++j) {
          const uint32_t* src = w_col(a, u * PACK + j, o_base + o, 1);
          if (src) word |= *src << (j * S);
        }
        ws[u * a.ot + o] = word;
      }
    }
  }
  cp_async_commit();

  // the TFF tree's lanes: bytes at N <= 16, half-words up to N = 256
  constexpr int B = PACK == 2 ? 8 : 16;
  const uint32_t s_even = a.s_even * Lanes<B>::ONES;
  const uint32_t s_odd = a.s_odd * Lanes<B>::ONES;
  Tree<B> tree;
  uint32_t sum[kVals];
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) issue(it + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int c = it & ((1 << nch_log) - 1);
    if (active) {
      const uint32_t* xs = xs0 + (it & 1) * a.stage_words;
      PopcSrc<WD, PACK> src;
#pragma unroll
      for (int i = 0; i < kRm; ++i)
        src.xrow[i] = xs + (i * a.groups + g) * a.x_stride;
      src.ot = a.ot;
      src.wd = wd;
      src.wcol = ws + c * (kChunk / PACK) * (PACK == 1 ? wd : 1) * a.ot + kRo * q;
      const int live = min(a.K - c * kChunk, kChunk);
      constexpr int NU = kChunk / PACK;
      const int stop = min(max(kp, PACK) / PACK, NU);
      if constexpr (IDEAL) {
        if (c == 0) {
#pragma unroll
          for (int k = 0; k < kVals; ++k) sum[k] = 0u;
        }
        sum_units<0, NU, PACK>(src, sum, live);
      } else {
        const uint32_t s4 = (c & 1) ? s_odd : s_even;
        fold_units<PACK, 0, NU>(src, tree, live, stop, s_even, s_odd, s4);
        if constexpr (CHUNKED) fold_root(tree, c, a.c0 + c, s_even, s_odd);
      }
      if (c == (1 << nch_log) - 1) {
        uint32_t res[kVals];
        if constexpr (IDEAL) {
#pragma unroll
          for (int k = 0; k < kVals; ++k) res[k] = sum[k] >> a.shift;
        } else {
          tree_root<CHUNKED>(tree, a.depth, res);
        }
        const int m0 = ((int)blockIdx.x + (it >> nch_log) * (int)gridDim.x) * a.tm;
        const int o = o_base + kRo * q;
#pragma unroll
        for (int i = 0; i < kRm; ++i) {
          const int m = m0 + i * a.groups + g;
          if (m >= a.M) continue;
          int32_t* dst = a.out + (long long)m * O + o;
          if ((O & 3) == 0 && o + 3 < O) {
            *reinterpret_cast<int4*>(dst) =
                make_int4((int)res[4 * i], (int)res[4 * i + 1],
                          (int)res[4 * i + 2], (int)res[4 * i + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < kRo; ++j)
              if (o + j < O) dst[j] = res[4 * i + j];
          }
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// tensor-core route: Wd = 8, one m16n8k256 b1 AND-POPC per leaf and tile
// ---------------------------------------------------------------------------

// Shared memory (bytes): W [kp leaves][ot outputs][32] with the 16-byte
// halves of output o swapped when (o >> 2) & 1; an X stage [tm rows][cl
// leaves][32] with 16-byte slot (2 k + h) of row r stored at (2 k + h) ^
// (r & 7).  Both make ldmatrix's eight 16-byte rows fall in eight distinct
// bank groups.
template <int NT>
struct MmaSrc {
  static constexpr int MT = 4 / NT;
  unsigned a_row[MT];   // X stage address of this lane's ldmatrix row, slot 0
  int a_r6, a_hb;       // its swizzle: slot (2k + h) ^ rx = (2k ^ r6) + hb
  unsigned b_col;       // W address of this lane's ldmatrix row, leaf 0
  int leaf0;            // the chunk's first leaf
  int b_leaf_bytes;     // ot * 32

  // The 4 tiles' products of chunk leaf k, each added to its c[t].
  __device__ __forceinline__ void products(int k, int (&d)[4][4],
                                           const int (&c)[4][4]) const {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], a_row[mt] + (((2 * k) ^ a_r6) + a_hb) * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      ldsm_x2(b[nt], b_col + (leaf0 + k) * b_leaf_bytes + nt * 8 * 32);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_b1(d[mt * NT + nt], a[mt], b[nt], c[mt * NT + nt]);
  }

  template <int U>
  __device__ __forceinline__ void count(uint32_t (&cnt)[kVals]) const {
    const int zero[4][4] = {};
    int d[4][4];
    products(U, d, zero);
#pragma unroll
    for (int k = 0; k < kVals; ++k) cnt[k] = d[k / 4][k % 4];
  }
};

template <int NT, bool IDEAL, bool CHUNKED>
__global__ void __launch_bounds__(kMaxThreads, 1)
sc_dot_mma_kernel(const Args args) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Args a = subtree(args);
  constexpr int MT = 4 / NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int wo = a.ot / (NT * 8);         // warps along O
  const int wm_i = warp / wo, wo_i = warp - wm_i * wo;
  unsigned char* const wsb = reinterpret_cast<unsigned char*>(smem);
  uint32_t* const xs0 = smem + a.w_words;
  const int o_base = blockIdx.y * a.ot;
  const int O = a.O;
  const int kp = 1 << a.depth;
  const int cl = max(min(kp, kChunk), 4);     // staged leaves per row
  const int nch_log = a.depth > kChunkDepth ? a.depth - kChunkDepth : 0;
  const int items = ((a.m_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x) << nch_log;

  auto issue = [&](int it) {
    const int c = it & ((1 << nch_log) - 1);
    const int m0 = ((int)blockIdx.x + (it >> nch_log) * (int)gridDim.x) * a.tm;
    const int k0 = c * kChunk;
    const int live = max(0, min(a.K - k0, kChunk));
    const int rows = min(a.tm, a.M - m0);
    unsigned char* xs =
        reinterpret_cast<unsigned char*>(xs0 + (it & 1) * a.stage_words);
    for (int r = warp; r < rows; r += nwarps) {
      unsigned char* dst = xs + r * cl * 32;
      const uint32_t* src = a.x + ((long long)(m0 + r) * a.kx + k0) * 8;
      for (int p = lane; p < 2 * cl; p += 32) {
        void* d = dst + ((p ^ (r & 7)) * 16);
        if (p < 2 * live) cp_async16(d, src + 4 * p);
        else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  if (items > 0) issue(0);
  cp_async_commit();
  for (int k = warp; k < kp; k += nwarps) {
    for (int p = lane; p < 2 * a.ot; p += 32) {
      const int o = p >> 1, h = p & 1;
      void* d = wsb + (k * a.ot + o) * 32 + ((h ^ ((o >> 2) & 1)) * 16);
      const uint32_t* src = w_col(a, k, o_base + o, 8);
      if (src) cp_async16(d, src + 4 * h);
      else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();

  // this lane's ldmatrix rows: A rows (l & 7) + 8 ((l >> 3) & 1) of each
  // m-tile, half l >> 4; B outputs (l & 7) of each n-tile, half (l >> 3) & 1
  MmaSrc<NT> src;
  {
    const int rx = lane & 7, h = lane >> 4;
    src.a_r6 = rx & 6;
    src.a_hb = (h ^ rx) & 1;
    const int ob = wo_i * NT * 8 + (lane & 7), hb = (lane >> 3) & 1;
    src.b_col = smem_u32(wsb) + ob * 32 + ((hb ^ ((ob >> 2) & 1)) * 16);
    src.b_leaf_bytes = a.ot * 32;
  }
  Tree<16> tree;     // counts of 256-bit streams: half-word lanes
  const uint32_t s_even = a.s_even * Lanes<16>::ONES;
  const uint32_t s_odd = a.s_odd * Lanes<16>::ONES;
  int acc[4][4];
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) issue(it + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int c = it & ((1 << nch_log) - 1);
    if (wm_i < a.groups) {
      const unsigned xs = smem_u32(xs0 + (it & 1) * a.stage_words);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm_i * MT * 16 + mt * 16 + ((lane >> 3) & 1) * 8 +
                        (lane & 7);
        src.a_row[mt] = xs + row * cl * 32;
      }
      src.leaf0 = c * kChunk;
      const int live = min(a.K - c * kChunk, kChunk);
      if constexpr (IDEAL) {
        if (c == 0) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[t][f] = 0;
        }
        for (int k = 0; k < live; ++k) src.products(k, acc, acc);
      } else {
        const uint32_t s4 = (c & 1) ? s_odd : s_even;
        const int stop = min(kp, kChunk);
        fold_units<1, 0, kChunk>(src, tree, live, stop, s_even, s_odd, s4);
        if constexpr (CHUNKED) fold_root(tree, c, a.c0 + c, s_even, s_odd);
      }
      if (c == (1 << nch_log) - 1) {
        uint32_t res[kVals];
        if constexpr (IDEAL) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int f = 0; f < 4; ++f) res[4 * t + f] = acc[t][f] >> a.shift;
        } else {
          tree_root<CHUNKED>(tree, a.depth, res);
        }
        const int m0 = ((int)blockIdx.x + (it >> nch_log) * (int)gridDim.x) * a.tm;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int m = m0 + wm_i * MT * 16 + mt * 16 + (lane >> 2) + 8 * hf;
              const int o = o_base + wo_i * NT * 8 + nt * 8 + 2 * (lane & 3);
              const uint32_t* v = &res[(mt * NT + nt) * 4 + 2 * hf];
              if (m >= a.M) continue;
              int32_t* dst = a.out + (long long)m * O + o;
              if ((O & 1) == 0 && o + 1 < O) {
                *reinterpret_cast<int2*>(dst) = make_int2((int)v[0], (int)v[1]);
              } else {
                if (o < O) dst[0] = v[0];
                if (o + 1 < O) dst[1] = v[1];
              }
            }
      }
    }
    __syncthreads();
  }
}

// The card's b1 AND-POPC rate, which no data sheet gives for the H100: each
// warp runs ``iters`` rounds of 8 independent m16n8k256 products (no loads)
// and writes one checksum per thread (chip_smoke.py times it).
__global__ void b1_peak_kernel(int32_t* out, int iters) {
  const uint32_t t = threadIdx.x;
  const uint32_t a[4] = {t, t * 3u, ~t, t ^ 0x5555u};
  const uint32_t b[2] = {t * 7u, ~t * 5u};
  int acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[j][f] = 0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_b1(acc[j], a, b, acc[j]);
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int f = 0; f < 4; ++f) sum += acc[j][f];
  out[blockIdx.x * blockDim.x + t] = sum;
}

// The upper levels of a tree of more than 1,024 leaves: part holds the
// roots of its ``live`` leading subtrees, one (M, O) plane each (n = M * O
// values); the ``1 << levels`` subtrees sit at level 10, and root j is node
// j there.  Each thread folds one output's roots as they stream in, with a
// stack of pending left siblings whose levels are compile-time indices
// (the carry runs predicated, as in fold_root); subtrees past ``live`` are
// zero roots.  The ideal adder (shift >= 0) sums the partial sums instead
// and shifts by the whole tree's depth.
__global__ void __launch_bounds__(256)
sc_dot_fold_kernel(const int32_t* __restrict__ part, int32_t* __restrict__ out,
                   long long n, int live, int levels, int s_even, int s_odd,
                   int shift) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (shift >= 0) {
    uint32_t sum = 0u;
    for (int j = 0; j < live; ++j) sum += (uint32_t)part[j * n + i];
    out[i] = (int32_t)(sum >> shift);
    return;
  }
  int up[kMaxFold + 1];
#pragma unroll
  for (int L = 0; L <= kMaxFold; ++L) up[L] = 0;
  for (int j = 0; j < (1 << levels); ++j) {
    int node = j < live ? part[j * n + i] : 0;
    int c = j;
    bool carry = true;
#pragma unroll
    for (int L = 0; L <= kMaxFold; ++L) {
      if (carry && !(c & 1)) {
        up[L] = node;
        carry = false;
      } else if (carry) {
        const int s = (((c >> 1) + kMaxDepth + L) & 1) ? s_odd : s_even;
        node = (up[L] + node + s) >> 1;
        c >>= 1;
      }
    }
  }
  int root = 0;
#pragma unroll
  for (int L = 0; L <= kMaxFold; ++L)
    if (L == levels) root = up[L];
  out[i] = root;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// One launch of ``kernel``, or with ``a.sub`` one per 65,535 subtrees
// (grid.z), on ``grid``'s x and y.
template <class Kernel>
cudaError_t run(Kernel kernel, const Args& a, dim3 grid, int threads,
                int smem, cudaStream_t s, bool& ready) {
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  if (!a.sub) {
    kernel<<<grid, threads, smem, s>>>(a);
    return cudaGetLastError();
  }
  const int live = (a.kx + (1 << kMaxDepth) - 1) >> kMaxDepth;
  Args b = a;
  for (b.z0 = 0; b.z0 < live; b.z0 += kMaxGridZ) {
    grid.z = min(kMaxGridZ, live - b.z0);
    kernel<<<grid, threads, smem, s>>>(b);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int WD, int PACK, bool IDEAL, bool CHUNKED>
cudaError_t popc(const Args& a, dim3 grid, int threads, int smem,
                 cudaStream_t s) {
  static bool ready = false;
  return run(sc_dot_popc_kernel<WD, PACK, IDEAL, CHUNKED>, a, grid, threads,
             smem, s, ready);
}

template <int NT, bool IDEAL, bool CHUNKED>
cudaError_t mma(const Args& a, dim3 grid, int threads, int smem,
                cudaStream_t s) {
  static bool ready = false;
  return run(sc_dot_mma_kernel<NT, IDEAL, CHUNKED>, a, grid, threads, smem, s,
             ready);
}

template <bool CHUNKED>
cudaError_t popc_tff(const Args& a, int pack, dim3 grid, int threads, int smem,
                     cudaStream_t s) {
  if (pack == 2) return popc<1, 2, false, CHUNKED>(a, grid, threads, smem, s);
  switch (a.Wd) {
    case 2: return popc<2, 1, false, CHUNKED>(a, grid, threads, smem, s);
    case 4: return popc<4, 1, false, CHUNKED>(a, grid, threads, smem, s);
    case 8: return popc<8, 1, false, CHUNKED>(a, grid, threads, smem, s);
    default: return popc<0, 1, false, CHUNKED>(a, grid, threads, smem, s);
  }
}

cudaError_t popc_ideal(const Args& a, int pack, dim3 grid, int threads,
                       int smem, cudaStream_t s) {
  switch (pack) {
    case 8: return popc<1, 8, true, false>(a, grid, threads, smem, s);
    case 4: return popc<1, 4, true, false>(a, grid, threads, smem, s);
    case 2: return popc<1, 2, true, false>(a, grid, threads, smem, s);
    default: break;
  }
  switch (a.Wd) {
    case 2: return popc<2, 1, true, false>(a, grid, threads, smem, s);
    case 4: return popc<4, 1, true, false>(a, grid, threads, smem, s);
    case 8: return popc<8, 1, true, false>(a, grid, threads, smem, s);
    default: return popc<0, 1, true, false>(a, grid, threads, smem, s);
  }
}

template <int NT>
cudaError_t mma_mode(const Args& a, bool ideal, dim3 grid, int threads,
                     int smem, cudaStream_t s) {
  if (ideal) return mma<NT, true, false>(a, grid, threads, smem, s);
  if (a.depth > kChunkDepth) return mma<NT, false, true>(a, grid, threads, smem, s);
  return mma<NT, false, false>(a, grid, threads, smem, s);
}

}  // namespace

// Plan entries (kernels/sc_dot.py, sc_dot_plan), in this order.
enum PlanField { kThreads, kGridX, kGridY, kOt, kGroups, kTm, kXStride,
                 kWWords, kStageWords, kSmem, kNt, kPlanFields };

// mode: 0 = tff s0 zero, 1 = tff s0 one, 2 = tff s0 alt, 3 = ideal adder.
// pack: leaves per popcount (2 only for Wd = 1 streams of N <= 16 bits; the
// ideal adder also 4, 8); mma: 1 for the tensor-core route (Wd = 8, every
// operand 16-byte aligned, K <= 1,024).  K > 1,024 takes ``part``, room for
// ceil(K / 1,024) planes of M x O int32 partial roots, and a plan made for
// K = 1,024; the subtrees' launch is followed by the fold's.  Returns
// cudaGetLastError() after the launches.
extern "C" int sc_dot_launch(const void* x, const void* w, void* out,
                             void* part, int M, int K, int O, int Wd,
                             int mode, int pack, int mma_route,
                             const int* plan, void* stream) {
  int depth = 1;
  while ((1 << depth) < K) ++depth;
  const bool sub = depth > kMaxDepth;
  const int nt = plan[kNt];
  const bool bad_shape = M <= 0 || K < 1 || O <= 0 || Wd < 1 || Wd > kMaxWd ||
                         mode < kZero || mode > kIdeal ||
                         depth > kMaxDepth + kMaxFold ||
                         (sub && (part == nullptr || mma_route)) ||
                         (long long)M * O >= (1ll << 31);
  const bool bad_pack = pack != 1 && (Wd != 1 || (mode != kIdeal && pack != 2) ||
                                      (pack != 2 && pack != 4 && pack != 8));
  const bool bad_plan =
      plan[kThreads] < 32 || plan[kThreads] > kMaxThreads ||
      plan[kThreads] % 32 || plan[kSmem] > kSmemMax || plan[kGridX] < 1 ||
      plan[kGridY] < 1 || plan[kGridY] > 65535 || plan[kTm] < 1 ||
      (long long)plan[kGridY] * plan[kOt] < O ||
      (mma_route ? (Wd != 8 || pack != 1 || (nt != 1 && nt != 2 && nt != 4) ||
                    plan[kOt] % (8 * nt) ||
                    plan[kGroups] * (plan[kOt] / (8 * nt)) * 32 !=
                        plan[kThreads] ||
                    plan[kTm] != plan[kGroups] * (64 / nt) ||
                    (((uintptr_t)x | (uintptr_t)w) & 15))
                 : (plan[kOt] % kRo ||
                    plan[kGroups] * (plan[kOt] / kRo) > plan[kThreads] ||
                    plan[kTm] != plan[kGroups] * kRm || plan[kXStride] % 4));
  if (bad_shape || bad_pack || bad_plan) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const uint32_t*)x;
  a.w = (const uint32_t*)w;
  a.out = (int32_t*)(sub ? part : out);
  a.M = M; a.O = O; a.Wd = Wd;
  a.K = sub ? 1 << kMaxDepth : K;
  a.kx = K;
  a.s_even = mode == kOne ? 1 : 0;
  a.s_odd = mode == kZero ? 0 : 1;
  a.depth = sub ? kMaxDepth : depth;
  a.shift = sub ? 0 : depth;
  a.sub = sub;
  a.z0 = 0;
  a.c0 = 0;
  a.ot = plan[kOt];
  a.groups = plan[kGroups];
  a.tm = plan[kTm];
  a.x_stride = plan[kXStride];
  a.w_words = plan[kWWords];
  a.stage_words = plan[kStageWords];
  a.m_tiles = (M + a.tm - 1) / a.tm;
  if (plan[kGridX] > a.m_tiles) return (int)cudaErrorInvalidValue;
  const dim3 grid(plan[kGridX], plan[kGridY]);
  const int threads = plan[kThreads], smem = plan[kSmem];
  const cudaStream_t s = (cudaStream_t)stream;
  const bool ideal = mode == kIdeal;
  cudaError_t e;
  if (mma_route) {
    switch (nt) {
      case 1: e = mma_mode<1>(a, ideal, grid, threads, smem, s); break;
      case 2: e = mma_mode<2>(a, ideal, grid, threads, smem, s); break;
      default: e = mma_mode<4>(a, ideal, grid, threads, smem, s); break;
    }
  } else if (ideal) {
    e = popc_ideal(a, pack, grid, threads, smem, s);
  } else {
    e = a.depth > kChunkDepth ? popc_tff<true>(a, pack, grid, threads, smem, s)
                              : popc_tff<false>(a, pack, grid, threads, smem, s);
  }
  if (e != cudaSuccess || !sub) return (int)e;
  const long long n = (long long)M * O;
  const int live = (K + (1 << kMaxDepth) - 1) >> kMaxDepth;
  sc_dot_fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const int32_t*)part, (int32_t*)out, n, live, depth - kMaxDepth,
      a.s_even, a.s_odd, ideal ? depth : -1);
  return (int)cudaGetLastError();
}

// The b1 rate probe: ``ctas`` x ``threads`` threads, ``iters`` rounds of 8
// MMAs per warp; out holds ctas * threads ints.
extern "C" int sc_dot_b1_peak_launch(void* out, int ctas, int threads,
                                     int iters, void* stream) {
  if (ctas < 1 || threads < 32 || threads > 1024 || threads % 32 || iters < 1)
    return (int)cudaErrorInvalidValue;
  b1_peak_kernel<<<ctas, threads, 0, (cudaStream_t)stream>>>((int32_t*)out,
                                                             iters);
  return (int)cudaGetLastError();
}
