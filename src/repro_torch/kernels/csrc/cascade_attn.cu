// Cascade decode kernels for Hopper (sm_90a): the shared-prefix pass of a
// group of decode lanes, and the log-sum-exp merge of two partial softmax
// states.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attn.py:
//   cascade_prefix_attention (_cascade_prefix_kernel) -> cascade_prefix_launch
//   merge_attn_states        (_merge_kernel)          -> merge_states_launch,
//                                                        and over S states
//                                                        merge_states_n_launch
// The prefix pass is templated on float and __nv_bfloat16 (the arena's
// dtype); the merge works on float32 states.  Built without fast math: the
// constants below must behave as the reference's (exp(-1e30 - m) is exactly
// 0, exp(0) exactly 1, and the division is IEEE).
//
// cascade_prefix_launch
//   qg (G, Lc, Hq, D) the query rows of each group's Lc lanes; arenas
//   (num_blocks, bs, Hkv, D); group_tables (G, npre) int32 chain block ids;
//   group_len (G,) int32 chain tokens; lane_lens (G, Lc) int32 each lane's
//   length.  Position pos of the chain attends for lane c when
//   pos < group_len[g] and pos >= lane_lens[g, c] - win.  Writes the float32
//   online-softmax state acc (G, Lc, Hq, D), m, l (G, Lc, Hq), unnormalized;
//   a query with no valid position keeps the empty state (acc 0, m -1e30,
//   l 0).
//
//   Bound on the H100: bytes.  The point of the pass is that each chain row
//   is read from device memory once per group, not once per lane, and used
//   for all Lc * n_rep queries of its KV head (about 1 flop per byte per
//   query).  Design: grid (Hkv * tiles, G, splits).  The nq = Lc * n_rep
//   queries of a KV head go to one CTA when their shared memory fits, else
//   to the fewest equal tiles of queries that fit (a large group, or GQA at
//   D = 128), each tile sweeping the chain on its own: load (c)'s eight
//   lanes are one tile, 64 stablelm-3b lanes two.  Split z
//   covers the chain's run of table entries [z*bps, (z+1)*bps), whole
//   blocks; the plan (the wrapper's cascade_split_plan) is a function of
//   the shapes alone, so the wrapper never reads group_len or lane_lens on
//   the host.  At one group of stablelm-3b's 32 KV heads over a
//   1,024-position chain it is 8 runs of 128 positions, 256 CTAs on 132
//   SMs.  A CTA whose run holds no position that one of its tile's lanes
//   attends reads nothing of the chain and writes the empty state.  In the
//   CTA, 256 threads walk the run's positions that the tile's lanes attend
//   in chunks of 64 through a two-stage ring of cp.async copies
//   (attn::cp_async16; only the attended K and V rows, a thread per row
//   reading the table once): the first two chunks are issued before the
//   rest of the prologue, and chunk c + 2 as soon as chunk c is consumed,
//   so a chunk's loads overlap the previous chunk's arithmetic.  The ring's
//   rows that no chunk has written start zeroed.  Rows are padded by 16
//   bytes, so the score loop's lanes, each reading another row at the same
//   column, hit distinct banks.  Scores: thread (t, g) scores position t
//   for queries g, g + 4, ..., two at a time, each K vector read once for
//   both, with float32 FMAs; only positions in the query's window.  By
//   count the scores are about 40 % of a chunk's instructions and the
//   value product about half, so the scores stay off the tensor cores.
//   Online softmax: a warp per query; a position outside its window, or
//   past the chunk, gets p = 0.  Value product on float32 FMAs with the
//   unrounded float32 probabilities (as the TPU kernel): warp w takes the
//   chunk's positions [8w, 8w + 8), holds their V values at its lane's
//   four columns in registers, and adds them for every query, two queries
//   at a time, into its own float partial accumulator in shared memory;
//   the eight partials are summed in warp order at the end.  With splits >
//   1 each CTA writes its state to scratch and the combine launch
//   (attn::combine_states, attn_common.cuh, with the state epilogue)
//   merges the splits in split order into acc, m, l; at one split the CTAs
//   write them directly.  Positions outside every window of the CTA's
//   lanes are never read, so garbage in the trash block (padded table
//   entries) or past group_len cannot reach a result.  A table entry
//   outside [0, num_blocks) reads block 0.  No atomics: bit for bit
//   reproducible.
//
// merge_states_launch
//   acc1, acc2 (rows, D) and m1, l1, m2, l2 (rows,) float32:
//   out = (c1 acc1 + c2 acc2) / max(c1 l1 + c2 l2, 1e-30), with
//   m = max(m1, m2), c = exp(m_side - m) (attn::merge_two), one thread per
//   element.  An empty side (m = -1e30, l = 0, acc = 0) drops out exactly;
//   two empty sides give zeros.  Bound: bytes (about 0.25 MB at
//   stablelm-3b's eight lanes), so its time is the launch.  The cascade
//   tick does not launch it: its merge runs in the epilogue of the suffix
//   pass (paged_attn.cu, paged_attn_merge_launch), through the same
//   attn::merge_two, so this kernel, the TPU function's own API, gives the
//   fused pass's values bit for bit.
//
// merge_states_n_launch
//   The same merge over S >= 2 states stacked on a leading axis, acc (S,
//   rows, D), m, l (S, rows) float32: M = max_s m_s, out = sum_s exp(m_s -
//   M) acc_s / max(sum_s exp(m_s - M) l_s, 1e-30), the sums in s order
//   (attn::combine_states, the normalizing epilogue of the split sweeps'
//   combine launch), one CTA a row.  The split-KV fallback of a sharded
//   serving slice merges its shards' suffix states through it when there
//   are more than two.  Bound: bytes, as above.
#include "attn_common.cuh"

namespace {

using attn::kNegInf;
using attn::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                       // positions per ring stage
constexpr int kTW = kChunk / kWarps;             // positions a warp adds
constexpr int kQG = kThreads / kChunk;           // query groups in scores
constexpr size_t kMaxSmem = 227 * 1024;

// Dot products of two float query rows with one staged K row of D
// elements, each 16-byte vector of K read once for both.
__device__ __forceinline__ void row_dot2(const float* q0, const float* q1,
                                         const float* k, int D, float& s0,
                                         float& s1) {
  s0 = s1 = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 b = *reinterpret_cast<const float4*>(k + d);
    const float4 x = *reinterpret_cast<const float4*>(q0 + d);
    const float4 y = *reinterpret_cast<const float4*>(q1 + d);
    s0 += x.x * b.x + x.y * b.y + x.z * b.z + x.w * b.w;
    s1 += y.x * b.x + y.y * b.y + y.z * b.z + y.w * b.w;
  }
}
__device__ __forceinline__ void row_dot2(const float* q0, const float* q1,
                                         const __nv_bfloat16* k, int D,
                                         float& s0, float& s1) {
  s0 = s1 = 0.f;
  for (int d = 0; d < D; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 b0 = __bfloat1622float2(h[0]), b1 = __bfloat1622float2(h[1]);
    const float2 b2 = __bfloat1622float2(h[2]), b3 = __bfloat1622float2(h[3]);
    const float4 x0 = *reinterpret_cast<const float4*>(q0 + d);
    const float4 x1 = *reinterpret_cast<const float4*>(q0 + d + 4);
    const float4 y0 = *reinterpret_cast<const float4*>(q1 + d);
    const float4 y1 = *reinterpret_cast<const float4*>(q1 + d + 4);
    s0 += x0.x * b0.x + x0.y * b0.y + x0.z * b1.x + x0.w * b1.y +
          x1.x * b2.x + x1.y * b2.y + x1.z * b3.x + x1.w * b3.y;
    s1 += y0.x * b0.x + y0.y * b0.y + y0.z * b1.x + y0.w * b1.y +
          y1.x * b2.x + y1.y * b2.y + y1.z * b3.x + y1.w * b3.y;
  }
}

// Four adjacent elements of a staged V row as floats.
__device__ __forceinline__ float4 quad_f32(const float* v) {
  return *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ float4 quad_f32(const __nv_bfloat16* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(v);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc * cr plus the warp's kTW positions' p[u] * v[u] (float32 FMAs).
__device__ __forceinline__ float4 add_positions(float4 acc, float cr,
                                                const float* p,
                                                const float4* v) {
  acc.x *= cr;
  acc.y *= cr;
  acc.z *= cr;
  acc.w *= cr;
#pragma unroll
  for (int u = 0; u < kTW; u += 4) {
    const float4 p4 = *reinterpret_cast<const float4*>(p + u);
    const float pu[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc.x = fmaf(pu[i], v[u + i].x, acc.x);
      acc.y = fmaf(pu[i], v[u + i].y, acc.y);
      acc.z = fmaf(pu[i], v[u + i].z, acc.z);
      acc.w = fmaf(pu[i], v[u + i].w, acc.w);
    }
  }
  return acc;
}

// Row pitch of a staged K or V row in elements: D plus 16 bytes.
__host__ __device__ inline int row_pitch(int D, int elem) {
  return D + 16 / elem;
}

// Lanes a tile of qt queries touches at most.
__host__ __device__ inline int tile_lanes(int qt, int n_rep) {
  return (qt - 1) / n_rep + 2;
}

// Shared memory of a tile of qt queries, in order: the ring, 2 stages x (K
// [kChunk][P], V [kChunk][P]) in the arena's dtype; then float q [qt][D],
// scores [qt][kChunk], per-warp accumulators [kWarps][qt][D], m, l, corr
// [qt]; and int lo [tile_lanes] (each lane's first attending position).
size_t prefix_smem_bytes(int elem, int D, int qt, int n_rep) {
  return (size_t)4 * kChunk * row_pitch(D, elem) * elem +
         sizeof(float) * ((size_t)qt * D + (size_t)qt * kChunk +
                          (size_t)kWarps * qt * D + 3 * (size_t)qt) +
         sizeof(int) * (size_t)tile_lanes(qt, n_rep);
}

// Queries per tile: all nq when they fit, else the fewest equal tiles that
// fit; 0 when not even one query fits.
int prefix_query_tile(int elem, int D, int nq, int n_rep) {
  int fit = 0;
  for (int lo = 1, hi = nq; lo <= hi;) {        // largest qt that fits
    const int mid = lo + (hi - lo) / 2;
    if (prefix_smem_bytes(elem, D, mid, n_rep) <= kMaxSmem)
      fit = mid, lo = mid + 1;
    else
      hi = mid - 1;
  }
  if (fit == 0) return 0;
  const int tiles = (nq + fit - 1) / fit;
  return (nq + tiles - 1) / tiles;
}

// Query qi = c * n_rep + r is lane c's query head h * n_rep + r; the CTA
// takes queries [tile*QT, tile*QT + QT) of them.  Split z sweeps chain
// positions [z*P_split, (z+1)*P_split) and writes its state at
// acc_out + z*R*D, m_out + z*R, l_out + z*R (R = G*Lc*Hq rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cascade_prefix_kernel(const T* __restrict__ qg, const T* __restrict__ ka,
                      const T* __restrict__ va,
                      const int32_t* __restrict__ gtables,
                      const int32_t* __restrict__ glen,
                      const int32_t* __restrict__ lane_lens,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int num_blocks, int bs,
                      int npre, int Lc, int Hkv, int n_rep, int D, int win,
                      int P_split, int QT) {
  constexpr int kVec = 16 / sizeof(T);           // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % Hkv, g = blockIdx.y, z = blockIdx.z;
  const int G = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = row_pitch(D, (int)sizeof(T));
  const int Hq = Hkv * n_rep;
  // the tile: queries [q_base, q_base + nq) of the KV head, lanes
  // [c_first, c_first + n_lanes)
  const int q_base = (blockIdx.x / Hkv) * QT;
  const int nq = min(QT, Lc * n_rep - q_base);
  const int c_first = q_base / n_rep;
  const int n_lanes = (q_base + nq - 1) / n_rep - c_first + 1;
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(ring + (size_t)4 * kChunk * P);
  float* ss = qs + (size_t)nq * D;
  float* accw = ss + (size_t)nq * kChunk;
  float* ms = accw + (size_t)kWarps * nq * D;
  float* ls = ms + nq;
  float* corr = ls + nq;
  int* lo_s = reinterpret_cast<int*>(corr + nq);
  // the tile's local query qi is lane lane_of(qi)'s query head h*n_rep + r
  auto lane_of = [&](int qi) { return (q_base + qi) / n_rep - c_first; };

  // positions [lo, hi) of the split that some lane of the tile attends,
  // read by every thread straight from global memory, so the first two
  // chunks' loads start before the rest of the prologue
  const int hi = min(min(glen[g], npre * bs), (z + 1) * P_split);
  int lo = npre * bs;
  for (int c = c_first; c < c_first + n_lanes; ++c)
    lo = min(lo, max(0, lane_lens[(size_t)g * Lc + c] - win));
  lo = max(lo, z * P_split);
  const int n_chunks = hi > lo ? (hi - lo + kChunk - 1) / kChunk : 0;
  const float scale = 1.f / sqrtf((float)D);
  const int vpr = D / kVec;                      // 16-byte vectors per row
  const size_t row_stride = (size_t)Hkv * D;     // elements between rows
  auto rows_of = [&](int c) { return min(kChunk, hi - (lo + c * kChunk)); };

  // chunk c's K and V rows into ring stage c & 1: a thread copies whole
  // rows, so the table is read once per row
  auto issue = [&](int c) {
    const int c0 = lo + c * kChunk, n = rows_of(c);
    T* ks = ring + (size_t)(c & 1) * 2 * kChunk * P;
    for (int i = tid; i < 2 * n; i += kThreads) {
      const int which = i >= n;                  // 0: K, 1: V
      const int t = i - which * n, pos = c0 + t;
      int bid = gtables[(size_t)g * npre + pos / bs];
      if (bid < 0 || bid >= num_blocks) bid = 0;
      const T* src = (which ? va : ka) +
                     ((size_t)bid * bs + pos % bs) * row_stride +
                     (size_t)h * D;
      T* dst = ks + ((size_t)which * kChunk + t) * P;
      for (int vec = 0; vec < vpr; ++vec)
        attn::cp_async16(dst + vec * kVec, src + vec * kVec);
    }
    attn::cp_async_commit();
  };
  if (n_chunks > 0) issue(0);
  if (n_chunks > 1) issue(1);

  // the ring's rows that the first two chunks leave unwritten start
  // zeroed (disjoint from the rows in flight): a short chunk's rows past n
  // hold zeros or an earlier chunk's rows, finite either way, which the
  // value product runs over with p = 0 (fixed trip counts)
  for (int st = 0; st < 2; ++st) {
    const int n = st < n_chunks ? rows_of(st) : 0;
    T* stage = ring + (size_t)st * 2 * kChunk * P;
    for (int i = tid; i < 2 * (kChunk - n) * P / kVec; i += kThreads) {
      const int half = (kChunk - n) * P / kVec;  // vectors per K or V part
      const int which = i >= half, j = i - which * half;
      reinterpret_cast<uint4*>(stage + ((size_t)which * kChunk + n) * P)[j] =
          make_uint4(0, 0, 0, 0);
    }
  }
  for (int i = tid; i < nq * D; i += kThreads) {
    const int qi = i / D, d = i - qi * D;
    const int c = (q_base + qi) / n_rep, r = q_base + qi - c * n_rep;
    qs[i] = to_f32(qg[(((size_t)g * Lc + c) * Hq + (size_t)h * n_rep + r) *
                          D + d]);
  }
  for (int i = tid; i < kWarps * nq * D; i += kThreads) accw[i] = 0.f;
  for (int qi = tid; qi < nq; qi += kThreads) {
    ms[qi] = kNegInf;
    ls[qi] = 0.f;
  }
  for (int c = tid; c < n_lanes; c += kThreads)
    lo_s[c] = max(0, lane_lens[(size_t)g * Lc + c_first + c] - win);

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks)
      attn::cp_async_wait<1>();
    else
      attn::cp_async_wait<0>();
    __syncthreads();                             // chunk c has landed
    const int c0 = lo + c * kChunk, n = rows_of(c);
    const T* ks = ring + (size_t)(c & 1) * 2 * kChunk * P;
    const T* vs = ks + (size_t)kChunk * P;
    // scores: thread (t, g) = (tid % kChunk, tid / kChunk) scores position
    // t for queries g, g + kQG, ..., two at a time, each K vector read
    // once for both; only positions in the query's window
    {
      const int t = tid % kChunk;
      const T* kr = ks + (size_t)t * P;
      for (int qi = tid / kChunk; qi < nq; qi += 2 * kQG) {
        const int qj = qi + kQG;
        const bool a = t < n && c0 + t >= lo_s[lane_of(qi)];
        const bool b = qj < nq && t < n && c0 + t >= lo_s[lane_of(qj)];
        if (!a && !b) continue;
        float s0, s1;
        row_dot2(qs + (size_t)qi * D, qs + (size_t)(b ? qj : qi) * D, kr, D,
                 s0, s1);
        if (a) ss[(size_t)qi * kChunk + t] = s0 * scale;
        if (b) ss[(size_t)qj * kChunk + t] = s1 * scale;
      }
    }
    __syncthreads();
    // online softmax: a warp per query; positions outside its window or
    // past n get p = 0
    for (int qi = warp; qi < nq; qi += kWarps) {
      const int t_lo = lo_s[lane_of(qi)] - c0;
      float* sq = ss + (size_t)qi * kChunk;
      float x[kChunk / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kChunk / 32; ++i) {
        const int t = lane + 32 * i;
        x[i] = t < n && t >= t_lo ? sq[t] : kNegInf;
        mx = fmaxf(mx, x[i]);
      }
      mx = attn::warp_max(mx);
      const float m_prev = ms[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kChunk / 32; ++i) {
        const int t = lane + 32 * i;
        const float p = t < n && t >= t_lo ? expf(x[i] - m_new) : 0.f;
        sq[t] = p;
        sum += p;
      }
      sum = attn::warp_sum(sum);
      if (lane == 0) {
        const float cr = expf(m_prev - m_new);
        corr[qi] = cr;
        ls[qi] = ls[qi] * cr + sum;
        ms[qi] = m_new;
      }
    }
    __syncthreads();
    // value product: warp w adds positions [t0, t0 + kTW) for every query;
    // a lane holds their V values at its four columns (D % 4 == 0)
    const int t0 = warp * kTW;
    for (int j = 4 * lane; j < D; j += 128) {
      float4 v[kTW];
#pragma unroll
      for (int u = 0; u < kTW; ++u)
        v[u] = quad_f32(vs + (size_t)(t0 + u) * P + j);
      // two queries at a time, so their chains interleave
      for (int qi = 0; qi < nq; qi += 2) {
        float4* a = reinterpret_cast<float4*>(
            accw + ((size_t)warp * nq + qi) * D + j);
        const float* pq = ss + (size_t)qi * kChunk + t0;
        if (qi + 1 < nq) {
          const float4 x = a[0], y = a[D / 4];
          const float4 nx = add_positions(x, corr[qi], pq, v);
          const float4 ny = add_positions(y, corr[qi + 1], pq + kChunk, v);
          a[0] = nx;
          a[D / 4] = ny;
        } else {
          a[0] = add_positions(a[0], corr[qi], pq, v);
        }
      }
    }
    __syncthreads();                             // stage c & 1 consumed
    if (c + 2 < n_chunks) issue(c + 2);
  }
  __syncthreads();                               // with no chunk: the init

  const size_t R = (size_t)G * Lc * Hq;
  for (int e = tid; e < nq * D; e += kThreads) {
    const int qi = e / D, d = e - qi * D;
    const int c = (q_base + qi) / n_rep, r = q_base + qi - c * n_rep;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += accw[((size_t)w * nq + qi) * D + d];
    acc_out[((size_t)z * R + ((size_t)g * Lc + c) * Hq + (size_t)h * n_rep +
             r) * D + d] = a;
  }
  for (int qi = tid; qi < nq; qi += kThreads) {
    const int c = (q_base + qi) / n_rep, r = q_base + qi - c * n_rep;
    const size_t o =
        (size_t)z * R + ((size_t)g * Lc + c) * Hq + (size_t)h * n_rep + r;
    m_out[o] = ms[qi];
    l_out[o] = ls[qi];
  }
}

template <typename T>
cudaError_t prefix_launch(const void* qg, const void* ka, const void* va,
                          const void* gtables, const void* glen,
                          const void* lane_lens, void* acc_out, void* m_out,
                          void* l_out, void* acc, void* m, void* l, int G,
                          int num_blocks, int bs, int npre, int Lc, int Hkv,
                          int n_rep, int D, int win, int splits, int bps,
                          cudaStream_t stream) {
  const int nq = Lc * n_rep;
  const int qt = prefix_query_tile((int)sizeof(T), D, nq, n_rep);
  if (qt == 0 || (long long)Hkv * ((nq + qt - 1) / qt) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = prefix_smem_bytes((int)sizeof(T), D, qt, n_rep);
  if (smem > 48 * 1024) {
    const cudaError_t e = attn::allow_max_smem<cascade_prefix_kernel<T>>();
    if (e != cudaSuccess) return e;
  }
  const bool direct = splits == 1;
  const unsigned tiles = (unsigned)((nq + qt - 1) / qt);
  cascade_prefix_kernel<T><<<dim3(Hkv * tiles, G, splits), kThreads, smem,
                             stream>>>(
      (const T*)qg, (const T*)ka, (const T*)va, (const int32_t*)gtables,
      (const int32_t*)glen, (const int32_t*)lane_lens,
      (float*)(direct ? acc_out : acc), (float*)(direct ? m_out : m),
      (float*)(direct ? l_out : l), num_blocks, bs, npre, Lc, Hkv, n_rep, D,
      win, bps * bs, qt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  const long long R = (long long)G * Lc * Hkv * n_rep;
  return attn::combine_to_state(
      attn::stacked_states((const float*)acc, (const float*)m,
                           (const float*)l),
      splits, R, D, (float*)acc_out, (float*)m_out, (float*)l_out, stream);
}

constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
merge_states_kernel(const float* __restrict__ acc1,
                    const float* __restrict__ m1,
                    const float* __restrict__ l1,
                    const float* __restrict__ acc2,
                    const float* __restrict__ m2,
                    const float* __restrict__ l2, float* __restrict__ out,
                    long long n, int D) {
  const long long i = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= n) return;
  const long long r = i / D;
  out[i] = attn::merge_two(m1[r], l1[r], acc1[i], m2[r], l2[r], acc2[i]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Rows of D elements must be whole
// 16-byte vectors and the query and arena pointers 16-byte aligned (the
// wrapper checks).  The chain is swept in `splits` runs of `bps` table
// entries (splits * bps >= npre, no run wholly past npre); with splits > 1,
// acc (splits, G*Lc*Hq, D), m, l (splits, G*Lc*Hq) float32 are the scratch
// the combine launch reads.  Returns cudaGetLastError() after the last
// launch.
extern "C" int cascade_prefix_launch(
    const void* qg, const void* ka, const void* va, const void* gtables,
    const void* glen, const void* lane_lens, void* acc_out, void* m_out,
    void* l_out, void* acc, void* m, void* l, int G, int num_blocks, int bs,
    int npre, int Lc, int Hkv, int n_rep, int D, int win, int splits, int bps,
    int dtype, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (G <= 0 || G > 65535 || num_blocks <= 0 || bs <= 0 || npre <= 0 ||
      (long long)npre * bs >= (1LL << 30) || Lc <= 0 || Hkv <= 0 ||
      Hkv > 65535 || n_rep <= 0 || D <= 0 || (D * elem) % 16 != 0 ||
      win <= 0 || (dtype != 0 && dtype != 1) || splits <= 0 ||
      splits > 65535 || bps <= 0 || (long long)bps * bs >= (1LL << 30) ||
      (long long)splits * bps < npre ||
      (long long)(splits - 1) * bps >= npre ||
      (splits > 1 && (acc == nullptr || m == nullptr || l == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)prefix_launch<float>(qg, ka, va, gtables, glen, lane_lens,
                                     acc_out, m_out, l_out, acc, m, l, G,
                                     num_blocks, bs, npre, Lc, Hkv, n_rep, D,
                                     win, splits, bps, s);
  return (int)prefix_launch<__nv_bfloat16>(
      qg, ka, va, gtables, glen, lane_lens, acc_out, m_out, l_out, acc, m, l,
      G, num_blocks, bs, npre, Lc, Hkv, n_rep, D, win, splits, bps, s);
}

// Shared-memory bytes cascade_prefix_launch asks for at these sizes: a
// tile's (prefix_query_tile), or one query's when not even that fits (the
// wrapper refuses a call above the card's per-block limit).
extern "C" long long cascade_prefix_smem_bytes(int Lc, int n_rep, int D,
                                               int dtype) {
  const int elem = dtype == 0 ? 4 : 2;
  const int qt = prefix_query_tile(elem, D, Lc * n_rep, n_rep);
  return (long long)prefix_smem_bytes(elem, D, qt > 0 ? qt : 1, n_rep);
}

// rows = B * Hq states of D elements each.
extern "C" int merge_states_launch(const void* acc1, const void* m1,
                                   const void* l1, const void* acc2,
                                   const void* m2, const void* l2, void* out,
                                   long long rows, int D, void* stream) {
  if (rows <= 0 || D <= 0 || rows * D > 0x7fffffffLL * kMergeThreads)
    return (int)cudaErrorInvalidValue;
  const long long n = rows * D;
  merge_states_kernel<<<(unsigned)((n + kMergeThreads - 1) / kMergeThreads),
                        kMergeThreads, 0, (cudaStream_t)stream>>>(
      (const float*)acc1, (const float*)m1, (const float*)l1,
      (const float*)acc2, (const float*)m2, (const float*)l2, (float*)out, n,
      D);
  return (int)cudaGetLastError();
}

// S >= 2 stacked states: acc (S, rows, D), m, l (S, rows) float32 -> out
// (rows, D) float32.
extern "C" int merge_states_n_launch(const void* acc, const void* m,
                                     const void* l, void* out, int S,
                                     long long rows, int D, void* stream) {
  if (S < 2 || rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return (int)attn::combine_states<float>(
      attn::stacked_states((const float*)acc, (const float*)m,
                           (const float*)l),
      S, rows, D, (float*)out, (cudaStream_t)stream);
}
