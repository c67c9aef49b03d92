// Paged KV cache kernels for Hopper (sm_90a): one-query decode attention
// read through a block table, and the decode tick's in-place row write.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attn.py:
//   paged_decode_attention (_paged_kernel)   -> paged_attn_launch
//   paged_decode_attention_with_state
//                    (_paged_state_kernel)   -> paged_attn_state_launch,
//                                               and merged with the
//                                               cascade's prefix states
//                                               (merge_attn_states,
//                                               _merge_kernel, fused)
//                                               -> paged_attn_merge_launch
//   scatter_kv_rows        (_scatter_kernel) -> scatter_rows_launch
// The attention kernels are templated on float and __nv_bfloat16 (the
// arena's dtype); the scatter copies 16-byte vectors of either.
//
// paged_attn_launch
//   q (B, Hq, D); arenas (num_blocks, bs, Hkv, D); tables (B, nb) int32;
//   lens (B,) int32; optional new rows k1, v1 (B, Hkv, D); out (B, Hq, D).
//   Position pos of lane b attends when lens[b] - win <= pos < lens[b];
//   with new rows, the row at pos == lens[b] - 1 is read from k1/v1 instead
//   of the arena.  Scores, running max m, running sum l, the probabilities
//   (never rounded to the arena's dtype, as in the TPU kernel) and the
//   accumulator are float32; the result is acc / max(l, 1e-30) in the
//   arena's dtype.  A lane with lens == 0 returns 0.  A table entry
//   outside [0, num_blocks) reads block 0.
//
//   Bound on the H100: bytes.  Each live K and V row is read once (per
//   lane, per KV head) and used for n_rep = Hq/Hkv queries, about 1 flop
//   per byte per query.  Design (flash-decoding): grid (Hkv, B, splits);
//   split z of a lane covers the fixed run of table entries [z*bps,
//   (z+1)*bps) (bps blocks, 512 positions at bs 16), so the split plan is
//   a function of the table width nb alone and the wrapper never reads
//   lens on the host.  A CTA whose run holds no live position writes the
//   empty state (acc 0, m -1e30, l 0) and does no other work.  In the CTA,
//   128 threads walk the run's live positions in chunks of 64: cp.async
//   brings the next chunk's K and V rows (only the live rows, a thread per
//   row reading the table once and issuing the row's 16-byte vectors)
//   into the other half of a two-stage ring, zeroed at the start, while
//   the current one is computed; the loops run the whole chunk with p = 0
//   past its live rows (fixed trip counts, unrolled).  Each position is
//   scored by a group of G lanes (16, or 32 for rows of more than sixteen
//   16-byte vectors; ten of them busy at D = 80 bf16), each dotting its
//   slice of K against the float q in shared memory, reduced by xor
//   shuffles inside the group; one warp per query updates m and l; in the
//   value product each warp takes every fourth position and all n_rep*D
//   accumulator elements (two adjacent ones a lane), into its own
//   float partial in shared memory, and the four partials are summed in
//   warp order at the end.  GQA reads each K and V row once for its
//   n_rep queries.  With splits > 1 each CTA writes its unnormalized
//   float32 state to scratch and a second launch (attn::combine_states,
//   attn_common.cuh) merges the splits in order and normalizes.  Positions
//   outside the window are never read, so garbage in the trash block or in
//   stale rows cannot reach the result.  No atomics: bit for bit
//   reproducible.
//
// paged_attn_state_launch (the cascade's per-lane suffix pass, and a
// shard's sweep under sharded serving's split-KV fallback)
//   The same CTA loop: the table names lane b's blocks, entry j holding
//   absolute positions q0[b] + j*stride + i for i < bs.  The cascade's
//   suffix tables hold contiguous blocks (stride = bs), so the sweep covers
//   [max(q0, lens - win), min(lens, q0 + nb*bs)), split z the run [q0 +
//   z*bps*bs, q0 + (z+1)*bps*bs) of it.  A fallback shard holds bs of each
//   stride-position block from offset q0 (stride = the slice's block size,
//   bs = stride / shards, q0 = shard * bs), so its sweep takes the table's
//   local rows u = j*bs + i whose positions attend, the positions falling
//   to the other shards skipped; the new row at lens - 1 is read only by
//   the shard whose rows hold that position.  The loop walks local rows
//   (split z the rows [z*bps*bs, (z+1)*bps*bs)), so at stride = bs it is
//   the contiguous sweep above, row for row.  It writes the float32
//   online-softmax state acc (B, Hq, D), m, l (B, Hq) unnormalized instead
//   of out: at one split the CTAs write it themselves; with splits > 1
//   they write their states to scratch and the combine launch merges them
//   in split order into the state (attn::combine_states, the state
//   epilogue), normalizing nothing.  The plan (the wrapper's
//   cascade_split_plan) is a function of the shapes: runs of at least two
//   64-position ring chunks until B * Hkv * splits fills the card (a run
//   of one chunk saves less than its combine launch costs), so a decode
//   tick's short suffixes (8 blocks at load (c)) run at one split.  A
//   sweep with no valid position leaves the empty state (acc 0, m -1e30,
//   l 0), which the combine and the cascade merge drop exactly.
//
// paged_attn_merge_launch (the cascade's suffix pass with the merge fused)
//   The suffix pass above, whose epilogue merges each lane's prefix state
//   (the prefix pass's output in group layout, read through lane_slot:
//   attn::Prefix) into the suffix state and normalizes, writing out (B,
//   Hq, D) in the arena's dtype: at one split the CTA merges its own state
//   (acc summed over the warps, m, l) in its epilogue; with splits > 1 the
//   combine launch computes the suffix state as the state epilogue does
//   and merges it (attn::combine_merge).  Either way the merge is
//   attn::merge_two, the function the standalone merge_attn_states kernel
//   calls, on the same float32 values the three-launch composition passes
//   through device memory (state, place_group_states, merge_attn_states),
//   so the output is that composition's, cast to the arena's dtype, bit
//   for bit.  The launches are the suffix pass's own (the sweep, and the
//   combine when split): the placement of the group states, the merge and
//   the cast are gone from the tick.  A lane in no group merges the empty
//   state, as the composition does.
//
// scatter_rows_launch
//   arenas (L, num_blocks, 1, bs, Hkv, D); the rows of layer l at kr[l],
//   vr[l], each (S, Hkv, D): per-layer pointers, so the tick passes the
//   rows its layers made and no stacked copy of them is written; wbids
//   and offs (S,) int32: arena[l, wbids[b], 0, offs[b]] = rows[l][b], in
//   place.  No other byte of the arenas is written; a lane whose block or
//   offset is out of range writes nothing.
//
//   Bound on the H100: bytes, a copy (at stablelm-3b's 32 layers x 8
//   lanes, 2.6 MB read and 2.6 MB written, 1.57 us at 3.35 TB/s), short
//   enough that the load latency and the launch decide the time.  Design:
//   the row pointers travel by value in the kernel's parameters (a
//   __grid_constant__ struct of up to kScatterLayers layers, 2 KB; more
//   layers launch in chunks); grid (2 * row chunks, S, layers), each CTA
//   one chunk of one K or V row of one (lane, layer), each thread
//   kScatterVecs 16-byte vectors at a stride of the CTA's width, all
//   loaded (fixed trip count, unrolled, no division) before the lane's
//   block and offset are checked and the vectors stored.  At stablelm-3b's
//   rows of 320 vectors that is 512 CTAs of 128 threads, 2-3 vectors a
//   thread.
#include "attn_common.cuh"

namespace {

using attn::from_f32;
using attn::kNegInf;
using attn::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                       // positions per ring stage

// Shared memory, in order: the ring, 2 stages x (K [kChunk][D], V
// [kChunk][D]) in the arena's dtype; then float q [n_rep][D], scores
// [n_rep][kChunk], per-warp accumulators [kWarps][n_rep][D], m, l, corr
// [n_rep].
size_t attn_smem_bytes(int elem, int D, int n_rep) {
  return (size_t)4 * kChunk * D * elem +
         sizeof(float) * ((size_t)n_rep * D + (size_t)n_rep * kChunk +
                          (size_t)kWarps * n_rep * D + 3 * (size_t)n_rep);
}

// Split z of lane b sweeps the local rows [z*P, (z+1)*P) of its table:
// local row u is row u % bs of entry u / bs and holds position q0 + (u /
// bs) * stride + u % bs (q0 = q0s[b], or 0 without q0s; stride = bs for a
// contiguous chain).  out != nullptr: one split, write
// acc / max(l, 1e-30) to out, or, with a prefix (pre.lane_slot !=
// nullptr), the state merged with the lane's prefix state and normalized;
// otherwise write the state of split z at acc_out + z*B*Hq*D, m_out +
// z*B*Hq, l_out + z*B*Hq.  G: the lanes that score one position (a power
// of two >= the row's 16-byte vectors).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ ka,
                  const T* __restrict__ va, const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ lens, const T* __restrict__ k1,
                  const T* __restrict__ v1, T* __restrict__ out,
                  const int32_t* __restrict__ q0s,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int num_blocks, int bs,
                  int stride, int nb, int Hkv, int n_rep, int D, int win,
                  int P, const attn::Prefix pre) {
  constexpr int kVec = 16 / sizeof(T);           // elements per 16 bytes
  constexpr int kGroups = kThreads / G;          // positions scored at once
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z, B = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * n_rep, RD = n_rep * D;
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(ring + (size_t)4 * kChunk * D);
  float* ss = qs + RD;
  float* accw = ss + n_rep * kChunk;
  float* ms = accw + kWarps * RD;
  float* ls = ms + n_rep;
  float* corr = ls + n_rep;

  // the ring starts zeroed: a chunk shorter than kChunk leaves rows that
  // hold zeros or an earlier chunk's live rows, finite either way, which
  // the loops below run over with p = 0 (fixed trip counts)
  for (int i = tid; i < kChunk * D * 4 / kVec; i += kThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  const T* qb = q + ((size_t)b * Hq + (size_t)h * n_rep) * D;
  for (int i = tid; i < RD; i += kThreads) qs[i] = to_f32(qb[i]);
  for (int i = tid; i < kWarps * RD; i += kThreads) accw[i] = 0.f;
  for (int r = tid; r < n_rep; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  __syncthreads();

  const int len = lens[b];
  const int q0 = q0s != nullptr ? q0s[b] : 0;   // position of table entry 0
  // the first local row whose position is at least p (p >= q0): p - q0
  // itself for contiguous blocks
  auto local = [&](int p) {
    const int r = p - q0;
    if (stride == bs) return r;
    const int j = r / stride;
    return j * bs + min(r - j * stride, bs);
  };
  const int s_lo = z * P;                        // local rows [lo, hi) attend
  const int lo = max(local(max(q0, len - win)), s_lo);
  const int hi = min(min(local(max(len, q0)), nb * bs), s_lo + P);
  // the local row holding position len - 1, read from k1/v1 (-1: no new
  // rows, or no row of this table holds it)
  int u_new = -1;
  if (k1 != nullptr && len - 1 >= q0 &&
      (stride == bs || (len - 1 - q0) % stride < bs))
    u_new = local(len - 1);
  const int n_chunks = hi > lo ? (hi - lo + kChunk - 1) / kChunk : 0;
  const float scale = 1.f / sqrtf((float)D);
  const int vpr = D / kVec;                      // 16-byte vectors per row
  const size_t row_stride = (size_t)Hkv * D;     // elements between rows

  // chunk c's live K and V rows into ring stage st: a thread copies whole
  // rows, so the table is read once per row
  auto issue = [&](int c, int st) {
    const int c0 = lo + c * kChunk, n = min(kChunk, hi - c0);
    T* ks = ring + (size_t)st * 2 * kChunk * D;
    for (int i = tid; i < 2 * n; i += kThreads) {
      const int which = i >= n;                  // 0: K, 1: V
      const int t = i - which * n, u = c0 + t;   // local row
      const T* src;
      if (u == u_new) {
        src = (which ? v1 : k1) + ((size_t)b * Hkv + h) * D;
      } else {
        int bid = tables[(size_t)b * nb + u / bs];
        if (bid < 0 || bid >= num_blocks) bid = 0;
        src = (which ? va : ka) +
              ((size_t)bid * bs + u % bs) * row_stride + (size_t)h * D;
      }
      T* dst = ks + ((size_t)which * kChunk + t) * D;
#pragma unroll
      for (int vec = 0; vec < G; ++vec)
        if (vec < vpr) attn::cp_async16(dst + vec * kVec, src + vec * kVec);
    }
    attn::cp_async_commit();
  };

  const int grp = tid / G, gl = tid % G;
  if (n_chunks > 0) issue(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      issue(c + 1, (c + 1) & 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();                             // chunk c has landed
    const int n = min(kChunk, hi - (lo + c * kChunk));
    const T* ks = ring + (size_t)(c & 1) * 2 * kChunk * D;
    const T* vs = ks + (size_t)kChunk * D;
    // scores: a group of G lanes per position, each its 16-byte slice of K
    // against its slice of q, reduced by xor shuffles inside the group
#pragma unroll 2
    for (int t0 = 0; t0 < kChunk; t0 += kGroups) {
      const int t = t0 + grp;
      float kf[kVec];
      if (gl < vpr) {
        const uint4 x = reinterpret_cast<const uint4*>(ks + (size_t)t * D)[gl];
        const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int u = 0; u < kVec; ++u) kf[u] = to_f32(e[u]);
      } else {
#pragma unroll
        for (int u = 0; u < kVec; ++u) kf[u] = 0.f;
      }
      const float* qr = qs + (gl < vpr ? gl : 0) * kVec;
      for (int r = 0; r < n_rep; ++r, qr += D) {
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < kVec; ++u) s = fmaf(qr[u], kf[u], s);
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (gl == 0) ss[r * kChunk + t] = s * scale;
      }
    }
    __syncthreads();
    // online softmax: one warp per query; positions past n get p = 0
    for (int r = warp; r < n_rep; r += kWarps) {
      float x[kChunk / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kChunk / 32; ++i) {
        const int t = lane + 32 * i;
        x[i] = t < n ? ss[r * kChunk + t] : kNegInf;
        mx = fmaxf(mx, x[i]);
      }
      mx = attn::warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kChunk / 32; ++i) {
        const int t = lane + 32 * i;
        const float p = t < n ? expf(x[i] - m_new) : 0.f;
        ss[r * kChunk + t] = p;
        sum += p;
      }
      sum = attn::warp_sum(sum);
      if (lane == 0) {
        const float cr = expf(m_prev - m_new);
        corr[r] = cr;
        ls[r] = ls[r] * cr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    // value product: warp w takes positions w, w + 4, ...; a lane two
    // adjacent accumulator elements (D is even)
    float* aw = accw + warp * RD;
    for (int e = 2 * lane; e < RD; e += 64) {
      const int r = e / D, d = e - r * D;
      const float cr = corr[r];
      float a0 = aw[e] * cr, a1 = aw[e + 1] * cr;
#pragma unroll
      for (int k = 0; k < kChunk / kWarps; ++k) {
        const int t = warp + k * kWarps;
        const float p = ss[r * kChunk + t];
        const T* x = vs + (size_t)t * D + d;
        a0 = fmaf(p, to_f32(x[0]), a0);
        a1 = fmaf(p, to_f32(x[1]), a1);
      }
      aw[e] = a0;
      aw[e + 1] = a1;
    }
    __syncthreads();                             // stage c & 1 consumed
  }
  __syncthreads();
  const size_t row0 = (size_t)b * Hq + (size_t)h * n_rep;
  for (int e = tid; e < RD; e += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += accw[w * RD + e];
    if (out == nullptr) {
      acc_out[((size_t)z * B * Hq + row0) * D + e] = a;
      continue;
    }
    const int r = e / D;
    out[row0 * D + e] = from_f32<T>(
        pre.lane_slot != nullptr
            ? attn::merge_prefix(pre, b, h * n_rep + r, e - r * D, D, ms[r],
                                 ls[r], a)
            : a / fmaxf(ls[r], 1e-30f));
  }
  if (out == nullptr) {
    for (int r = tid; r < n_rep; r += kThreads) {
      m_out[(size_t)z * B * Hq + row0 + r] = ms[r];
      l_out[(size_t)z * B * Hq + row0 + r] = ls[r];
    }
  }
}

constexpr int kScatterThreads = 128;
constexpr int kScatterVecs = 4;      // 16-byte vectors a thread moves a row
constexpr int kScatterLayers = 128;  // layers a launch takes (2 KB of params)

struct LayerRows {
  const uint4* k[kScatterLayers];
  const uint4* v[kScatterLayers];
};

// Grid (2 * chunks, S, layers): x = 2 * chunk + (0: K, 1: V).  ka, va point
// at the launch's first layer; rows of nvec 16-byte vectors.
__global__ void __launch_bounds__(kScatterThreads)
scatter_rows_kernel(uint4* __restrict__ ka, uint4* __restrict__ va,
                    const __grid_constant__ LayerRows rows,
                    const int32_t* __restrict__ wbids,
                    const int32_t* __restrict__ offs, int num_blocks, int bs,
                    int nvec) {
  const int side = blockIdx.x & 1, b = blockIdx.y, l = blockIdx.z;
  const int v0 =
      (blockIdx.x >> 1) * kScatterThreads * kScatterVecs + threadIdx.x;
  const uint4* src = (side ? rows.v[l] : rows.k[l]) + (size_t)b * nvec;
  uint4 x[kScatterVecs];
#pragma unroll
  for (int i = 0; i < kScatterVecs; ++i) {
    const int v = v0 + i * kScatterThreads;
    if (v < nvec) x[i] = __ldg(src + v);
  }
  const int wb = wbids[b], off = offs[b];
  if (wb < 0 || wb >= num_blocks || off < 0 || off >= bs) return;
  uint4* dst = (side ? va : ka) +
               (((size_t)l * num_blocks + wb) * bs + off) * nvec;
#pragma unroll
  for (int i = 0; i < kScatterVecs; ++i) {
    const int v = v0 + i * kScatterThreads;
    if (v < nvec) dst[v] = x[i];
  }
}

// out != nullptr: the flat sweep, normalized into out, or with a prefix
// (pre.lane_slot != nullptr) the suffix sweep merged with the prefix
// states into out; otherwise the state sweep into st_acc, st_m, st_l.
// With splits > 1 the CTAs write their states to the scratch acc, m, l and
// the combine launch merges them.
template <typename T>
cudaError_t attn_launch(const void* q, const void* ka, const void* va,
                        const void* tables, const void* lens, const void* k1,
                        const void* v1, void* out, const void* q0s,
                        void* acc, void* m, void* l, void* st_acc,
                        void* st_m, void* st_l, int B, int num_blocks,
                        int bs, int stride, int nb, int Hkv, int n_rep,
                        int D, int win, int splits, int P,
                        const attn::Prefix& pre, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes(sizeof(T), D, n_rep);
  const bool wide = D * (int)sizeof(T) > 16 * 16;  // more than 16 vectors
  const auto kernel =
      wide ? paged_attn_kernel<T, 32> : paged_attn_kernel<T, 16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = wide
        ? attn::allow_max_smem<paged_attn_kernel<T, 32>>()
        : attn::allow_max_smem<paged_attn_kernel<T, 16>>();
    if (e != cudaSuccess) return e;
  }
  const bool state = out == nullptr, direct = splits == 1;
  kernel<<<dim3(Hkv, B, splits), kThreads, smem, stream>>>(
      (const T*)q, (const T*)ka, (const T*)va, (const int32_t*)tables,
      (const int32_t*)lens, (const T*)k1, (const T*)v1,
      direct && !state ? (T*)out : nullptr, (const int32_t*)q0s,
      (float*)(direct ? st_acc : acc), (float*)(direct ? st_m : m),
      (float*)(direct ? st_l : l), num_blocks, bs, stride, nb, Hkv, n_rep,
      D, win, P, pre);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  const long long R = (long long)B * Hkv * n_rep;
  const attn::States parts = attn::stacked_states(
      (const float*)acc, (const float*)m, (const float*)l);
  if (state)
    return attn::combine_to_state(parts, splits, R, D, (float*)st_acc,
                                  (float*)st_m, (float*)st_l, stream);
  if (pre.lane_slot != nullptr)
    return attn::combine_merge<T>(parts, splits, R, D, pre, (T*)out, stream);
  return attn::combine_states<T>(parts, splits, R, D, (T*)out, stream);
}

bool attn_args_ok(int B, int num_blocks, int bs, int nb, int Hkv, int n_rep,
                  int D, int win, int dtype) {
  const int elem = dtype == 0 ? 4 : 2;
  return B > 0 && B <= 65535 && num_blocks > 0 && bs > 0 && nb > 0 &&
         Hkv > 0 && n_rep > 0 && D > 0 && (D * elem) % 16 == 0 &&
         D * elem <= 32 * 16 && win > 0 && (long long)nb * bs < (1LL << 30) &&
         (dtype == 0 || dtype == 1);
}

// The chain is swept in `splits` runs of `bps` table entries (splits * bps
// >= nb, no run wholly past nb); with splits > 1, acc (splits, B, Hq, D),
// m, l (splits, B, Hq) float32 are the scratch the combine launch reads.
bool plan_ok(int nb, int splits, int bps, const void* acc, const void* m,
             const void* l) {
  return splits > 0 && splits <= 65535 && bps > 0 &&
         (long long)splits * bps >= nb && (long long)(splits - 1) * bps < nb &&
         (splits == 1 || (acc != nullptr && m != nullptr && l != nullptr));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  k1/v1 may be null (no splice).  Rows
// of D elements must be whole 16-byte vectors (at most 32 of them) and
// every pointer 16-byte aligned (the wrapper checks).  Returns
// cudaGetLastError() after the last launch.
extern "C" int paged_attn_launch(const void* q, const void* ka, const void* va,
                                 const void* tables, const void* lens,
                                 const void* k1, const void* v1, void* out,
                                 void* acc, void* m, void* l, int B,
                                 int num_blocks, int bs, int nb, int Hkv,
                                 int n_rep, int D, int win, int splits,
                                 int bps, int dtype, void* stream) {
  if (!attn_args_ok(B, num_blocks, bs, nb, Hkv, n_rep, D, win, dtype) ||
      !plan_ok(nb, splits, bps, acc, m, l))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int P = bps * bs;
  if (dtype == 0)
    return (int)attn_launch<float>(q, ka, va, tables, lens, k1, v1, out,
                                   nullptr, acc, m, l, nullptr, nullptr,
                                   nullptr, B, num_blocks, bs, bs, nb, Hkv,
                                   n_rep, D, win, splits, P, attn::Prefix{},
                                   s);
  return (int)attn_launch<__nv_bfloat16>(
      q, ka, va, tables, lens, k1, v1, out, nullptr, acc, m, l, nullptr,
      nullptr, nullptr, B, num_blocks, bs, bs, nb, Hkv, n_rep, D, win, splits,
      P, attn::Prefix{}, s);
}

// The suffix pass of the cascade: as paged_attn_launch, with q0 (B,) int32,
// the positions per table entry (stride, at least bs) and the float32 state
// acc_out (B, Hq, D), m_out, l_out (B, Hq) in place of out; acc, m, l the
// scratch of a split plan.
extern "C" int paged_attn_state_launch(
    const void* q, const void* ka, const void* va, const void* tables,
    const void* lens, const void* q0s, const void* k1, const void* v1,
    void* acc_out, void* m_out, void* l_out, void* acc, void* m, void* l,
    int B, int num_blocks, int bs, int stride, int nb, int Hkv, int n_rep,
    int D, int win, int splits, int bps, int dtype, void* stream) {
  if (!attn_args_ok(B, num_blocks, bs, nb, Hkv, n_rep, D, win, dtype) ||
      !plan_ok(nb, splits, bps, acc, m, l) || acc_out == nullptr ||
      m_out == nullptr || l_out == nullptr || stride < bs ||
      (long long)nb * stride >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int P = bps * bs;
  if (dtype == 0)
    return (int)attn_launch<float>(q, ka, va, tables, lens, k1, v1, nullptr,
                                   q0s, acc, m, l, acc_out, m_out, l_out, B,
                                   num_blocks, bs, stride, nb, Hkv, n_rep, D,
                                   win, splits, P, attn::Prefix{}, s);
  return (int)attn_launch<__nv_bfloat16>(
      q, ka, va, tables, lens, k1, v1, nullptr, q0s, acc, m, l, acc_out,
      m_out, l_out, B, num_blocks, bs, stride, nb, Hkv, n_rep, D, win, splits,
      P, attn::Prefix{}, s);
}

// The suffix pass merged with the prefix pass's states: as
// paged_attn_state_launch, with the prefix states pacc (slots * Hq, D),
// pm, pl (slots * Hq) float32 and lane_slot (B,) int32 (attn::Prefix), and
// out (B, Hq, D) in the arena's dtype in place of the state.
extern "C" int paged_attn_merge_launch(
    const void* q, const void* ka, const void* va, const void* tables,
    const void* lens, const void* q0s, const void* k1, const void* v1,
    const void* pacc, const void* pm, const void* pl, const void* lane_slot,
    long long slots, void* out, void* acc, void* m, void* l, int B,
    int num_blocks, int bs, int nb, int Hkv, int n_rep, int D, int win,
    int splits, int bps, int dtype, void* stream) {
  if (!attn_args_ok(B, num_blocks, bs, nb, Hkv, n_rep, D, win, dtype) ||
      !plan_ok(nb, splits, bps, acc, m, l) || out == nullptr ||
      lane_slot == nullptr || slots < 0 ||
      (slots > 0 && (pacc == nullptr || pm == nullptr || pl == nullptr)))
    return (int)cudaErrorInvalidValue;
  const attn::Prefix pre = {(const float*)pacc, (const float*)pm,
                            (const float*)pl, (const int32_t*)lane_slot,
                            slots, Hkv * n_rep};
  const cudaStream_t s = (cudaStream_t)stream;
  const int P = bps * bs;
  if (dtype == 0)
    return (int)attn_launch<float>(q, ka, va, tables, lens, k1, v1, out, q0s,
                                   acc, m, l, nullptr, nullptr, nullptr, B,
                                   num_blocks, bs, bs, nb, Hkv, n_rep, D, win,
                                   splits, P, pre, s);
  return (int)attn_launch<__nv_bfloat16>(
      q, ka, va, tables, lens, k1, v1, out, q0s, acc, m, l, nullptr, nullptr,
      nullptr, B, num_blocks, bs, bs, nb, Hkv, n_rep, D, win, splits, P, pre,
      s);
}

// Shared-memory bytes paged_attn_launch asks for at these sizes (the wrapper
// refuses a call above the card's per-block limit).
extern "C" long long paged_attn_smem_bytes(int n_rep, int D, int dtype) {
  return (long long)attn_smem_bytes(dtype == 0 ? 4 : 2, D, n_rep);
}

// kr, vr: host arrays of L pointers, layer l's rows (S, Hkv, D), each
// 16-byte aligned; row_bytes = Hkv * D * element size, whole 16-byte
// vectors.  Layers launch in chunks of kScatterLayers.
extern "C" int scatter_rows_launch(void* ka, void* va, const void* const* kr,
                                   const void* const* vr, const void* wbids,
                                   const void* offs, int L, int num_blocks,
                                   int bs, int S, int row_bytes,
                                   void* stream) {
  if (L <= 0 || S <= 0 || S > 65535 || num_blocks <= 0 || bs <= 0 ||
      row_bytes <= 0 || row_bytes % 16 != 0 || kr == nullptr || vr == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nvec = row_bytes / 16;
  const int chunks = (nvec + kScatterThreads * kScatterVecs - 1) /
                     (kScatterThreads * kScatterVecs);
  const size_t layer = (size_t)num_blocks * bs * nvec;  // vectors a layer
  LayerRows rows;
  for (int l0 = 0; l0 < L; l0 += kScatterLayers) {
    const int n = L - l0 < kScatterLayers ? L - l0 : kScatterLayers;
    for (int i = 0; i < n; ++i) {
      rows.k[i] = (const uint4*)kr[l0 + i];
      rows.v[i] = (const uint4*)vr[l0 + i];
    }
    scatter_rows_kernel<<<dim3(2 * chunks, S, n), kScatterThreads, 0, s>>>(
        (uint4*)ka + l0 * layer, (uint4*)va + l0 * layer, rows,
        (const int32_t*)wbids, (const int32_t*)offs, num_blocks, bs, nvec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
