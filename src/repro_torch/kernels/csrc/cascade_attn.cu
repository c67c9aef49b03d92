// Cascade decode kernels for Hopper (sm_90a): the shared-prefix pass of a
// group of decode lanes, and the log-sum-exp merge of two partial softmax
// states.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attn.py:
//   cascade_prefix_attention (_cascade_prefix_kernel) -> cascade_prefix_launch
//   merge_attn_states        (_merge_kernel)          -> merge_states_launch
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
//   is read from device memory once per group, not once per lane: one CTA
//   per (KV head, group) holds all Lc * n_rep queries of that KV head and
//   walks the chain in chunks of up to 128 positions.  Each chunk's K and V
//   rows are copied to shared memory with 16-byte loads (rows padded by 16
//   bytes, so the per-position row reads below hit distinct banks), then
//   every staged row serves every query: one thread per (query, position)
//   score with the query broadcast from shared memory, one warp per query
//   for the running max and sum, and one thread per accumulator element for
//   the value product.  Only positions inside a query's window are scored or
//   read again, so garbage in the trash block (padded table entries) or past
//   group_len cannot reach a result.  At one group the grid is Hkv CTAs (32
//   for stablelm-3b) on 132 SMs, so the pass is latency-bound; splitting a
//   chain across CTAs is later work.  A table entry outside
//   [0, num_blocks) reads block 0.
//
// merge_states_launch
//   acc1, acc2 (rows, D) and m1, l1, m2, l2 (rows,) float32:
//   out = (c1 acc1 + c2 acc2) / max(c1 l1 + c2 l2, 1e-30), with
//   m = max(m1, m2), c = exp(m_side - m).  One thread per output element.
//   An empty side (m = -1e30, l = 0, acc = 0) drops out exactly; two empty
//   sides give zeros.  Bound: bytes (about 0.25 MB at stablelm-3b's eight
//   lanes), so its time is the launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunkPositions = 128;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dot product of a float query row with one staged K row of D elements,
// read as 16-byte vectors.
__device__ __forceinline__ float row_dot(const float* q, const float* k,
                                         int D) {
  float s = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(q + d);
    const float4 b = *reinterpret_cast<const float4*>(k + d);
    s += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  return s;
}
__device__ __forceinline__ float row_dot(const float* q,
                                         const __nv_bfloat16* k, int D) {
  float s = 0.f;
  for (int d = 0; d < D; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 a0 = *reinterpret_cast<const float4*>(q + d);
    const float4 a1 = *reinterpret_cast<const float4*>(q + d + 4);
    const float2 b0 = __bfloat1622float2(h[0]), b1 = __bfloat1622float2(h[1]);
    const float2 b2 = __bfloat1622float2(h[2]), b3 = __bfloat1622float2(h[3]);
    s += a0.x * b0.x + a0.y * b0.y + a0.z * b1.x + a0.w * b1.y +
         a1.x * b2.x + a1.y * b2.y + a1.z * b3.x + a1.w * b3.y;
  }
  return s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row pitch of a staged K or V row in elements: D plus 16 bytes.
__host__ __device__ inline int row_pitch(int D, int elem) {
  return D + 16 / elem;
}

size_t prefix_smem_bytes(int elem, int T_, int D, int nq, int Lc) {
  return (size_t)2 * T_ * row_pitch(D, elem) * elem +
         sizeof(float) * ((size_t)2 * nq * D + (size_t)nq * T_ +
                          3 * (size_t)nq) +
         sizeof(int) * (size_t)Lc;
}

// Positions per chunk: up to 128, in whole blocks, fewer if the queries'
// scores would not fit in shared memory.
int prefix_chunk_blocks(int elem, int bs, int D, int nq, int Lc) {
  int cb = bs >= kMaxChunkPositions ? 1 : kMaxChunkPositions / bs;
  while (cb > 1 && prefix_smem_bytes(elem, cb * bs, D, nq, Lc) > kMaxSmem)
    cb /= 2;
  return cb;
}

// Shared memory, in order: K tile [T][P] and V tile [T][P] in the arena's
// dtype, then float q [nq][D], scores [nq][T], acc [nq][D], m, l, corr [nq],
// and int lo [Lc] (each lane's first attending position).  Query qi = c *
// n_rep + r is lane c's query head h * n_rep + r.
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
                      int cb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T_ = cb * bs;                        // positions per chunk
  const int P = row_pitch(D, (int)sizeof(T));
  const int nq = Lc * n_rep;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)T_ * P;
  float* qs = reinterpret_cast<float*>(vs + (size_t)T_ * P);
  float* ss = qs + (size_t)nq * D;
  float* acc = ss + (size_t)nq * T_;
  float* ms = acc + (size_t)nq * D;
  float* ls = ms + nq;
  float* corr = ls + nq;
  int* lo_s = reinterpret_cast<int*>(corr + nq);

  const int Hq = Hkv * n_rep;
  for (int i = tid; i < nq * D; i += kThreads) {
    const int qi = i / D, d = i - qi * D;
    const int c = qi / n_rep, r = qi - c * n_rep;
    qs[i] = to_f32(qg[(((size_t)g * Lc + c) * Hq + (size_t)h * n_rep + r) *
                          D + d]);
    acc[i] = 0.f;
  }
  for (int qi = tid; qi < nq; qi += kThreads) {
    ms[qi] = kNegInf;
    ls[qi] = 0.f;
  }
  for (int c = tid; c < Lc; c += kThreads)
    lo_s[c] = max(0, lane_lens[(size_t)g * Lc + c] - win);
  __syncthreads();

  const int hi = min(glen[g], npre * bs);        // the chain's positions
  int lo = hi;                                   // first position any lane
  for (int c = 0; c < Lc; ++c) lo = min(lo, lo_s[c]);  // attends
  const float scale = 1.f / sqrtf((float)D);
  const int vpr = D * (int)sizeof(T) / 16;       // 16-byte vectors per row
  const size_t row_stride = (size_t)Hkv * D;     // elements between rows

  for (int c0 = (lo / bs) * bs; c0 < hi; c0 += T_) {
    const int t_hi = min(hi - c0, T_);
    const int rows = min(T_, ((hi - 1) / bs + 1) * bs - c0);
    __syncthreads();                             // previous chunk consumed
    for (int i = tid; i < 2 * rows * vpr; i += kThreads) {
      const int which = i / (rows * vpr);        // 0: K, 1: V
      const int j = i - which * rows * vpr;
      const int t = j / vpr, vec = j - t * vpr;
      const int pos = c0 + t;
      int bid = gtables[(size_t)g * npre + pos / bs];
      if (bid < 0 || bid >= num_blocks) bid = 0;
      const T* src = (which ? va : ka) +
                     ((size_t)bid * bs + pos % bs) * row_stride +
                     (size_t)h * D;
      T* dst = (which ? vs : ks) + (size_t)t * P;
      reinterpret_cast<uint4*>(dst)[vec] =
          __ldg(reinterpret_cast<const uint4*>(src) + vec);
    }
    __syncthreads();
    // scores: one thread per (query, position), each staged row shared by
    // every query of the CTA
    for (int pr = tid; pr < nq * T_; pr += kThreads) {
      const int qi = pr / T_, t = pr - qi * T_;
      if (t < t_hi && c0 + t >= lo_s[qi / n_rep])
        ss[pr] = row_dot(qs + (size_t)qi * D, ks + (size_t)t * P, D) * scale;
    }
    __syncthreads();
    // online softmax: one warp per query, over its own valid positions
    for (int qi = warp; qi < nq; qi += kWarps) {
      const int t_lo = max(lo_s[qi / n_rep] - c0, 0);
      float* sq = ss + (size_t)qi * T_;
      float mx = kNegInf;
      for (int t = t_lo + lane; t < t_hi; t += 32) mx = fmaxf(mx, sq[t]);
      mx = warp_max(mx);
      const float m_prev = ms[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = t_lo + lane; t < t_hi; t += 32) {
        const float p = expf(sq[t] - m_new);
        sq[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[qi] = c;
        ls[qi] = ls[qi] * c + sum;
        ms[qi] = m_new;
      }
    }
    __syncthreads();
    // value product: one thread per accumulator element
    for (int e = tid; e < nq * D; e += kThreads) {
      const int qi = e / D, d = e - qi * D;
      const int t_lo = max(lo_s[qi / n_rep] - c0, 0);
      const float* pq = ss + (size_t)qi * T_;
      float a = acc[e] * corr[qi];
      for (int t = t_lo; t < t_hi; ++t)
        a += pq[t] * to_f32(vs[(size_t)t * P + d]);
      acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < nq * D; e += kThreads) {
    const int qi = e / D, d = e - qi * D;
    const int c = qi / n_rep, r = qi - c * n_rep;
    acc_out[(((size_t)g * Lc + c) * Hq + (size_t)h * n_rep + r) * D + d] =
        acc[e];
  }
  for (int qi = tid; qi < nq; qi += kThreads) {
    const int c = qi / n_rep, r = qi - c * n_rep;
    const size_t o = ((size_t)g * Lc + c) * Hq + (size_t)h * n_rep + r;
    m_out[o] = ms[qi];
    l_out[o] = ls[qi];
  }
}

__global__ void __launch_bounds__(kThreads)
merge_states_kernel(const float* __restrict__ acc1,
                    const float* __restrict__ m1, const float* __restrict__ l1,
                    const float* __restrict__ acc2,
                    const float* __restrict__ m2, const float* __restrict__ l2,
                    float* __restrict__ out, long long n, int D) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const long long r = i / D;
    const float a = m1[r], b = m2[r];
    const float m = fmaxf(a, b);
    const float c1 = expf(a - m), c2 = expf(b - m);
    const float l = c1 * l1[r] + c2 * l2[r];
    out[i] = (c1 * acc1[i] + c2 * acc2[i]) / fmaxf(l, 1e-30f);
  }
}

template <typename T>
cudaError_t prefix_launch(const void* qg, const void* ka, const void* va,
                          const void* gtables, const void* glen,
                          const void* lane_lens, void* acc_out, void* m_out,
                          void* l_out, int G, int num_blocks, int bs, int npre,
                          int Lc, int Hkv, int n_rep, int D, int win,
                          cudaStream_t stream) {
  const int elem = (int)sizeof(T), nq = Lc * n_rep;
  const int cb = prefix_chunk_blocks(elem, bs, D, nq, Lc);
  const size_t smem = prefix_smem_bytes(elem, cb * bs, D, nq, Lc);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cascade_prefix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  cascade_prefix_kernel<T><<<dim3(Hkv, G), kThreads, smem, stream>>>(
      (const T*)qg, (const T*)ka, (const T*)va, (const int32_t*)gtables,
      (const int32_t*)glen, (const int32_t*)lane_lens, (float*)acc_out,
      (float*)m_out, (float*)l_out, num_blocks, bs, npre, Lc, Hkv, n_rep, D,
      win, cb);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Rows of D elements must be whole
// 16-byte vectors and the query and arena pointers 16-byte aligned (the
// wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int cascade_prefix_launch(
    const void* qg, const void* ka, const void* va, const void* gtables,
    const void* glen, const void* lane_lens, void* acc_out, void* m_out,
    void* l_out, int G, int num_blocks, int bs, int npre, int Lc, int Hkv,
    int n_rep, int D, int win, int dtype, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (G <= 0 || G > 65535 || num_blocks <= 0 || bs <= 0 || npre <= 0 ||
      Lc <= 0 || Hkv <= 0 || Hkv > 65535 || n_rep <= 0 || D <= 0 ||
      (D * elem) % 16 != 0 || win <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)prefix_launch<float>(qg, ka, va, gtables, glen, lane_lens,
                                     acc_out, m_out, l_out, G, num_blocks, bs,
                                     npre, Lc, Hkv, n_rep, D, win, s);
  return (int)prefix_launch<__nv_bfloat16>(
      qg, ka, va, gtables, glen, lane_lens, acc_out, m_out, l_out, G,
      num_blocks, bs, npre, Lc, Hkv, n_rep, D, win, s);
}

// Shared-memory bytes cascade_prefix_launch asks for at these sizes (the
// wrapper refuses a call above the card's per-block limit).
extern "C" long long cascade_prefix_smem_bytes(int bs, int Lc, int n_rep,
                                               int D, int dtype) {
  const int elem = dtype == 0 ? 4 : 2, nq = Lc * n_rep;
  const int cb = prefix_chunk_blocks(elem, bs, D, nq, Lc);
  return (long long)prefix_smem_bytes(elem, cb * bs, D, nq, Lc);
}

// rows = B * Hq states of D elements each.
extern "C" int merge_states_launch(const void* acc1, const void* m1,
                                   const void* l1, const void* acc2,
                                   const void* m2, const void* l2, void* out,
                                   long long rows, int D, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long n = rows * D;
  const long long blocks = (n + kThreads - 1) / kThreads;
  merge_states_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), kThreads,
                        0, (cudaStream_t)stream>>>(
      (const float*)acc1, (const float*)m1, (const float*)l1,
      (const float*)acc2, (const float*)m2, (const float*)l2, (float*)out, n,
      D);
  return (int)cudaGetLastError();
}
