// Paged KV cache kernels for Hopper (sm_90a): one-query decode attention
// read through a block table, and the decode tick's in-place row write.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attn.py:
//   paged_decode_attention (_paged_kernel)   -> paged_attn_launch
//   paged_decode_attention_with_state
//                    (_paged_state_kernel)   -> paged_attn_state_launch
//   scatter_kv_rows        (_scatter_kernel) -> scatter_rows_launch
// All are templated on float and __nv_bfloat16 (the arena's dtype).
//
// paged_attn_launch
//   q (B, Hq, D); arenas (num_blocks, bs, Hkv, D); tables (B, nb) int32;
//   lens (B,) int32; optional new rows k1, v1 (B, Hkv, D); out (B, Hq, D).
//   Position pos of lane b attends when lens[b] - win <= pos < lens[b];
//   with new rows, the row at pos == lens[b] - 1 is read from k1/v1 instead
//   of the arena.  Scores, running max m, running sum l and the accumulator
//   are float32; the result is acc / max(l, 1e-30) in the arena's dtype.
//
//   Bound on the H100: bytes.  Each live K and V row is read once (per
//   lane, per KV head) and used for n_rep = Hq/Hkv queries, about 1 flop per
//   byte per query.  Design: one CTA per (KV head, lane) computes that KV
//   head's n_rep query heads.  It walks only the blocks that hold positions
//   in [lens - win, lens), CB blocks (about 64 positions) at a time: the
//   K and V tiles of those blocks are copied to shared memory with 16-byte
//   loads (D = 80 bf16 is 10 of them per row), so each thread has several
//   loads in flight; then one warp per (query, position) pair takes the dot
//   product across its lanes, one warp per query updates m and l, and each
//   thread owns fixed accumulator elements.  Positions outside the window
//   are never read, so garbage in the trash block or in stale rows cannot
//   reach the result (a masked probability is exactly 0, as in the TPU
//   kernel whenever the lane has a valid position; a lane with lens == 0
//   returns 0).  A table entry outside [0, num_blocks) reads block 0.
//
// paged_attn_state_launch (the cascade's per-lane suffix pass)
//   The same CTA loop, instantiated with kState: the table names lane b's
//   divergent-suffix blocks, entry j holding absolute positions
//   q0[b] + j*bs + i, so the sweep covers [max(q0, lens - win),
//   min(lens, q0 + nb*bs)).  It writes the float32 online-softmax state
//   acc (B, Hq, D), m, l (B, Hq) unnormalized instead of out; a sweep with
//   no valid position leaves the empty state (acc 0, m -1e30, l 0), which
//   the cascade merge drops exactly.  The flat instantiation has q0 = 0
//   and is the code above unchanged.
//
// scatter_rows_launch
//   arenas (L, num_blocks, 1, bs, Hkv, D), rows (L, S, Hkv, D), wbids and
//   offs (S,) int32: arena[l, wbids[b], 0, offs[b]] = rows[l, b], in place.
//   Grid (S, L); each CTA copies one K row and one V row of Hkv*D elements.
//   No other byte of the arenas is written; a lane whose block or offset is
//   out of range writes nothing.  Bound: bytes, a copy.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkPositions = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory, in order: K tile [T][D] and V tile [T][D] in the arena's
// dtype (16-byte aligned rows), then float q [n_rep][D], scores
// [n_rep][T], acc [n_rep][D], m, l, corr [n_rep].
// kState: q0 (B,) gives each lane's first position and the state goes to
// acc_out, m_out, l_out; otherwise positions start at 0 and out is written.
template <typename T, bool kState>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ ka,
                  const T* __restrict__ va, const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ lens, const T* __restrict__ k1,
                  const T* __restrict__ v1, T* __restrict__ out,
                  const int32_t* __restrict__ q0s,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int num_blocks, int bs, int nb,
                  int Hkv, int n_rep, int D, int win, int cb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T_ = cb * bs;                        // positions per chunk
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)T_ * D;
  float* qs = reinterpret_cast<float*>(vs + (size_t)T_ * D);
  float* ss = qs + n_rep * D;
  float* acc = ss + n_rep * T_;
  float* ms = acc + n_rep * D;
  float* ls = ms + n_rep;
  float* corr = ls + n_rep;

  const int Hq = Hkv * n_rep;
  const T* qb = q + ((size_t)b * Hq + (size_t)h * n_rep) * D;
  for (int i = tid; i < n_rep * D; i += kThreads) {
    qs[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < n_rep; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  const int len = lens[b];
  const int q0 = kState ? q0s[b] : 0;            // position of table entry 0
  const int hi = min(len, q0 + nb * bs);         // positions [lo, hi) attend
  const int lo = max(q0, len - win);
  const float scale = 1.f / sqrtf((float)D);
  const int vpr = D * (int)sizeof(T) / 16;       // 16-byte vectors per row
  const size_t row_stride = (size_t)Hkv * D;     // elements between rows

  for (int c0 = q0 + (lo - q0) / bs * bs; c0 < hi; c0 += T_) {
    const int t_lo = max(lo - c0, 0), t_hi = min(hi - c0, T_);
    const int rows = min(T_, q0 + ((hi - q0 - 1) / bs + 1) * bs - c0);
    __syncthreads();                             // previous chunk consumed
    for (int i = tid; i < 2 * rows * vpr; i += kThreads) {
      const int which = i / (rows * vpr);        // 0: K, 1: V
      const int j = i - which * rows * vpr;
      const int t = j / vpr, vec = j - t * vpr;
      const int pos = c0 + t;
      const T* src;
      if (k1 != nullptr && pos == len - 1) {
        src = (which ? v1 : k1) + ((size_t)b * Hkv + h) * D;
      } else {
        const int loc = pos - q0;                // index into the table
        int bid = tables[(size_t)b * nb + loc / bs];
        if (bid < 0 || bid >= num_blocks) bid = 0;
        src = (which ? va : ka) +
              ((size_t)bid * bs + loc % bs) * row_stride + (size_t)h * D;
      }
      T* dst = (which ? vs : ks) + (size_t)t * D;
      reinterpret_cast<uint4*>(dst)[vec] =
          __ldg(reinterpret_cast<const uint4*>(src) + vec);
    }
    __syncthreads();
    // scores: one warp per (query, position) pair, lanes across D
    const int span = t_hi - t_lo;
    for (int pr = warp; pr < n_rep * span; pr += kWarps) {
      const int r = pr / span, t = t_lo + (pr - r * span);
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s += qs[r * D + d] * to_f32(ks[(size_t)t * D + d]);
      s = warp_sum(s);
      if (lane == 0) ss[r * T_ + t] = s * scale;
    }
    __syncthreads();
    // online softmax: one warp per query
    for (int r = warp; r < n_rep; r += kWarps) {
      float mx = kNegInf;
      for (int t = t_lo + lane; t < t_hi; t += 32) mx = fmaxf(mx, ss[r * T_ + t]);
      mx = warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = t_lo + lane; t < t_hi; t += 32) {
        const float p = expf(ss[r * T_ + t] - m_new);
        ss[r * T_ + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[r] = c;
        ls[r] = ls[r] * c + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < n_rep * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      float a = acc[e] * corr[r];
      for (int t = t_lo; t < t_hi; ++t)
        a += ss[r * T_ + t] * to_f32(vs[(size_t)t * D + d]);
      acc[e] = a;
    }
  }
  __syncthreads();
  const size_t o0 = ((size_t)b * Hq + (size_t)h * n_rep) * D;
  if constexpr (kState) {
    for (int e = tid; e < n_rep * D; e += kThreads) acc_out[o0 + e] = acc[e];
    for (int r = tid; r < n_rep; r += kThreads) {
      m_out[(size_t)b * Hq + (size_t)h * n_rep + r] = ms[r];
      l_out[(size_t)b * Hq + (size_t)h * n_rep + r] = ls[r];
    }
  } else {
    for (int e = tid; e < n_rep * D; e += kThreads)
      out[o0 + e] = from_f32<T>(acc[e] / fmaxf(ls[e / D], 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(T* __restrict__ ka, T* __restrict__ va,
                    const T* __restrict__ kr, const T* __restrict__ vr,
                    const int32_t* __restrict__ wbids,
                    const int32_t* __restrict__ offs, int num_blocks, int bs,
                    int S, int row) {
  const int b = blockIdx.x, l = blockIdx.y;
  const int wb = wbids[b], off = offs[b];
  if (wb < 0 || wb >= num_blocks || off < 0 || off >= bs) return;
  const size_t dst = (((size_t)l * num_blocks + wb) * bs + off) * row;
  const size_t src = ((size_t)l * S + b) * row;
  const int nvec = row * (int)sizeof(T) / 16;    // whole 16-byte vectors
  for (int i = threadIdx.x; i < 2 * nvec; i += kThreads) {
    const int which = i / nvec, v = i - which * nvec;
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(
                              (which ? vr : kr) + src) + v);
    reinterpret_cast<uint4*>((which ? va : ka) + dst)[v] = x;
  }
}

size_t attn_smem_bytes(int elem, int T_, int D, int n_rep) {
  return (size_t)2 * T_ * D * elem +
         sizeof(float) * ((size_t)2 * n_rep * D + (size_t)n_rep * T_ +
                          3 * (size_t)n_rep);
}

template <typename T, bool kState>
cudaError_t attn_launch(const void* q, const void* ka, const void* va,
                        const void* tables, const void* lens, const void* k1,
                        const void* v1, void* out, const void* q0s,
                        void* acc_out, void* m_out, void* l_out, int B,
                        int num_blocks, int bs, int nb, int Hkv, int n_rep,
                        int D, int win, cudaStream_t stream) {
  const int cb = bs >= kChunkPositions ? 1 : kChunkPositions / bs;
  const size_t smem = attn_smem_bytes(sizeof(T), cb * bs, D, n_rep);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<T, kState>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_attn_kernel<T, kState><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)ka, (const T*)va, (const int32_t*)tables,
      (const int32_t*)lens, (const T*)k1, (const T*)v1, (T*)out,
      (const int32_t*)q0s, (float*)acc_out, (float*)m_out, (float*)l_out,
      num_blocks, bs, nb, Hkv, n_rep, D, win, cb);
  return cudaGetLastError();
}

bool attn_args_ok(int B, int num_blocks, int bs, int nb, int Hkv, int n_rep,
                  int D, int win, int dtype) {
  const int elem = dtype == 0 ? 4 : 2;
  return B > 0 && B <= 65535 && num_blocks > 0 && bs > 0 && nb > 0 &&
         Hkv > 0 && n_rep > 0 && D > 0 && (D * elem) % 16 == 0 && win > 0 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  k1/v1 may be null (no splice).
// Rows of D elements must be whole 16-byte vectors and every pointer
// 16-byte aligned (the wrapper checks).  Returns cudaGetLastError() after
// the launch.
extern "C" int paged_attn_launch(const void* q, const void* ka, const void* va,
                                 const void* tables, const void* lens,
                                 const void* k1, const void* v1, void* out,
                                 int B, int num_blocks, int bs, int nb,
                                 int Hkv, int n_rep, int D, int win, int dtype,
                                 void* stream) {
  if (!attn_args_ok(B, num_blocks, bs, nb, Hkv, n_rep, D, win, dtype))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)attn_launch<float, false>(
        q, ka, va, tables, lens, k1, v1, out, nullptr, nullptr, nullptr,
        nullptr, B, num_blocks, bs, nb, Hkv, n_rep, D, win, s);
  return (int)attn_launch<__nv_bfloat16, false>(
      q, ka, va, tables, lens, k1, v1, out, nullptr, nullptr, nullptr,
      nullptr, B, num_blocks, bs, nb, Hkv, n_rep, D, win, s);
}

// The suffix pass of the cascade: as paged_attn_launch, with q0 (B,) int32
// and the float32 state acc (B, Hq, D), m, l (B, Hq) in place of out.
extern "C" int paged_attn_state_launch(
    const void* q, const void* ka, const void* va, const void* tables,
    const void* lens, const void* q0s, const void* k1, const void* v1,
    void* acc_out, void* m_out, void* l_out, int B, int num_blocks, int bs,
    int nb, int Hkv, int n_rep, int D, int win, int dtype, void* stream) {
  if (!attn_args_ok(B, num_blocks, bs, nb, Hkv, n_rep, D, win, dtype))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)attn_launch<float, true>(
        q, ka, va, tables, lens, k1, v1, nullptr, q0s, acc_out, m_out, l_out,
        B, num_blocks, bs, nb, Hkv, n_rep, D, win, s);
  return (int)attn_launch<__nv_bfloat16, true>(
      q, ka, va, tables, lens, k1, v1, nullptr, q0s, acc_out, m_out, l_out,
      B, num_blocks, bs, nb, Hkv, n_rep, D, win, s);
}

// Shared-memory bytes paged_attn_launch asks for at these sizes (the wrapper
// refuses a call above the card's per-block limit).
extern "C" long long paged_attn_smem_bytes(int bs, int n_rep, int D,
                                           int dtype) {
  const int cb = bs >= kChunkPositions ? 1 : kChunkPositions / bs;
  return (long long)attn_smem_bytes(dtype == 0 ? 4 : 2, cb * bs, D, n_rep);
}

// row = Hkv * D elements; row bytes must be whole 16-byte vectors.
extern "C" int scatter_rows_launch(void* ka, void* va, const void* kr,
                                   const void* vr, const void* wbids,
                                   const void* offs, int L, int num_blocks,
                                   int bs, int S, int row, int dtype,
                                   void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (L <= 0 || L > 65535 || S <= 0 || num_blocks <= 0 || bs <= 0 ||
      row <= 0 || (row * elem) % 16 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(S, L);
  if (dtype == 0)
    scatter_rows_kernel<float><<<grid, kThreads, 0, s>>>(
        (float*)ka, (float*)va, (const float*)kr, (const float*)vr,
        (const int32_t*)wbids, (const int32_t*)offs, num_blocks, bs, S, row);
  else
    scatter_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (__nv_bfloat16*)ka, (__nv_bfloat16*)va, (const __nv_bfloat16*)kr,
        (const __nv_bfloat16*)vr, (const int32_t*)wbids,
        (const int32_t*)offs, num_blocks, bs, S, row);
  return (int)cudaGetLastError();
}
