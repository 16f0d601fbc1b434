// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attn.py::
// paged_decode_attention (_fp_kernel): one query token per sequence
// attends over the K/V that its block table names in a shared pool, with
// online softmax across the table entries.
//
//   q [B,Hkv,G,hd] (f32 or bf16); k_pool / v_pool [N,bs,Hkv,hd] (f32 or
//   bf16); tables [B,M] int32 (-1 = no block); pos [B] int32 (the write
//   slot, included); out [B,Hkv,G,hd] f32. Slot j of entry m is valid iff
//   m * bs + j <= pos[b] and tables[b, m] >= 0.
//
// The TPU kernel's grid is (B, Hkv, M): the table rides the scalar-
// prefetch path and the index map DMAs block tables[b, m] at step m, with
// the running max / normalizer / accumulator in VMEM across the sequential
// m axis. Here one block of 128 threads owns one (b, kv head) and loops
// over key tiles of KT = 32 slots (32 / bs table entries each) up to
// pos[b]; each thread reads the table entry itself (the prefetch becomes
// a plain indexed load). A tile's K and V rows are staged in shared memory
// as f32 (K row stride hd + 1, so the column-wise dot products do not
// conflict); scores qk / sqrt(hd) for all G query heads of the kv head go
// to shared memory, one warp per query head updates the running max (seed
// -1e30) and normalizer, and every thread owns up to 8 of the G x hd f32
// accumulators. Masked slots get score -2e38 and value 0 and their pool
// rows are never read, so whatever block 0 or a stale slot holds cannot
// reach the output. A row with no valid slot (an idle engine slot) sums to
// l = 0 and gives 0/0 = NaN, as the TPU kernel does.
//
// What bounds it on the H100: bytes. Each valid K/V row is read once
// (2 * hd * itemsize per slot per kv head); q, tables and out are small.
// This first version has no copy pipeline: each thread issues all its
// 16-byte loads of a tile at once (hd must be a multiple of 8), but the
// tile's math waits for them, and blocks of other (b, head) pairs on the
// same SM hide part of that latency.
// Split-K over the table (flash-decoding), cp.async/TMA prefetch of the
// next tile and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PT = 128;                 // threads per block
constexpr int KT = 32;                  // key slots per tile (= warp size)
constexpr int MAXG = 8;                 // query heads per kv head
constexpr int MAXD = 128;               // head dim
constexpr int OUT_PER_T = MAXG * MAXD / PT;
constexpr float NEG_INF = -2.0e38f;
constexpr float RUN_INIT = -1.0e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// one 16-byte vector of pool elements -> f32 in shared memory
__device__ __forceinline__ void unpack(float* dst, uint4 u, const float*) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(float* dst, uint4 u,
                                       const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {           // element 2i is the low half
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(PT)
paged_fp(const TQ* __restrict__ q, const TKV* __restrict__ kp,
         const TKV* __restrict__ vp, const int* __restrict__ tables,
         const int* __restrict__ pos, float* __restrict__ out, int M, int bs,
         int Hkv, int G, int hd) {
  __shared__ float Qs[MAXG * MAXD];
  __shared__ float Ks[KT * (MAXD + 1)];
  __shared__ float Vs[KT * MAXD];
  __shared__ float Ps[MAXG * KT];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];
  __shared__ int blk_s[KT];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int VN = 16 / sizeof(TKV);    // pool elements per 16-byte load
  constexpr int MAXV = KT * MAXD / VN / PT;
  const int vpr = hd / VN;                 // loads per K or V row
  const int ks = hd + 1;
  const int p = pos[b];
  const float scale = sqrtf((float)hd);
  const long head = (long)b * Hkv + h;

  for (int i = tid; i < G * hd; i += PT) Qs[i] = to_f32(q[head * G * hd + i]);
  if (tid < G) {
    m_s[tid] = RUN_INIT;
    l_s[tid] = 0.f;
  }
  float acc[OUT_PER_T];
#pragma unroll
  for (int r = 0; r < OUT_PER_T; ++r) acc[r] = 0.f;

  const long n_keys = (long)p + 1 < (long)M * bs ? (long)p + 1 : (long)M * bs;
  const int n_tiles = n_keys > 0 ? (int)((n_keys + KT - 1) / KT) : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * KT;
    __syncthreads();                    // last tile's Ps / Vs reads are done
    if (tid < KT) {
      const int kpos = k0 + tid, m = kpos / bs;
      blk_s[tid] = (kpos <= p && m < M) ? tables[(long)b * M + m] : -1;
    }
    __syncthreads();
    // the tile's K and V rows arrive as 16-byte vectors, all of a
    // thread's loads issued before any is stored
    uint4 kr[MAXV], vr[MAXV];
#pragma unroll
    for (int r = 0; r < MAXV; ++r) {
      const int c = tid + r * PT;
      kr[r] = make_uint4(0u, 0u, 0u, 0u);
      vr[r] = kr[r];
      if (c < KT * vpr) {
        const int j = c / vpr;
        const int bid = blk_s[j];
        if (bid >= 0) {
          const long off = (((long)bid * bs + (k0 + j) % bs) * Hkv + h) * hd +
                           (long)(c - j * vpr) * VN;
          kr[r] = __ldg(reinterpret_cast<const uint4*>(kp + off));
          vr[r] = __ldg(reinterpret_cast<const uint4*>(vp + off));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAXV; ++r) {
      const int c = tid + r * PT;
      if (c < KT * vpr) {
        const int j = c / vpr, d0 = (c - j * vpr) * VN;
        unpack(Ks + j * ks + d0, kr[r], kp);
        unpack(Vs + j * hd + d0, vr[r], kp);
      }
    }
    __syncthreads();
    for (int i = tid; i < G * KT; i += PT) {
      const int g = i / KT, j = i - g * KT;
      float s = NEG_INF;
      if (blk_s[j] >= 0) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d)
          dot = fmaf(Qs[g * hd + d], Ks[j * ks + d], dot);
        s = dot / scale;
      }
      Ps[g * KT + j] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += PT / 32) {
      const float s = Ps[g * KT + lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float pj = expf(s - m_new);
      float sum = pj;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ps[g * KT + lane] = pj;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < OUT_PER_T; ++r) {
      const int o = tid + r * PT;
      if (o < G * hd) {
        const int g = o / hd, d = o - g * hd;
        float a = acc[r] * alpha_s[g];
        for (int j = 0; j < KT; ++j)
          a = fmaf(Ps[g * KT + j], Vs[j * hd + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < OUT_PER_T; ++r) {
    const int o = tid + r * PT;
    if (o < G * hd) out[head * G * hd + o] = acc[r] / l_s[o / hd];
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* pos, float* out, int B, int M, int bs, int Hkv, int G,
           int hd, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  paged_fp<TQ, TKV><<<grid, PT, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), tables, pos, out, M, bs, Hkv, G, hd);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
              const int* tables, const int* pos, float* out, int B, int M,
              int bs, int Hkv, int G, int hd, cudaStream_t s) {
  if (kv_dtype == 0)
    return launch<TQ, float>(q, k, v, tables, pos, out, B, M, bs, Hkv, G, hd,
                             s);
  if (kv_dtype == 1)
    return launch<TQ, __nv_bfloat16>(q, k, v, tables, pos, out, B, M, bs, Hkv,
                                     G, hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,Hkv,G,hd] of q_dtype, pools [N,bs,Hkv,hd] of kv_dtype (0 float32,
// 1 bfloat16), tables [B,M] int32, pos [B] int32, out [B,Hkv,G,hd]
// float32; all contiguous, pools 16-byte aligned. bs must divide 32 and hd
// be a multiple of 8.
int paged_decode_fwd(const void* q, int q_dtype, const void* k_pool,
                     const void* v_pool, int kv_dtype, const int* tables,
                     const int* pos, float* out, int B, int M, int bs,
                     int Hkv, int G, int hd, void* stream) {
  if (B <= 0 || B > 65535 || M <= 0 || bs <= 0 || KT % bs || Hkv <= 0 ||
      G < 1 || G > MAXG || hd < 8 || hd > MAXD || hd % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, q, k_pool, v_pool, tables, pos, out, B,
                            M, bs, Hkv, G, hd, s);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, tables, pos,
                                    out, B, M, bs, Hkv, G, hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
