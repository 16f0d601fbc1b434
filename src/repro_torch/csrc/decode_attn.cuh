// The one-block decode-attention tile loop of paged_attn.cu's fp pools
// (paged_decode; it replaces the TPU kernel
// repro/kernels/paged_attn.py::paged_decode_attention): one query token per
// sequence attends over its K/V rows with an f32 online softmax. The int8
// and int4 kernels (qdecode, paged_qdecode, paged_q4decode) run
// decode_split.cuh's split-K loop instead. What bounds the work is bytes
// (each valid K/V row read once), but this loop's time is latency: each
// block walks its tiles in turn, table entry, then K/V rows, with five
// block barriers a tile; decode_split.cuh's design is the later step for
// these pools too.
//
// One block of 128 threads owns one (sequence b, kv head h) and walks key
// tiles of KT = 32 slots. PagedRows says where slot k of sequence b lives
// in the [rows, Hkv, hd] K/V storage: through the block table and the
// position, slot k is valid iff k <= pos[b] and its table entry is >= 0
// (the TPU kernel's _slot_mask); -1 is masked and never read. A tile's K
// and V rows arrive as 16-byte vectors (hd a multiple of 16 / sizeof(TKV)),
// all of a thread's loads issued before any is stored, and are unpacked to
// f32 in shared memory (K row stride hd + 1, so the column-wise dot
// products do not conflict). Scores for all G query heads go to shared
// memory, one warp per query head updates the running max (seed -1e30) and
// normalizer, and every thread owns up to 8 of the G x hd f32
// accumulators. A masked slot gets score -2e38 and value 0 and its row is
// not read, so whatever the trash block holds (NaN an idle slot wrote
// there included) cannot reach the output. A row with no valid slot gives
// l = 0 and 0/0 = NaN, as the TPU kernel does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

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

// one 16-byte vector of stored elements -> f32 in shared memory
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
struct PagedRows {
  const int* tables;
  int M, bs, p;                         // p = pos[b], the write slot
  __device__ int n_keys() const { return p + 1 < M * bs ? p + 1 : M * bs; }
  __device__ int row(int b, int k) const {   // k < n_keys(), so k <= p
    const int bid = tables[(long)b * M + k / bs];
    return bid >= 0 ? bid * bs + k % bs : -1;
  }
};

// q [B,Hkv,G,hd]; k / v storage [rows, Hkv, hd]; out [B,Hkv,G,hd] f32.
template <typename TQ, typename TKV, typename Rows>
__device__ __forceinline__ void attend(const TQ* __restrict__ q,
                                       const TKV* __restrict__ kp,
                                       const TKV* __restrict__ vp,
                                       const Rows& rows,
                                       float* __restrict__ out, int b, int h,
                                       int Hkv, int G, int hd) {
  __shared__ float Qs[MAXG * MAXD];
  __shared__ float Ks[KT * (MAXD + 1)];
  __shared__ float Vs[KT * MAXD];
  __shared__ float Ps[MAXG * KT];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];
  __shared__ int row_s[KT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int VN = 16 / sizeof(TKV);    // elements per 16-byte load
  constexpr int MAXV = KT * MAXD / VN / PT;
  const int vpr = hd / VN;                 // loads per K or V row
  const int ks = hd + 1;
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

  const int n_keys = rows.n_keys();
  const int n_tiles = n_keys > 0 ? (n_keys + KT - 1) / KT : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * KT;
    __syncthreads();                    // last tile's Ps / Vs reads are done
    if (tid < KT) {
      const int k = k0 + tid;
      row_s[tid] = k < n_keys ? rows.row(b, k) : -1;
    }
    __syncthreads();
    uint4 kr[MAXV], vr[MAXV];
#pragma unroll
    for (int r = 0; r < MAXV; ++r) {
      const int c = tid + r * PT;
      kr[r] = make_uint4(0u, 0u, 0u, 0u);
      vr[r] = kr[r];
      if (c < KT * vpr) {
        const int j = c / vpr;
        const int row = row_s[j];
        if (row >= 0) {
          const long off =
              ((long)row * Hkv + h) * hd + (long)(c - j * vpr) * VN;
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
      if (row_s[j] >= 0) {
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

}  // namespace decode_attn
