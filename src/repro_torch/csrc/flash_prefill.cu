// Causal flash prefill attention for Hopper (sm_90a), fp, int8 and int4
// K/V.
//
// Replaces the TPU kernels repro/kernels/flash_prefill.py::
// flash_prefill_attention (_fp_kernel), flash_qprefill_attention
// (_q_kernel) and flash_q4prefill_attention (_q4_kernel): causal
// online-softmax attention of a whole prompt from position 0, GQA query
// rows flattened as r = s * G + g per kv head, tiles above the diagonal
// skipped. The int8 variant reads int8 K [B,S,Hkv,hd] and V [B,S,Hkv,dv]
// with f32 per-(position, head) scales [B,S,Hkv] and fuses the
// dequantization as the TPU kernel does: the K scale multiplies the score
// after the dot, (q . k_codes) * k_s / sqrt(hd), and the V scale is folded
// into the value row as it is staged, code * v_s. The int4 variant reads
// nibble-packed K [B,S,Hkv,hd/2] and V [B,S,Hkv,dv/2] with f16
// per-(position, head, group of 32) scales [B,S,Hkv,hd/32] / [..,dv/32]
// and, as its TPU kernel does, dequantizes K and V while staging them,
// code * s_g, so the score is q . k / sqrt(hd) with no scale after the
// dot.
//
// One block per (64 group-flattened query rows, kv head, batch). The TPU
// kernel carries its running max / normalizer / accumulator across a
// sequential grid axis; here one block loops over the KV tiles itself, up
// to the last query position it holds, so the state never leaves
// registers: 128 threads, each owning 4 rows x (4 keys of a 32-key tile)
// for the scores and 4 rows x (dv / 8 columns) of the f32 accumulator.
// Q, K and V are read as f32 into shared memory (row stride hd + 1 and
// dv + 1, so neither the row-wise nor the column-wise reads conflict).
// Arithmetic is f32 on the CUDA cores: scores qk / sqrt(hd) (a division,
// as the TPU kernel), masked with -2e38, running max seeded at -1e30,
// out = acc / l. Row blocks are issued latest-first so the longest causal
// rows start first.
//
// What bounds it on the H100: the causal f32 work, 2 * (hd + dv) flops per
// (query row, visible key); e.g. 1.07 GFLOP for B4 S256 H32 hd64, 16 us at
// the 67 TFLOP/s f32 rate of the CUDA cores it runs on. Against the card's
// own floor, bytes bound it (q, k, v and scales read once, out written
// once): 21.0 MB with bf16 K/V, 17.0 MB with int8 K/V and 14.9 MB with int4
// K/V at that shape, more than half of it the f32 output. f32 CUDA cores keep the result
// within rounding of the f32 reference; bf16/TF32 tensor-core variants,
// vector loads and a copy pipeline are later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kv_int4.cuh"

namespace {

using kv_int4::q4_t;

constexpr int FT = 128;            // threads: 16 row groups x 8 column lanes
constexpr int FR = 64;             // query rows per block
constexpr int FK = 32;             // keys per KV tile
constexpr int MAXD = 128;          // largest hd and dv
constexpr int DC = MAXD / 8;       // accumulator columns per lane
constexpr float NEG_INF = -2.0e38f;
constexpr float RUN_INIT = -1.0e30f;
constexpr size_t MAX_SMEM =
    sizeof(float) * (FR * (MAXD + 1) + 2 * FK * (MAXD + 1) + FR * (FK + 1));

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// Stages FK positions of one int4 K or V head (width w, w / 2 bytes and
// w / 32 f16 scales per position) into dst [FK][stride] as code * s_g;
// row0 = b * S * Hkv + h, positions past S stage 0.
__device__ __forceinline__ void stage_q4(float* dst, int stride,
                                         const q4_t* src, const __half* sc,
                                         long row0, long k0, int S, int Hkv,
                                         int w) {
  const int hw = w / 2, ng = w / kv_int4::GROUP;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(src);
  for (int i = threadIdx.x; i < FK * hw; i += FT) {
    const int c = i / hw, bb = i - c * hw;   // byte bb: elements 2bb, 2bb+1
    const long kp = k0 + c;
    float lo = 0.f, hi = 0.f;
    if (kp < S) {
      const long e = row0 + kp * Hkv;
      const unsigned u = bytes[e * hw + bb];
      const float s = kv_int4::scale_at(sc, e * ng + 2 * bb / kv_int4::GROUP);
      lo = kv_int4::nibble(u, 0) * s;
      hi = kv_int4::nibble(u, 1) * s;
    }
    dst[c * stride + 2 * bb] = lo;
    dst[c * stride + 2 * bb + 1] = hi;
  }
}

// ks / vs: [B,S,Hkv] f32 scales for int8 K/V (TKV = int8_t), [B,S,Hkv,hd/32]
// / [B,S,Hkv,dv/32] f16 group scales for int4 K/V (TKV = q4_t, TS =
// __half), else unused
template <typename TQ, typename TKV, typename TS>
__global__ void __launch_bounds__(FT)
flash_attend(const TQ* __restrict__ q, const TKV* __restrict__ k,
             const TS* __restrict__ ksp, const TKV* __restrict__ v,
             const TS* __restrict__ vsp, float* __restrict__ out, int S,
             int Hq, int Hkv, int hd, int dv) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr bool Q4 = std::is_same<TKV, q4_t>::value;
  extern __shared__ float smem[];
  __shared__ float Ksc[FK], Vsc[FK];   // the tile's scales (int8 only)
  const int qs = hd + 1, vs = dv + 1, ps = FK + 1;
  float* Qs = smem;                // [FR][hd + 1]
  float* Ks = Qs + FR * qs;        // [FK][hd + 1]
  float* Vs = Ks + FK * qs;        // [FK][dv + 1]
  float* Ps = Vs + FK * vs;        // [FR][FK + 1]

  const int G = Hq / Hkv;
  const int rb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const long rows_total = (long)S * G;
  const long r0 = (long)rb * FR;

  for (int i = tid; i < FR * hd; i += FT) {
    const int r = i / hd, d = i - r * hd;
    const long rg = r0 + r;
    float val = 0.f;
    if (rg < rows_total) {
      const long pos = rg / G;
      const int gg = (int)(rg - pos * G);
      val = to_f32(q[(((long)b * S + pos) * Hq + (long)h * G + gg) * hd + d]);
    }
    Qs[r * qs + d] = val;
  }

  long qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (r0 + ty * 4 + i) / G;
  const long last_row = (r0 + FR < rows_total ? r0 + FR : rows_total) - 1;
  const long q_last = last_row / G;
  const float scale = sqrtf((float)hd);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = RUN_INIT;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (long k0 = 0; k0 <= q_last; k0 += FK) {
    __syncthreads();
    if constexpr (QUANT) {
      if (tid < FK) {
        const long kp = k0 + tid;
        const long at = ((long)b * S + kp) * Hkv + h;
        Ksc[tid] = kp < S ? ksp[at] : 0.f;
        Vsc[tid] = kp < S ? vsp[at] : 0.f;
      }
      __syncthreads();
    }
    if constexpr (Q4) {
      const long row0 = (long)b * S * Hkv + h;
      stage_q4(Ks, qs, k, ksp, row0, k0, S, Hkv, hd);
      stage_q4(Vs, vs, v, vsp, row0, k0, S, Hkv, dv);
    } else {
      for (int i = tid; i < FK * hd; i += FT) {
        const int c = i / hd, d = i - c * hd;
        const long kp = k0 + c;
        Ks[c * qs + d] =
            kp < S ? to_f32(k[(((long)b * S + kp) * Hkv + h) * hd + d]) : 0.f;
      }
      for (int i = tid; i < FK * dv; i += FT) {
        const int c = i / dv, d = i - c * dv;
        const long kp = k0 + c;
        float val =
            kp < S ? to_f32(v[(((long)b * S + kp) * Hkv + h) * dv + d]) : 0.f;
        if (QUANT) val = val * Vsc[c];
        Vs[c * vs + d] = val;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * qs + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 8 * j) * qs + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long kp = k0 + tx + 8 * j;
        const float dot = QUANT ? s[i][j] * Ksc[tx + 8 * j] : s[i][j];
        s[i][j] = (kp <= qpos[i] && kp < S) ? dot / scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * ps + tx + 8 * j] = p;
        psum += p;
      }
      for (int o = 1; o < 8; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();   // a warp's 4 row groups write and read only their own Ps rows

    for (int kk = 0; kk < FK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * ps + kk];
      const float* vrow = Vs + kk * vs;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 8 * c;
        if (col < dv) {
          const float vv = vrow[col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long rg = r0 + ty * 4 + i;
    if (rg >= rows_total) continue;
    const long pos = rg / G;
    const int gg = (int)(rg - pos * G);
    float* o = out + (((long)b * S + pos) * Hq + (long)h * G + gg) * dv;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 8 * c;
      if (col < dv) o[col] = acc[i][c] / l[i];
    }
  }
}

template <typename TQ, typename TKV, typename TS>
int launch(const void* q, const void* k, const TS* ks, const void* v,
           const TS* vs, float* out, int B, int S, int Hq, int Hkv, int hd,
           int dv, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attend<TQ, TKV, TS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem =
      sizeof(float) * (FR * (hd + 1) + FK * (hd + 1) + FK * (dv + 1) +
                       FR * (FK + 1));
  const long rows = (long)S * (Hq / Hkv);
  const dim3 grid((unsigned)((rows + FR - 1) / FR), Hkv, B);
  flash_attend<TQ, TKV, TS><<<grid, FT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), ks,
      static_cast<const TKV*>(v), vs, out, S, Hq, Hkv, hd, dv);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int Hq, int Hkv, int hd, int dv) {
  return B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || hd < 1 || hd > MAXD ||
         dv < 1 || dv > MAXD || Hkv > 65535 || B > 65535;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,S,Hq,hd], k [B,S,Hkv,hd], v [B,S,Hkv,dv], all contiguous and of one
// dtype: float32 (0) or bfloat16 (1). out [B,S,Hq,dv] float32.
int flash_prefill_fwd(const void* q, const void* k, const void* v, int dtype,
                      float* out, int B, int S, int Hq, int Hkv, int hd,
                      int dv, void* stream) {
  if (bad_shape(B, S, Hq, Hkv, hd, dv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float, float>(q, k, nullptr, v, nullptr, out, B, S,
                                       Hq, Hkv, hd, dv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(
        q, k, nullptr, v, nullptr, out, B, S, Hq, Hkv, hd, dv, s);
  return (int)cudaErrorInvalidValue;
}

// q [B,S,Hq,hd] of q_dtype (0 float32, 1 bfloat16); k [B,S,Hkv,hd] and
// v [B,S,Hkv,dv] int8; k_s / v_s [B,S,Hkv] f32; out [B,S,Hq,dv] float32;
// all contiguous.
int flash_qprefill_fwd(const void* q, int q_dtype, const int8_t* k,
                       const float* k_s, const int8_t* v, const float* v_s,
                       float* out, int B, int S, int Hq, int Hkv, int hd,
                       int dv, void* stream) {
  if (bad_shape(B, S, Hq, Hkv, hd, dv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch<float, int8_t, float>(q, k, k_s, v, v_s, out, B, S, Hq,
                                        Hkv, hd, dv, s);
  if (q_dtype == 1)
    return launch<__nv_bfloat16, int8_t, float>(q, k, k_s, v, v_s, out, B,
                                                S, Hq, Hkv, hd, dv, s);
  return (int)cudaErrorInvalidValue;
}

// q [B,S,Hq,hd] of q_dtype (0 float32, 1 bfloat16); k [B,S,Hkv,hd/2] and
// v [B,S,Hkv,dv/2] int4 packed two codes per byte; k_s [B,S,Hkv,hd/32]
// and v_s [B,S,Hkv,dv/32] f16 group scales; out [B,S,Hq,dv] float32; all
// contiguous; hd and dv multiples of 32.
int flash_q4prefill_fwd(const void* q, int q_dtype, const void* k,
                        const __half* k_s, const void* v, const __half* v_s,
                        float* out, int B, int S, int Hq, int Hkv, int hd,
                        int dv, void* stream) {
  if (bad_shape(B, S, Hq, Hkv, hd, dv) || hd % kv_int4::GROUP ||
      dv % kv_int4::GROUP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch<float, q4_t, __half>(q, k, k_s, v, v_s, out, B, S, Hq, Hkv,
                                       hd, dv, s);
  if (q_dtype == 1)
    return launch<__nv_bfloat16, q4_t, __half>(q, k, k_s, v, v_s, out, B, S,
                                               Hq, Hkv, hd, dv, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
