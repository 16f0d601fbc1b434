// Dense int8-KV decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/qdecode.py::qdecode_attention
// (_kernel): one query token per sequence attends over a dense int8 cache
// with an additive bias, the dequantization fused into the dots:
// scores = (q . k_codes) * k_s / sqrt(hd) + bias, softmax over the row,
// out = sum_j p_j * (v_codes_j * v_s_j).
//
//   q [B,Hkv,G,hd] (f32 or bf16); k / v codes [B,S,Hkv,hd] int8; k_s / v_s
//   [B,S,Hkv] f32; bias [B,S] f32 (0 or -2e38); out [B,Hkv,G,hd] f32.
//
// The TPU kernel stages the whole [S, hd] panel of one (b, kv head) in
// VMEM and takes a full-row softmax. A Hopper block cannot hold that for
// long caches, so one block of 128 threads per (b, kv head) walks S in
// 32-slot tiles with an f32 online softmax (running max seeded at -1e30):
// the same function on every row that has an unmasked slot, which every
// decode row has (slot 0 <= pos). The tile loop is decode_attn.cuh's
// (DenseRows): paged_attn.cu's with an identity table and the additive
// bias in place of the position mask; the k scale multiplies the score
// after the dot and the v scale is folded into the value row.
//
// What bounds it on the H100: bytes. Every slot's codes and scales are
// read once: at the dense-engine shape (B8 S512 Hkv32 G1 hd64) 16.8 MB of
// codes, 1.05 MB of scales and 16 KB of bias, ~5.3 us at 3.35 TB/s. Each
// thread issues its 16-byte loads (16 codes each) of a tile at once, but
// the tile's math waits for them and each block walks its S / 32 tiles in
// turn, so one block's serial walk, not bytes, sets the time: split-K over
// S (flash-decoding) and a cp.async/TMA pipeline are later work.

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

template <typename TQ>
__global__ void __launch_bounds__(PT)
qdecode_attend(const TQ* __restrict__ q, const int8_t* __restrict__ kq,
               const float* __restrict__ ks, const int8_t* __restrict__ vq,
               const float* __restrict__ vs, const float* __restrict__ bias,
               float* __restrict__ out, int S, int Hkv, int G, int hd) {
  const int h = blockIdx.x, b = blockIdx.y;
  const DenseRows rows{bias, S};
  attend<TQ, int8_t>(q, kq, ks, vq, vs, rows, out, b, h, Hkv, G, hd);
}

template <typename TQ>
int launch(const void* q, const int8_t* kq, const float* ks,
           const int8_t* vq, const float* vs, const float* bias, float* out,
           int B, int S, int Hkv, int G, int hd, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  qdecode_attend<TQ><<<grid, PT, 0, stream>>>(
      static_cast<const TQ*>(q), kq, ks, vq, vs, bias, out, S, Hkv, G, hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,Hkv,G,hd] of q_dtype (0 float32, 1 bfloat16); k / v [B,S,Hkv,hd]
// int8, 16-byte aligned; k_s / v_s [B,S,Hkv] f32; bias [B,S] f32; out
// [B,Hkv,G,hd] f32; all contiguous. hd must be a multiple of 16, B * S
// below 2^31.
int qdecode_fwd(const void* q, int q_dtype, const int8_t* k, const float* k_s,
                const int8_t* v, const float* v_s, const float* bias,
                float* out, int B, int S, int Hkv, int G, int hd,
                void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || (long)B * S >= (1L << 31) ||
      Hkv <= 0 || G < 1 || G > MAXG || hd < 16 || hd > MAXD || hd % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch<float>(q, k, k_s, v, v_s, bias, out, B, S, Hkv, G, hd, s);
  if (q_dtype == 1)
    return launch<__nv_bfloat16>(q, k, k_s, v, v_s, bias, out, B, S, Hkv, G,
                                 hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
