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
// VMEM and takes a full-row softmax. Here the loop is decode_split.cuh's
// (DenseRows): a cluster of up to 8 CTAs per (b, kv head) splits S into
// equal shares of 32-slot tiles, each CTA's warps walk their slots with an
// f32 online softmax (running max seeded at -1e30) and no block barrier,
// and rank 0 merges the partials through distributed shared memory: the
// same function on every row that has an unmasked slot, which every
// decode row has (slot 0 <= pos). The k scale multiplies the score after
// the dot and the v scale is folded in per slot.
//
// What bounds it on the H100: bytes. Every slot's codes and scales are
// read once: at the dense-engine shape (B8 S512 Hkv32 G1 hd64) 16.8 MB of
// codes, 1.05 MB of scales and 16 KB of bias, ~5.3 us at 3.35 TB/s. The
// one-block-per-(b, kv head) loop this replaces walked S / 32 tiles in
// turn, three dependent round trips each: its time was latency, ~60 us
// at B1 and B8 alike. The split spreads each sequence over up to 8 SMs'
// CTAs, and each warp keeps its next step's loads in flight. The wide
// class (G 16, hd 256 at recurrentgemma's B8 S2048 Hkv1) must read 8.4 MB
// of codes, 131 KB of scales and 64 KB of bias: ~2.6 us at 3.35 TB/s. Its
// 8 (sequence, kv head) pairs give few CTAs, so it splits the query heads
// over a grid axis too, one head a CTA, and reads each K/V row once from
// HBM and G - 1 more times from L2.

#include "decode_split.cuh"

namespace {

namespace ds = decode_split;

template <int LPR, int GB>
__global__ void __launch_bounds__(ds::PT)
qdecode_split(const void* __restrict__ q, int q_bf16,
              const int8_t* __restrict__ kq, const float* __restrict__ ks,
              const int8_t* __restrict__ vq, const float* __restrict__ vs,
              const float* __restrict__ bias, float* __restrict__ out, int S,
              int Hkv, int G, int hd) {
  const int h = ds::cluster_head(Hkv), b = blockIdx.y;
  const ds::DenseRows rows{bias, S, S};
  ds::attend<ds::Int8, LPR, GB>(q, q_bf16, kq, ks, vq, vs, rows, out, b, h,
                                Hkv, G, hd);
}

// The wide class: G up to WIDE_G and hd up to WIDE_D (recurrentgemma's
// 16 query heads x 256 over one kv head, the sliding window's 2048-slot
// ring). blockIdx.z picks a group of WIDE_GB query heads (one); a lane row
// is WIDE_LPR lanes x 16 codes, two slot rows a warp step. Static shared
// memory: q 1 KB and the warps' partials 4 KB.
__global__ void __launch_bounds__(ds::PT)
qdecode_wide(const void* __restrict__ q, int q_bf16,
             const int8_t* __restrict__ kq, const float* __restrict__ ks,
             const int8_t* __restrict__ vq, const float* __restrict__ vs,
             const float* __restrict__ bias, float* __restrict__ out, int S,
             int Hkv, int G, int hd) {
  const int h = ds::cluster_head(Hkv), b = blockIdx.y;
  const int g0 = blockIdx.z * ds::WIDE_GB;
  const ds::DenseRows rows{bias, S, S};
  ds::attend<ds::Int8, ds::WIDE_LPR, ds::WIDE_GB, ds::DenseRows, ds::WIDE_D>(
      q, q_bf16, kq, ks, vq, vs, rows, out, b, h, Hkv,
      min(ds::WIDE_GB, G - g0), hd, g0, G);
}

struct Go {
  const void* q;
  int q_bf16;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const float* bias;
  float* out;
  int B, S, Hkv, G, hd;
  cudaStream_t stream;
  template <int LPR, int GB>
  int run() const {
    static const long resident = ds::resident_ctas(&qdecode_split<LPR, GB>);
    return ds::launch(&qdecode_split<LPR, GB>,
                      ds::splits_for(S, (long)B * Hkv, resident), Hkv, B,
                      stream, q, q_bf16, kq, ks, vq, vs, bias, out, S, Hkv,
                      G, hd);
  }
  int run_wide() const {
    static const long resident = ds::resident_ctas(&qdecode_wide);
    const int z = (G + ds::WIDE_GB - 1) / ds::WIDE_GB;
    return ds::launch_z(&qdecode_wide,
                        ds::splits_for(S, (long)B * Hkv * z, resident), Hkv,
                        B, z, stream, q, q_bf16, kq, ks, vq, vs, bias, out,
                        S, Hkv, G, hd);
  }
};

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,Hkv,G,hd] of q_dtype (0 float32, 1 bfloat16); k / v [B,S,Hkv,hd]
// int8, 16-byte aligned; k_s / v_s [B,S,Hkv] f32; bias [B,S] f32; out
// [B,Hkv,G,hd] f32; all contiguous. hd must be a multiple of 16, B * S
// below 2^31. G <= MAXG and hd <= MAXD take the split classes, anything
// else up to WIDE_G and WIDE_D the wide class.
int qdecode_fwd(const void* q, int q_dtype, const int8_t* k, const float* k_s,
                const int8_t* v, const float* v_s, const float* bias,
                float* out, int B, int S, int Hkv, int G, int hd,
                void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || (long)B * S >= (1L << 31) ||
      Hkv <= 0 || G < 1 || G > ds::WIDE_G || hd < 16 || hd > ds::WIDE_D ||
      hd % 16 || (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Go go{q, q_dtype, k, k_s, v, v_s, bias, out, B, S, Hkv, G, hd,
              static_cast<cudaStream_t>(stream)};
  if (G <= ds::MAXG && hd <= ds::MAXD)
    return ds::dispatch<ds::Int8>(go, hd, G);
  return go.run_wide();
}

}  // extern "C"
