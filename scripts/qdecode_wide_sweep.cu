// The shapes of qdecode's wide class swept over (lanes a slot row, query
// heads a CTA), for scripts/qdecode_wide_sweep.py: the loop of
// src/repro_torch/csrc/decode_split.cuh over a dense int8 cache, one
// instantiation per pair, the host's split rule unless a split count is
// forced. Built on the card with the port's nvcc flags and
// -I src/repro_torch/csrc.

#include "decode_split.cuh"

namespace {

namespace ds = decode_split;

template <int LPR, int GB>
__global__ void __launch_bounds__(ds::PT)
wide_sweep(const void* __restrict__ q, int q_bf16,
           const int8_t* __restrict__ kq, const float* __restrict__ ks,
           const int8_t* __restrict__ vq, const float* __restrict__ vs,
           const float* __restrict__ bias, float* __restrict__ out, int S,
           int Hkv, int G, int hd) {
  const int h = ds::cluster_head(Hkv), b = blockIdx.y;
  const int g0 = blockIdx.z * GB;
  const ds::DenseRows rows{bias, S, S};
  ds::attend<ds::Int8, LPR, GB, ds::DenseRows, ds::WIDE_D>(
      q, q_bf16, kq, ks, vq, vs, rows, out, b, h, Hkv, min(GB, G - g0), hd,
      g0, G);
}

template <int LPR, int GB>
int run(const void* q, int q_bf16, const int8_t* k, const float* k_s,
        const int8_t* v, const float* v_s, const float* bias, float* out,
        int B, int S, int Hkv, int G, int hd, int splits, cudaStream_t st,
        int* used) {
  static const long resident = ds::resident_ctas(&wide_sweep<LPR, GB>);
  const int z = (G + GB - 1) / GB;
  *used = splits ? splits : ds::splits_for(S, (long)B * Hkv * z, resident);
  return ds::launch_z(&wide_sweep<LPR, GB>, *used, Hkv, B, z, st, q, q_bf16,
                      k, k_s, v, v_s, bias, out, S, Hkv, G, hd);
}

}  // namespace

extern "C" {

// variant 0: 32 lanes x 8 codes, 8 heads a CTA; 1: 16 x 16, 4 heads; 2:
// 16 x 16, 2 heads; 3: 16 x 16, 1 head (the committed wide class).
// splits 0: the host's rule. *used: the split count launched.
int wide_sweep_fwd(const void* q, int q_bf16, const int8_t* k,
                   const float* k_s, const int8_t* v, const float* v_s,
                   const float* bias, float* out, int B, int S, int Hkv,
                   int G, int hd, int variant, int splits, void* stream,
                   int* used) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return run<32, 8>(q, q_bf16, k, k_s, v, v_s, bias, out, B, S, Hkv, G,
                        hd, splits, st, used);
    case 1:
      return run<16, 4>(q, q_bf16, k, k_s, v, v_s, bias, out, B, S, Hkv, G,
                        hd, splits, st, used);
    case 2:
      return run<16, 2>(q, q_bf16, k, k_s, v, v_s, bias, out, B, S, Hkv, G,
                        hd, splits, st, used);
    case 3:
      return run<16, 1>(q, q_bf16, k, k_s, v, v_s, bias, out, B, S, Hkv, G,
                        hd, splits, st, used);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
