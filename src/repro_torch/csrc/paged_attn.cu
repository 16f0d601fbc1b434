// Paged decode attention for Hopper (sm_90a), fp, int8 and int4 block
// pools.
//
// Replaces the TPU kernels repro/kernels/paged_attn.py::
// paged_decode_attention (_fp_kernel), paged_qdecode_attention
// (_q_kernel) and paged_q4decode_attention (_q4_kernel): one query token
// per sequence attends over the K/V that its block table names in a shared
// pool, with online softmax across the table entries; the int8 variant
// reads int8 pools with f32 per-(slot, head) scale pools, the int4 variant
// nibble-packed pools with f16 per-(slot, head, group of 32) scale pools,
// and both fuse the dequantization.
//
//   q [B,Hkv,G,hd] (f32 or bf16); k_pool / v_pool [N,bs,Hkv,hd] (f32, bf16
//   or int8; int4: [N,bs,Hkv,hd/2] packed bytes); k_scale / v_scale
//   [N,bs,Hkv] f32 (int8) or [N,bs,Hkv,hd/32] f16 (int4); tables [B,M]
//   int32 (-1 = no block); pos [B] int32 (the write slot, included); out
//   [B,Hkv,G,hd] f32. Slot j of entry m is valid iff m * bs + j <= pos[b]
//   and tables[b, m] >= 0.
//
// The TPU kernel's grid is (B, Hkv, M): the table rides the scalar-
// prefetch path and the index map DMAs block tables[b, m] at step m, with
// the running max / normalizer / accumulator in VMEM across the sequential
// m axis. Here one loop serves all three pool kinds: decode_split.cuh's
// split-K loop (PagedRows) in its Fp<T>, Int8 or Int4 code format. A
// cluster of up to 8 CTAs per (b, kv head) reads pos[b], splits the
// sequence's pos[b] + 1 slots into equal shares of 32-slot tiles, stages
// its share's table entries in shared memory once, and its warps walk
// their slots with the next step's codes and scales in flight and no block
// barrier; rank 0 merges the partials through distributed shared memory,
// in rank order. An fp lane reads 8 elements of its row (16 bytes of bf16,
// 32 of f32) and no scale; an int8 lane scales the dot after it; an int4
// lane loads its group's two f16 scales beside its codes and dequantizes K
// and V before the dot, as the TPU int4 kernel does.
//
// The loop never reads a masked slot, so NaN scales or codes that an idle
// slot wrote into the trash block cannot reach a live row, and an idle row
// (no valid slot) is 0/0 = NaN, as the TPU kernel gives.
//
// What bounds it on the H100: bytes. Each valid K/V row is read once
// (2 * hd * itemsize per slot per kv head, plus 8 bytes of scales for
// int8, hd / 8 bytes of group scales for int4); q, tables and out are
// small. At the stablelm-1.6b engine shape (B8 Hkv32 G1 hd64 bs16, ~2450
// valid slots) that is ~20 MB for bf16 pools (~6 us at 3.35 TB/s), ~10.7 MB
// for int8 (~3.2 us) and ~5.8 MB for int4 (~1.7 us). The split loop spreads
// a sequence over up to 8 CTAs and keeps the next step's loads in flight;
// what is left above the bound is latency (see PERF.md).

#include "decode_split.cuh"

namespace {

namespace ds = decode_split;

template <class Fmt, int LPR, int GB>
__device__ __forceinline__ void paged_split(
    const void* __restrict__ q, int q_bf16, const int8_t* __restrict__ kp,
    const typename Fmt::Scale* __restrict__ ksp, const int8_t* __restrict__ vp,
    const typename Fmt::Scale* __restrict__ vsp,
    const int* __restrict__ tables, const int* __restrict__ pos,
    float* __restrict__ out, int M, int bs_shift, int Hkv, int G, int hd) {
  const int h = ds::cluster_head(Hkv), b = blockIdx.y;
  const ds::PagedRows rows{tables, M, bs_shift,
                           min(pos[b] + 1, M << bs_shift)};
  ds::attend<Fmt, LPR, GB>(q, q_bf16, kp, ksp, vp, vsp, rows, out, b, h, Hkv,
                           G, hd);
}

// bf16 or f32 pools: no scale pointer
template <typename T, int LPR, int GB>
__global__ void __launch_bounds__(ds::PT)
paged_decode_split(const void* __restrict__ q, int q_bf16,
                   const int8_t* __restrict__ kp,
                   const int8_t* __restrict__ vp,
                   const int* __restrict__ tables,
                   const int* __restrict__ pos, float* __restrict__ out,
                   int M, int bs_shift, int Hkv, int G, int hd) {
  paged_split<ds::Fp<T>, LPR, GB>(q, q_bf16, kp, nullptr, vp, nullptr,
                                  tables, pos, out, M, bs_shift, Hkv, G, hd);
}

template <int LPR, int GB>
__global__ void __launch_bounds__(ds::PT)
paged_qdecode_split(const void* __restrict__ q, int q_bf16,
                    const int8_t* __restrict__ kp,
                    const float* __restrict__ ksp,
                    const int8_t* __restrict__ vp,
                    const float* __restrict__ vsp,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, float* __restrict__ out,
                    int M, int bs_shift, int Hkv, int G, int hd) {
  paged_split<ds::Int8, LPR, GB>(q, q_bf16, kp, ksp, vp, vsp, tables, pos,
                                 out, M, bs_shift, Hkv, G, hd);
}

// 32 codes a lane at G bound 1: with a floor of 4 CTAs an SM, ptxas keeps
// the kernel under 128 registers without spilling (left to its occupancy
// heuristic it picks 96 and spills); 3 above it, as it picks there
template <int LPR, int GB>
__global__ void __launch_bounds__(ds::PT, GB == 1 ? 4 : 3)
paged_q4decode_split(const void* __restrict__ q, int q_bf16,
                     const int8_t* __restrict__ kp,
                     const __half* __restrict__ ksp,
                     const int8_t* __restrict__ vp,
                     const __half* __restrict__ vsp,
                     const int* __restrict__ tables,
                     const int* __restrict__ pos, float* __restrict__ out,
                     int M, int bs_shift, int Hkv, int G, int hd) {
  paged_split<ds::Int4, LPR, GB>(q, q_bf16, kp, ksp, vp, vsp, tables, pos,
                                 out, M, bs_shift, Hkv, G, hd);
}

template <int LPR, int GB, typename T>
auto split_kernel(ds::Fp<T>) {
  return &paged_decode_split<T, LPR, GB>;
}
template <int LPR, int GB>
auto split_kernel(ds::Int8) {
  return &paged_qdecode_split<LPR, GB>;
}
template <int LPR, int GB>
auto split_kernel(ds::Int4) {
  return &paged_q4decode_split<LPR, GB>;
}

// one launch of the split loop over Fmt's pools (Fp: ksp / vsp unused)
template <class Fmt>
struct GoPaged {
  const void* q;
  int q_bf16;
  const int8_t* kp;
  const typename Fmt::Scale* ksp;
  const int8_t* vp;
  const typename Fmt::Scale* vsp;
  const int* tables;
  const int* pos;
  float* out;
  int B, M, bs, Hkv, G, hd;
  cudaStream_t stream;
  template <int LPR, int GB>
  int run() const {
    const auto kernel = split_kernel<LPR, GB>(Fmt{});
    static const long resident = ds::resident_ctas(kernel);
    int shift = 0;
    while ((1 << shift) < bs) ++shift;
    const int splits = ds::splits_for(M * bs, (long)B * Hkv, resident);
    if constexpr (Fmt::kScaled)
      return ds::launch(kernel, splits, Hkv, B, stream, q, q_bf16, kp, ksp,
                        vp, vsp, tables, pos, out, M, shift, Hkv, G, hd);
    else
      return ds::launch(kernel, splits, Hkv, B, stream, q, q_bf16, kp, vp,
                        tables, pos, out, M, shift, Hkv, G, hd);
  }
};

bool bad_shape(int B, int M, int bs, int Hkv, int G, int hd, int vec) {
  return B <= 0 || B > 65535 || M <= 0 || bs <= 0 || ds::KT % bs ||
         Hkv <= 0 || G < 1 || G > ds::MAXG || hd < vec || hd > ds::MAXD ||
         hd % vec;
}

template <class Fmt>
int go_paged(const void* q, int q_dtype, const void* k, const void* ks,
             const void* v, const void* vs, const int* tables, const int* pos,
             float* out, int B, int M, int bs, int Hkv, int G, int hd,
             void* stream) {
  using Scale = typename Fmt::Scale;
  const GoPaged<Fmt> go{q, q_dtype, static_cast<const int8_t*>(k),
                        static_cast<const Scale*>(ks),
                        static_cast<const int8_t*>(v),
                        static_cast<const Scale*>(vs), tables, pos, out, B, M,
                        bs, Hkv, G, hd, static_cast<cudaStream_t>(stream)};
  return ds::dispatch<Fmt>(go, hd, G);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,Hkv,G,hd] of q_dtype, pools [N,bs,Hkv,hd] of kv_dtype (0 float32,
// 1 bfloat16), tables [B,M] int32, pos [B] int32, out [B,Hkv,G,hd]
// float32; all contiguous, pools 16-byte aligned. bs must divide 32 and hd
// be a multiple of 8. One launch of the split-K loop (decode_split.cuh,
// Fp<T>).
int paged_decode_fwd(const void* q, int q_dtype, const void* k_pool,
                     const void* v_pool, int kv_dtype, const int* tables,
                     const int* pos, float* out, int B, int M, int bs,
                     int Hkv, int G, int hd, void* stream) {
  if (bad_shape(B, M, bs, Hkv, G, hd, 8) || (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 0)
    return go_paged<ds::Fp<float>>(q, q_dtype, k_pool, nullptr, v_pool,
                                   nullptr, tables, pos, out, B, M, bs, Hkv,
                                   G, hd, stream);
  if (kv_dtype == 1)
    return go_paged<ds::Fp<__nv_bfloat16>>(q, q_dtype, k_pool, nullptr,
                                           v_pool, nullptr, tables, pos, out,
                                           B, M, bs, Hkv, G, hd, stream);
  return (int)cudaErrorInvalidValue;
}

// As paged_decode_fwd over int8 pools [N,bs,Hkv,hd] with f32 scale pools
// k_scale / v_scale [N,bs,Hkv]; hd must be a multiple of 16. One launch of
// the split-K loop (decode_split.cuh, Int8).
int paged_qdecode_fwd(const void* q, int q_dtype, const int8_t* k_pool,
                      const float* k_scale, const int8_t* v_pool,
                      const float* v_scale, const int* tables,
                      const int* pos, float* out, int B, int M, int bs,
                      int Hkv, int G, int hd, void* stream) {
  if (bad_shape(B, M, bs, Hkv, G, hd, 16) || (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  return go_paged<ds::Int8>(q, q_dtype, k_pool, k_scale, v_pool, v_scale,
                            tables, pos, out, B, M, bs, Hkv, G, hd, stream);
}

// As paged_decode_fwd over int4 pools [N,bs,Hkv,hd/2] (two codes per
// byte) with f16 group-scale pools k_scale / v_scale [N,bs,Hkv,hd/32]; hd
// must be a multiple of 32. One launch of the split-K loop
// (decode_split.cuh, Int4).
int paged_q4decode_fwd(const void* q, int q_dtype, const int8_t* k_pool,
                       const __half* k_scale, const int8_t* v_pool,
                       const __half* v_scale, const int* tables,
                       const int* pos, float* out, int B, int M, int bs,
                       int Hkv, int G, int hd, void* stream) {
  if (bad_shape(B, M, bs, Hkv, G, hd, kv_int4::GROUP) ||
      (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  return go_paged<ds::Int4>(q, q_dtype, k_pool, k_scale, v_pool, v_scale,
                            tables, pos, out, B, M, bs, Hkv, G, hd, stream);
}

}  // extern "C"
