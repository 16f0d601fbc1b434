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
// m axis. Here one block of 128 threads owns one (b, kv head) and loops
// over key tiles of 32 slots (32 / bs table entries each) up to pos[b];
// the thread of slot j reads its table entry (the prefetch becomes a plain
// indexed load) and, for int8 pools, the slot's K and V scales; for int4
// pools each thread that loads a 16-byte vector of 32 codes loads its
// group's two f16 scales from the same row address in the same batch of
// loads (no second dependent load per tile), and K is dequantized before
// the dot, as the TPU int4 kernel does. The tile loop is decode_attn.cuh's
// (PagedRows): masked slots are never read, so NaN scales or codes that an
// idle slot wrote into the trash block cannot reach a live row, and an
// idle row (no valid slot) is 0/0 = NaN, as the TPU kernel gives.
//
// What bounds it on the H100: bytes. Each valid K/V row is read once
// (2 * hd * itemsize per slot per kv head, plus 8 bytes of scales for
// int8); q, tables and out are small. At the stablelm-1.6b engine shape
// (B8 Hkv32 G1 hd64 bs16, ~2450 valid slots) that is ~20 MB for bf16 pools
// (~6 us at 3.35 TB/s), ~10.7 MB for int8 (~3.2 us) and ~5.8 MB for int4
// (~1.7 us). This version has no copy pipeline: each thread issues all its
// 16-byte loads of a tile at once (8 bf16, 16 int8 or 32 int4 elements
// each; hd a multiple of 8, of 16 for int8 and of 32 for int4), but the
// tile's math waits for them, and blocks of other (b, head) pairs on the
// same SM hide part of that latency. Split-K over the table
// (flash-decoding), cp.async/TMA prefetch of the next tile and tensor
// cores are later work.

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

using kv_int4::q4_t;

template <typename TQ, typename TKV, typename TS>
__global__ void __launch_bounds__(PT)
paged_attend(const TQ* __restrict__ q, const TKV* __restrict__ kp,
             const TS* __restrict__ ksp, const TKV* __restrict__ vp,
             const TS* __restrict__ vsp, const int* __restrict__ tables,
             const int* __restrict__ pos, float* __restrict__ out, int M,
             int bs, int Hkv, int G, int hd) {
  const int h = blockIdx.x, b = blockIdx.y;
  const PagedRows rows{tables, M, bs, pos[b]};
  attend<TQ, TKV>(q, kp, ksp, vp, vsp, rows, out, b, h, Hkv, G, hd);
}

template <typename TQ, typename TKV, typename TS>
int launch(const void* q, const void* k, const TS* ks, const void* v,
           const TS* vs, const int* tables, const int* pos, float* out,
           int B, int M, int bs, int Hkv, int G, int hd, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  paged_attend<TQ, TKV, TS><<<grid, PT, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), ks,
      static_cast<const TKV*>(v), vs, tables, pos, out, M, bs, Hkv, G, hd);
  return (int)cudaGetLastError();
}

template <typename TKV, typename TS>
int launch_q(int q_dtype, const void* q, const void* k, const TS* ks,
             const void* v, const TS* vs, const int* tables,
             const int* pos, float* out, int B, int M, int bs, int Hkv, int G,
             int hd, cudaStream_t s) {
  if (q_dtype == 0)
    return launch<float, TKV, TS>(q, k, ks, v, vs, tables, pos, out, B, M,
                                  bs, Hkv, G, hd, s);
  if (q_dtype == 1)
    return launch<__nv_bfloat16, TKV, TS>(q, k, ks, v, vs, tables, pos, out,
                                          B, M, bs, Hkv, G, hd, s);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int B, int M, int bs, int Hkv, int G, int hd, int vec) {
  return B <= 0 || B > 65535 || M <= 0 || bs <= 0 || KT % bs || Hkv <= 0 ||
         G < 1 || G > MAXG || hd < vec || hd > MAXD || hd % vec;
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
  if (bad_shape(B, M, bs, Hkv, G, hd, 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return launch_q<float, float>(q_dtype, q, k_pool, nullptr, v_pool,
                                  nullptr, tables, pos, out, B, M, bs, Hkv,
                                  G, hd, s);
  if (kv_dtype == 1)
    return launch_q<__nv_bfloat16, float>(q_dtype, q, k_pool, nullptr,
                                          v_pool, nullptr, tables, pos, out,
                                          B, M, bs, Hkv, G, hd, s);
  return (int)cudaErrorInvalidValue;
}

// As paged_decode_fwd over int8 pools [N,bs,Hkv,hd] with f32 scale pools
// k_scale / v_scale [N,bs,Hkv]; hd must be a multiple of 16.
int paged_qdecode_fwd(const void* q, int q_dtype, const int8_t* k_pool,
                      const float* k_scale, const int8_t* v_pool,
                      const float* v_scale, const int* tables,
                      const int* pos, float* out, int B, int M, int bs,
                      int Hkv, int G, int hd, void* stream) {
  if (bad_shape(B, M, bs, Hkv, G, hd, 16)) return (int)cudaErrorInvalidValue;
  return launch_q<int8_t, float>(q_dtype, q, k_pool, k_scale, v_pool,
                                 v_scale, tables, pos, out, B, M, bs, Hkv, G,
                                 hd, static_cast<cudaStream_t>(stream));
}

// As paged_decode_fwd over int4 pools [N,bs,Hkv,hd/2] (two codes per
// byte) with f16 group-scale pools k_scale / v_scale [N,bs,Hkv,hd/32]; hd
// must be a multiple of 32.
int paged_q4decode_fwd(const void* q, int q_dtype, const void* k_pool,
                       const __half* k_scale, const void* v_pool,
                       const __half* v_scale, const int* tables,
                       const int* pos, float* out, int B, int M, int bs,
                       int Hkv, int G, int hd, void* stream) {
  if (bad_shape(B, M, bs, Hkv, G, hd, kv_int4::GROUP))
    return (int)cudaErrorInvalidValue;
  return launch_q<q4_t, __half>(q_dtype, q, k_pool, k_scale, v_pool,
                                v_scale, tables, pos, out, B, M, bs, Hkv, G,
                                hd, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
