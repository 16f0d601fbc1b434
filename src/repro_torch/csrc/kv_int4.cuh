// The int4 KV tier's wire layout on the card, shared by decode_split.cuh
// (the Int4 format of paged_q4decode's split loop) and flash_prefill.cu
// (flash_q4prefill).
//
// Layout (repro_torch/kernels/quantize.py, the JAX package's
// kernels/quantize.py): signed 4-bit codes in [-7, 7], two per byte along
// head_dim, element d in byte d / 2 with the even element in the low
// nibble; one f16 scale per (slot, head, group of KV_GROUP = 32 elements).
// Dequantization is code * scale in f32, exact: a 4-bit code times an
// 11-bit f16 significand fits the f32 significand, so the kernels and the
// plain versions dequantize to the same values.

#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

namespace kv_int4 {

constexpr int GROUP = 32;               // head_dim elements per f16 scale

// storage tag for packed int4: one byte holds two codes
struct q4_t {
  uint8_t bits;
};
static_assert(sizeof(q4_t) == 1, "q4_t must be one byte");

// nibble k (0 = lowest) of word w, sign-extended, as f32
__device__ __forceinline__ float nibble(unsigned w, int k) {
  return (float)((int)(w << (28 - 4 * k)) >> 28);
}

// one f16 scale read through the read-only cache, as f32
__device__ __forceinline__ float scale_at(const __half* p, long i) {
  return __half2float(
      __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p) + i)));
}

}  // namespace kv_int4
