// The int4 KV tier's wire layout on the card, shared by decode_split.cuh
// (the Int4 format of paged_q4decode's split loop) and flash_prefill.cu
// (flash_q4prefill's flash_q4tc).
//
// Layout (repro_torch/kernels/quantize.py, the JAX package's
// kernels/quantize.py): signed 4-bit codes in [-7, 7], two per byte along
// head_dim, element d in byte d / 2 with the even element in the low
// nibble; one f16 scale per (slot, head, group of GROUP = 32 elements).
// Dequantization is code * scale in f32, exact: a 4-bit code times an
// 11-bit f16 significand fits the f32 significand (not the bf16 one, so
// flash_q4tc feeds the codes to the tensor cores and applies the scales in
// f32), so the kernels and the plain versions dequantize to the same
// values.

#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

namespace kv_int4 {

constexpr int GROUP = 32;               // head_dim elements per f16 scale

}  // namespace kv_int4
