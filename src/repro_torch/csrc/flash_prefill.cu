// Causal flash prefill attention for Hopper (sm_90a), fp, int8 and int4
// K/V.
//
// Replaces the TPU kernels repro/kernels/flash_prefill.py::
// flash_prefill_attention (_fp_kernel), flash_qprefill_attention
// (_q_kernel) and flash_q4prefill_attention (_q4_kernel): causal
// online-softmax attention of a whole prompt from position 0, GQA query
// rows flattened as r = s * G + g per kv head, tiles above the diagonal
// skipped, scores qk / sqrt(hd) (a division, as the TPU kernel) masked with
// -2e38, running max seeded at -1e30, out = acc / l in f32. The TPU kernel
// carries its running max / normalizer / accumulator across a sequential
// grid axis; here one block owns BR group-flattened query rows of one
// (batch, kv head) and loops over the KV tiles itself, up to the last query
// position it holds, so the state never leaves registers. Row blocks are
// issued latest-first so the longest causal rows start first. The tile
// (BR rows, BK keys) is the caller's, from the pairs each body
// instantiates (tc::TileSet: BR 64 or 128, BK 32, 64 or 128; 64 x 64 is
// the tile of old), as the TPU kernels take block_q / block_k. Three
// bodies:
//
// flash_tc (flash_prefill_fwd, bf16 or f32 q/k/v): the tensor-core body.
// BR / 16 warps of 16 query rows; the block's Q is held as bf16 A fragments
// for the whole loop (bf16: staged once in shared memory and read with
// ldmatrix). BK-key K and V tiles stream through a 2-stage shared-memory
// ring filled by 16-byte cp.async copies (rows past S zero-filled), so the
// next tile is in flight while the tensor cores work on this one; rows are
// padded so the fragment reads (ldmatrix, ldmatrix.trans for V) have no
// bank conflicts, and a width that is not a multiple of 16 is zero-padded to
// the next one (exact). S = QK^T runs on mma.sync m16n8k16 bf16 -> f32
// (bf16 x bf16 products are exact in f32), then each score is divided by
// sqrt(hd) (a correctly rounded quotient in three operations, div_by) and
// masked. The online softmax stays in registers (row max and sum over the
// quad that shares a C-fragment row, expf as the reference). The value
// product reuses the C fragments of p as A fragments, split into two bf16
// terms, hi = bf16(p) and lo = bf16(p - hi): O += hi V + lo V keeps the
// product within ~1e-5 of the f32 reference, where one bf16 rounding of p
// alone errs by ~3e-3. f32 q, k and v are split the same way as they are
// read into fragments (K from 64-bit and V from 32-bit shared-memory reads)
// and each mma becomes three, hi hi + hi lo + lo hi, for both products:
// ~2e-5 against the reference. O / l leaves through shared memory in
// coalesced 16-byte stores. Width classes (one instantiation each, as
// registers grow with them): the wider of hd and dv up to 64, 96 or 128,
// and MLA's hd up to 192 with dv up to 128 (deepseek-v2: q and k of
// qk_nope + qk_rope = 192, v of 128, one kv head per query head).
//
// flash_mla (flash_mla_fwd: bf16 q/k/v of MLA's class, hd above 128 up to
// 192, dv up to 128, widths multiples of 8, 16-byte aligned): the same
// function on the instructions the H100 runs at its full tensor rate. At
// deepseek-v2's prefill (B1 S1024 H128 hd192 dv128: 43.0 GFLOP causal,
// 60.2 with the split value product, 201 MB) flash_tc's mma.sync loop
// keeps 244 registers a thread, so 8 warps an SM fill its ring and hide
// its latency; only wgmma reaches the full bf16 rate. This body is
// warp-specialised:
// a CTA owns 128 query rows of one (batch, kv head); one producer thread
// streams 128-key K tiles [BK, 192] and V tiles [BK, 128] by TMA (4-D
// tensor maps over [B, S, Hkv, width], 64-column boxes in 128-byte
// swizzle, zeros past S and past the width) into a 2-stage ring of full /
// empty mbarrier pairs, K and V apart so that S = QK^T starts before V
// lands; two consumer warpgroups of 64 rows take the registers the
// producer gives up (setmaxnreg 40 / 232). Q is staged once, by the
// consumers, in the swizzle the descriptors read. S = QK^T is wgmma
// m64n128k16 over 12 k-steps from shared memory; the scores are scaled
// into log2 units (a multiply by log2(e) / sqrt(hd) in place of div_by,
// then exp2f: within a few f32 roundings of the reference's division and
// expf, which the CPU emulation holds to 1e-4 of flash_prefill_ref),
// masked only on a tile that crosses the warpgroup's diagonal or passes
// S, and the online softmax runs on the accumulator in registers. O += P V
// is wgmma m64n128k16 with P from registers (the accumulator's C fragments
// are the A fragments, p split in two bf16 terms as above) and V's tile as
// the transposed (MN-major) operand. The value product of tile t - 1 is in
// flight while the softmax of tile t computes, and the two warpgroups take
// turns issuing their products (ping-pong on named barriers), so one's
// softmax overlaps the other's products. O times one reciprocal of l
// a row (within an ulp of the division) leaves through shared memory in
// coalesced 16-byte row stores. Bound: bytes at 0.060 ms there, the split
// work 0.061 ms at 989 TFLOP/s.
//
// flash_qtc (flash_qprefill_fwd: int8 K [B,S,Hkv,hd] and V [B,S,Hkv,dv]
// with f32 per-(position, head) scales [B,S,Hkv], bf16 or f32 q): the same
// tensor-core loop over codes. BK-key tiles of int8 codes and their BK K
// and BK V scales stream through a 2-stage cp.async ring (half the bytes of
// the bf16 ring; codes and scales past S zero-filled, so a masked score is
// 0 * 0 before the mask, never NaN); the tile after next is issued as soon
// as a stage is free. Every int8 code is exact in bf16, so one pass per
// tile converts the landed codes into a padded bf16 tile that the
// ldmatrix fragment code above reads, and the codes feed mma.sync
// unchanged. The dequantization is fused as the TPU kernel does it: the
// score is (q . codes) * k_s / sqrt(hd), and the V scale folds into p per
// key, p' = p * v_s, split hi + lo for O += p' V_codes while l sums p. f32
// q is split once into two bf16 terms, two products per mma (the codes
// need no split): ~1e-5 against the f32 reference.
//
// flash_q4tc (flash_q4prefill_fwd: nibble-packed int4 K [B,S,Hkv,hd/2] and
// V [B,S,Hkv,dv/2] with f16 per-(position, head, group of 32) scales
// [B,S,Hkv,hd/32] / [..,dv/32], bf16 or f32 q; kv_int4.cuh's layout): the
// same loop over nibble codes. BK-key tiles of packed bytes (a quarter of
// the bf16 ring's bytes; zero-filled past S, and nibble 0 is code 0) stream
// through the 2-stage cp.async ring; a tile's f16 group scales (2-8 bytes
// a key, Hkv * groups halves from the next key's: below cp.async's 4-byte
// copy at hd 32, 6 bytes at hd 96) are read by plain 2-byte loads into
// registers one tile ahead, a slot per key and side spread over the
// block's threads, and stored to shared memory as f32 when the tile
// lands. One pass per tile turns the nibbles into the padded bf16 tile
// that the ldmatrix code reads: every
// code in [-8, 7] is exact in bf16 (nibble c + 8 under the bf16 exponent of
// 128, then 136 taken off). The dequantized value code * s_g needs up to
// 15 significand bits, more than bf16 holds, so the scales stay in f32:
// each group of 32 K columns (two k16-steps) has its own accumulator,
// which is multiplied by s_k[key, g] before it joins the score (then / sqrt
// (hd), div_by); for each group of 32 V columns, p'_g = p * s_v[key, g] is
// split hi + lo for O[:, group] += p'_g V_codes[:, group], while l sums p.
// f32 q is split once into two bf16 terms, as in flash_qtc.
//
// What bounds them on the H100: bytes (q, k, v and scales read once, out
// written once): 21.0 MB with bf16 K/V at B4 S256 H32 hd64 (6.3 us at 3.35
// TB/s), 40% of it the f32 output, 17.0 MB with int8 K/V, 14.9 MB with
// int4; its causal work, 2 * (hd + dv) flops per visible (query row, key),
// is 1.07 GFLOP there (1.1 us at the bf16 tensor-core rate even with the
// 1.5x of the split value product, 3x for f32 operands).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kv_int4.cuh"
#include "tma.cuh"  // mbarrier / TMA helpers and the tensor-map encoder

// The file builds as three parts, one nvcc each in parallel, linked into
// one library (kernels/_build.py PARTS): REPRO_PART 0 instantiates
// flash_tc and flash_mla, 1 flash_qtc, 2 flash_q4tc. Without REPRO_PART
// one nvcc builds all three.
#ifdef REPRO_PART
#define PART(n) (REPRO_PART == (n))
#else
#define PART(n) 1
#endif

namespace {

constexpr int MAXD = 128;          // largest hd and dv of every body
// flash_tc's MLA class: q and k of hd = qk_nope + qk_rope (128 + 64 at
// deepseek-v2's width) beside v of dv <= MAXD
constexpr int MAXD_MLA = 192;
constexpr float NEG_INF = -2.0e38f;
constexpr float RUN_INIT = -1.0e30f;

bool bad_shape(int B, int S, int Hq, int Hkv, int hd, int dv,
               int max_hd = MAXD) {
  return B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || hd < 1 || hd > max_hd ||
         dv < 1 || dv > MAXD || Hkv > 65535 || B > 65535;
}

// ---------------------------------------------------------------------
// flash_tc: the tensor-core body (see the note at the top). T = bf16:
// operands as they are; T = float: each operand split into two bf16 terms
// and three products per mma (hi hi + hi lo + lo hi).
// ---------------------------------------------------------------------
namespace tc {

// Each body takes its tile as template parameters: BR group-flattened query
// rows a block (16 a warp, so BR / 16 warps and 2 * BR threads) and BK keys
// a K / V tile. The pairs instantiated are listed per body and width class
// in TileSet below.
constexpr int STAGES = 2;          // K/V ring depth

using bf16 = __nv_bfloat16;

template <int BR_, int BK_>
struct Tile {
  static constexpr int BR = BR_;
  static constexpr int BK = BK_;
};
template <class... Ts>
struct Tiles {};

// The tiles each body instantiates, per width class (the wider of hd and dv
// padded to 64, 96 or 128; MLA's 192 / 128). kernels/autotune.py's H100
// profile lists exactly these pairs, and tests/test_torch_autotune.py reads
// them from here. (64, 64) is every class's tile of old. Left out (ptxas
// -v and the tile sweep on an H100, PERF.md, PR 32): 64 x 128 spills
// 840-1268 bytes in every body and class (255 registers); 128 x 128
// spills in flash_tc<bf16> at 128, flash_qtc<float> and flash_q4tc<float>
// at 128, and where it does not, it was never more than ~1% faster than
// the best of these four, not worth its build time; and any tile over the
// 232,448 bytes of shared memory a block may use (flash_tc<float> at 128
// with 128 keys).
enum class Body { TC_BF16, TC_F32, QTC, Q4TC, MLA };
// every body at the width classes 64, 96 and 128
template <Body B, int W>
struct TileSet {
  using type = Tiles<Tile<64, 32>, Tile<64, 64>, Tile<128, 32>, Tile<128, 64>>;
};
// flash_tc's MLA class keeps the tile of old: its f32 instantiation spills
// already, and bf16 MLA prefills take flash_mla
template <>
struct TileSet<Body::TC_BF16, 192> {
  using type = Tiles<Tile<64, 64>>;
};
template <>
struct TileSet<Body::TC_F32, 192> {
  using type = Tiles<Tile<64, 64>>;
};
// flash_mla's one tile: 128 rows (two m64 wgmma warpgroups) by 128 keys
// (its TMA boxes); mla::BM and mla::BK are held to it
template <>
struct TileSet<Body::MLA, 192> {
  using type = Tiles<Tile<128, 128>>;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// a / b correctly rounded, for b > 0 and rcp = RN(1 / b): q0 = RN(a rcp)
// is within an ulp of a / b, the FMA residual a - b q0 is exact, and one
// FMA correction rounds the quotient as IEEE division does (Markstein's
// theorem; outside overflow and underflow). Three operations where the
// compiler's division takes about ten and a branch.
__device__ __forceinline__ float div_by(float a, float b, float rcp) {
  const float q0 = a * rcp;
  return fmaf(fmaf(-q0, b, a), rcp, q0);
}

// Splits two f32 values into bf16 pairs hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0.f);
}
template <>
__device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

// Stages n_rows rows of width w into dst [n_rows][stride]: 16-byte
// cp.async chunks when rows are 16-byte aligned (vec; a row whose pointer
// is null is zero-filled), else element by element. row(i) gives row i's
// first element or nullptr; any is a valid global address for the
// zero-fill copies.
template <int THREADS, typename T, typename RowPtr>
__device__ __forceinline__ void stage_rows(T* dst, int stride, int w,
                                           int n_rows, bool vec, const T* any,
                                           RowPtr row) {
  constexpr int E = 16 / sizeof(T);          // elements per chunk
  const int chunks = (w + E - 1) / E;
  if (vec) {
    for (int i = threadIdx.x; i < n_rows * chunks; i += THREADS) {
      const int r = i / chunks, c = i - r * chunks;
      const T* src = row(r);
      cp_async16(smem_addr(dst + r * stride + c * E),
                 src ? src + c * E : any, src ? 16 : 0);
    }
  } else {
    const int cols = chunks * E;
    for (int i = threadIdx.x; i < n_rows * cols; i += THREADS) {
      const int r = i / cols, c = i - r * cols;
      const T* src = row(r);
      dst[r * stride + c] = (src && c < w) ? src[c] : zero<T>();
    }
  }
}

// Stages BK key rows of width w into dst [BK][stride]. src is key k0's
// row of this (batch, kv head); rows are row_elems apart; keys past S are
// zero-filled. Rows 16-byte aligned (vec): thread -> chunk column
// tid % cpr (cpr = 8, 16, 32 or 64 chunks, those past the row idle) of
// every (THREADS / cpr)-th row, cp.async; else element by element.
template <int BK, int THREADS, typename T>
__device__ __forceinline__ void stage_tile(T* dst, int stride, const T* src,
                                           long row_elems, int w, int k0,
                                           int S, bool vec) {
  // every row step THREADS / cpr divides the tile
  static_assert(BK % (THREADS / 8) == 0, "tile rows per step");
  constexpr int E = 16 / sizeof(T);
  const int chunks = (w + E - 1) / E;
  if (!vec) {
    stage_rows<THREADS>(dst, stride, w, BK, false, src,
                        [&](int r) -> const T* {
                          return k0 + r < S ? src + r * row_elems : nullptr;
                        });
    return;
  }
  // 64 chunks a row: an f32 row of the MLA class (hd up to 192)
  const int lg = chunks > 32 ? 6 : chunks > 16 ? 5 : chunks > 8 ? 4 : 3;
  const int c = threadIdx.x & ((1 << lg) - 1);
  if (c >= chunks) return;
  const int r0 = threadIdx.x >> lg, rstep = THREADS >> lg;
  const T* g = src + r0 * row_elems + c * E;
  const long gstep = rstep * row_elems;
  const uint32_t s = smem_addr(dst + r0 * stride + c * E);
  const uint32_t sstep = rstep * stride * (uint32_t)sizeof(T);
#pragma unroll
  for (int n = 0; n < BK / (THREADS >> 6); ++n) {
    if (n * rstep >= BK) break;
    const bool in = k0 + r0 + n * rstep < S;
    cp_async16(s + n * sstep, in ? g + n * gstep : src, in ? 16 : 0);
  }
}

// Zeroes columns [E * ceil(w / E), ceil16(w)) of n_rows rows: the pad
// that no staging writes.
template <int THREADS, typename T>
__device__ __forceinline__ void zero_pad(T* dst, int stride, int w,
                                         int n_rows) {
  constexpr int E = 16 / sizeof(T);
  const int c0 = (w + E - 1) / E * E, wp = (w + 15) & ~15;
  for (int i = threadIdx.x; i < n_rows * ((wp - c0) / E); i += THREADS) {
    const int r = i / ((wp - c0) / E), c = c0 + (i - r * ((wp - c0) / E)) * E;
    *reinterpret_cast<uint4*>(dst + r * stride + c) = make_uint4(0, 0, 0, 0);
  }
}

// Row strides in elements: bf16 rows padded by 16 bytes, so ldmatrix
// (and ldmatrix.trans) reads 8 rows without bank conflicts; f32 K rows by
// 8 floats (64-bit fragment reads of 4 rows x 8 words hit 32 banks) and
// f32 V rows by 4 (two rows 2 apart land 8 banks apart for the column
// reads of the value fragments).
template <typename T>
__host__ __device__ __forceinline__ int k_stride(int hdp) {
  return hdp + 8;
}
template <typename T>
__host__ __device__ __forceinline__ int v_stride(int dvp) {
  return sizeof(T) == 4 ? dvp + 4 : dvp + 8;
}

// Pieces shared by flash_tc, flash_qtc and flash_q4tc. sc[j][e] is a thread's C
// fragment of keys 8j..8j+7 of a tile: row gid (e < 2) or gid + 8 of the
// warp's 16, key 8j + 2 tig + (e & 1).

// Q as bf16 A fragments of the warp's 16 rows, from the staged tile Qs
template <int HMAX>
__device__ __forceinline__ void q_frags(uint32_t (&qf)[HMAX / 16][4],
                                        const bf16* Qs, int qs, int hdp,
                                        int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < HMAX / 16; ++kk)
    if (kk * 16 < hdp)
      ldsm_x4(qf[kk], smem_addr(Qs + (warp * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * qs +
                                kk * 16 + (lane >> 4) * 8));
}

// f32 Q rows qa (row gid) and qb (gid + 8; null past the rows) as A
// fragments split in two bf16 terms: qf[0] = hi, qf[1] = lo
template <int HMAX>
__device__ __forceinline__ void q_frags_split(uint32_t (&qf)[2][HMAX / 16][4],
                                              const float* qa,
                                              const float* qb, int hd,
                                              int hdp, int tig) {
  auto at = [&](const float* p, int c) -> float {
    return p && c < hd ? __ldg(p + c) : 0.f;
  };
#pragma unroll
  for (int kk = 0; kk < HMAX / 16; ++kk) {
    if (kk * 16 >= hdp) break;
    const int c = kk * 16 + tig * 2;
    split2(at(qa, c), at(qa, c + 1), qf[0][kk][0], qf[1][kk][0]);
    split2(at(qb, c), at(qb, c + 1), qf[0][kk][1], qf[1][kk][1]);
    split2(at(qa, c + 8), at(qa, c + 9), qf[0][kk][2], qf[1][kk][2]);
    split2(at(qb, c + 8), at(qb, c + 9), qf[0][kk][3], qf[1][kk][3]);
  }
}

// sc += Q K^T over the bf16 K tile Kt [BK][ks], for each of the NQ terms
// of Q (one K fragment read serves them all)
template <int HMAX, int NQ, int BK>
__device__ __forceinline__ void qk_bf16(float (&sc)[BK / 8][4],
                                        const uint32_t (&qf)[NQ][HMAX / 16][4],
                                        const bf16* Kt, int ks, int hdp,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < HMAX / 16; ++kk) {
    if (kk * 16 >= hdp) break;
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      uint32_t bk[4];
      ldsm_x4(bk, smem_addr(Kt + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * ks +
                            kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        mma_bf16(sc[2 * jj], qf[n][kk], bk[0], bk[1]);
        mma_bf16(sc[2 * jj + 1], qf[n][kk], bk[2], bk[3]);
      }
    }
  }
}

// Masks the tile's scaled scores (only a tile that crosses the diagonal or
// passes S), moves the running max m of the thread's two rows, rescales
// its part of the normalizer l and the accumulator o, adds this tile's p
// to l and leaves p = exp(s - m) in sc.
template <int DMAX, int BK>
__device__ __forceinline__ void online_softmax(
    float (&sc)[BK / 8][4], int k0, int S, long first_pos, long qpos_lo,
    long qpos_hi, int tig, float& m_lo, float& m_hi, float& l_lo,
    float& l_hi, float (&o)[DMAX / 8][4]) {
  const bool masked = k0 + BK - 1 > first_pos || k0 + BK > S;
  float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = sc[j][e];
      if (masked) {
        const int kp = k0 + j * 8 + tig * 2 + (e & 1);
        if (kp > (e < 2 ? qpos_lo : qpos_hi) || kp >= S) s = NEG_INF;
      }
      sc[j][e] = s;
      if (e < 2) mx_lo = fmaxf(mx_lo, s);
      else mx_hi = fmaxf(mx_hi, s);
    }
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
  }
  const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
  const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(sc[j][e] - (e < 2 ? mn_lo : mn_hi));
      sc[j][e] = p;
      if (e < 2) ps_lo += p;
      else ps_hi += p;
    }
  l_lo = l_lo * a_lo + ps_lo;      // this thread's part; the quad sums
  l_hi = l_hi * a_hi + ps_hi;      // them at the end
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    o[j][0] *= a_lo;
    o[j][1] *= a_lo;
    o[j][2] *= a_hi;
    o[j][3] *= a_hi;
  }
}

// o += P V over the bf16 V tile Vt [BK][vs], P split in two bf16 terms;
// the C fragments of keys 16kk..16kk+15 are the A fragment of k-step kk
template <int DMAX, int BK>
__device__ __forceinline__ void pv_bf16(float (&o)[DMAX / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const bf16* Vt, int vs, int dvp,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t ph[4], pl[4];
    split2(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
    split2(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
    split2(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
    split2(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int jp = 0; jp < DMAX / 16; ++jp) {
      if (jp * 16 >= dvp) break;
      uint32_t bv[4];
      ldsm_x4_trans(bv, smem_addr(Vt + (kk * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * vs +
                                  jp * 16 + (lane >> 4) * 8));
      mma_bf16(o[2 * jp], ph, bv[0], bv[1]);
      mma_bf16(o[2 * jp], pl, bv[0], bv[1]);
      mma_bf16(o[2 * jp + 1], ph, bv[2], bv[3]);
      mma_bf16(o[2 * jp + 1], pl, bv[2], bv[3]);
    }
  }
}

// O / l of the block's BR rows out through shared memory Os [BR][dvp + 8]
// (the caller has synchronized: Os overlays the tiles), in coalesced
// 16-byte row stores
template <int DMAX, int BR>
__device__ __forceinline__ void store_out(const float (&o)[DMAX / 8][4],
                                          float l_lo, float l_hi, float* Os,
                                          float* __restrict__ out, long r0,
                                          long rows_total, int b, int S,
                                          int Hq, int h, int G, int dv,
                                          int dvp, int warp, int lane) {
  constexpr int THREADS = 2 * BR;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o_);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o_);
  }
  const int os = dvp + 8;
  const int rl = warp * 16 + gid;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    if (j * 8 >= dvp) break;
    const int c = j * 8 + tig * 2;
    *reinterpret_cast<float2*>(Os + rl * os + c) =
        make_float2(o[j][0] / l_lo, o[j][1] / l_lo);
    *reinterpret_cast<float2*>(Os + (rl + 8) * os + c) =
        make_float2(o[j][2] / l_hi, o[j][3] / l_hi);
  }
  __syncthreads();
  auto out_row = [&](int r) -> float* {
    const long rg = r0 + r;
    const long pos = rg / G;
    return out + (((long)b * S + pos) * Hq + (long)h * G + (rg - pos * G)) * dv;
  };
  if ((dv & 3) == 0) {
    const int c4 = dv >> 2;
    for (int i = threadIdx.x; i < BR * c4; i += THREADS) {
      const int r = i / c4, c = i - r * c4;
      if (r0 + r < rows_total)
        *reinterpret_cast<float4*>(out_row(r) + c * 4) =
            *reinterpret_cast<const float4*>(Os + r * os + c * 4);
    }
  } else {
    for (int i = threadIdx.x; i < BR * dv; i += THREADS) {
      const int r = i / dv, c = i - r * dv;
      if (r0 + r < rows_total) out_row(r)[c] = Os[r * os + c];
    }
  }
}

// HMAX / DMAX: the largest padded hd / dv this instantiation takes (64, 96
// or 128 each, or MLA's 192 / 128); register arrays are sized by them and
// loops stop at the padded widths, a block-uniform bound. BR / BK: the
// tile (see Tile).
template <typename T, int HMAX, int DMAX, int BR, int BK>
__global__ void __launch_bounds__(2 * BR)
flash_tc(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, float* __restrict__ out, int S, int Hq,
         int Hkv, int hd, int dv, bool vec_k, bool vec_v) {
  constexpr int THREADS = 2 * BR;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int hdp = (hd + 15) & ~15, dvp = (dv + 15) & ~15;
  const int qs = hdp + 8, ks = k_stride<T>(hdp), vs = v_stride<T>(dvp);
  // bf16: Q tile [BR][qs], then the rings; f32: Q is read into registers
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  T* Ks = reinterpret_cast<T*>(tc_smem + (F32 ? 0 : BR * qs * sizeof(bf16)));
  T* Vs = Ks + STAGES * BK * ks;              // K [STAGES][BK][ks]

  const int G = Hq / Hkv;
  const int rb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long rows_total = (long)S * G;
  const long r0 = (long)rb * BR;
  const long last_row = (r0 + BR < rows_total ? r0 + BR : rows_total) - 1;
  const int n_tiles = (int)(last_row / G / BK) + 1;
  const long first_pos = r0 / G;
  auto q_row = [&](long rg) -> const T* {
    if (rg >= rows_total) return nullptr;
    const long pos = rg / G;
    return q + (((long)b * S + pos) * Hq + (long)h * G + (rg - pos * G)) * hd;
  };

  if constexpr (!F32) zero_pad<THREADS>(Qs, qs, hd, BR);
  zero_pad<THREADS>(Ks, ks, hd, STAGES * BK);
  zero_pad<THREADS>(Vs, vs, dv, STAGES * BK);

  if constexpr (!F32)
    stage_rows<THREADS>(Qs, qs, hd, BR, vec_k, q,
                        [&](int r) -> const T* { return q_row(r0 + r); });
  const T* kh = k + ((long)b * S * Hkv + h) * hd;   // key 0, this head
  const T* vh = v + ((long)b * S * Hkv + h) * dv;
  auto stage_kv = [&](int t) {
    const int k0 = t * BK, st = t % STAGES;
    stage_tile<BK, THREADS>(Ks + st * BK * ks, ks, kh + (long)k0 * Hkv * hd,
                            (long)Hkv * hd, hd, k0, S, vec_k);
    stage_tile<BK, THREADS>(Vs + st * BK * vs, vs, vh + (long)k0 * Hkv * dv,
                            (long)Hkv * dv, dv, k0, S, vec_v);
  };
  stage_kv(0);
  cp_async_commit();

  // this thread's two rows of each C fragment: gid and gid + 8
  const long row_lo = r0 + warp * 16 + gid;
  const long qpos_lo = row_lo / G, qpos_hi = (row_lo + 8) / G;
  const float scale = sqrtf((float)hd), rcp = 1.f / scale;

  // Q as A fragments: bf16 (T = bf16), or hi and lo terms (T = float)
  uint32_t qf[F32 ? 2 : 1][HMAX / 16][4];
  if constexpr (F32)
    q_frags_split<HMAX>(qf, q_row(row_lo), q_row(row_lo + 8), hd, hdp, tig);
  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_lo = RUN_INIT, m_hi = RUN_INIT, l_lo = 0.f, l_hi = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage_kv(t + 1);               // in flight while this tile computes
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (!F32) {
      if (t == 0) q_frags<HMAX>(qf[0], Qs, qs, hdp, warp, lane);
    }
    const T* Kt = Ks + (t % STAGES) * BK * ks;
    const T* Vt = Vs + (t % STAGES) * BK * vs;

    // S = Q K^T: BK / 8 n-tiles of 8 keys
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < HMAX / 16; ++kk) {
        if (kk * 16 >= hdp) break;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const T* kr = Kt + (j * 8 + gid) * ks + kk * 16 + tig * 2;
          const float2 x = *reinterpret_cast<const float2*>(kr);
          const float2 y = *reinterpret_cast<const float2*>(kr + 8);
          uint32_t h0, l0, h1, l1;
          split2(x.x, x.y, h0, l0);
          split2(y.x, y.y, h1, l1);
          mma_bf16(sc[j], qf[0][kk], h0, h1);
          mma_bf16(sc[j], qf[0][kk], l0, l1);
          mma_bf16(sc[j], qf[1][kk], h0, h1);
        }
      }
    } else {
      qk_bf16<HMAX, 1, BK>(sc, qf, Kt, ks, hdp, lane);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = div_by(sc[j][e], scale, rcp);   // sc / sqrt(hd)
    online_softmax<DMAX, BK>(sc, t * BK, S, first_pos, qpos_lo, qpos_hi,
                             tig, m_lo, m_hi, l_lo, l_hi, o);

    // O += P V with P split in two bf16 terms
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int jn = 0; jn < DMAX / 8; ++jn) {
          if (jn * 8 >= dvp) break;
          const T* vc = Vt + (kk * 16 + tig * 2) * vs + jn * 8 + gid;
          uint32_t h0, l0, h1, l1;
          split2(vc[0], vc[vs], h0, l0);
          split2(vc[8 * vs], vc[9 * vs], h1, l1);
          mma_bf16(o[jn], ph, h0, h1);
          mma_bf16(o[jn], ph, l0, l1);
          mma_bf16(o[jn], pl, h0, h1);
        }
      }
    } else {
      pv_bf16<DMAX, BK>(o, sc, Vt, vs, dvp, lane);
    }
    __syncthreads();                 // this stage is refilled next+1 tile
  }

  store_out<DMAX, BR>(o, l_lo, l_hi, reinterpret_cast<float*>(tc_smem), out,
                      r0, rows_total, b, S, Hq, h, G, dv, dvp, warp, lane);
}

// Dynamic shared memory of flash_tc at (hd, dv) and tile (BR, BK);
// kernels/autotune.py mirrors it (smem_bytes)
template <typename T>
size_t smem_bytes(int hd, int dv, int BR, int BK) {
  const int hdp = (hd + 15) & ~15, dvp = (dv + 15) & ~15;
  const size_t q = sizeof(T) == 4 ? 0 : sizeof(bf16) * BR * (hdp + 8);
  const size_t tiles = q + sizeof(T) * STAGES * BK *
                               ((size_t)k_stride<T>(hdp) + v_stride<T>(dvp));
  const size_t epilogue = sizeof(float) * (size_t)BR * (dvp + 8);
  return tiles > epilogue ? tiles : epilogue;
}

template <typename T, int HMAX, int DMAX, int BR, int BK>
int launch(const void* q, const void* k, const void* v, float* out, int B,
           int S, int Hq, int Hkv, int hd, int dv, cudaStream_t stream) {
  static bool attr_set = false;   // one per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc<T, HMAX, DMAX, BR, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T>(HMAX, DMAX, BR, BK));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  constexpr int E = 16 / sizeof(T);   // 16-byte copies need aligned rows
  const bool vec_k = hd % E == 0 && ((uintptr_t)q | (uintptr_t)k) % 16 == 0;
  const bool vec_v = dv % E == 0 && (uintptr_t)v % 16 == 0;
  const long rows = (long)S * (Hq / Hkv);
  const dim3 grid((unsigned)((rows + BR - 1) / BR), Hkv, B);
  flash_tc<T, HMAX, DMAX, BR, BK>
      <<<grid, 2 * BR, smem_bytes<T>(hd, dv, BR, BK), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), out, S, Hq, Hkv, hd, dv, vec_k, vec_v);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// flash_qtc: the int8-K/V tensor-core body (see the note at the top). TQ =
// bf16: Q as it is; TQ = float: Q split in two bf16 terms, two products
// per mma (the codes are exact in bf16).
// ---------------------------------------------------------------------

// two int8 codes of x ^ 0x80808080 (bytes j and j + 1) as a bf16 pair,
// exact: each through f32 by a byte permute and a subtraction
__device__ __forceinline__ uint32_t codes_bf16x2(unsigned x, int j) {
  const float a =
      __int_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + j)) - 8388736.f;
  const float b =
      __int_as_float(__byte_perm(x, 0x4B000000u, 0x7441u + j)) - 8388736.f;
  return as_u32(__floats2bfloat162_rn(a, b));
}

// The int8 tile src [BK][w] (w a multiple of 16, rows unpadded) into the
// bf16 tile dst [BK][stride], 16 codes a step
template <int BK, int THREADS>
__device__ __forceinline__ void codes_to_bf16(bf16* dst, int stride,
                                              const int8_t* src, int w) {
  const int cpr = w >> 4;                    // 16-code chunks per row
  for (int i = threadIdx.x; i < BK * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const uint4 u = *reinterpret_cast<const uint4*>(src + i * 16);
    const unsigned x0 = u.x ^ 0x80808080u, x1 = u.y ^ 0x80808080u;
    const unsigned x2 = u.z ^ 0x80808080u, x3 = u.w ^ 0x80808080u;
    uint4* d = reinterpret_cast<uint4*>(dst + r * stride + c * 16);
    d[0] = make_uint4(codes_bf16x2(x0, 0), codes_bf16x2(x0, 2),
                      codes_bf16x2(x1, 0), codes_bf16x2(x1, 2));
    d[1] = make_uint4(codes_bf16x2(x2, 0), codes_bf16x2(x2, 2),
                      codes_bf16x2(x3, 0), codes_bf16x2(x3, 2));
  }
}

// q [B,S,Hq,hd] TQ; k [B,S,Hkv,hd] / v [B,S,Hkv,dv] int8 codes; ksp / vsp
// [B,S,Hkv] f32 scales. HMAX / DMAX / BR / BK as flash_tc.
template <typename TQ, int HMAX, int DMAX, int BR, int BK>
__global__ void __launch_bounds__(2 * BR)
flash_qtc(const TQ* __restrict__ q, const int8_t* __restrict__ k,
          const float* __restrict__ ksp, const int8_t* __restrict__ v,
          const float* __restrict__ vsp, float* __restrict__ out, int S,
          int Hq, int Hkv, int hd, int dv, bool vec_q, bool vec_k,
          bool vec_v) {
  constexpr int THREADS = 2 * BR;
  constexpr bool F32 = sizeof(TQ) == 4;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int hdp = (hd + 15) & ~15, dvp = (dv + 15) & ~15;
  const int qs = hdp + 8, ks = hdp + 8, vs = dvp + 8;
  // bf16 q: the Q tile [BR][qs]; then the bf16 tile the fragments read, K
  // [BK][ks] and V [BK][vs], and its scales Sc [2][BK] (K, V); then the
  // ring: scales Rs [STAGES][2][BK], codes Rk [STAGES][BK][hdp] and Rv
  // [STAGES][BK][dvp]
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Kb = reinterpret_cast<bf16*>(tc_smem +
                                     (F32 ? 0 : BR * qs * sizeof(bf16)));
  bf16* Vb = Kb + BK * ks;
  float* Sc = reinterpret_cast<float*>(Vb + BK * vs);
  float* Rs = Sc + 2 * BK;
  int8_t* Rk = reinterpret_cast<int8_t*>(Rs + STAGES * 2 * BK);
  int8_t* Rv = Rk + STAGES * BK * hdp;

  const int G = Hq / Hkv;
  const int rb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long rows_total = (long)S * G;
  const long r0 = (long)rb * BR;
  const long last_row = (r0 + BR < rows_total ? r0 + BR : rows_total) - 1;
  const int n_tiles = (int)(last_row / G / BK) + 1;
  const long first_pos = r0 / G;
  auto q_row = [&](long rg) -> const TQ* {
    if (rg >= rows_total) return nullptr;
    const long pos = rg / G;
    return q + (((long)b * S + pos) * Hq + (long)h * G + (rg - pos * G)) * hd;
  };

  if constexpr (!F32) {
    zero_pad<THREADS>(Qs, qs, hd, BR);
    stage_rows<THREADS>(Qs, qs, hd, BR, vec_q, q,
                        [&](int r) -> const TQ* { return q_row(r0 + r); });
  }
  const long kv0 = (long)b * S * Hkv + h;         // (b, key 0, h)
  const int8_t* kh = k + kv0 * hd;
  const int8_t* vh = v + kv0 * dv;
  // codes of keys past S and the rows' pad are zero, and so are their
  // scales: a masked score is 0 * 0 before the mask, never NaN
  auto stage_kv = [&](int t) {
    const int k0 = t * BK, st = t % STAGES;
    stage_tile<BK, THREADS>(Rk + st * BK * hdp, hdp,
                            kh + (long)k0 * Hkv * hd, (long)Hkv * hd, hd, k0,
                            S, vec_k);
    stage_tile<BK, THREADS>(Rv + st * BK * dvp, dvp,
                            vh + (long)k0 * Hkv * dv, (long)Hkv * dv, dv, k0,
                            S, vec_v);
    // scale slot i of the tile: key k0 + i % BK's K (i < BK) or V scale
    for (int i = threadIdx.x; i < 2 * BK; i += THREADS) {
      const int key = k0 + i % BK;
      const bool in = key < S;
      cp_async4(smem_addr(Rs + st * 2 * BK + i),
                (i < BK ? ksp : vsp) + kv0 + (in ? (long)key * Hkv : 0),
                in ? 4 : 0);
    }
  };
  stage_kv(0);
  cp_async_commit();
  if (n_tiles > 1) {
    stage_kv(1);
    cp_async_commit();
  }

  const long row_lo = r0 + warp * 16 + gid;
  const long qpos_lo = row_lo / G, qpos_hi = (row_lo + 8) / G;
  const float scale = sqrtf((float)hd), rcp = 1.f / scale;
  uint32_t qf[F32 ? 2 : 1][HMAX / 16][4];
  if constexpr (F32)
    q_frags_split<HMAX>(qf, q_row(row_lo), q_row(row_lo + 8), hd, hdp, tig);
  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_lo = RUN_INIT, m_hi = RUN_INIT, l_lo = 0.f, l_hi = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();                 // tile t landed; tile t - 1 is read
    if constexpr (!F32) {
      if (t == 0) q_frags<HMAX>(qf[0], Qs, qs, hdp, warp, lane);
    }
    const int st = t % STAGES;
    codes_to_bf16<BK, THREADS>(Kb, ks, Rk + st * BK * hdp, hdp);
    codes_to_bf16<BK, THREADS>(Vb, vs, Rv + st * BK * dvp, dvp);
    for (int i = threadIdx.x; i < 2 * BK; i += THREADS)
      Sc[i] = Rs[st * 2 * BK + i];
    __syncthreads();                 // the bf16 tile is written
    if (t + 2 < n_tiles) {           // into the stage just converted
      stage_kv(t + 2);
      cp_async_commit();
    }

    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    qk_bf16<HMAX, F32 ? 2 : 1, BK>(sc, qf, Kb, ks, hdp, lane);
    // (q . codes) * k_s / sqrt(hd), the TPU kernel's order
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float2 f = *reinterpret_cast<const float2*>(Sc + j * 8 + tig * 2);
      sc[j][0] = div_by(sc[j][0] * f.x, scale, rcp);
      sc[j][1] = div_by(sc[j][1] * f.y, scale, rcp);
      sc[j][2] = div_by(sc[j][2] * f.x, scale, rcp);
      sc[j][3] = div_by(sc[j][3] * f.y, scale, rcp);
    }
    online_softmax<DMAX, BK>(sc, t * BK, S, first_pos, qpos_lo, qpos_hi,
                             tig, m_lo, m_hi, l_lo, l_hi, o);
    // p' = p * v_s of its key (l has taken p), then O += p' V_codes
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float2 f =
          *reinterpret_cast<const float2*>(Sc + BK + j * 8 + tig * 2);
      sc[j][0] *= f.x;
      sc[j][1] *= f.y;
      sc[j][2] *= f.x;
      sc[j][3] *= f.y;
    }
    pv_bf16<DMAX, BK>(o, sc, Vb, vs, dvp, lane);
  }

  __syncthreads();                   // the output overlays the tiles
  store_out<DMAX, BR>(o, l_lo, l_hi, reinterpret_cast<float*>(tc_smem), out,
                      r0, rows_total, b, S, Hq, h, G, dv, dvp, warp, lane);
}

// kernels/autotune.py mirrors it (qtc_smem_bytes)
template <typename TQ>
size_t qtc_smem_bytes(int hd, int dv, int BR, int BK) {
  const int hdp = (hd + 15) & ~15, dvp = (dv + 15) & ~15;
  const size_t q = sizeof(TQ) == 4 ? 0 : sizeof(bf16) * BR * (hdp + 8);
  const size_t tiles = q + sizeof(bf16) * BK * (size_t)(hdp + 8 + dvp + 8) +
                       sizeof(float) * (2 + STAGES * 2) * BK +
                       (size_t)STAGES * BK * (hdp + dvp);
  const size_t epilogue = sizeof(float) * (size_t)BR * (dvp + 8);
  return tiles > epilogue ? tiles : epilogue;
}

template <typename TQ, int HMAX, int DMAX, int BR, int BK>
int launch_qtc(const void* q, const int8_t* k, const float* ks,
               const int8_t* v, const float* vs, float* out, int B, int S,
               int Hq, int Hkv, int hd, int dv, cudaStream_t stream) {
  static bool attr_set = false;   // one per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_qtc<TQ, HMAX, DMAX, BR, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)qtc_smem_bytes<TQ>(HMAX, DMAX, BR, BK));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // 16-byte copies need aligned rows: 8 bf16 q elements, 16 codes
  const bool vec_q = hd % 8 == 0 && (uintptr_t)q % 16 == 0;
  const bool vec_k = hd % 16 == 0 && (uintptr_t)k % 16 == 0;
  const bool vec_v = dv % 16 == 0 && (uintptr_t)v % 16 == 0;
  const long rows = (long)S * (Hq / Hkv);
  const dim3 grid((unsigned)((rows + BR - 1) / BR), Hkv, B);
  flash_qtc<TQ, HMAX, DMAX, BR, BK>
      <<<grid, 2 * BR, qtc_smem_bytes<TQ>(hd, dv, BR, BK), stream>>>(
          static_cast<const TQ*>(q), k, ks, v, vs, out, S, Hq, Hkv, hd, dv,
          vec_q, vec_k, vec_v);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// flash_q4tc: the int4-K/V tensor-core body (see the note at the top).
// TQ = bf16: Q as it is; TQ = float: Q split in two bf16 terms, two
// products per mma. The scales multiply in f32, per group of 32 columns.
// ---------------------------------------------------------------------
constexpr int NGMAX = 4;           // most scale groups a row
static_assert(NGMAX * kv_int4::GROUP == MAXD, "groups of the widest row");

// Eight int4 codes of the word w (element 2j in the low nibble of byte j)
// as four bf16 pairs, exact: nibble c + 8 under 0x43 is the bf16 128 + c +
// 8, and 136 is taken off in bf16 (the difference c is representable, so
// the subtraction does not round).
__device__ __forceinline__ void nibbles_bf16x8(unsigned w, uint32_t* d) {
  const unsigned x = w ^ 0x88888888u;
  const unsigned lo = x & 0x0f0f0f0fu, hi = (x >> 4) & 0x0f0f0f0fu;
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte 0 = lo byte j (element 2j), byte 2 = hi byte j (element 2j + 1)
    uint32_t pair = (__byte_perm(lo, hi, 0x0400u + 0x0101u * j) &
                     0x00ff00ffu) | 0x43004300u;
    d[j] = as_u32(__hsub2(*reinterpret_cast<__nv_bfloat162*>(&pair), off));
  }
}

// The packed tile src [BK][w / 2] (w a multiple of 32, rows unpadded) into
// the bf16 tile dst [BK][stride], 32 codes (16 bytes) a step
template <int BK, int THREADS>
__device__ __forceinline__ void nibbles_to_bf16(bf16* dst, int stride,
                                                const int8_t* src, int w) {
  const int cpr = w >> 5;                    // 16-byte chunks per row
  for (int i = threadIdx.x; i < BK * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const uint4 u = *reinterpret_cast<const uint4*>(src + i * 16);
    uint4* d = reinterpret_cast<uint4*>(dst + r * stride + c * 32);
    uint32_t e[16];
    nibbles_bf16x8(u.x, e);
    nibbles_bf16x8(u.y, e + 4);
    nibbles_bf16x8(u.z, e + 8);
    nibbles_bf16x8(u.w, e + 12);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      d[n] = make_uint4(e[4 * n], e[4 * n + 1], e[4 * n + 2], e[4 * n + 3]);
  }
}

// sc += sum over groups g of (Q K_codes^T over g's 32 columns) * s_k[key,
// g]: one accumulator pair per group and 16 keys, scaled in f32 before it
// joins the score; Sk [groups][BK] f32. Each K fragment is read once.
template <int HMAX, int NQ, int BK>
__device__ __forceinline__ void qk_q4(float (&sc)[BK / 8][4],
                                      const uint32_t (&qf)[NQ][HMAX / 16][4],
                                      const bf16* Kt, int ks, const float* Sk,
                                      int hd, int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int jj = 0; jj < BK / 16; ++jj) {
#pragma unroll
    for (int g = 0; g < HMAX / kv_int4::GROUP; ++g) {
      if (g * kv_int4::GROUP >= hd) break;
      float a[2][4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 2 * g + h;
        uint32_t bk[4];
        ldsm_x4(bk, smem_addr(Kt + (jj * 16 + (lane & 7) + (lane >> 4) * 8) *
                                       ks +
                              kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          mma_bf16(a[0], qf[n][kk], bk[0], bk[1]);
          mma_bf16(a[1], qf[n][kk], bk[2], bk[3]);
        }
      }
      const float* sg = Sk + g * BK + jj * 16 + tig * 2;
#pragma unroll
      for (int n = 0; n < 2; ++n) {   // keys 16jj + 8n + 2tig + (e & 1)
        const float2 f = *reinterpret_cast<const float2*>(sg + 8 * n);
        float* s = sc[2 * jj + n];
        s[0] = fmaf(a[n][0], f.x, s[0]);
        s[1] = fmaf(a[n][1], f.y, s[1]);
        s[2] = fmaf(a[n][2], f.x, s[2]);
        s[3] = fmaf(a[n][3], f.y, s[3]);
      }
    }
  }
}

// o[:, g] += p'_g V_codes[:, g] for each group g of 32 value columns, p'_g
// = p * s_v[key, g] split in two bf16 terms; Sv [groups][BK] f32. The C
// fragments of keys 16kk..16kk+15 are the A fragment of k-step kk.
template <int DMAX, int BK>
__device__ __forceinline__ void pv_q4(float (&o)[DMAX / 8][4],
                                      const float (&p)[BK / 8][4],
                                      const bf16* Vt, int vs, const float* Sv,
                                      int dv, int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int g = 0; g < DMAX / kv_int4::GROUP; ++g) {
      if (g * kv_int4::GROUP >= dv) break;
      const float* sg = Sv + g * BK + kk * 16 + tig * 2;
      const float2 fa = *reinterpret_cast<const float2*>(sg);
      const float2 fb = *reinterpret_cast<const float2*>(sg + 8);
      uint32_t ph[4], pl[4];
      split2(p[2 * kk][0] * fa.x, p[2 * kk][1] * fa.y, ph[0], pl[0]);
      split2(p[2 * kk][2] * fa.x, p[2 * kk][3] * fa.y, ph[1], pl[1]);
      split2(p[2 * kk + 1][0] * fb.x, p[2 * kk + 1][1] * fb.y, ph[2], pl[2]);
      split2(p[2 * kk + 1][2] * fb.x, p[2 * kk + 1][3] * fb.y, ph[3], pl[3]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jp = 2 * g + h;
        uint32_t bv[4];
        ldsm_x4_trans(bv, smem_addr(Vt + (kk * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * vs +
                                    jp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * jp], ph, bv[0], bv[1]);
        mma_bf16(o[2 * jp], pl, bv[0], bv[1]);
        mma_bf16(o[2 * jp + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * jp + 1], pl, bv[2], bv[3]);
      }
    }
  }
}

// q [B,S,Hq,hd] TQ; k [B,S,Hkv,hd/2] / v [B,S,Hkv,dv/2] packed int4 codes;
// ksp / vsp [B,S,Hkv,hd/32] / [B,S,Hkv,dv/32] f16 group scales; hd and dv
// multiples of 32. HMAX / DMAX / BR / BK as flash_tc.
template <typename TQ, int HMAX, int DMAX, int BR, int BK>
__global__ void __launch_bounds__(2 * BR)
flash_q4tc(const TQ* __restrict__ q, const int8_t* __restrict__ k,
           const __half* __restrict__ ksp, const int8_t* __restrict__ v,
           const __half* __restrict__ vsp, float* __restrict__ out, int S,
           int Hq, int Hkv, int hd, int dv, bool vec_q, bool vec_k,
           bool vec_v) {
  constexpr int THREADS = 2 * BR;
  // scale slots of a tile a thread: 2 BK (a K and a V slot a key)
  constexpr int SLOTS = (2 * BK + THREADS - 1) / THREADS;
  constexpr bool F32 = sizeof(TQ) == 4;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int qs = hd + 8, ks = hd + 8, vs = dv + 8;
  const int hb = hd / 2, vb = dv / 2;                 // packed bytes a key
  const int ngk = hd / kv_int4::GROUP, ngv = dv / kv_int4::GROUP;
  // bf16 q: the Q tile [BR][qs]; then the bf16 tile the fragments read, K
  // [BK][ks] and V [BK][vs], and its scales Sk [ngk][BK] and Sv [ngv][BK];
  // then the ring of packed codes Rk [STAGES][BK][hb] and Rv
  // [STAGES][BK][vb]
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Kb = reinterpret_cast<bf16*>(tc_smem +
                                     (F32 ? 0 : BR * qs * sizeof(bf16)));
  bf16* Vb = Kb + BK * ks;
  float* Sk = reinterpret_cast<float*>(Vb + BK * vs);
  float* Sv = Sk + ngk * BK;
  int8_t* Rk = reinterpret_cast<int8_t*>(Sv + ngv * BK);
  int8_t* Rv = Rk + STAGES * BK * hb;

  const int G = Hq / Hkv;
  const int rb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long rows_total = (long)S * G;
  const long r0 = (long)rb * BR;
  const long last_row = (r0 + BR < rows_total ? r0 + BR : rows_total) - 1;
  const int n_tiles = (int)(last_row / G / BK) + 1;
  const long first_pos = r0 / G;
  auto q_row = [&](long rg) -> const TQ* {
    if (rg >= rows_total) return nullptr;
    const long pos = rg / G;
    return q + (((long)b * S + pos) * Hq + (long)h * G + (rg - pos * G)) * hd;
  };

  if constexpr (!F32)
    stage_rows<THREADS>(Qs, qs, hd, BR, vec_q, q,
                        [&](int r) -> const TQ* { return q_row(r0 + r); });
  const long kv0 = (long)b * S * Hkv + h;         // (b, key 0, h)
  const int8_t* kh = k + kv0 * hb;
  const int8_t* vh = v + kv0 * vb;
  // codes of keys past S are zero (nibble 0 is code 0), and so are their
  // scales: a masked score is 0 * 0 before the mask, never NaN
  auto stage_kv = [&](int t) {
    const int k0 = t * BK, st = t % STAGES;
    stage_tile<BK, THREADS>(Rk + st * BK * hb, hb, kh + (long)k0 * Hkv * hb,
                            (long)Hkv * hb, hb, k0, S, vec_k);
    stage_tile<BK, THREADS>(Rv + st * BK * vb, vb, vh + (long)k0 * Hkv * vb,
                            (long)Hkv * vb, vb, k0, S, vec_v);
  };
  // this thread's scale slots of a tile: slot i = tid + j THREADS (below 2
  // BK) holds key k0 + i % BK's K (i < BK) or V group scales, raw f16 bits
  // in registers, 0 past S
  unsigned short sr[SLOTS][NGMAX];
  auto load_scales = [&](int t) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const bool k_side = i < BK;
      const int ng = k_side ? ngk : ngv, key = t * BK + i % BK;
      const unsigned short* sh =
          reinterpret_cast<const unsigned short*>(k_side ? ksp : vsp) +
          kv0 * ng;
#pragma unroll
      for (int g = 0; g < NGMAX; ++g)
        sr[j][g] = i < 2 * BK && key < S && g < ng
                       ? __ldg(sh + (long)key * Hkv * ng + g)
                       : (unsigned short)0;
    }
  };
  stage_kv(0);
  cp_async_commit();
  if (n_tiles > 1) {
    stage_kv(1);
    cp_async_commit();
  }
  load_scales(0);

  const long row_lo = r0 + warp * 16 + gid;
  const long qpos_lo = row_lo / G, qpos_hi = (row_lo + 8) / G;
  const float scale = sqrtf((float)hd), rcp = 1.f / scale;
  uint32_t qf[F32 ? 2 : 1][HMAX / 16][4];
  if constexpr (F32)
    q_frags_split<HMAX>(qf, q_row(row_lo), q_row(row_lo + 8), hd, hd, tig);
  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_lo = RUN_INIT, m_hi = RUN_INIT, l_lo = 0.f, l_hi = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();                 // tile t landed; tile t - 1 is read
    if constexpr (!F32) {
      if (t == 0) q_frags<HMAX>(qf[0], Qs, qs, hd, warp, lane);
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int ng = i < BK ? ngk : ngv;
      float* s_dst = (i < BK ? Sk : Sv) + i % BK;
#pragma unroll
      for (int g = 0; g < NGMAX; ++g)
        if (i < 2 * BK && g < ng)
          s_dst[g * BK] = __half2float(__ushort_as_half(sr[j][g]));
    }
    const int st = t % STAGES;
    nibbles_to_bf16<BK, THREADS>(Kb, ks, Rk + st * BK * hb, hd);
    nibbles_to_bf16<BK, THREADS>(Vb, vs, Rv + st * BK * vb, dv);
    __syncthreads();                 // the bf16 tile and its scales
    if (t + 2 < n_tiles) {           // into the stage just converted
      stage_kv(t + 2);
      cp_async_commit();
    }
    if (t + 1 < n_tiles) load_scales(t + 1);   // in flight over this tile

    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    qk_q4<HMAX, F32 ? 2 : 1, BK>(sc, qf, Kb, ks, Sk, hd, lane);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = div_by(sc[j][e], scale, rcp);   // sc / sqrt(hd)
    online_softmax<DMAX, BK>(sc, t * BK, S, first_pos, qpos_lo, qpos_hi,
                             tig, m_lo, m_hi, l_lo, l_hi, o);
    pv_q4<DMAX, BK>(o, sc, Vb, vs, Sv, dv, lane);
  }

  __syncthreads();                   // the output overlays the tiles
  store_out<DMAX, BR>(o, l_lo, l_hi, reinterpret_cast<float*>(tc_smem), out,
                      r0, rows_total, b, S, Hq, h, G, dv, dv, warp, lane);
}

// kernels/autotune.py mirrors it (q4tc_smem_bytes)
template <typename TQ>
size_t q4tc_smem_bytes(int hd, int dv, int BR, int BK) {
  const size_t q = sizeof(TQ) == 4 ? 0 : sizeof(bf16) * BR * (hd + 8);
  const size_t tiles = q + sizeof(bf16) * BK * (size_t)(hd + 8 + dv + 8) +
                       sizeof(float) * BK * (size_t)(hd + dv) /
                           kv_int4::GROUP +
                       (size_t)STAGES * BK * (hd + dv) / 2;
  const size_t epilogue = sizeof(float) * (size_t)BR * (dv + 8);
  return tiles > epilogue ? tiles : epilogue;
}

template <typename TQ, int HMAX, int DMAX, int BR, int BK>
int launch_q4tc(const void* q, const void* k, const __half* ks,
                const void* v, const __half* vs, float* out, int B, int S,
                int Hq, int Hkv, int hd, int dv, cudaStream_t stream) {
  static bool attr_set = false;   // one per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_q4tc<TQ, HMAX, DMAX, BR, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)q4tc_smem_bytes<TQ>(HMAX, DMAX, BR, BK));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // 16-byte copies need aligned rows: 8 bf16 q elements; a packed row of
  // hd / 2 bytes is whole 16-byte chunks
  const bool vec_q = (uintptr_t)q % 16 == 0;
  const bool vec_k = (uintptr_t)k % 16 == 0;
  const bool vec_v = (uintptr_t)v % 16 == 0;
  const long rows = (long)S * (Hq / Hkv);
  const dim3 grid((unsigned)((rows + BR - 1) / BR), Hkv, B);
  flash_q4tc<TQ, HMAX, DMAX, BR, BK>
      <<<grid, 2 * BR, q4tc_smem_bytes<TQ>(hd, dv, BR, BK), stream>>>(
          static_cast<const TQ*>(q), static_cast<const int8_t*>(k), ks,
          static_cast<const int8_t*>(v), vs, out, S, Hq, Hkv, hd, dv, vec_q,
          vec_k, vec_v);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, W>) for the width class W (64, 96, 128)
// of the wider of hd and dv: one instantiation per class, since registers
// (Q fragments, the accumulator) grow with it and set how many blocks
// share an SM
template <class F>
int by_width(int hd, int dv, F f) {
  const int w = hd > dv ? hd : dv;
  if (w <= 64) return f(std::integral_constant<int, 64>{});
  if (w <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

// launch<.., BR, BK> (or launch_qtc, launch_q4tc) for the pair (bq, bk) of
// the list: a pair the list does not hold was not instantiated and is
// refused (cudaErrorInvalidValue), never rounded to a neighbour
template <typename T, int HMAX, int DMAX, class... Ts>
int launch_tile(Tiles<Ts...>, int bq, int bk, const void* q, const void* k,
                const void* v, float* out, int B, int S, int Hq, int Hkv,
                int hd, int dv, cudaStream_t stream) {
  int rc = (int)cudaErrorInvalidValue;
  (void)(((Ts::BR == bq && Ts::BK == bk) &&
          (rc = launch<T, HMAX, DMAX, Ts::BR, Ts::BK>(q, k, v, out, B, S, Hq,
                                                      Hkv, hd, dv, stream),
           true)) ||
         ...);
  return rc;
}

template <typename TQ, int HMAX, int DMAX, class... Ts>
int launch_qtc_tile(Tiles<Ts...>, int bq, int bk, const void* q,
                    const int8_t* k, const float* ks, const int8_t* v,
                    const float* vs, float* out, int B, int S, int Hq,
                    int Hkv, int hd, int dv, cudaStream_t stream) {
  int rc = (int)cudaErrorInvalidValue;
  (void)(((Ts::BR == bq && Ts::BK == bk) &&
          (rc = launch_qtc<TQ, HMAX, DMAX, Ts::BR, Ts::BK>(
               q, k, ks, v, vs, out, B, S, Hq, Hkv, hd, dv, stream),
           true)) ||
         ...);
  return rc;
}

template <typename TQ, int HMAX, int DMAX, class... Ts>
int launch_q4tc_tile(Tiles<Ts...>, int bq, int bk, const void* q,
                     const void* k, const __half* ks, const void* v,
                     const __half* vs, float* out, int B, int S, int Hq,
                     int Hkv, int hd, int dv, cudaStream_t stream) {
  int rc = (int)cudaErrorInvalidValue;
  (void)(((Ts::BR == bq && Ts::BK == bk) &&
          (rc = launch_q4tc<TQ, HMAX, DMAX, Ts::BR, Ts::BK>(
               q, k, ks, v, vs, out, B, S, Hq, Hkv, hd, dv, stream),
           true)) ||
         ...);
  return rc;
}

template <typename T>
constexpr Body tc_body = sizeof(T) == 4 ? Body::TC_F32 : Body::TC_BF16;

// flash_tc adds the MLA class <192, 128> for hd above MAXD (bad_shape has
// held dv to MAXD); the quantized bodies stay at MAXD. Each launches the
// tile (bq, bk) of its class's TileSet, or refuses it.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, float* out, int B,
             int S, int Hq, int Hkv, int hd, int dv, int bq, int bk,
             cudaStream_t stream) {
  if (hd > MAXD)
    return launch_tile<T, MAXD_MLA, MAXD>(
        typename TileSet<tc_body<T>, MAXD_MLA>::type{}, bq, bk, q, k, v, out,
        B, S, Hq, Hkv, hd, dv, stream);
  return by_width(hd, dv, [&](auto W) {
    constexpr int w = decltype(W)::value;
    return launch_tile<T, w, w>(typename TileSet<tc_body<T>, w>::type{}, bq,
                                bk, q, k, v, out, B, S, Hq, Hkv, hd, dv,
                                stream);
  });
}

template <typename TQ>
int dispatch_q(const void* q, const int8_t* k, const float* ks,
               const int8_t* v, const float* vs, float* out, int B, int S,
               int Hq, int Hkv, int hd, int dv, int bq, int bk,
               cudaStream_t stream) {
  return by_width(hd, dv, [&](auto W) {
    constexpr int w = decltype(W)::value;
    return launch_qtc_tile<TQ, w, w>(typename TileSet<Body::QTC, w>::type{},
                                     bq, bk, q, k, ks, v, vs, out, B, S, Hq,
                                     Hkv, hd, dv, stream);
  });
}

template <typename TQ>
int dispatch_q4(const void* q, const void* k, const __half* ks,
                const void* v, const __half* vs, float* out, int B, int S,
                int Hq, int Hkv, int hd, int dv, int bq, int bk,
                cudaStream_t stream) {
  return by_width(hd, dv, [&](auto W) {
    constexpr int w = decltype(W)::value;
    return launch_q4tc_tile<TQ, w, w>(
        typename TileSet<Body::Q4TC, w>::type{}, bq, bk, q, k, ks, v, vs, out,
        B, S, Hq, Hkv, hd, dv, stream);
  });
}

}  // namespace tc

#if PART(0)
// ---------------------------------------------------------------------
// flash_mla: the bf16 MLA class (hd above MAXD up to MAXD_MLA, dv up to
// MAXD) as a warp-specialised wgmma + TMA body (see the note at the top).
// ---------------------------------------------------------------------
namespace mla {

using namespace tma;
using tc::split2;

constexpr int BM = 128;              // query rows a CTA: 2 warpgroups of 64
constexpr int BK = 128;              // keys a K / V tile
constexpr int STAGES = 2;            // K / V ring depth
constexpr int COLS = 64;             // bf16 columns of one 128-byte row
constexpr int ROW_BYTES = 128;       // a TMA box row, 128-byte swizzle
constexpr int HB = MAXD_MLA / COLS;  // 64-column boxes of a Q / K row: 3
constexpr int VB = MAXD / COLS;      // of a V row: 2
constexpr int CONSUMERS = 2;         // warpgroups, 64 query rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;   // + the producer's
constexpr int Q_BYTES = HB * BM * ROW_BYTES;     // 48 KB, staged once
constexpr int K_BYTES = HB * BK * ROW_BYTES;     // 48 KB a stage
constexpr int V_BYTES = VB * BK * ROW_BYTES;     // 32 KB a stage
// 1024 bytes of slack to align the boxes for the swizzle; the barriers
constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) +
                     4 * STAGES * 8;
// the producer warpgroup gives all but 40 of its registers to the
// consumers (168 a thread at launch: one CTA an SM)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
// the epilogue's O / l rows over the ring, padded so that the quads'
// float2 writes of 8 rows hit distinct banks
constexpr int OS = MAXD + 8;
static_assert(SMEM <= 227 * 1024, "shared memory");
static_assert(BM * OS * 4 <= STAGES * (K_BYTES + V_BYTES), "epilogue");
static_assert(BK * ROW_BYTES % 1024 == 0, "boxes stay 1024-byte aligned");

// wgmma operand descriptors of tiles in 128-byte swizzle (bases 1024-byte
// aligned; the hardware swizzles the addresses it forms, as TMA did when
// it wrote the tile). K-major (Q, K): rows of 128 bytes, 8-row groups 1024
// bytes apart (SBO), a k16 step 32 bytes into the row; the leading offset
// is unused. MN-major (V, the transposed operand): a 128-byte row holds 64
// dv columns of one key, 8-key groups 1024 bytes apart (SBO), and the
// second 64-column half (the next atom along N) a box of BK rows further
// (LBO).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((BK * ROW_BYTES) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it cannot see that the tensor cores own them).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for the A fragments of P: their conversions stay before the
// fence instead of sinking between the wgmmas that read them.
template <int R>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// S[64 x 128] (+)= Q[64 x 16] . K[128 x 16]^T, bf16 -> f32, both operands
// K-major in shared memory; scale_d 0 overwrites S
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x 128] += P[64 x 16] . V[16 x 128], bf16 -> f32: P from registers
// (the m16n8k16 A fragment of each warp's 16 rows), V MN-major in shared
// memory (the transposed operand), both 64-column halves in one wgmma;
// d0 / d1 hold columns 0..63 / 64..127
__device__ __forceinline__ void wgmma_pv(float (&d0)[32], float (&d1)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]),
        "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Grid (row blocks, Hkv, B), latest row block first. Warpgroup 2 is the
// producer: one thread fills the K / V ring by TMA (4-D maps over [B, S,
// Hkv, width]: keys past S and columns past hd / dv arrive as zeros, so
// every tile is a full [BK, 192] / [BK, 128] and the wgmma sequences
// carry no branch: a conditional wgmma makes the compiler serialize them).
// Warpgroups 0 and 1 hold 64 query rows each: Q staged once into shared
// memory in the swizzle the descriptors read, then per tile S = Q K^T
// (wgmma from shared memory), the scaled, masked online softmax on the
// accumulator in registers, and O += (p_hi + p_lo) V (wgmma with P from
// registers). The value product of tile t - 1 runs while the softmax of
// tile t computes (P, S and O are 192 registers a thread), and the
// warpgroups take turns issuing their products.
__global__ void __launch_bounds__(THREADS, 1)
flash_mla(const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __nv_bfloat16* __restrict__ q, float* __restrict__ out,
          int S, int Hq, int Hkv, int hd, int dv) {
  extern __shared__ uint8_t mla_smem[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(mla_smem) + 1023) & ~(uintptr_t)1023);
  uint8_t* Ks = Qs + Q_BYTES;                  // [STAGES][HB][BK][128 B]
  uint8_t* Vs = Ks + STAGES * K_BYTES;         // [STAGES][VB][BK][128 B]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Vs + STAGES * V_BYTES);
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int G = Hq / Hkv;
  const int rb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long rows_total = (long)S * G;
  const long r0 = (long)rb * BM;
  const long last_row = (r0 + BM < rows_total ? r0 + BM : rows_total) - 1;
  const int n_tiles = (int)(last_row / G / BK) + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], CONSUMERS);
      mbar_init(&empty_v[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the K / V ring full ----
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES, ph = (t / STAGES) & 1;
        mbar_wait(&empty_k[st], ph ^ 1);
        mbar_expect_tx(&full_k[st], K_BYTES);
        for (int j = 0; j < HB; ++j)
          tma_load_4d(Ks + st * K_BYTES + j * BK * ROW_BYTES, &tm_k,
                      &full_k[st], j * COLS, h, t * BK, b);
        mbar_wait(&empty_v[st], ph ^ 1);
        mbar_expect_tx(&full_v[st], V_BYTES);
        for (int j = 0; j < VB; ++j)
          tma_load_4d(Vs + st * V_BYTES + j * BK * ROW_BYTES, &tm_v,
                      &full_v[st], j * COLS, h, t * BK, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows a warpgroup ----
  reg_alloc<CONSUMER_REGS>();
  // Q: the CTA's rows (zero past the rows and past hd) into HB boxes of
  // [BM][128 B], 16-byte chunk c of row r at chunk c ^ (r % 8): the
  // 128-byte swizzle that TMA writes and the descriptors read. A thread's
  // QIT chunks are loaded together, then stored.
  constexpr int QIT = BM * HB * 8 / (CONSUMERS * 128);
  uint4 qv[QIT];
#pragma unroll
  for (int it = 0; it < QIT; ++it) {
    const int i = threadIdx.x + it * CONSUMERS * 128;
    const int r = i / (HB * 8), c = i - r * (HB * 8);
    const long rg = r0 + r;
    qv[it] = make_uint4(0, 0, 0, 0);
    if (rg < rows_total && c * 8 < hd) {
      const long pos = rg / G;
      qv[it] = __ldg(reinterpret_cast<const uint4*>(
          q + (((long)b * S + pos) * Hq + (long)h * G + (rg - pos * G)) * hd +
          c * 8));
    }
  }
#pragma unroll
  for (int it = 0; it < QIT; ++it) {
    const int i = threadIdx.x + it * CONSUMERS * 128;
    const int r = i / (HB * 8), c = i - r * (HB * 8);
    *reinterpret_cast<uint4*>(Qs + (c >> 3) * BM * ROW_BYTES +
                              r * ROW_BYTES + (((c & 7) ^ (r & 7)) << 4)) =
        qv[it];
  }
  // the generic-proxy stores, visible to wgmma's reads; the consumers only
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");

  const int t128 = threadIdx.x & 127;
  const int warp = t128 >> 5, lane = t128 & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long row_lo = r0 + wg * 64 + warp * 16 + gid;
  const long qpos_lo = row_lo / G, qpos_hi = (row_lo + 8) / G;
  const long first_pos = (r0 + wg * 64) / G;   // this warpgroup's
  // scores in log2 units: qk * (log2(e) / sqrt(hd)), then exp2
  const float scale = LOG2E / sqrtf((float)hd);
  const uint32_t qa = smem_u32(Qs) + wg * 64 * ROW_BYTES;

  float s[64], o[VB][32];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < VB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float m_lo = RUN_INIT, m_hi = RUN_INIT, l_lo = 0.f, l_hi = 0.f;

  // S = Q K^T of tile t, committed as one group
  auto issue_qk = [&](int t) {
    const int st = t % STAGES;
    mbar_wait(&full_k[st], (t / STAGES) & 1);
    const uint32_t kb = smem_u32(Ks + st * K_BYTES);
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MAXD_MLA / 16; ++kk)
      wgmma_qk(s,
               kmajor_desc(qa + (kk >> 2) * BM * ROW_BYTES + (kk & 3) * 32),
               kmajor_desc(kb + (kk >> 2) * BK * ROW_BYTES + (kk & 3) * 32),
               kk > 0);
    wgmma_commit();
  };
  // O += P V of tile t from ph / pl, committed as one group
  auto issue_pv = [&](int t) {
    const int st = t % STAGES;
    mbar_wait(&full_v[st], (t / STAGES) & 1);
    const uint32_t vb = smem_u32(Vs + st * V_BYTES);
#pragma unroll
    for (int j = 0; j < VB; ++j) fence_acc(o[j]);
    fence_frags(ph);
    fence_frags(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t d = mnmajor_desc(vb + kk * 16 * ROW_BYTES);
      wgmma_pv(o[0], o[1], ph[kk], d);
      wgmma_pv(o[0], o[1], pl[kk], d);
    }
    wgmma_commit();
  };
  // the scaled, masked scores of tile t in s, the running max moved, p =
  // exp2(s - m) left in s and its sum added to l; returns the rescale
  // factors of the rows' earlier sums
  auto softmax = [&](int t, float& a_lo, float& a_hi) {
    const int k0 = t * BK;
    const bool masked = k0 + BK - 1 > first_pos || k0 + BK > S;
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale;
        if (masked) {
          const int kp = k0 + j * 8 + tig * 2 + (e & 1);
          if (kp > (e < 2 ? qpos_lo : qpos_hi) || kp >= S) x = NEG_INF;
        }
        s[4 * j + e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x);
        else mx_hi = fmaxf(mx_hi, x);
      }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    a_lo = exp2f(m_lo - mn_lo);
    a_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - (e < 2 ? mn_lo : mn_hi));
        s[4 * j + e] = p;
        if (e < 2) ps_lo += p;
        else ps_hi += p;
      }
    l_lo = l_lo * a_lo + ps_lo;      // this thread's part; the quad sums
    l_hi = l_hi * a_hi + ps_hi;      // them at the end
  };
  // p in s as the A fragments of the value product, split in two bf16
  // terms; the C fragments of keys 16kk..16kk+15 are k-step kk's
  auto to_frags = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      split2(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
      split2(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
      split2(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
      split2(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
    }
  };
  const bool lead = t128 == 0;       // arrives for the warpgroup

  // Ping-pong: the warpgroups take turns issuing their products (named
  // barriers 2 and 3, each 128 threads waiting and 128 arriving), so one
  // warpgroup's softmax runs while the other's products do. Warpgroup 1
  // opens the first turn for warpgroup 0 and skips its last pass, so every
  // barrier ends with as many arrivals as waits.
  const int turns = n_tiles + 1;
  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory");
  };
  auto turn_pass = [&](int k) {
    if (!(wg == 1 && k == turns - 1))
      asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wg) : "memory");
  };
  if (wg == 1) asm volatile("bar.arrive 2, 256;\n" ::: "memory");

  float a_lo, a_hi;
  turn_wait();
  issue_qk(0);
  turn_pass(0);
  wgmma_wait<0>();
  fence_acc(s);
  if (lead) mbar_arrive(&empty_k[0]);
  softmax(0, a_lo, a_hi);
  to_frags();
  for (int t = 1; t < n_tiles; ++t) {
    turn_wait();
    issue_qk(t);
    issue_pv(t - 1);
    turn_pass(t);
    wgmma_wait<1>();                 // S of tile t; P V of t - 1 in flight
    fence_acc(s);
    if (lead) mbar_arrive(&empty_k[t % STAGES]);
    softmax(t, a_lo, a_hi);
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < VB; ++j) fence_acc(o[j]);
    if (lead) mbar_arrive(&empty_v[(t - 1) % STAGES]);
#pragma unroll
    for (int j = 0; j < VB; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[j][4 * i] *= a_lo;
        o[j][4 * i + 1] *= a_lo;
        o[j][4 * i + 2] *= a_hi;
        o[j][4 * i + 3] *= a_hi;
      }
    to_frags();
  }
  turn_wait();
  issue_pv(n_tiles - 1);
  turn_pass(n_tiles);
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < VB; ++j) fence_acc(o[j]);

  // O / l through shared memory (over the ring, once both warpgroups are
  // done with it: the last tile's loads have all been consumed), then out
  // in coalesced 16-byte row stores
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o_);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o_);
  }
  // one reciprocal a row (within an ulp of the division, far inside 1e-4)
  const float r_lo = 1.f / l_lo, r_hi = 1.f / l_hi;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
  float* Os = reinterpret_cast<float*>(Ks);        // [BM][OS]
  const int rl = wg * 64 + warp * 16 + gid;
#pragma unroll
  for (int j = 0; j < VB; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = j * COLS + i * 8 + tig * 2;
      *reinterpret_cast<float2*>(Os + rl * OS + c) =
          make_float2(o[j][4 * i] * r_lo, o[j][4 * i + 1] * r_lo);
      *reinterpret_cast<float2*>(Os + (rl + 8) * OS + c) =
          make_float2(o[j][4 * i + 2] * r_hi, o[j][4 * i + 3] * r_hi);
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
  for (int i = threadIdx.x; i < BM * (MAXD / 4); i += CONSUMERS * 128) {
    const int r = i / (MAXD / 4), c = (i - r * (MAXD / 4)) * 4;
    const long rg = r0 + r;
    if (rg < rows_total && c < dv) {
      const long pos = rg / G;
      *reinterpret_cast<float4*>(
          out + (((long)b * S + pos) * Hq + (long)h * G + (rg - pos * G)) * dv +
          c) = *reinterpret_cast<const float4*>(Os + r * OS + c);
    }
  }
}

// [B, S, Hkv, w] bf16 as a 4-D map of boxes [1][BK][1][64] (64 columns of
// BK keys of one head) in 128-byte swizzle; keys past S and columns past
// w fill with zeros
int make_map(CUtensorMap* map, const void* base, int w, int Hkv, int S,
             int B) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)Hkv, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)w * 2, (cuuint64_t)Hkv * w * 2,
                                 (cuuint64_t)S * Hkv * w * 2};
  const cuuint32_t box[4] = {COLS, 1, BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch(const void* q, const void* k, const void* v, float* out, int B,
           int S, int Hq, int Hkv, int hd, int dv, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mla, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap tk, tv;
  int rc = make_map(&tk, k, hd, Hkv, S, B);
  if (rc) return rc;
  rc = make_map(&tv, v, dv, Hkv, S, B);
  if (rc) return rc;
  const long rows = (long)S * (Hq / Hkv);
  const dim3 grid((unsigned)((rows + BM - 1) / BM), Hkv, B);
  flash_mla<<<grid, THREADS, SMEM, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), out, S, Hq, Hkv, hd, dv);
  return (int)cudaGetLastError();
}

}  // namespace mla
#endif  // PART(0)

}  // namespace

extern "C" {

#if PART(0)
const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,S,Hq,hd], k [B,S,Hkv,hd], v [B,S,Hkv,dv], all contiguous and of one
// dtype: float32 (0) or bfloat16 (1), both through flash_tc on the tensor
// cores; hd up to 192, dv up to 128. out [B,S,Hq,dv] float32. (block_q,
// block_k): the tile, in group-flattened query rows and keys, one of the
// pairs tc::TileSet instantiates for the dtype and width class; any other
// pair returns cudaErrorInvalidValue and launches nothing.
int flash_prefill_fwd(const void* q, const void* k, const void* v, int dtype,
                      float* out, int B, int S, int Hq, int Hkv, int hd,
                      int dv, int block_q, int block_k, void* stream) {
  if (bad_shape(B, S, Hq, Hkv, hd, dv, MAXD_MLA))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tc::dispatch<float>(q, k, v, out, B, S, Hq, Hkv, hd, dv, block_q,
                               block_k, s);
  if (dtype == 1)
    return tc::dispatch<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, hd, dv,
                                       block_q, block_k, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 MLA class on the wgmma body: q [B,S,Hq,hd], k [B,S,Hkv,hd],
// v [B,S,Hkv,dv] bfloat16, contiguous and 16-byte aligned, hd above 128 up
// to 192 and dv up to 128, both multiples of 8 (TMA's 16-byte strides);
// out [B,S,Hq,dv] float32. (block_q, block_k) must be its one tile, (BM,
// BK) = (128, 128).
int flash_mla_fwd(const void* q, const void* k, const void* v, float* out,
                  int B, int S, int Hq, int Hkv, int hd, int dv, int block_q,
                  int block_k, void* stream) {
  static_assert(mla::BM == 128 && mla::BK == 128, "TileSet<Body::MLA, 192>");
  if (bad_shape(B, S, Hq, Hkv, hd, dv, MAXD_MLA) || hd <= MAXD || hd % 8 ||
      dv % 8 || block_q != mla::BM || block_k != mla::BK ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  return mla::launch(q, k, v, out, B, S, Hq, Hkv, hd, dv,
                     static_cast<cudaStream_t>(stream));
}

#endif  // PART(0)

#if PART(1)
// q [B,S,Hq,hd] of q_dtype (0 float32, 1 bfloat16); k [B,S,Hkv,hd] and
// v [B,S,Hkv,dv] int8; k_s / v_s [B,S,Hkv] f32; out [B,S,Hq,dv] float32;
// all contiguous; (block_q, block_k) as flash_prefill_fwd's.
int flash_qprefill_fwd(const void* q, int q_dtype, const int8_t* k,
                       const float* k_s, const int8_t* v, const float* v_s,
                       float* out, int B, int S, int Hq, int Hkv, int hd,
                       int dv, int block_q, int block_k, void* stream) {
  if (bad_shape(B, S, Hq, Hkv, hd, dv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return tc::dispatch_q<float>(q, k, k_s, v, v_s, out, B, S, Hq, Hkv, hd,
                                 dv, block_q, block_k, s);
  if (q_dtype == 1)
    return tc::dispatch_q<__nv_bfloat16>(q, k, k_s, v, v_s, out, B, S, Hq,
                                         Hkv, hd, dv, block_q, block_k, s);
  return (int)cudaErrorInvalidValue;
}

#endif  // PART(1)

#if PART(2)
// q [B,S,Hq,hd] of q_dtype (0 float32, 1 bfloat16); k [B,S,Hkv,hd/2] and
// v [B,S,Hkv,dv/2] int4 packed two codes per byte; k_s [B,S,Hkv,hd/32]
// and v_s [B,S,Hkv,dv/32] f16 group scales; out [B,S,Hq,dv] float32; all
// contiguous; hd and dv multiples of 32. Both q dtypes through flash_q4tc
// on the tensor cores; (block_q, block_k) as flash_prefill_fwd's.
int flash_q4prefill_fwd(const void* q, int q_dtype, const void* k,
                        const __half* k_s, const void* v, const __half* v_s,
                        float* out, int B, int S, int Hq, int Hkv, int hd,
                        int dv, int block_q, int block_k, void* stream) {
  if (bad_shape(B, S, Hq, Hkv, hd, dv) || hd % kv_int4::GROUP ||
      dv % kv_int4::GROUP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return tc::dispatch_q4<float>(q, k, k_s, v, v_s, out, B, S, Hq, Hkv, hd,
                                  dv, block_q, block_k, s);
  if (q_dtype == 1)
    return tc::dispatch_q4<__nv_bfloat16>(q, k, k_s, v, v_s, out, B, S, Hq,
                                          Hkv, hd, dv, block_q, block_k, s);
  return (int)cudaErrorInvalidValue;
}
#endif  // PART(2)

}  // extern "C"
