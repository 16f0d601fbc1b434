// The split-K decode-attention loop for Hopper (sm_90a), shared by
// qdecode.cu (qdecode: a dense int8 cache plus an additive bias) and
// paged_attn.cu's paged_decode_fwd (bf16 or f32 block pools),
// paged_qdecode_fwd (int8 block pools) and paged_q4decode_fwd (int4 block
// pools), all three through a block table. One query token per sequence
// attends over its K/V slots with an f32 online softmax.
//
// Three code formats, one loop:
// - Fp<T>: bf16 or f32 elements [rows, Hkv, hd], no scale. A lane holds 8
//   elements of a row (one 16-byte load in bf16, two in f32), each exact
//   in f32 (bf16 by a shift), and the score is q . k / sqrt(hd), as the
//   TPU fp kernel computes it. No scale pointer is read.
// - Int8: int8 codes [rows, Hkv, hd] with f32 scales [rows, Hkv]. The K
//   scale multiplies the score after the dot, (q . k_codes) * k_s /
//   sqrt(hd), plus the bias for the dense cache, and the V scale is folded
//   in per slot (p * v_s times the codes), as the TPU int8 kernels do.
// - Int4: nibble-packed codes [rows, Hkv, hd / 2] with f16 scales per
//   (slot, head, group of 32) [rows, Hkv, hd / 32] (kv_int4.cuh's layout).
//   A lane's codes lie in one group, so it needs one K and one V scale;
//   it dequantizes both before the dot, code * s_g in f32 (exact), and the
//   score is q . k / sqrt(hd) with no scale after the dot, acc += p * v, as
//   the TPU int4 kernel does.
//
// Grid (splits * Hkv, B) in clusters of `splits` CTAs along x: the
// `splits` CTAs of one (sequence b, kv head h) each take an equal share of
// that sequence's keys in whole tiles of KT slots (rank order along the
// sequence; a late rank may get none) and keep a partial (m, l, acc[G, hd])
// in shared memory. After one cluster barrier the rank-0 CTA merges the
// partials in rank order through distributed shared memory and writes out;
// a second barrier keeps the other CTAs, and so their shared memory, alive
// until it has read them. No workspace, no second launch, no atomics: two
// calls on the same inputs give the same bits. The host picks `splits`
// (splits_for) from what it knows: S or M * bs, B * Hkv, and how many CTAs
// of the kernel the card holds at once.
//
// Inside a CTA the four warps walk the share in steps of R = 32 / LPR
// slots, step i going to warp i % 4. LPR lanes hold one slot row: lane l
// loads the row's l-th vector of VL K and VL V codes (lane_codes: fp 8
// elements; int8 16 codes, one 16-byte load, or 8 where G > 4; int4 32
// codes at G 1, 16 at G <= 4 and 8 above, so acc[G][VL] fits the
// registers; lanes past hd / VL are masked, as hd 96 leaves some), and the
// same VL dims of q come from shared memory, stored so the lanes of a row
// read consecutive float4s. Codes become f32 by byte permutes and a
// subtraction (exact), not I2F; bf16 elements by a shift.
// The row's dot is reduced with __shfl_xor_sync, and each warp keeps its
// own online-softmax state: the running max m[g] (warp-uniform, seeded at
// RUN_INIT = -1e30; l and acc are rescaled only when it moves), and per
// lane the normalizer l[g] and acc[g][VL] of its own dims. A step's loads
// (codes and scales in one batch) are issued before the previous step's
// math (a register double buffer), and the loop has no block barrier: the
// table entries of the share are staged in shared memory once before it
// (TAB_CAP entries at a time), beside q. The warps merge once at the end
// of the share, the CTAs once per cluster.
//
// A masked slot (a table entry of -1, or past pos[b]) scores NEG_INF =
// -2e38 and neither its codes nor its scales are read, so whatever the
// trash block holds cannot reach a live row. A CTA or warp whose share
// holds no valid slot contributes m = -1e30, l = 0 and acc = 0, never -inf,
// so the merge never computes exp(-inf - -inf). A paged row with no valid
// slot gives l = 0 and 0/0 = NaN, as the TPU kernel does. The dense kernel
// reads every slot of S and adds its bias: its running max is seeded at
// RUN_INIT_BIAS, below NEG_INF, and a lane row past the share scores -inf,
// so a row whose every slot the bias masks averages them uniformly, as the
// plain softmax does, and a live row's masked slots weigh exp(-2e38 - m) =
// 0 as before. The cluster's merge starts from rank 0's max.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_int4.cuh"

namespace decode_split {

namespace cg = cooperative_groups;

constexpr int PT = 128;                 // threads per CTA
constexpr int NW = PT / 32;             // warps per CTA
constexpr int KT = 32;                  // key slots per tile: a share's unit
constexpr int MAX_SPLITS = 8;           // CTAs per cluster (portable size)
constexpr int MAXG = 8;                 // query heads per kv head
constexpr int MAXD = 128;               // head dim
constexpr int TAB_CAP = 512;            // table entries staged at once
constexpr float NEG_INF = -2.0e38f;     // a masked slot's score
constexpr float RUN_INIT = -1.0e30f;    // the running max's seed
constexpr float RUN_INIT_BIAS = -3.0e38f;  // the dense (bias) rows' seed

// bf16 or f32 elements, no scale
template <typename T>
struct Fp {
  using Scale = float;                  // none is read
  using Bits = float;
  static constexpr bool kScaled = false;
  static constexpr bool kScaleAfterDot = false;
  // elements a lane holds of one K or V row: 16 bytes of bf16, 32 of f32;
  // a multiple of 8 (hd's step) up to 128 takes at most 16 lanes
  __host__ __device__ static constexpr int lane_codes(int) { return 8; }
  __host__ __device__ static constexpr int bytes(int codes) {
    return codes * (int)sizeof(T);
  }
  __device__ static float to_f32(Bits b) { return b; }
};

// int8 codes, one f32 scale per (slot, head) applied after the dot
struct Int8 {
  using Scale = float;                  // a scale in memory
  using Bits = float;                   // a scale as a lane holds it
  static constexpr bool kScaled = true;
  static constexpr bool kScaleAfterDot = true;
  // codes a lane holds of one K or V row: one 16-byte load, or one 8-byte
  // load where G > 4 (acc[G][codes] must fit the registers)
  __host__ __device__ static constexpr int lane_codes(int gb) {
    return gb > 4 ? 8 : 16;
  }
  __host__ __device__ static constexpr int bytes(int codes) { return codes; }
  __device__ static Bits scale(const Scale* p, long e, int, int) {
    return __ldg(p + e);
  }
  __device__ static float to_f32(Bits b) { return b; }
};

// int4 codes two a byte, one f16 scale per (slot, head, group of 32)
// applied before the dot
struct Int4 {
  using Scale = __half;
  using Bits = unsigned short;          // loaded raw, converted at use
  static constexpr bool kScaled = true;
  static constexpr bool kScaleAfterDot = false;
  // codes a lane holds of one K or V row: one 16-, 8- or 4-byte load, all
  // in one group of 32 (acc[G][codes] must fit the registers)
  __host__ __device__ static constexpr int lane_codes(int gb) {
    return gb == 1 ? 32 : (gb <= 4 ? 16 : 8);
  }
  __host__ __device__ static constexpr int bytes(int codes) {
    return codes / 2;
  }
  // the scale of the group that holds element d0 of row e
  __device__ static Bits scale(const Scale* p, long e, int hd, int d0) {
    return __ldg(reinterpret_cast<const unsigned short*>(p) +
                 e * (hd / kv_int4::GROUP) + d0 / kv_int4::GROUP);
  }
  __device__ static float to_f32(Bits b) {
    return __half2float(__ushort_as_half(b));
  }
};

// CTAs per (sequence, kv head): a power of two, at most one per tile of
// the longest sequence the host can see (S, or M * bs), at most
// MAX_SPLITS, and doubled only while all B * Hkv clusters stay resident at
// once (`resident`: CTAs of the kernel the card holds)
inline int splits_for(int n_keys_max, long pairs, long resident) {
  int s = 1;
  while (s < MAX_SPLITS && s * KT < n_keys_max && pairs * 2 * s <= resident)
    s *= 2;
  return s;
}

// CTAs of `kernel` resident on the current card at once
template <class K>
long resident_ctas(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PT, 0);
  return (long)sms * (per_sm > 0 ? per_sm : 1);
}

// the compiled bound on G and lanes per slot row (a power of two >=
// hd / lane_codes, which divides hd), the two template parameters of a
// launch
inline int group_bound(int G) { return G == 1 ? 1 : (G <= 4 ? 4 : 8); }
template <class Fmt>
int lanes_per_row(int hd, int gb) {
  const int lc = Fmt::lane_codes(gb), v = (hd + lc - 1) / lc;
  return v <= 2 ? 2 : (v <= 4 ? 4 : (v <= 8 ? 8 : 16));
}

// keys [k0, k1) of CTA `rank` of `splits`: equal shares of whole tiles
__device__ __forceinline__ void share(int n_keys, int splits, int rank,
                                      int& k0, int& k1) {
  const int n = max(n_keys, 0);
  const int tiles = (n + KT - 1) / KT;
  const int per = (tiles + splits - 1) / splits;
  k0 = min(rank * per * KT, n);
  k1 = min(k0 + per * KT, n);
}

// A block table: slot k of the sequence lives in row tables[b, k / bs] *
// bs + k % bs of the pools, and is valid iff k <= pos[b] (k < n_keys) and
// its table entry is >= 0. bs = 1 << bs_shift divides KT.
struct PagedRows {
  static constexpr bool kBias = false;
  static constexpr int kTab = TAB_CAP;
  const int* tables;
  int M, bs_shift, n_keys;              // n_keys = min(pos[b] + 1, M * bs)
  __device__ int chunk() const { return TAB_CAP << bs_shift; }
  // the table entries of slots [c0, c1) into tab; c0 is a multiple of bs
  __device__ void stage(int* tab, int b, int c0, int c1) const {
    const int e0 = c0 >> bs_shift, n = ((c1 - c0 - 1) >> bs_shift) + 1;
    for (int i = threadIdx.x; i < n; i += PT)
      tab[i] = __ldg(tables + (long)b * M + e0 + i);
  }
  __device__ int row(const int* tab, int, int c0, int k) const {
    const int bid = tab[(k - c0) >> bs_shift];
    return bid >= 0 ? (bid << bs_shift) + (k & ((1 << bs_shift) - 1)) : -1;
  }
  __device__ float bias(int, int) const { return 0.f; }
};

// A dense cache: slot k is row b * S + k, every slot read, plus the
// caller's additive bias [B, S].
struct DenseRows {
  static constexpr bool kBias = true;
  static constexpr int kTab = 1;
  const float* bias_;
  int S, n_keys;                        // n_keys = S
  __device__ int chunk() const { return S; }
  __device__ void stage(int*, int, int, int) const {}
  __device__ int row(const int*, int b, int, int k) const {
    return b * S + k;
  }
  __device__ float bias(int b, int k) const {
    return __ldg(bias_ + (long)b * S + k);
  }
};

template <int BYTES> struct CodeVec;    // one load of a lane's codes
template <> struct CodeVec<16> { using T = uint4; };
template <> struct CodeVec<8> { using T = uint2; };
template <> struct CodeVec<4> { using T = unsigned; };
struct Vec32 {                          // two 16-byte loads (8 f32)
  uint4 a, b;
};
template <> struct CodeVec<32> { using T = Vec32; };

template <class V>
__device__ __forceinline__ V ldg_vec(const V* p) {
  return __ldg(p);
}
__device__ __forceinline__ Vec32 ldg_vec(const Vec32* p) {
  const uint4* u = reinterpret_cast<const uint4*>(p);
  return Vec32{__ldg(u), __ldg(u + 1)};
}

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : (i == 1 ? u.y : (i == 2 ? u.z : u.w));
}
__device__ __forceinline__ unsigned word(const uint2& u, int i) {
  return i == 0 ? u.x : u.y;
}
__device__ __forceinline__ unsigned word(unsigned u, int) { return u; }
__device__ __forceinline__ unsigned word(const Vec32& u, int i) {
  return i < 4 ? word(u.a, i) : word(u.b, i - 4);
}

// f32: word i is element i. bf16: element 2i is the low half of word i,
// 2i + 1 the high half; a bf16 is the top half of its f32 (exact).
__device__ __forceinline__ void unpack_word(Fp<float>, float* f, unsigned w) {
  f[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack_word(Fp<__nv_bfloat16>, float* f,
                                            unsigned w) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// Element 4i + j is byte j of word i. A code c becomes f32 without I2F
// (16 results per clock per SM, as slow as the bytes here): byte c + 128
// is put under the exponent of 2^23 by one byte permute, and 2^23 + 128 is
// taken off; both steps are exact.
__device__ __forceinline__ void unpack_word(Int8, float* f, unsigned w) {
  const unsigned x = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + j)) -
           8388736.f;
}
// Element 8i + 2j + n is nibble n of byte j of word i (the even element in
// the low nibble). The same way: nibble c + 8 goes under the exponent of
// 2^23 and 2^23 + 8 is taken off.
__device__ __forceinline__ void unpack_word(Int4, float* f, unsigned w) {
  const unsigned x = w ^ 0x88888888u;
  const unsigned lo = x & 0x0f0f0f0fu, hi = (x >> 4) & 0x0f0f0f0fu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __int_as_float(__byte_perm(lo, 0x4B000000u, 0x7440u + j)) -
               8388616.f;
    f[2 * j + 1] =
        __int_as_float(__byte_perm(hi, 0x4B000000u, 0x7440u + j)) -
        8388616.f;
  }
}
template <class Fmt, int VL, typename V>
__device__ __forceinline__ void unpack(float (&f)[VL], const V& v) {
  constexpr int W = sizeof(V) / 4;        // words of the load
#pragma unroll
  for (int i = 0; i < W; ++i) unpack_word(Fmt{}, f + i * (VL / W), word(v, i));
}

// a lane's part of one slot row: its VL K and VL V codes and the scales
// (none in Fp)
template <class Fmt, int VL>
struct Slot {
  typename CodeVec<Fmt::bytes(VL)>::T k, v;
  typename Fmt::Bits ks, vs;
  float add;
  bool on;                              // a valid slot (codes were read)
};

template <class Fmt, int LPR, int VL, class Rows>
__device__ __forceinline__ Slot<Fmt, VL> fetch(
    const int8_t* __restrict__ kp, const typename Fmt::Scale* __restrict__ ksp,
    const int8_t* __restrict__ vp, const typename Fmt::Scale* __restrict__ vsp,
    const Rows& rows, const int* tab, int b, int h, int Hkv, int hd, int c0,
    int c1, int step, int rg, int l) {
  using T = typename CodeVec<Fmt::bytes(VL)>::T;
  Slot<Fmt, VL> s;
  s.k = T{};
  s.v = T{};
  s.ks = 0;
  s.vs = 0;
  s.add = 0.f;
  const int k = c0 + step * (32 / LPR) + rg;
  const int row = k < c1 ? rows.row(tab, b, c0, k) : -1;
  s.on = row >= 0;
  if (s.on) {
    const long e = (long)row * Hkv + h;
    const long row_bytes = Fmt::bytes(hd);
    if (l * VL < hd) {
      s.k = ldg_vec(reinterpret_cast<const T*>(kp + e * row_bytes) + l);
      s.v = ldg_vec(reinterpret_cast<const T*>(vp + e * row_bytes) + l);
      if constexpr (Fmt::kScaled && !Fmt::kScaleAfterDot) {
        s.ks = Fmt::scale(ksp, e, hd, l * VL);   // a group scale: its
        s.vs = Fmt::scale(vsp, e, hd, l * VL);   // lanes only
      }
    }
    if constexpr (Fmt::kScaleAfterDot) {  // a row scale: every lane of the
      s.ks = Fmt::scale(ksp, e, hd, 0);     // row scales the reduced dot
      s.vs = Fmt::scale(vsp, e, hd, 0);
    }
    if (Rows::kBias) s.add = rows.bias(b, k);
  }
  return s;
}

// one step of a warp: 32 / LPR slot rows, one per group of LPR lanes
template <class Fmt, int LPR, int VL, int GB, bool BIAS>
__device__ __forceinline__ void consume(const Slot<Fmt, VL>& s,
                                        const float* qs, int G, int l,
                                        float scale, float (&m)[GB],
                                        float (&lsum)[GB],
                                        float (&acc)[GB][VL]) {
  constexpr int QW = LPR * VL;            // q floats per head in qs
  float kf[VL], vf[VL];
  unpack<Fmt>(kf, s.k);
  unpack<Fmt>(vf, s.v);
  const float ks = Fmt::to_f32(s.ks), vs = Fmt::to_f32(s.vs);
  // a group scale dequantizes first: exact
  if constexpr (Fmt::kScaled && !Fmt::kScaleAfterDot) {
#pragma unroll
    for (int c = 0; c < VL; ++c) {
      kf[c] *= ks;
      vf[c] *= vs;
    }
  }
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (GB > 1 && g >= G) break;
    const float4* q4 = reinterpret_cast<const float4*>(qs + g * QW) + l;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < VL / 4; ++i) {
      const float4 qq = q4[i * LPR];
      dot = fmaf(qq.x, kf[4 * i], dot);
      dot = fmaf(qq.y, kf[4 * i + 1], dot);
      dot = fmaf(qq.z, kf[4 * i + 2], dot);
      dot = fmaf(qq.w, kf[4 * i + 3], dot);
    }
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    float sc = BIAS ? __int_as_float(0xff800000u) : NEG_INF;  // -inf
    if (s.on) {
      sc = Fmt::kScaleAfterDot ? dot * ks / scale : dot / scale;
      if (BIAS) sc = sc + s.add;
    }
    float mx = sc;
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (mx > m[g]) {                      // warp-uniform: the max moved
      const float alpha = expf(m[g] - mx);
      lsum[g] *= alpha;
#pragma unroll
      for (int c = 0; c < VL; ++c) acc[g][c] *= alpha;
      m[g] = mx;
    }
    const float p = expf(sc - m[g]);
    lsum[g] += p;
    const float pv = Fmt::kScaleAfterDot ? p * vs : p;
#pragma unroll
    for (int c = 0; c < VL; ++c) acc[g][c] = fmaf(pv, vf[c], acc[g][c]);
  }
}

// the kv head of this CTA's cluster (blockIdx.y is the sequence)
__device__ __forceinline__ int cluster_head(int Hkv) {
  return blockIdx.x / (gridDim.x / Hkv);
}

// q [B,Hkv,GS,hd] f32 (q_bf16 = 0) or bf16; k / v codes and k_s / v_s in
// Fmt's layout, rows as `Rows` says; out [B,Hkv,GS,hd] f32. This CTA
// serves the G query heads g0 .. g0 + G - 1 of the GS of its kv head (GS
// = 0: G, all of them); DB bounds hd in its shared memory. Every caller
// passes the defaults; the parameters stay so that each split
// instantiation compiles to the same code as before. Called by every
// thread of every CTA of the cluster.
template <class Fmt, int LPR, int GB, class Rows, int DB = MAXD>
__device__ __forceinline__ void attend(
    const void* __restrict__ q, int q_bf16, const int8_t* __restrict__ kp,
    const typename Fmt::Scale* __restrict__ ksp, const int8_t* __restrict__ vp,
    const typename Fmt::Scale* __restrict__ vsp, const Rows& rows,
    float* __restrict__ out, int b, int h, int Hkv, int G, int hd,
    int g0 = 0, int GS = 0) {
  constexpr int VL = Fmt::lane_codes(GB);
  constexpr int R = 32 / LPR;             // slot rows per warp step
  constexpr int QW = LPR * VL;
  static_assert(QW <= DB && GB <= MAXG, "compiled bounds");
  __shared__ __align__(16) float qs[GB * QW];   // q; then the CTA partial
  __shared__ __align__(16) float wacc[NW][GB * DB];
  __shared__ float wm[NW][GB], wl[NW][GB];
  __shared__ float pm[GB], pl[GB];
  __shared__ int tab[Rows::kTab];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane / LPR, l = lane % LPR;
  const long head = (long)b * Hkv + h;
  const long q0 = head * (GS ? GS : G) + g0;    // this CTA's first q head
  const float scale = sqrtf((float)hd);

  int k0, k1;
  share(rows.n_keys, splits, rank, k0, k1);
  const int chunk = rows.chunk();
  int c1 = min(k0 + chunk, k1);
  // the first chunk's table entries, and a dense cache's first codes, are
  // in flight while q is staged
  if (k0 < k1) rows.stage(tab, b, k0, c1);
  Slot<Fmt, VL> cur;
  if (Rows::kTab == 1)
    cur = fetch<Fmt, LPR, VL>(kp, ksp, vp, vsp, rows, tab, b, h, Hkv, hd, k0,
                              c1, warp, rg, l);

  // qs[g][(i * LPR + l) * 4 + c] = q[g][l * VL + i * 4 + c]: the lanes of a
  // row read consecutive float4s, and the rows of a warp the same ones
  for (int o = tid; o < GB * QW; o += PT) {
    const int g = o / QW, f = (o - g * QW) >> 2, c = o & 3;
    const int d = (f % LPR) * VL + (f / LPR) * 4 + c;
    float v = 0.f;
    if (g < G && d < hd) {
      const long i = (q0 + g) * hd + d;
      v = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
                 : static_cast<const float*>(q)[i];
    }
    qs[o] = v;
  }

  float m[GB], lsum[GB], acc[GB][VL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = Rows::kBias ? RUN_INIT_BIAS : RUN_INIT;
    lsum[g] = 0.f;
#pragma unroll
    for (int c = 0; c < VL; ++c) acc[g][c] = 0.f;
  }
  __syncthreads();                        // qs and the first entries

  for (int c0 = k0; c0 < k1; c0 += chunk, c1 = min(c0 + chunk, k1)) {
    if (c0 != k0) {                       // CTA-uniform: shares > TAB_CAP
      __syncthreads();                    // entries, paged only
      rows.stage(tab, b, c0, c1);
      __syncthreads();
    }
    if (Rows::kTab > 1 || c0 != k0)
      cur = fetch<Fmt, LPR, VL>(kp, ksp, vp, vsp, rows, tab, b, h, Hkv, hd,
                                c0, c1, warp, rg, l);
    const int n_steps = (c1 - c0 + R - 1) / R;
    for (int st = warp; st < n_steps; st += NW) {
      Slot<Fmt, VL> nxt = cur;
      if (st + NW < n_steps)              // in flight during this step's math
        nxt = fetch<Fmt, LPR, VL>(kp, ksp, vp, vsp, rows, tab, b, h, Hkv, hd,
                                  c0, c1, st + NW, rg, l);
      consume<Fmt, LPR, VL, GB, Rows::kBias>(cur, qs, G, l, scale, m, lsum,
                                             acc);
      cur = nxt;
    }
  }

  // the warp's rows merge: m is warp-uniform, l and acc are summed over the
  // row groups; row group 0 holds the result
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      lsum[g] += __shfl_xor_sync(0xffffffffu, lsum[g], o);
#pragma unroll
      for (int c = 0; c < VL; ++c)
        acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], o);
    }
  }
  if (lane < LPR && lane * VL < hd) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        float4* dst =
            reinterpret_cast<float4*>(&wacc[warp][g * DB + lane * VL]);
#pragma unroll
        for (int i = 0; i < VL / 4; ++i)
          dst[i] = make_float4(acc[g][4 * i], acc[g][4 * i + 1],
                               acc[g][4 * i + 2], acc[g][4 * i + 3]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      wm[warp][g] = m[g];
      wl[warp][g] = lsum[g];
    }
  }
  __syncthreads();

  // the CTA's partial, in warp order, over q's storage
  float* part = qs;
  for (int o = tid; o < G * hd; o += PT) {
    const int g = o / hd, d = o - g * hd;
    float mx = wm[0][g];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, wm[w][g]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w][g] - mx);
      ls = fmaf(wl[w][g], f, ls);
      a = fmaf(wacc[w][g * DB + d], f, a);
    }
    part[o] = a;
    if (d == 0) {
      pm[g] = mx;
      pl[g] = ls;
    }
  }
  cluster.sync();                         // every partial is written

  // rank 0 merges the cluster's partials in rank order, reading each
  // rank's (m, l, acc) in one round of remote loads
  if (rank == 0) {
    for (int o = tid; o < G * hd; o += PT) {
      const int g = o / hd;
      float rm[MAX_SPLITS], rl[MAX_SPLITS], ra[MAX_SPLITS];
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < splits) {
          rm[r] = *cluster.map_shared_rank(pm + g, r);
          rl[r] = *cluster.map_shared_rank(pl + g, r);
          ra[r] = *cluster.map_shared_rank(part + o, r);
        }
      }
      float mx = rm[0];
#pragma unroll
      for (int r = 1; r < MAX_SPLITS; ++r)
        if (r < splits) mx = fmaxf(mx, rm[r]);
      float ls = 0.f, a = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < splits) {
          const float f = expf(rm[r] - mx);
          ls = fmaf(rl[r], f, ls);
          a = fmaf(ra[r], f, a);
        }
      }
      out[q0 * hd + o] = a / ls;
    }
  }
  cluster.sync();                         // rank 0 has read every partial
}

// Launch `kernel` on the grid (splits * Hkv, B) in clusters of `splits`
// CTAs along x, CTAs of `threads` threads with `smem` bytes of dynamic
// shared memory; a cluster that cannot be scheduled is refused here.
template <typename... KArgs, typename... AArgs>
int launch_ex(void (*kernel)(KArgs...), int splits, int Hkv, int B,
              int threads, int smem, cudaStream_t stream, AArgs&&... args) {
  while (splits > 1 && (long)splits * Hkv > 0x7fffffffL) splits /= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * Hkv, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// the grid (splits * Hkv, B), PT threads a CTA, static shared memory only
template <typename... KArgs, typename... AArgs>
int launch(void (*kernel)(KArgs...), int splits, int Hkv, int B,
           cudaStream_t stream, AArgs&&... args) {
  return launch_ex(kernel, splits, Hkv, B, PT, 0, stream, args...);
}

// go.template run<LPR, GB>() where a lane row of LPR lanes fits MAXD;
// dispatch never asks for another
template <class Fmt, int LPR, int GB, class Go>
int run(const Go& go) {
  if constexpr (LPR * Fmt::lane_codes(GB) <= MAXD)
    return go.template run<LPR, GB>();
  else
    return (int)cudaErrorInvalidValue;
}

// the compiled (LPR, GB) pair that serves (hd, G) in format Fmt
template <class Fmt, class Go>
int dispatch(const Go& go, int hd, int G) {
  const int gb = group_bound(G), lpr = lanes_per_row<Fmt>(hd, gb);
  if (gb == 1) {
    if (lpr == 2) return run<Fmt, 2, 1>(go);
    if (lpr == 4) return run<Fmt, 4, 1>(go);
    if (lpr == 8) return run<Fmt, 8, 1>(go);
    return run<Fmt, 16, 1>(go);
  }
  if (gb == 4) {
    if (lpr == 2) return run<Fmt, 2, 4>(go);
    if (lpr == 4) return run<Fmt, 4, 4>(go);
    if (lpr == 8) return run<Fmt, 8, 4>(go);
    return run<Fmt, 16, 4>(go);
  }
  if (lpr == 2) return run<Fmt, 2, 8>(go);
  if (lpr == 4) return run<Fmt, 4, 8>(go);
  if (lpr == 8) return run<Fmt, 8, 8>(go);
  return run<Fmt, 16, 8>(go);
}

}  // namespace decode_split
