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
// f32 online softmax (running max seeded at -3e38) and no block barrier,
// and rank 0 merges the partials through distributed shared memory: the
// same function on every row, a row whose every slot the bias masks
// averaging them uniformly as the plain softmax does. The k scale
// multiplies the score after the dot and the v scale is folded in per
// slot.
//
// What bounds it on the H100: bytes. Every slot's codes and scales are
// read once: at the dense-engine shape (B8 S512 Hkv32 G1 hd64) 16.8 MB of
// codes, 1.05 MB of scales and 16 KB of bias, ~5.3 us at 3.35 TB/s. The
// one-block-per-(b, kv head) loop this replaces walked S / 32 tiles in
// turn, three dependent round trips each: its time was latency, ~60 us
// at B1 and B8 alike. The split spreads each sequence over up to 8 SMs'
// CTAs, and each warp keeps its next step's loads in flight.
//
// The wide class (G above MAXG or hd above MAXD, up to WIDE_G query heads
// of hd up to WIDE_D: recurrentgemma's 16 x 256 over one kv head, its
// 2048-slot ring) has its own body, qdecode_wide_tc, on the tensor cores.
// At B8 S2048 it must read 8.4 MB of codes, 131 KB of scales and 64 KB of
// bias: ~2.6 us at 3.35 TB/s. With 8 (sequence, kv head) pairs and G heads
// a pair, a per-head scalar loop is latency-bound: here one CTA holds all
// G heads of its (b, kv head, share) as one m16 tile, so each code is read
// once, and the dots run on the tensor cores:
// - each of the WIDE_NW warps walks its own 16-slot tiles of the share
//   (tile i to warp i % WIDE_NW) in a ring of WIDE_ST, all issued before
//   q is staged: 16-byte cp.async copies of the codes (rows padded so the
//   fragment loads below hit no bank twice) and 4-byte copies of the
//   slots' k_s, v_s and bias, zero past the share;
// - S[16 x 16] = Q K^T on mma.sync m16n8k16 bf16 -> f32: Q staged once in
//   shared memory as bf16 A fragments (f32 q as hi + lo, two products),
//   K's codes turned to bf16 from one 16-byte load a fragment (exact), the
//   head dims permuted alike in Q and K so that a lane's 16 bytes feed 4
//   k-steps;
// - the scores (acc * k_s) / sqrt(hd) + bias and the per-head online
//   softmax in registers (the quad of a C-fragment row);
// - O[16 x hd] += P' V on mma.sync, p' = p * v_s split hi + lo (two
//   products: one bf16 rounding of p' errs by ~1e-3), V's codes paired
//   across two slots by byte permutes into the k-pairs of the B fragment
//   (exact), the head dims permuted in O and undone at the merge;
// - the warps' merge and the cluster's merge in rank order as
//   decode_split.cuh does them, over partials kept in the C-fragment
//   order (each rank writes its slice of the outputs); clusters of
//   WIDE_SPLITS CTAs where the card holds one for every pair at once.
// mma.sync, not wgmma: wgmma takes 64 rows, and this work is bound by
// bytes (16 heads x 256 dims of O is 128 f32 registers a thread).

#include "decode_split.cuh"

namespace {

namespace ds = decode_split;
namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------
// qdecode_wide_tc: the wide class on the tensor cores (see the note above)
// ---------------------------------------------------------------------
constexpr int WIDE_G = 16;          // query heads: one m16 tile
constexpr int WIDE_D = 256;         // head dim
constexpr int WIDE_NW = 8;          // warps a CTA: two a scheduler
constexpr int WIDE_PT = 32 * WIDE_NW;
constexpr int WIDE_KT = 16;         // slots a warp tile: one k16 step of P'V
constexpr int WIDE_ST = 2;          // tiles in flight a warp
// Code rows in shared memory, in 16-byte chunks: K rows 20 apart (a K
// fragment load reads chunks 4c + tig of rows gid: 8 lanes of 2 rows on 8
// distinct 16-byte bank groups), V rows 17 apart (a V load reads chunk gid
// of rows 2 tig (+1, +8, +9): rows 0, 2, 4, 6 on bank groups 0, 2, 4, 6)
constexpr int WIDE_KS = WIDE_D + 64;
constexpr int WIDE_VS = WIDE_D + 16;
constexpr int WIDE_TILE = WIDE_KT * (WIDE_KS + WIDE_VS) + 3 * WIDE_KT * 4;
constexpr int WIDE_KSTEPS = WIDE_D / 16;
constexpr int WIDE_QF = 2 * WIDE_KSTEPS * 32 * 16;   // hi and lo fragments
constexpr int WIDE_RING = WIDE_NW * WIDE_ST * WIDE_TILE;
// after the loop the ring holds the warps' partials and the CTA's
constexpr int WIDE_MERGE = (WIDE_NW + 1) * WIDE_G * WIDE_D * 4;
// CTAs a cluster: up to 16 (a non-portable size) where the card
// schedules them, else up to the portable 8
constexpr int WIDE_SPLITS = 16;
constexpr int WIDE_SMEM = WIDE_QF + (WIDE_RING > WIDE_MERGE ? WIDE_RING
                                                            : WIDE_MERGE);
static_assert(WIDE_SMEM <= 227 * 1024, "shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int n, int src_bytes) {
  if (n == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
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

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// bytes j and j + 1 of x (int8 codes) as a bf16 pair, exact: each through
// f32 by a byte permute under the exponent of 2^23 and a subtraction
__device__ __forceinline__ uint32_t codes_bf16x2(unsigned x, int j) {
  x ^= 0x80808080u;
  const float a =
      __int_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + j)) - 8388736.f;
  const float b =
      __int_as_float(__byte_perm(x, 0x4B000000u, 0x7441u + j)) - 8388736.f;
  return as_u32(__floats2bfloat162_rn(a, b));
}

// two f32 as bf16 pairs hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : (i == 1 ? u.y : (i == 2 ? u.z : u.w));
}

// keys [k0, k1) of CTA `rank` of `splits`: equal shares of whole tiles of
// WIDE_KT slots
__device__ __forceinline__ void wide_share(int n, int splits, int rank,
                                           int& k0, int& k1) {
  const int tiles = (n + WIDE_KT - 1) / WIDE_KT;
  const int per = (tiles + splits - 1) / splits;
  k0 = min(rank * per * WIDE_KT, n);
  k1 = min(k0 + per * WIDE_KT, n);
}

// CTAs per (sequence, kv head) of the wide body: decode_split.cuh's rule
// (a power of two, at most one per KT-slot tile, doubled while every
// cluster stays resident) up to `max_splits`
inline int wide_splits(int n_keys_max, long pairs, long resident,
                       int max_splits) {
  int s = 1;
  while (s < max_splits && s * ds::KT < n_keys_max &&
         pairs * 2 * s <= resident)
    s *= 2;
  return s;
}

// Grid (splits * Hkv, B) in clusters of `splits`. Head dims: k-step s =
// 4c + w of Q K^T gives lane (gid, tig) the dims 64c + 16 tig + 4w + {0,
// 1} (k 2 tig, 2 tig + 1) and + {2, 3} (k 2 tig + 8, + 9), in Q's A
// fragments and K's B fragments alike; the value product's n-block nb =
// 16 hh + j holds, in column n, dim 16 n + j + 128 hh.
__global__ void __launch_bounds__(WIDE_PT, 1)
qdecode_wide_tc(const void* __restrict__ q, int q_bf16,
                const int8_t* __restrict__ kq, const float* __restrict__ ks,
                const int8_t* __restrict__ vq, const float* __restrict__ vs,
                const float* __restrict__ bias, float* __restrict__ out,
                int S, int Hkv, int G, int hd) {
  extern __shared__ __align__(16) uint8_t wide_smem[];
  uint4* qf = reinterpret_cast<uint4*>(wide_smem);     // [2][KSTEPS][32]
  uint8_t* ring = wide_smem + WIDE_QF;
  __shared__ float wm[WIDE_NW][WIDE_G], wl[WIDE_NW][WIDE_G];
  __shared__ float wf[WIDE_NW][WIDE_G];     // the warps' weights
  __shared__ float pm[WIDE_G], pl[WIDE_G];  // the CTA's (m, l)
  __shared__ float rf[WIDE_SPLITS][WIDE_G], rls[WIDE_G];  // the ranks'


  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = ds::cluster_head(Hkv), b = blockIdx.y;
  const long head = (long)b * Hkv + h;
  const float scale = sqrtf((float)hd);
  const int n64 = (hd + 63) / 64, n128 = (hd + 127) / 128;

  int k0, k1;
  wide_share(S, splits, rank, k0, k1);
  const int n_tiles = (k1 - k0 + WIDE_KT - 1) / WIDE_KT;
  const int mine = n_tiles > warp ? (n_tiles - warp + WIDE_NW - 1) / WIDE_NW
                                  : 0;
  uint8_t* wring = ring + warp * WIDE_ST * WIDE_TILE;

  // this warp's i-th tile (the share's tile warp + i * NW) into its slot
  // i % ST: K rows, V rows, then k_s, v_s, bias; zero past the share and
  // past hd
  auto stage = [&](int i) {
    uint8_t* t = wring + (i % WIDE_ST) * WIDE_TILE;
    uint8_t* tv = t + WIDE_KT * WIDE_KS;
    const int key0 = k0 + (warp + i * WIDE_NW) * WIDE_KT;
    // lane -> 16-byte chunk lane % 16 of rows lane / 16 + 2j: a row has at
    // most 16 chunks (hd <= 256); K stages whole 64-dim steps, V whole
    // 128-dim halves, zero past hd
    const int c = lane & 15, hc = hd >> 4;
    const bool kc = c < n64 * 4, vc = c < n128 * 8;
    const long step = 2L * Hkv * hd;                  // two rows of codes
    long e = ((long)(b * S + key0 + (lane >> 4)) * Hkv + h) * hd + c * 16;
#pragma unroll
    for (int j = 0; j < WIDE_KT / 2; ++j, e += step) {
      const int r = (lane >> 4) + 2 * j;
      const bool on = key0 + r < k1 && c < hc;
      if (kc)
        cp_async(smem_u32(t + r * WIDE_KS + c * 16), on ? kq + e : kq, 16,
                 on ? 16 : 0);
      if (vc)
        cp_async(smem_u32(tv + r * WIDE_VS + c * 16), on ? vq + e : vq, 16,
                 on ? 16 : 0);
    }
    if (lane < WIDE_KT) {
      float* sc = reinterpret_cast<float*>(tv + WIDE_KT * WIDE_VS);
      const int key = key0 + lane;
      const bool on = key < k1;
      const long e1 = (long)(b * S + key) * Hkv + h;
      cp_async(smem_u32(sc + lane), on ? ks + e1 : ks, 4, on ? 4 : 0);
      cp_async(smem_u32(sc + WIDE_KT + lane), on ? vs + e1 : vs, 4,
               on ? 4 : 0);
      cp_async(smem_u32(sc + 2 * WIDE_KT + lane),
               on ? bias + (long)b * S + key : bias, 4, on ? 4 : 0);
    }
  };
  // Q as bf16 A fragments, hi then lo (f32 q; bf16 q is exact in hi),
  // zero past G and hd. A fragment entry's 4 dims of a row are one 8-byte
  // (bf16) or 16-byte (f32) load; a thread's loads all go out first, and
  // the warp's whole ring of tiles right behind them.
  constexpr int QIT = WIDE_KSTEPS * 32 / WIDE_PT;   // entries a thread
  float qv[QIT][2][4];
#pragma unroll
  for (int it = 0; it < QIT; ++it) {
    const int o = tid + it * WIDE_PT;
    const int s = o >> 5, ln = o & 31, g = ln >> 2, t = ln & 3;
    const int d = (s >> 2) * 64 + t * 16 + (s & 3) * 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gg = g + 8 * r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (o < 4 * n64 * 32 && gg < G && d < hd) {
        const long i = (head * G + gg) * hd + d;
        if (q_bf16) {
          const uint2 u = __ldg(reinterpret_cast<const uint2*>(
              static_cast<const __nv_bfloat16*>(q) + i));
          x = make_float4(__uint_as_float(u.x << 16),
                          __uint_as_float(u.x & 0xffff0000u),
                          __uint_as_float(u.y << 16),
                          __uint_as_float(u.y & 0xffff0000u));
        } else {
          x = __ldg(reinterpret_cast<const float4*>(
              static_cast<const float*>(q) + i));
        }
      }
      qv[it][r][0] = x.x;
      qv[it][r][1] = x.y;
      qv[it][r][2] = x.z;
      qv[it][r][3] = x.w;
    }
  }
#pragma unroll
  for (int i = 0; i < WIDE_ST; ++i) {
    if (i < mine) stage(i);
    cp_async_commit();
  }
#pragma unroll
  for (int it = 0; it < QIT; ++it) {
    const int o = tid + it * WIDE_PT;
    uint4 hi, lo;
    split2(qv[it][0][0], qv[it][0][1], hi.x, lo.x);
    split2(qv[it][1][0], qv[it][1][1], hi.y, lo.y);
    split2(qv[it][0][2], qv[it][0][3], hi.z, lo.z);
    split2(qv[it][1][2], qv[it][1][3], hi.w, lo.w);
    qf[o] = hi;
    qf[WIDE_KSTEPS * 32 + o] = lo;
  }
  __syncthreads();

  float o_[2 * 16][4];
#pragma unroll
  for (int nb = 0; nb < 32; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_[nb][e] = 0.f;
  // rows gid and gid + 8 of the thread's C fragments
  float m_lo = ds::RUN_INIT_BIAS, m_hi = ds::RUN_INIT_BIAS;
  float l_lo = 0.f, l_hi = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<WIDE_ST - 1>();     // this lane's copies of tile i
    __syncwarp();                      // and every lane's
    const uint8_t* kt = wring + (i % WIDE_ST) * WIDE_TILE;
    const uint8_t* vt = kt + WIDE_KT * WIDE_KS;
    const float* sk = reinterpret_cast<const float*>(vt + WIDE_KT * WIDE_VS);
    const int key0 = k0 + (warp + i * WIDE_NW) * WIDE_KT;

    // S = Q K^T: n-block j holds slots 8j .. 8j + 7
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < WIDE_D / 64; ++c) {
      if (c >= n64) break;
      const uint4 ka = *reinterpret_cast<const uint4*>(
          kt + gid * WIDE_KS + (4 * c + tig) * 16);
      const uint4 kb = *reinterpret_cast<const uint4*>(
          kt + (8 + gid) * WIDE_KS + (4 * c + tig) * 16);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int s = 4 * c + w;
        const uint4 a = qf[s * 32 + lane];
        const unsigned xa = word(ka, w), xb = word(kb, w);
        const uint32_t a0 = codes_bf16x2(xa, 0), a1 = codes_bf16x2(xa, 2);
        const uint32_t b0 = codes_bf16x2(xb, 0), b1 = codes_bf16x2(xb, 2);
        mma_bf16(sc[0], a, a0, a1);
        mma_bf16(sc[1], a, b0, b1);
        if (!q_bf16) {
          const uint4 al = qf[(WIDE_KSTEPS + s) * 32 + lane];
          mma_bf16(sc[0], al, a0, a1);
          mma_bf16(sc[1], al, b0, b1);
        }
      }
    }

    // scores, the rows' online softmax, p' = p * v_s
    const float ninf = __int_as_float(0xff800000u);
    float mx_lo = ninf, mx_hi = ninf;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 8 * j + 2 * tig + (e & 1);
        float x = ninf;                        // past the share
        if (key0 + kk < k1)
          x = sc[j][e] * sk[kk] / scale + sk[2 * WIDE_KT + kk];
        sc[j][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x);
        else mx_hi = fmaxf(mx_hi, x);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
    }
    const bool up_lo = mx_lo > m_lo, up_hi = mx_hi > m_hi;
    if (__any_sync(0xffffffffu, up_lo || up_hi)) {   // a max moved
      const float a_lo = up_lo ? expf(m_lo - mx_lo) : 1.f;
      const float a_hi = up_hi ? expf(m_hi - mx_hi) : 1.f;
      if (up_lo) m_lo = mx_lo;
      if (up_hi) m_hi = mx_hi;
      l_lo *= a_lo;
      l_hi *= a_hi;
#pragma unroll
      for (int nb = 0; nb < 32; ++nb) {
        o_[nb][0] *= a_lo;
        o_[nb][1] *= a_lo;
        o_[nb][2] *= a_hi;
        o_[nb][3] *= a_hi;
      }
    }
    float pv[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - (e < 2 ? m_lo : m_hi));
        if (e < 2) l_lo += p;
        else l_hi += p;
        pv[j][e] = p * sk[WIDE_KT + 8 * j + 2 * tig + (e & 1)];
      }
    // p' as the A fragment of slots 0..15, hi and lo
    uint4 ph, pl;
    split2(pv[0][0], pv[0][1], ph.x, pl.x);
    split2(pv[0][2], pv[0][3], ph.y, pl.y);
    split2(pv[1][0], pv[1][1], ph.z, pl.z);
    split2(pv[1][2], pv[1][3], ph.w, pl.w);

    // O += P' V: lane (gid, tig) reads chunk 8 hh + gid of slots 2 tig,
    // 2 tig + 1, 2 tig + 8, 2 tig + 9; byte j of a chunk pairs two slots
    // into n-block 16 hh + j
#pragma unroll
    for (int hh = 0; hh < WIDE_D / 128; ++hh) {
      if (hh >= n128) break;
      const uint8_t* vc = vt + (8 * hh + gid) * 16;
      const uint4 v0 = *reinterpret_cast<const uint4*>(vc + 2 * tig * WIDE_VS);
      const uint4 v1 =
          *reinterpret_cast<const uint4*>(vc + (2 * tig + 1) * WIDE_VS);
      const uint4 v8 =
          *reinterpret_cast<const uint4*>(vc + (2 * tig + 8) * WIDE_VS);
      const uint4 v9 =
          *reinterpret_cast<const uint4*>(vc + (2 * tig + 9) * WIDE_VS);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const unsigned x0 = word(v0, w), x1 = word(v1, w);
        const unsigned x8 = word(v8, w), x9 = word(v9, w);
        // [slot a byte 0, slot b byte 0, a byte 1, b byte 1], then bytes 2, 3
        const unsigned lo01 = __byte_perm(x0, x1, 0x5140);
        const unsigned hi01 = __byte_perm(x0, x1, 0x7362);
        const unsigned lo89 = __byte_perm(x8, x9, 0x5140);
        const unsigned hi89 = __byte_perm(x8, x9, 0x7362);
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          const unsigned u01 = jb < 2 ? lo01 : hi01;
          const unsigned u89 = jb < 2 ? lo89 : hi89;
          const uint32_t b0 = codes_bf16x2(u01, (jb & 1) * 2);
          const uint32_t b1 = codes_bf16x2(u89, (jb & 1) * 2);
          float(&acc)[4] = o_[16 * hh + 4 * w + jb];
          mma_bf16(acc, ph, b0, b1);
          mma_bf16(acc, pl, b0, b1);
        }
      }
    }
    __syncwarp();                      // every lane is done with the slot
    if (i + WIDE_ST < mine) stage(i + WIDE_ST);
    cp_async_commit();
  }

  // The merges keep O in the C-fragment order: the float4 of n-block nb
  // and lane is (row gid: dims d0, d0 + 16; row gid + 8: the same), d0 =
  // 32 tig + (nb % 16) + 128 (nb / 16), so every shared-memory access
  // below is a warp's 512 contiguous bytes. l is summed over the quad.
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  __syncthreads();                     // every warp is done with the ring
  const int nf = 16 * n128 * 32;       // float4s of a partial
  float4* wacc = reinterpret_cast<float4*>(ring);   // [NW][nf]
  float4* part = wacc + WIDE_NW * 32 * 32;          // [nf]
#pragma unroll
  for (int nb = 0; nb < 32; ++nb) {
    if ((nb >> 4) >= n128) break;
    wacc[warp * 32 * 32 + nb * 32 + lane] =
        make_float4(o_[nb][0], o_[nb][1], o_[nb][2], o_[nb][3]);
  }
  if (tig == 0) {
    wm[warp][gid] = m_lo;
    wm[warp][gid + 8] = m_hi;
    wl[warp][gid] = l_lo;
    wl[warp][gid + 8] = l_hi;
  }
  __syncthreads();

  // the CTA's partial, in warp order: each head's warp weights once
  if (tid < WIDE_G) {
    float mx = wm[0][tid];
#pragma unroll
    for (int w = 1; w < WIDE_NW; ++w) mx = fmaxf(mx, wm[w][tid]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < WIDE_NW; ++w) {
      const float f = expf(wm[w][tid] - mx);
      wf[w][tid] = f;
      ls = fmaf(wl[w][tid], f, ls);
    }
    pm[tid] = mx;
    pl[tid] = ls;
  }
  __syncthreads();
  for (int i = tid; i < nf; i += WIDE_PT) {
    const int g = (i & 31) >> 2;       // the lane's row gid
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WIDE_NW; ++w) {
      const float f0 = wf[w][g], f1 = wf[w][g + 8];
      const float4 x = wacc[w * 32 * 32 + i];
      a = make_float4(fmaf(x.x, f0, a.x), fmaf(x.y, f0, a.y),
                      fmaf(x.z, f1, a.z), fmaf(x.w, f1, a.w));
    }
    part[i] = a;
  }
  cluster.sync();                      // every partial is written

  // the cluster's merge in rank order, each rank writing its slice of the
  // outputs: the ranks' weights of each head once, then a float4 a thread
  if (tid < WIDE_G) {
    float rm[WIDE_SPLITS], rl[WIDE_SPLITS];
#pragma unroll
    for (int r = 0; r < WIDE_SPLITS; ++r) {
      if (r < splits) {
        rm[r] = *cluster.map_shared_rank(pm + tid, r);
        rl[r] = *cluster.map_shared_rank(pl + tid, r);
      }
    }
    float mx = rm[0];
#pragma unroll
    for (int r = 1; r < WIDE_SPLITS; ++r)
      if (r < splits) mx = fmaxf(mx, rm[r]);
    float ls = 0.f;
#pragma unroll
    for (int r = 0; r < WIDE_SPLITS; ++r) {
      if (r < splits) {
        const float f = expf(rm[r] - mx);
        rf[r][tid] = f;
        ls = fmaf(rl[r], f, ls);
      }
    }
    rls[tid] = ls;
  }
  __syncthreads();
  const int per = (nf + splits - 1) / splits;
  const int i1 = min((rank + 1) * per, nf);
  float* oh = out + head * G * hd;
  for (int i = rank * per + tid; i < i1; i += WIDE_PT) {
    const int ln = i & 31, g = ln >> 2, nb = i >> 5;
    float4 x[WIDE_SPLITS];
#pragma unroll
    for (int r = 0; r < WIDE_SPLITS; ++r)
      if (r < splits) x[r] = *cluster.map_shared_rank(part + i, r);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < WIDE_SPLITS; ++r) {
      if (r < splits) {
        const float f0 = rf[r][g], f1 = rf[r][g + 8];
        a = make_float4(fmaf(x[r].x, f0, a.x), fmaf(x[r].y, f0, a.y),
                        fmaf(x[r].z, f1, a.z), fmaf(x[r].w, f1, a.w));
      }
    }
    const int d0 = 32 * (ln & 3) + (nb & 15) + 128 * (nb >> 4);
    if (g < G) {
      if (d0 < hd) oh[g * hd + d0] = a.x / rls[g];
      if (d0 + 16 < hd) oh[g * hd + d0 + 16] = a.y / rls[g];
    }
    if (g + 8 < G) {
      if (d0 < hd) oh[(g + 8) * hd + d0] = a.z / rls[g + 8];
      if (d0 + 16 < hd) oh[(g + 8) * hd + d0 + 16] = a.w / rls[g + 8];
    }
  }
  cluster.sync();                      // every rank has read the partials
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
    static long resident = 0;
    static int cluster16 = 0;
    if (resident == 0) {
      cudaError_t e = cudaFuncSetAttribute(
          qdecode_wide_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
          WIDE_SMEM);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            qdecode_wide_tc, cudaFuncAttributeNonPortableClusterSizeAllowed,
            1);
      if (e != cudaSuccess) return (int)e;
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qdecode_wide_tc,
                                                    WIDE_PT, WIDE_SMEM);
      // 16-CTA clusters where the card holds one for every (sequence, kv
      // head) at once (cluster16 of them), else the portable 8
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(WIDE_SPLITS, 1);
      cfg.blockDim = dim3(WIDE_PT);
      cfg.dynamicSmemBytes = WIDE_SMEM;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = WIDE_SPLITS;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&cluster16, qdecode_wide_tc,
                                         &cfg) != cudaSuccess)
        cluster16 = 0;
      cudaGetLastError();                 // a refused query is no error
      resident = (long)sms * (per_sm > 0 ? per_sm : 1);
    }
    const long pairs = (long)B * Hkv;
    return ds::launch_ex(&qdecode_wide_tc,
                         wide_splits(S, pairs, resident,
                                     pairs <= cluster16 ? WIDE_SPLITS
                                                        : ds::MAX_SPLITS),
                         Hkv, B, WIDE_PT, WIDE_SMEM, stream, q, q_bf16, kq,
                         ks, vq, vs, bias, out, S, Hkv, G, hd);
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
// else up to WIDE_G and WIDE_D the wide class (q 16-byte aligned: its
// rows are read in 8- or 16-byte pieces).
int qdecode_fwd(const void* q, int q_dtype, const int8_t* k, const float* k_s,
                const int8_t* v, const float* v_s, const float* bias,
                float* out, int B, int S, int Hkv, int G, int hd,
                void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || (long)B * S >= (1L << 31) ||
      Hkv <= 0 || G < 1 || G > WIDE_G || hd < 16 || hd > WIDE_D ||
      hd % 16 || (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Go go{q, q_dtype, k, k_s, v, v_s, bias, out, B, S, Hkv, G, hd,
              static_cast<cudaStream_t>(stream)};
  if (G <= ds::MAXG && hd <= ds::MAXD)
    return ds::dispatch<ds::Int8>(go, hd, G);
  if (reinterpret_cast<uintptr_t>(q) % 16) return (int)cudaErrorInvalidValue;
  return go.run_wide();
}

}  // extern "C"
