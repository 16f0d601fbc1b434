// int8 w8a8 GEMMs for Hopper (sm_90a): the static and dynamic quantized
// linears of an int8 artifact.
//
// Replaces the TPU kernels repro/kernels/qmatmul.py::qmatmul_static and
// repro/kernels/dynquant.py::qmatmul_dynamic. Both compute
// codes = clip(rint(x * inv), -127, 127) per activation row, an exact
// int8 x int8 -> int32 product with the weight codes, and the epilogue in
// the TPU kernels' multiplication order:
//     dynamic  (acc * a_scale[m]) * w_scale[n],  inv = 127 / absmax(row)
//     static   acc * (act_scale * w_scale[n]),   inv = 1 / act_scale
// (IEEE division and rintf, round half to even: never build with
// --use_fast_math). The result is f32, or bf16 rounded to nearest even
// from that f32 (__float2bfloat16_rn), bit for bit what a cast would give.
//
// The weight operand is the packed copy the wrapper keeps on the card:
// w_packed [N, Kp] int8, K-major (Kp = K rounded up to PACK_K, zero tail).
// wgmma takes 8-bit operands only K-major, and the JAX layout [K, N] is
// N-major, so the artifact's leaf is transposed once when a param tree
// moves to the card (kernels/qmatmul.py::pack_weight).
//
// Two bodies; the wrapper's plan (kernels/qmatmul.py::plan) picks one:
//
//   qgemv (M <= GEMV_MAX_M, decode): one launch per linear. Every block
//     quantizes the M activation rows itself into shared memory (the
//     absmax is a max, exact in any order, so every block gets the same
//     scale bit for bit), then streams the weight rows of its 8 * ng
//     output columns with 16-byte loads, already in the "col" operand
//     layout of mma.sync m16n8k32, so nothing is transposed. Its 8 warps
//     split the columns into ng groups of 8 and K into 8 / ng slices;
//     slices meet in shared memory, and the epilogue writes the output.
//     The first weight loads are issued before the quantize so that their
//     latency hides behind it. Bound: the weight bytes (K * N int8 read
//     once: 23.1 MB for K 2048, N 11264, 6.9 us at 3.35 TB/s).
//
//   qgemm_wgmma (prefill): a warp-specialised GEMM over a ring of STAGES
//     shared-memory stages. One producer thread issues TMA loads of the
//     code tile [BM, 128 B] and the weight tile [BN, 128 B] with 128-byte
//     swizzle onto the stage's "full" mbarrier; BM / 64 consumer
//     warpgroups run wgmma.mma_async m64nBNk32 s32.s8.s8 from shared
//     memory into int32 registers and release the stage on its "empty"
//     mbarrier. setmaxnreg moves registers from the producer warpgroup to
//     the consumers. Blocks walk the output tiles GROUP_M tile rows at a
//     time so that a wave of blocks shares its weight tiles in L2. The
//     epilogue applies the scales from registers and writes f32 or bf16.
//     Activation codes come from quantize_rows, a pass of its own: each
//     of the N / BN blocks of a row stripe would otherwise read the whole
//     [BM, K] stripe again to find the rows' absmax. Bound: the int8
//     tensor-core rate (2 M N K ops at 1979 TOPS: 0.044 ms for M 4632 and
//     K = N = 3072).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"  // mbarrier / TMA helpers and the tensor-map encoder

namespace {

using namespace tma;

// Layout constants (tests/test_torch_gemm_plan.py reads them from here).
constexpr int PACK_K = 128;           // K tile of both bodies: one swizzle row
constexpr int SW_ROW_BYTES = 128;     // 128-byte swizzle: a row of the atom
constexpr int SW_ATOM_ROWS = 8;       // rows of one swizzle atom
constexpr int SW_SBO_BYTES = SW_ROW_BYTES * SW_ATOM_ROWS;  // 8-row stride
constexpr int WG_K_BYTES = 32;        // K bytes of one wgmma (k32, s8)
constexpr int GROUP_M = 16;           // tile rows walked together
constexpr int GEMV_MAX_M = 16;        // the decode body's rows (one m16 tile)
constexpr int GEMV_THREADS = 256;     // 8 warps
constexpr int GEMV_PAD = 8;           // code row stride Kp + 8: the 8-byte
                                      // fragment loads are conflict-free
constexpr int QT = 256;               // threads of quantize_rows
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float quantize(float v, float inv) {
  return fminf(fmaxf(rintf(v * inv), -127.f), 127.f);
}

// ------------------------------------------------------------------ //
// Row passes shared by both bodies: thread ``i`` of ``n`` takes elements
// i, i + n, ... (16-byte vectors of them when ``vec``: K a multiple of
// the vector and the row 16-byte aligned).
// ------------------------------------------------------------------ //
template <typename T>
__device__ __forceinline__ float row_absmax(const T* row, int K, int vec,
                                            int i, int n) {
  constexpr int V = 16 / sizeof(T);
  float amax = 0.f;
  if (vec) {
#pragma unroll 4
    for (int k = i * V; k < K; k += n * V) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + k);
      const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(to_f32(e[j])));
    }
  } else {
    for (int k = i; k < K; k += n) amax = fmaxf(amax, fabsf(to_f32(row[k])));
  }
  return amax;
}

// codes[k] = quantize(row[k]) for k < K, 0 up to Kp.
template <typename T>
__device__ __forceinline__ void quantize_row(const T* row, int K, int Kp,
                                             float inv, int vec, int8_t* codes,
                                             int i, int n) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (vec) {
#pragma unroll 4
    for (int k = i * V; k < K; k += n * V) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + k);
      const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        uint32_t b = 0u;
#pragma unroll
        for (int h = 0; h < 4; ++h)
          b |= (uint32_t)(uint8_t)(int8_t)quantize(to_f32(e[4 * j + h]), inv)
               << (8 * h);
        reinterpret_cast<uint32_t*>(codes + k)[j] = b;
      }
    }
    done = K;
  }
  for (int k = done + i; k < Kp; k += n)
    codes[k] = (int8_t)(k < K ? quantize(to_f32(row[k]), inv) : 0.f);
}

// ------------------------------------------------------------------ //
// quantize_rows: codes [M, Kp] (zero K tail) and, dynamic, a_scale [M]
// ------------------------------------------------------------------ //
template <typename T>
__global__ void __launch_bounds__(QT)
quantize_rows(const T* __restrict__ x, int K, int Kp, int vec,
              const float* __restrict__ act_scale,
              int8_t* __restrict__ codes, float* __restrict__ a_scale) {
  const int m = blockIdx.x;
  const T* row = x + (size_t)m * K;
  __shared__ float red[QT / 32];
  __shared__ float inv_s;
  if (act_scale == nullptr) {
    float amax = row_absmax(row, K, vec, threadIdx.x, QT);
    for (int o = 16; o; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = red[0];
      for (int w = 1; w < QT / 32; ++w) a = fmaxf(a, red[w]);
      a = fmaxf(a, 1e-12f);
      inv_s = 127.0f / a;
      a_scale[m] = a / 127.0f;
    }
  } else if (threadIdx.x == 0) {
    inv_s = 1.0f / act_scale[0];
  }
  __syncthreads();
  quantize_row(row, K, Kp, inv_s, vec, codes + (size_t)m * Kp, threadIdx.x,
               QT);
}

// The epilogue of one output element, in the TPU kernels' order.
__device__ __forceinline__ float scale_out(int acc, float a_row, float a0,
                                           float ws, int per_row) {
  return per_row ? (float)acc * a_row * ws : (float)acc * (a0 * ws);
}

// Two neighbouring outputs (n, n + 1) of row m; n is even.
__device__ __forceinline__ void store2(void* out, int out_bf16, int M, int N,
                                       int m, int n, float v0, float v1) {
  if (m >= M || n >= N) return;
  const size_t i = (size_t)m * N + n;
  const bool pair = n + 1 < N && (N & 1) == 0;
  if (out_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + i;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    } else {
      o[0] = __float2bfloat16_rn(v0);
      if (n + 1 < N) o[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* o = static_cast<float*>(out) + i;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (n + 1 < N) o[1] = v1;
    }
  }
}

// ------------------------------------------------------------------ //
// qgemv: the decode body (M <= GEMV_MAX_M), one launch per linear
// ------------------------------------------------------------------ //
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared memory of qgemv: codes [M][Kp + GEMV_PAD], the rows' scales
// [GEMV_MAX_M], and the K slices' partial sums [8 warps][32 lanes][4].
size_t gemv_smem(int M, int Kp) {
  return (((size_t)M * (Kp + GEMV_PAD) + 15) & ~(size_t)15) +
         sizeof(float) * GEMV_MAX_M + sizeof(int) * GEMV_THREADS * 4;
}

// One 128-byte K chunk of a lane: bytes [32 t, 32 t + 32) of its weight row
// (n = 8 * group + g). mma step s takes bytes [8 s, 8 s + 8): words 2s and
// 2s + 1 as b0 and b1. The lane's A fragment takes the same 8 bytes of K
// from code rows g and g + 8, so A and B agree on which k each mma
// position holds (a permutation of K inside the chunk, which the integer
// sum does not see).
template <typename T>
__global__ void __launch_bounds__(GEMV_THREADS)
qgemv(const T* __restrict__ x, const int8_t* __restrict__ w,
      const float* __restrict__ w_scale, const float* __restrict__ act_scale,
      void* __restrict__ out, int out_bf16, int M, int N, int K, int Kp,
      int ng, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lda = Kp + GEMV_PAD;
  int8_t* codes = reinterpret_cast<int8_t*>(smem);
  float* row_scale = reinterpret_cast<float*>(
      smem + (((size_t)M * lda + 15) & ~(size_t)15));
  int* part = reinterpret_cast<int*>(row_scale + GEMV_MAX_M);
  constexpr int WARPS = GEMV_THREADS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp % ng, slice = warp / ng, slices = WARPS / ng;
  const int n = blockIdx.x * 8 * ng + grp * 8 + g;   // this lane's weight row
  const int chunks = Kp / PACK_K;
  const int per = (chunks + slices - 1) / slices;
  const int c_begin = min(chunks, slice * per);
  const int c_end = min(chunks, c_begin + per);
  const bool live = n < N;
  const int8_t* wrow = w + (size_t)min(n, N - 1) * Kp + 32 * t;

  uint4 nxt[2][2];
  auto load = [&](int c) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (live && c + u < c_end) {
        const uint4* p =
            reinterpret_cast<const uint4*>(wrow + (size_t)(c + u) * PACK_K);
        nxt[u][0] = __ldg(p);
        nxt[u][1] = __ldg(p + 1);
      } else {
        nxt[u][0] = nxt[u][1] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  load(c_begin);            // in flight while the block quantizes

  // Quantize: warp w takes rows w and w + 8.
  for (int m = warp; m < M; m += WARPS) {
    const T* row = x + (size_t)m * K;
    float inv;
    if (act_scale == nullptr) {
      float amax = row_absmax(row, K, vec, lane, 32);
      for (int o = 16; o; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float a = fmaxf(amax, 1e-12f);
      inv = 127.0f / a;
      if (lane == 0) row_scale[m] = a / 127.0f;
    } else {
      inv = 1.0f / act_scale[0];
    }
    quantize_row(row, K, Kp, inv, vec, codes + (size_t)m * lda, lane, 32);
  }
  __syncthreads();

  int acc[4] = {0, 0, 0, 0};
  for (int c = c_begin; c < c_end; c += 2) {
    const uint4 cur[2][2] = {{nxt[0][0], nxt[0][1]}, {nxt[1][0], nxt[1][1]}};
    if (c + 2 < c_end) load(c + 2);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (c + u < c_end) {
        const int8_t* a_lo = codes + (size_t)g * lda + (c + u) * PACK_K + 32 * t;
        const int8_t* a_hi = a_lo + 8 * lda;
        const uint32_t b[8] = {cur[u][0].x, cur[u][0].y, cur[u][0].z,
                               cur[u][0].w, cur[u][1].x, cur[u][1].y,
                               cur[u][1].z, cur[u][1].w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint2 lo = g < M ? *reinterpret_cast<const uint2*>(a_lo + 8 * s)
                                 : make_uint2(0u, 0u);
          const uint2 hi = g + 8 < M
                               ? *reinterpret_cast<const uint2*>(a_hi + 8 * s)
                               : make_uint2(0u, 0u);
          mma_s8(acc, lo.x, hi.x, lo.y, hi.y, b[2 * s], b[2 * s + 1]);
        }
      }
    }
  }

  // The K slices meet: slice 0's warp of each column group sums them.
  *reinterpret_cast<int4*>(part + ((size_t)warp * 32 + lane) * 4) =
      make_int4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (warp >= ng) return;
  for (int s = 1; s < slices; ++s) {
    const int4 v = *reinterpret_cast<const int4*>(
        part + ((size_t)(s * ng + warp) * 32 + lane) * 4);
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  const int col = blockIdx.x * 8 * ng + warp * 8 + 2 * t;
  if (col >= N) return;
  const int per_row = act_scale == nullptr;
  const float a0 = per_row ? 0.f : act_scale[0];
  const float ws0 = w_scale[col], ws1 = col + 1 < N ? w_scale[col + 1] : 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = g + 8 * h;
    if (m < M) {
      const float ar = per_row ? row_scale[m] : 0.f;
      store2(out, out_bf16, M, N, m, col,
             scale_out(acc[2 * h], ar, a0, ws0, per_row),
             scale_out(acc[2 * h + 1], ar, a0, ws1, per_row));
    }
  }
}

// ------------------------------------------------------------------ //
// qgemm_wgmma: the prefill body
// ------------------------------------------------------------------ //
// wgmma operand descriptor of a K-major tile in 128-byte swizzle: rows of
// SW_ROW_BYTES, groups of SW_ATOM_ROWS rows SW_SBO_BYTES apart. One k32
// step inside the atom advances the start address by WG_K_BYTES; the
// hardware applies the swizzle to the address it forms, as TMA did when
// it wrote the tile (the tile base is 1024-byte aligned).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |      // start address / 16
         ((uint64_t)1 << 16) |                     // LBO: unused here
         ((uint64_t)(SW_SBO_BYTES >> 4) << 32) |   // SBO: next 8 rows
         ((uint64_t)1 << 62);                      // 128-byte swizzle
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
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// D[64 x 16] += A[64 x 32] . B[16 x 32]^T, s8 x s8 -> s32, both
// operands K-major in shared memory (128-byte swizzle descriptors)
__device__ __forceinline__ void wgmma_n16(int (&d)[8], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 32] += A[64 x 32] . B[32 x 32]^T, s8 x s8 -> s32, both
// operands K-major in shared memory (128-byte swizzle descriptors)
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 32] . B[64 x 32]^T, s8 x s8 -> s32, both
// operands K-major in shared memory (128-byte swizzle descriptors)
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32, both
// operands K-major in shared memory (128-byte swizzle descriptors)
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 256] += A[64 x 32] . B[256 x 32]^T, s8 x s8 -> s32, both
// operands K-major in shared memory (128-byte swizzle descriptors)
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256) wgmma_n256(d, da, db, 1);
  else if constexpr (BN == 128) wgmma_n128(d, da, db, 1);
  else if constexpr (BN == 64) wgmma_n64(d, da, db, 1);
  else if constexpr (BN == 32) wgmma_n32(d, da, db, 1);
  else wgmma_n16(d, da, db, 1);
}

// Output tile of block ``bid``: GROUP_M tile rows are walked together, so
// the blocks in flight share their weight tiles (and code stripes) in L2.
// kernels/qmatmul.py::block_tiles mirrors this mapping.
__device__ __forceinline__ void tile_of(int bid, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  const int per_group = GROUP_M * tiles_n;
  const int first = bid / per_group * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in = bid % per_group;
  tm = first + in % rows;
  tn = in / rows;
}

template <int BM, int BN, int STAGES>
struct WgmmaTile {
  static constexpr int CONSUMERS = BM / 64;             // warpgroups
  static constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer's
  static constexpr int A_BYTES = BM * SW_ROW_BYTES;
  static constexpr int B_BYTES = BN * SW_ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // 1024 bytes of slack to align the ring for the swizzle; the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  // BM 64 tiles run two blocks per SM (128 registers a thread at launch),
  // BM 128 one (168); the producer warpgroup gives all but 40 of its
  // registers to the consumers
  static constexpr int MIN_BLOCKS = BM == 64 ? 2 : 1;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = BM == 64 ? 216 : 232;
  static_assert(SMEM * MIN_BLOCKS <= 228 * 1024, "shared memory");
};

template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(WgmmaTile<BM, BN, STAGES>::THREADS,
                                  WgmmaTile<BM, BN, STAGES>::MIN_BLOCKS)
qgemm_wgmma(const __grid_constant__ CUtensorMap tm_a,
            const __grid_constant__ CUtensorMap tm_b,
            const float* __restrict__ a_scale,
            const float* __restrict__ w_scale, int per_row,
            void* __restrict__ out, int out_bf16, int M, int N, int Kp) {
  using T = WgmmaTile<BM, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  const int nk = Kp / PACK_K;
  int tm, tn;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, tm, tn);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    reg_dealloc<T::PRODUCER_REGS>();
    if (threadIdx.x == T::CONSUMERS * 128) {
      int stage = 0, phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * T::STAGE_BYTES;
        mbar_expect_tx(&full[stage], T::STAGE_BYTES);
        tma_load_2d(st, &tm_a, &full[stage], kt * PACK_K, tm * BM);
        tma_load_2d(st + T::A_BYTES, &tm_b, &full[stage], kt * PACK_K,
                    tn * BN);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows x BN columns each ----
    reg_alloc<T::CONSUMER_REGS>();
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const uint32_t a_base = smem_u32(ring) + wg * 64 * SW_ROW_BYTES;
    const uint32_t b_base = smem_u32(ring) + T::A_BYTES;
    int stage = 0, phase = 0, prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint32_t sa = a_base + stage * T::STAGE_BYTES;
      const uint32_t sb = b_base + stage * T::STAGE_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PACK_K / WG_K_BYTES; ++kk)
        wgmma_tile<BN>(acc, sw128_desc(sa + kk * WG_K_BYTES),
                       sw128_desc(sb + kk * WG_K_BYTES));
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Epilogue from registers: thread (warp w, lane l) holds rows
    // 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1) of its 64 rows.
    const int t = threadIdx.x % 128, lane = t & 31;
    const int r0 = tm * BM + wg * 64 + (t >> 5) * 16 + (lane >> 2);
    const int c_base = tn * BN + 2 * (lane & 3);
    const float a0 = per_row ? 0.f : a_scale[0];
    const float ar0 = per_row && r0 < M ? a_scale[r0] : 0.f;
    const float ar1 = per_row && r0 + 8 < M ? a_scale[r0 + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c_base + 8 * j;
      if (c < N) {
        const float ws0 = w_scale[c];
        const float ws1 = c + 1 < N ? w_scale[c + 1] : 0.f;
        store2(out, out_bf16, M, N, r0, c,
               scale_out(acc[4 * j], ar0, a0, ws0, per_row),
               scale_out(acc[4 * j + 1], ar0, a0, ws1, per_row));
        store2(out, out_bf16, M, N, r0 + 8, c,
               scale_out(acc[4 * j + 2], ar1, a0, ws0, per_row),
               scale_out(acc[4 * j + 3], ar1, a0, ws1, per_row));
      }
    }
  }
}

// ------------------------------------------------------------------ //
// Host side
// ------------------------------------------------------------------ //
// A K-major int8 matrix [rows, Kp] as TMA boxes of [box_rows, PACK_K]
// bytes with 128-byte swizzle; boxes past the last row fill with zeros.
int make_map(CUtensorMap* map, const int8_t* base, int Kp, int rows,
             int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {(cuuint32_t)PACK_K, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                         const_cast<int8_t*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Rows of x take 16-byte loads: K a multiple of the vector, x aligned.
template <typename T>
int vec_rows(const void* x, int K) {
  return K % (16 / (int)sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <int BM, int BN, int STAGES>
int launch_wgmma(const int8_t* codes, const int8_t* w, const float* a_scale,
                 int per_row, const float* w_scale, void* out, int out_bf16,
                 int M, int N, int Kp, cudaStream_t stream) {
  using T = WgmmaTile<BM, BN, STAGES>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qgemm_wgmma<BM, BN, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap ta, tb;
  int rc = make_map(&ta, codes, Kp, M, BM);
  if (rc) return rc;
  rc = make_map(&tb, w, Kp, N, BN);
  if (rc) return rc;
  const long tiles = (long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  qgemm_wgmma<BM, BN, STAGES><<<(unsigned)tiles, T::THREADS, T::SMEM,
                                stream>>>(ta, tb, a_scale, w_scale, per_row,
                                          out, out_bf16, M, N, Kp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gemv(const void* x, const int8_t* w, const float* w_scale,
                const float* act_scale, void* out, int out_bf16, int M, int N,
                int K, int Kp, int ng, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qgemv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = gemv_smem(M, Kp);
  const int vec = vec_rows<T>(x, K);
  const int per_block = 8 * ng;
  qgemv<T><<<(unsigned)((N + per_block - 1) / per_block), GEMV_THREADS, smem,
             stream>>>(static_cast<const T*>(x), w, w_scale, act_scale, out,
                       out_bf16, M, N, K, Kp, ng, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [M, K] float32 (dtype 0) or bfloat16 (dtype 1). act_scale == NULL
// selects dynamic mode and writes a_scale [M]; otherwise act_scale points
// at one f32 on the device. codes: [M, Kp], Kp % PACK_K == 0.
int qmm_quantize(const void* x, int dtype, int M, int K, int Kp,
                 const float* act_scale, int8_t* codes, float* a_scale,
                 void* stream) {
  if (M <= 0 || K <= 0 || Kp < K || Kp % PACK_K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    quantize_rows<float><<<M, QT, 0, s>>>(
        static_cast<const float*>(x), K, Kp, vec_rows<float>(x, K), act_scale,
        codes, a_scale);
  else if (dtype == 1)
    quantize_rows<__nv_bfloat16><<<M, QT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), K, Kp,
        vec_rows<__nv_bfloat16>(x, K), act_scale, codes, a_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The decode body: x [M, K] (dtype 0 f32, 1 bf16), M <= GEMV_MAX_M;
// w_packed [N, Kp]; act_scale NULL = dynamic, else one f32 on the device;
// out [M, N] f32 (out_bf16 0) or bf16 (1); ng column groups of 8 a block.
int qmm_gemv(const void* x, int dtype, const int8_t* w, const float* w_scale,
             const float* act_scale, void* out, int out_bf16, int M, int N,
             int K, int Kp, int ng, void* stream) {
  if (M <= 0 || M > GEMV_MAX_M || N <= 0 || K <= 0 || Kp < K ||
      Kp % PACK_K || (ng != 1 && ng != 2 && ng != 4 && ng != 8) ||
      gemv_smem(M, Kp) > (size_t)MAX_SMEM ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gemv<float>(x, w, w_scale, act_scale, out, out_bf16, M, N,
                              K, Kp, ng, s);
  if (dtype == 1)
    return launch_gemv<__nv_bfloat16>(x, w, w_scale, act_scale, out,
                                      out_bf16, M, N, K, Kp, ng, s);
  return (int)cudaErrorInvalidValue;
}

// The prefill body on codes [M, Kp] from qmm_quantize: a_scale [M]
// (per_row, dynamic) or one f32 (static); w_packed [N, Kp]; out [M, N]
// f32 or bf16; (bm, bn) one of the tiles of kernels/qmatmul.py::TILES.
int qmm_wgmma(const int8_t* codes, const int8_t* w, const float* a_scale,
              int per_row, const float* w_scale, void* out, int out_bf16,
              int M, int N, int Kp, int bm, int bn, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % PACK_K ||
      reinterpret_cast<uintptr_t>(codes) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 256)
    return launch_wgmma<128, 256, 4>(codes, w, a_scale, per_row, w_scale, out,
                                     out_bf16, M, N, Kp, s);
  if (bm == 128 && bn == 128)
    return launch_wgmma<128, 128, 6>(codes, w, a_scale, per_row, w_scale, out,
                                     out_bf16, M, N, Kp, s);
  if (bm == 64 && bn == 128)
    return launch_wgmma<64, 128, 4>(codes, w, a_scale, per_row, w_scale, out,
                                    out_bf16, M, N, Kp, s);
  if (bm == 64 && bn == 64)
    return launch_wgmma<64, 64, 4>(codes, w, a_scale, per_row, w_scale, out,
                                   out_bf16, M, N, Kp, s);
  if (bm == 64 && bn == 32)
    return launch_wgmma<64, 32, 4>(codes, w, a_scale, per_row, w_scale, out,
                                   out_bf16, M, N, Kp, s);
  if (bm == 64 && bn == 16)
    return launch_wgmma<64, 16, 4>(codes, w, a_scale, per_row, w_scale, out,
                                   out_bf16, M, N, Kp, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
