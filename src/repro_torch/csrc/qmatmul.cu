// int8 w8a8 GEMMs for Hopper (sm_90a): the static and dynamic quantized
// linears of an int8 artifact.
//
// Replaces the TPU kernels repro/kernels/qmatmul.py::qmatmul_static and
// repro/kernels/dynquant.py::qmatmul_dynamic.
//
// Two kernels per call:
//   quantize_rows  one block per activation row. Dynamic mode reduces the
//                  row's absmax over the full K and takes
//                  inv = 127 / absmax (IEEE division: never build with
//                  --use_fast_math); static mode takes inv = 1 / act_scale.
//                  Codes are rintf(x * inv) (round half to even, as
//                  jnp.round / torch.round) clipped to +-127, written to a
//                  [M, Kp] scratch whose K tail is zero.
//   qgemm          int8 x int8 -> int32 with mma.sync m16n8k32, a 64x128
//                  output tile per block, 64-deep K steps staged through
//                  shared memory (weights transposed to K-major on the way
//                  in), the next K step prefetched into registers while the
//                  tensor cores work on the current one. Epilogues keep the
//                  TPU kernels' multiplication order:
//                    dynamic  (acc * a_scale[m]) * w_scale[n]
//                    static   acc * (a_scale * w_scale[n])
//                  When M x N gives too few tiles to fill the SMs (decode),
//                  K is split over blockIdx.z; partial sums meet in an int32
//                  workspace through atomicAdd (integer sums are exact, so
//                  the result does not depend on their order) and a last
//                  pass applies the epilogue.
//
// What bounds it on the H100: at decode M (a few rows) the weight bytes,
// K*N int8 read once (e.g. 23.1 MB for K=2048, N=11264: ~6.9 us at
// 3.35 TB/s); the split-K grid exists to put every SM on that stream. At
// prefill M (1024 rows) the int8 tensor-core rate; mma.sync reaches only
// part of it, and wgmma with a TMA pipeline is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 256;               // threads of quantize_rows
constexpr int BM = 64, BN = 128, BK = 64;
constexpr int LDS = BK + 16;          // smem row stride in bytes: 20 words,
                                      // conflict-free fragment loads
constexpr int GT = 256;               // threads of qgemm: 8 warps, 2 x 4
enum { EPI_ROW = 0, EPI_SCALAR = 1, EPI_ATOMIC = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(QT)
quantize_rows(const T* __restrict__ x, int K, int Kp,
              const float* __restrict__ act_scale,
              int8_t* __restrict__ codes, float* __restrict__ a_scale) {
  const int m = blockIdx.x;
  const T* row = x + (size_t)m * K;
  __shared__ float red[QT / 32];
  __shared__ float inv_s;
  if (act_scale == nullptr) {
    float amax = 0.f;
    for (int k = threadIdx.x; k < K; k += QT)
      amax = fmaxf(amax, fabsf(to_f32(row[k])));
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
  const float inv = inv_s;
  int8_t* out = codes + (size_t)m * Kp;
  for (int k = threadIdx.x; k < Kp; k += QT) {
    float c = 0.f;
    if (k < K) c = fminf(fmaxf(rintf(to_f32(row[k]) * inv), -127.f), 127.f);
    out[k] = (int8_t)c;
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int EPI>
__device__ __forceinline__ float epilogue(int acc, const float* a_scale,
                                          const float* w_scale, int m, int n) {
  if (EPI == EPI_ROW) return (float)acc * a_scale[m] * w_scale[n];
  return (float)acc * (a_scale[0] * w_scale[n]);
}

// A: codes [M, Kp] (Kp % 64 == 0, zero K tail); W: [K, N] int8 row-major.
template <int EPI, int OUT_EPI>
__global__ void __launch_bounds__(GT)
qgemm(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
      const float* __restrict__ w_scale, const float* __restrict__ a_scale,
      float* __restrict__ out, int* __restrict__ ws, int M, int N, int K,
      int Kp, int tiles_per_split) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;      // warp tile 32 x 32
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nt = Kp / BK;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(nt, t_begin + tiles_per_split);

  const int a_row = tid >> 2, a_col = (tid & 3) * 16;   // 16 B of A
  const int b_k = (tid >> 4) * 4, b_n = (tid & 15) * 8; // 4 k x 8 n of W
  const bool b_vec = ((N & 7) == 0) && (n0 + b_n + 8 <= N);

  uint4 a_reg;
  uint32_t b_reg[4][2];
  auto load_tile = [&](int kt) {
    const int k0 = kt * BK;
    if (m0 + a_row < M)
      a_reg = *reinterpret_cast<const uint4*>(
          A + (size_t)(m0 + a_row) * Kp + k0 + a_col);
    else
      a_reg = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + b_k + r;
      if (k < K && b_vec) {
        const uint2 w2 = *reinterpret_cast<const uint2*>(
            W + (size_t)k * N + n0 + b_n);
        b_reg[r][0] = w2.x;
        b_reg[r][1] = w2.y;
      } else {
        uint32_t w0 = 0u, w1 = 0u;
        if (k < K) {
          for (int j = 0; j < 8; ++j) {
            const int n = n0 + b_n + j;
            if (n < N) {
              const uint32_t byte = (uint8_t)W[(size_t)k * N + n];
              if (j < 4) w0 |= byte << (8 * j);
              else w1 |= byte << (8 * (j - 4));
            }
          }
        }
        b_reg[r][0] = w0;
        b_reg[r][1] = w1;
      }
    }
  };
  auto store_tile = [&]() {
    *reinterpret_cast<uint4*>(As + a_row * LDS + a_col) = a_reg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // 4x4 byte transpose: word r holds k-row r; word j of the result
      // holds column n = j with k ascending in its bytes.
      const uint32_t r0 = b_reg[0][h], r1 = b_reg[1][h];
      const uint32_t r2 = b_reg[2][h], r3 = b_reg[3][h];
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
      const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
      const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410),
                               __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410),
                               __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(Bs + (b_n + h * 4 + j) * LDS + b_k) =
            col[j];
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  if (t_begin < t_end) {
    load_tile(t_begin);
    store_tile();
  }
  __syncthreads();
  for (int kt = t_begin; kt < t_end; ++kt) {
    if (kt + 1 < t_end) load_tile(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = As + (wm * 32 + i * 16 + g) * LDS + kk + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bs + (wn * 32 + j * 8 + g) * LDS + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
    if (kt + 1 < t_end) store_tile();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * 32 + j * 8 + t * 2 + (e & 1);
        if (m < M && n < N) {
          if (EPI == EPI_ATOMIC)
            atomicAdd(ws + (size_t)m * N + n, acc[i][j][e]);
          else
            out[(size_t)m * N + n] =
                epilogue<OUT_EPI>(acc[i][j][e], a_scale, w_scale, m, n);
        }
      }
}

template <int EPI>
__global__ void qgemm_finish(const int* __restrict__ ws,
                             const float* __restrict__ w_scale,
                             const float* __restrict__ a_scale,
                             float* __restrict__ out, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  out[i] = epilogue<EPI>(ws[i], a_scale, w_scale, m, n);
}

template <int OUT_EPI>
void launch_gemm(const int8_t* codes, const int8_t* w, const float* w_scale,
                 const float* a_scale, float* out, int* ws, int M, int N,
                 int K, int Kp, int splits, cudaStream_t stream) {
  const int nt = Kp / BK;
  const int tps = (nt + splits - 1) / splits;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (nt + tps - 1) / tps);
  if (grid.z > 1) {
    qgemm<EPI_ATOMIC, OUT_EPI><<<grid, GT, 0, stream>>>(
        codes, w, w_scale, a_scale, out, ws, M, N, K, Kp, tps);
    const size_t total = (size_t)M * N;
    qgemm_finish<OUT_EPI><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        ws, w_scale, a_scale, out, M, N);
  } else {
    qgemm<OUT_EPI, OUT_EPI><<<grid, GT, 0, stream>>>(
        codes, w, w_scale, a_scale, out, ws, M, N, K, Kp, tps);
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [M, K] float32 (dtype 0) or bfloat16 (dtype 1). act_scale == NULL
// selects dynamic mode and writes a_scale [M]; otherwise act_scale points
// at one f32 on the device. codes: [M, Kp], Kp % 64 == 0.
int qmm_quantize(const void* x, int dtype, int M, int K, int Kp,
                 const float* act_scale, int8_t* codes, float* a_scale,
                 void* stream) {
  if (M <= 0 || K <= 0 || Kp < K || Kp % BK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    quantize_rows<float><<<M, QT, 0, s>>>(static_cast<const float*>(x), K, Kp,
                                          act_scale, codes, a_scale);
  else if (dtype == 1)
    quantize_rows<__nv_bfloat16><<<M, QT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), K, Kp, act_scale, codes, a_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// per_row != 0: a_scale is [M] (dynamic); else a_scale is one f32
// (static). splits > 1 needs ws: a zeroed int32 [M, N] workspace.
int qmm_gemm(const int8_t* codes, const int8_t* w, const float* w_scale,
             const float* a_scale, int per_row, float* out, int* ws, int M,
             int N, int K, int Kp, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % BK || splits < 1 ||
      (splits > 1 && ws == nullptr) || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_row)
    launch_gemm<EPI_ROW>(codes, w, w_scale, a_scale, out, ws, M, N, K, Kp,
                         splits, s);
  else
    launch_gemm<EPI_SCALAR>(codes, w, w_scale, a_scale, out, ws, M, N, K, Kp,
                            splits, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
