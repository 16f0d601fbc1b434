// Per-output-channel symmetric int8 weight quantization for Hopper (sm_90a):
// the artifact-build step of an int8 variant (quantize once, deploy many).
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_weights
// (_kernel): w [K, N] f32 or bf16 -> codes int8 [K, N] and scale f32 [1, N]
// with, per column n,
//   absmax = max(max_k |w[k, n]|, 1e-12)          (f32)
//   codes  = clip(round(w * (127 / absmax)), -127, 127)
//   scale  = absmax / 127
// The TPU kernel stages a whole [K, 256] column panel in VMEM and reduces it
// there. What bounds it on the H100: bytes. K*N input elements read once,
// K*N codes and 4*N scale bytes written once: for phi-3-vision's wi [3072,
// 16384] in bf16 151 MB, ~45 us at 3.35 TB/s. Two routes; the wrapper's
// plan (kernels/quantize.py::plan) picks one from the shape:
//
//   quantize_cluster (the rule): one read of w from device memory. A strip
//     of W = 32 columns (a code row segment is one full 32-byte sector) is
//     split along K over a cluster of c CTAs (c <= CLUSTER_MAX, the
//     portable size). Each CTA stages its K-slice [rows, W] in dynamic
//     shared memory: with TMA in boxes of `box` rows, each on its own
//     mbarrier, so the absmax of box i overlaps the loads of the later
//     boxes; or, where TMA cannot describe w (a base not 16-byte aligned,
//     a row pitch not a multiple of 16 bytes), with plain loads into the
//     same layout. Columns past N are zeros (TMA's out-of-bounds fill, or
//     written so) and never change an absmax. The CTA reduces its slice
//     to W partial maxima in shared memory (shuffles across the row groups
//     of a warp, then an integer atomicMax on the bits: exact for
//     non-negative floats). After cluster.sync() every CTA reads the c
//     partials of its strip through distributed shared memory; the max is
//     exact and order-free, so every CTA has the same absmax bits and the
//     same inv. Rank 0 writes the scales; every CTA writes its codes from
//     its own shared memory, VEC bytes a store. It arrives on the cluster
//     barrier once it has read its peers' partials and waits on it only
//     before it exits, so no CTA's shared memory goes while a peer still
//     reads it. The plan takes c = CLUSTER_MAX wherever K has the rows:
//     the smallest slices, so the most CTAs in flight (timed against every
//     c on the card: scripts/qw_sweep.py). Each launch is checked with
//     cudaOccupancyMaxActiveClusters first.
//
//   quantize_cols (two passes, for a K taller than a cluster holds: 8
//     CTAs of at most SMEM_CAP, ~29,000 rows of a bf16 strip, ~14,500 of
//     an f32 one): one block of 256 threads owns a strip of 4 * VEC
//     consecutive columns: 4 threads across the strip (each loads VEC
//     columns of a row with one 16-byte load where the row pitch allows,
//     else one element) times 64 row groups walking K. Pass 1 keeps a
//     running absmax per thread, the 64 row groups meet in shared memory
//     and one thread per column takes the reciprocal. Pass 2 walks the
//     strip again and writes the codes, VEC bytes per store: up to twice
//     the input bytes, where the strips in flight outgrow the 50 MB L2.
//
// Numerics, bit for bit with the plain version and the JAX oracle, on both
// routes: the reciprocal is 127 / absmax and the scale absmax / 127, both
// IEEE divisions (__fdiv_rn; never build with --use_fast_math); the code
// is rintf(w * inv) (round half to even, as jnp.round / torch.round)
// clamped to +-127. The absmax is taken over fabsf of the exact f32 value.
// An all-zero column gives absmax 1e-12, codes 0 and scale 1e-12/127.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "tma.cuh"  // mbarrier / TMA helpers and the tensor-map encoder

namespace cg = cooperative_groups;

namespace {

using namespace tma;

// Layout constants (tests/test_torch_qweights.py reads them from here).
constexpr int THREADS = 256;
constexpr int W = 32;                 // cluster strip: a 32-byte code sector
constexpr int CLUSTER_MAX = 8;        // the portable cluster size
constexpr int BOX_MAX = 256;          // TMA's largest box dimension
constexpr int BOX_ALIGN = 8;          // box rows: keeps boxes 128-B aligned
constexpr int SMEM_ALIGN = 128;       // TMA destination alignment
constexpr int SMEM_CAP = 227 * 1024;  // a CTA's most: the cluster's edge
constexpr int TC = 4;                 // two-pass: threads across a strip
constexpr int TR = THREADS / TC;      // two-pass: row groups walking K

// Dynamic shared memory of a cluster CTA (``cluster_smem`` in
// kernels/quantize.py): alignment slack, the [rows, W] slice, one mbarrier
// a box, W partial maxima and W reciprocals.
constexpr size_t cluster_smem(int rows, int box, int elem) {
  return (size_t)SMEM_ALIGN + (size_t)rows * W * elem +
         8 * (size_t)(rows / box) + 8 * (size_t)W;
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> f32 is exact: the 16 bits are the top half of the f32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ int8_t code_of(float x, float inv) {
  const float q = fminf(fmaxf(rintf(x * inv), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// VEC codes to dst: one store where the row pitch keeps it aligned
template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* dst, const int8_t (&q)[VEC],
                                            bool vec, int live) {
  if constexpr (VEC == 8) {
    if (vec) {
      uint2 b;
      memcpy(&b, q, 8);
      *reinterpret_cast<uint2*>(dst) = b;
      return;
    }
  } else if constexpr (VEC == 4) {
    if (vec) {
      uint32_t b;
      memcpy(&b, q, 4);
      *reinterpret_cast<uint32_t*>(dst) = b;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (j < live) dst[j] = q[j];
}

// the raw bits of one element, for the plain-load fill
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 2, uint16_t,
                                       uint32_t>::type;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ------------------------------------------------------------------ //
// quantize_cluster: one read of w, K split over a cluster
// ------------------------------------------------------------------ //
// Grid: strips * c CTAs in clusters of c along x; the cluster of blockIdx.x
// / c owns columns [strip * W, strip * W + W), rank r rows [r * rows,
// min(K, (r + 1) * rows)). rows is a multiple of box.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_cluster(const __grid_constant__ CUtensorMap map,
                 const T* __restrict__ w, int K, int N, int rows, int box,
                 int use_tma, int8_t* __restrict__ codes,
                 float* __restrict__ scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements of one 16-byte load
  constexpr int TCW = W / VEC;         // threads across a row
  constexpr int TRW = THREADS / TCW;   // row groups
  static_assert(TCW <= 32 && 32 % TCW == 0, "a row inside one warp");
  extern __shared__ uint8_t smem_raw[];
  T* tile = reinterpret_cast<T*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
      ~(uintptr_t)(SMEM_ALIGN - 1));
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile + (size_t)rows * W);
  float* part = reinterpret_cast<float*>(bar + rows / box);
  float* inv_s = part + W;

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int col0 = (int)(blockIdx.x / c) * W;
  const int r0 = rank * rows;
  const int n_rows = max(0, min(rows, K - r0));
  const int n_box = (n_rows + box - 1) / box;
  const int tid = threadIdx.x, tc = tid % TCW, tr = tid / TCW;

  if (tid < W) part[tid] = 0.0f;
  if (use_tma) {
    if (tid == 0) {
      for (int b = 0; b < n_box; ++b) mbar_init(&bar[b], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const uint32_t box_bytes = (uint32_t)(box * W * sizeof(T));
      for (int b = 0; b < n_box; ++b) {
        mbar_expect_tx(&bar[b], box_bytes);
        tma_load_2d(tile + (size_t)b * box * W, &map, &bar[b], col0,
                    r0 + b * box);
      }
    }
  } else {
    const Bits<T>* src = reinterpret_cast<const Bits<T>*>(w);
    Bits<T>* dst = reinterpret_cast<Bits<T>*>(tile);
    for (int i = tid; i < n_rows * W; i += THREADS) {
      const int r = i / W, col = col0 + i % W;
      dst[i] = col < N ? src[(size_t)(r0 + r) * N + col] : Bits<T>(0);
    }
  }
  __syncthreads();                      // barriers initialised, or the fill

  float amax[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) amax[j] = 0.0f;
  for (int b = 0; b < n_box; ++b) {
    if (use_tma) mbar_wait(&bar[b], 0);
    const int end = min((b + 1) * box, n_rows);
    for (int r = b * box + tr; r < end; r += TRW) {
      float v[VEC];
      load_vec<VEC>(tile + (size_t)r * W + tc * VEC, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) amax[j] = fmaxf(amax[j], fabsf(v[j]));
    }
  }
  // the row groups of a warp meet by shuffles, the warps by an atomicMax
  // on the bits (non-negative floats order as their bits)
#pragma unroll
  for (int o = TCW; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      amax[j] = fmaxf(amax[j], __shfl_xor_sync(0xffffffffu, amax[j], o));
  }
  if ((tid & 31) < TCW) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      atomicMax(reinterpret_cast<unsigned int*>(&part[tc * VEC + j]),
                __float_as_uint(amax[j]));
  }
  cluster.sync();                       // every rank's partials are final

  if (tid < W) {
    float a = 0.0f;
    for (int r = 0; r < c; ++r)
      a = fmaxf(a, *cluster.map_shared_rank(part + tid, r));
    a = fmaxf(a, 1e-12f);
    inv_s[tid] = __fdiv_rn(127.0f, a);
    if (rank == 0 && col0 + tid < N) scale[col0 + tid] = __fdiv_rn(a, 127.0f);
  }
  cluster_arrive();                     // done reading the peers' partials
  __syncthreads();                      // inv_s

  const int c0 = col0 + tc * VEC;
  if (c0 < N) {
    float inv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) inv[j] = inv_s[tc * VEC + j];
    const bool vec = N % VEC == 0;      // codes is 16-byte aligned
    const int live = min(VEC, N - c0);
    for (int r = tr; r < n_rows; r += TRW) {
      float v[VEC];
      load_vec<VEC>(tile + (size_t)r * W + tc * VEC, v);
      int8_t q[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) q[j] = code_of(v[j], inv[j]);
      store_codes<VEC>(codes + (size_t)(r0 + r) * N + c0, q, vec, live);
    }
  }
  cluster_wait();                       // no peer still reads part
}

// ------------------------------------------------------------------ //
// quantize_cols: the two-pass route for a tall K
// ------------------------------------------------------------------ //
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
quantize_cols(const T* __restrict__ w, int K, int N,
              int8_t* __restrict__ codes, float* __restrict__ scale) {
  constexpr int SW = TC * VEC;         // columns of the strip
  __shared__ float red[TR][SW + 1];
  __shared__ float inv_s[SW];
  const int tc = threadIdx.x % TC, tr = threadIdx.x / TC;
  const int c0 = blockIdx.x * SW + tc * VEC;
  // N % VEC == 0 whenever VEC > 1, so a thread's columns are all in range
  // or all out of it
  const bool live = c0 < N;

  float amax[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) amax[j] = 0.0f;
  if (live) {
    const T* col = w + c0;
#pragma unroll 4
    for (int r = tr; r < K; r += TR) {
      float v[VEC];
      load_vec<VEC>(col + (size_t)r * N, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) amax[j] = fmaxf(amax[j], fabsf(v[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[tr][tc * VEC + j] = amax[j];
  __syncthreads();
  if (threadIdx.x < SW) {
    const int c = blockIdx.x * SW + threadIdx.x;
    float a = red[0][threadIdx.x];
    for (int g = 1; g < TR; ++g) a = fmaxf(a, red[g][threadIdx.x]);
    a = fmaxf(a, 1e-12f);
    inv_s[threadIdx.x] = __fdiv_rn(127.0f, a);
    if (c < N) scale[c] = __fdiv_rn(a, 127.0f);
  }
  __syncthreads();
  if (!live) return;

  float inv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) inv[j] = inv_s[tc * VEC + j];
  const T* col = w + c0;
  int8_t* out = codes + c0;
#pragma unroll 4
  for (int r = tr; r < K; r += TR) {
    float v[VEC];
    load_vec<VEC>(col + (size_t)r * N, v);
    int8_t q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) q[j] = code_of(v[j], inv[j]);
    store_codes<VEC>(out + (size_t)r * N, q, true, VEC);
  }
}

// ------------------------------------------------------------------ //
// Host side
// ------------------------------------------------------------------ //
// w [K, N] as TMA boxes of [box rows, W columns], no swizzle; elements
// past N or K fill with zeros.
int make_map(CUtensorMap* map, const void* w, int elem, int K, int N,
             int box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * elem};
  const cuuint32_t boxdim[2] = {(cuuint32_t)W, (cuuint32_t)box};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(
      map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(w), dims, strides, boxdim, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_cluster(const void* w, int K, int N, int c, int rows, int box,
                   int use_tma, int8_t* codes, float* scale,
                   cudaStream_t stream) {
  auto kernel = quantize_cluster<T>;
  static bool attr_set = false;
  // per cluster size, the largest shared memory already confirmed to fit
  static size_t confirmed[CLUSTER_MAX + 1] = {};
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = cluster_smem(rows, box, sizeof(T));
  const long grid = (long)((N + W - 1) / W) * c;
  if (smem > (size_t)SMEM_CAP || grid > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (use_tma) {
    const int rc = make_map(&map, w, sizeof(T), K, N, box);
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > confirmed[c]) {            // a cluster the card cannot place
    int n = 0;                          // is refused here, not launched
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    confirmed[c] = smem;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, map, static_cast<const T*>(w), K, N, rows, box, use_tma,
      codes, scale);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int VEC>
int launch_cols(const void* w, int K, int N, int8_t* codes, float* scale,
                cudaStream_t s) {
  constexpr int SW = TC * VEC;
  quantize_cols<T, VEC><<<(N + SW - 1) / SW, THREADS, 0, s>>>(
      static_cast<const T*>(w), K, N, codes, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The cluster route. w: [K, N] float32 (dtype 0) or bfloat16 (dtype 1),
// contiguous; tma: 1 where w is 16-byte aligned and N * elem % 16 == 0.
// cluster c, rows and box as kernels/quantize.py::plan gives them. codes:
// int8 [K, N], 16-byte aligned; scale: f32 [N].
int qw_cluster(const void* w, int dtype, int K, int N, int cluster, int rows,
               int box, int tma, int8_t* codes, float* scale, void* stream) {
  if (K <= 0 || N <= 0 || cluster < 1 || cluster > CLUSTER_MAX ||
      box < BOX_ALIGN || box > BOX_MAX || box % BOX_ALIGN || rows < box ||
      rows % box || (long)rows * cluster < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cluster<float>(w, K, N, cluster, rows, box, tma, codes,
                                 scale, s);
  if (dtype == 1)
    return launch_cluster<__nv_bfloat16>(w, K, N, cluster, rows, box, tma,
                                         codes, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The two-pass route. vec: 1, or the elements of one 16-byte load (4 for
// f32, 8 for bf16) when N is a multiple of it and w is 16-byte aligned.
int qw_two_pass(const void* w, int dtype, int K, int N, int vec,
                int8_t* codes, float* scale, void* stream) {
  if (K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && N % 4 == 0)
    return launch_cols<float, 4>(w, K, N, codes, scale, s);
  if (dtype == 0 && vec == 1)
    return launch_cols<float, 1>(w, K, N, codes, scale, s);
  if (dtype == 1 && vec == 8 && N % 8 == 0)
    return launch_cols<__nv_bfloat16, 8>(w, K, N, codes, scale, s);
  if (dtype == 1 && vec == 1)
    return launch_cols<__nv_bfloat16, 1>(w, K, N, codes, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
