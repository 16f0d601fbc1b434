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
// there. A Hopper block cannot hold a 3072-row panel in shared memory, so one
// block of 256 threads owns a strip of 4 * VEC consecutive columns: 4
// threads across the strip (each loads VEC columns of a row with one 16-byte
// load where the row pitch allows, else one element) times 64 row groups
// walking K. Pass 1 keeps a running absmax per thread, the 64 row groups
// meet in shared memory and one thread per column takes the reciprocal.
// Pass 2 walks the strip again (from L2 where it is still there) and writes
// the codes, VEC bytes per store.
//
// Numerics, bit for bit with the plain version and the JAX oracle: the
// reciprocal is 127 / absmax and the scale absmax / 127, both IEEE
// divisions (__fdiv_rn; never build with --use_fast_math); the code is
// rintf(w * inv) (round half to even, as jnp.round / torch.round) clamped to
// +-127. An all-zero column gives absmax 1e-12, codes 0 and scale 1e-12/127.
//
// What bounds it on the H100: bytes. K*N input elements read once, K*N
// codes and 4*N scale bytes written once: for phi-3-vision's wi [3072,
// 16384] in bf16 151 MB, ~45 us at 3.35 TB/s. This kernel reads the input
// twice; where the strips in flight outgrow the 50 MB L2 the second pass
// comes from device memory, up to 1.67x the bound's bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int TC = 4;                  // threads across a strip
constexpr int TR = THREADS / TC;       // row groups walking K

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

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
quantize_cols(const T* __restrict__ w, int K, int N,
              int8_t* __restrict__ codes, float* __restrict__ scale) {
  constexpr int W = TC * VEC;          // columns of the strip
  __shared__ float red[TR][W + 1];
  __shared__ float inv_s[W];
  const int tc = threadIdx.x % TC, tr = threadIdx.x / TC;
  const int c0 = blockIdx.x * W + tc * VEC;
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
  if (threadIdx.x < W) {
    const int c = blockIdx.x * W + threadIdx.x;
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
    int8_t* dst = out + (size_t)r * N;
    if constexpr (VEC == 8) {
      uint2 b;
      memcpy(&b, q, 8);
      *reinterpret_cast<uint2*>(dst) = b;
    } else if constexpr (VEC == 4) {
      uint32_t b;
      memcpy(&b, q, 4);
      *reinterpret_cast<uint32_t*>(dst) = b;
    } else {
      dst[0] = q[0];
    }
  }
}

template <typename T, int VEC>
void launch(const void* w, int K, int N, int8_t* codes, float* scale,
            cudaStream_t s) {
  constexpr int W = TC * VEC;
  quantize_cols<T, VEC><<<(N + W - 1) / W, THREADS, 0, s>>>(
      static_cast<const T*>(w), K, N, codes, scale);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// w: [K, N] float32 (dtype 0) or bfloat16 (dtype 1), contiguous. vec: 1, or
// the elements of one 16-byte load (4 for f32, 8 for bf16) when N is a
// multiple of it and w is 16-byte aligned. codes: int8 [K, N]; scale: f32
// [N].
int qw_quantize(const void* w, int dtype, int K, int N, int vec,
                int8_t* codes, float* scale, void* stream) {
  if (K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && N % 4 == 0)
    launch<float, 4>(w, K, N, codes, scale, s);
  else if (dtype == 0 && vec == 1)
    launch<float, 1>(w, K, N, codes, scale, s);
  else if (dtype == 1 && vec == 8 && N % 8 == 0)
    launch<__nv_bfloat16, 8>(w, K, N, codes, scale, s);
  else if (dtype == 1 && vec == 1)
    launch<__nv_bfloat16, 1>(w, K, N, codes, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
