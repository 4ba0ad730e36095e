// Weighted sum over stacked client parameters on Hopper:
//   y[j] = sum_k s[k] * theta[k, j],  theta (K, N) float32 or bfloat16,
//   s (K,) float32, y (N,) in theta's dtype, accumulated in float32.
//
// Replaces src/repro/kernels/weighted_agg/weighted_agg.py:weighted_agg_kernel
// (body _agg_kernel), the FedAvg/FedSGD server reduction.  The TPU kernel runs
// a (1 x K) . (K x block) product on the matrix unit per tile.  A 1 x K matvec
// is far below any tensor-core tile, and the work is two operations per
// 4 bytes read, so on Hopper it is a column reduction on CUDA cores that is
// bound by memory bandwidth: each thread owns VEC contiguous columns, reads
// them with 16-byte loads for every client k, and keeps VEC float32
// accumulators in registers.  theta is read exactly once and y written once.
//
// Bound on the card: bytes.  At the FL round's shapes (K=30, 421,642 params over
// eight leaves) one round moves about 52 MB, about 16 us at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// VEC * sizeof(T) is 16 bytes on the vector path and sizeof(T) on the scalar
// path (VEC == 1), used when N or a base pointer is not 16-byte aligned.
template <typename T, int VEC>
__global__ void weighted_agg_kernel(const T* __restrict__ theta,
                                    const float* __restrict__ scales,
                                    T* __restrict__ out, int k_clients,
                                    long long n) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte vectors only");
  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (col >= n) return;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

  for (int k = 0; k < k_clients; ++k) {
    const float s = __ldg(scales + k);
    const T* src = theta + static_cast<long long>(k) * n + col;
    alignas(16) T x[VEC];
    if constexpr (VEC == 1) {
      x[0] = src[0];
    } else {
      *reinterpret_cast<uint4*>(x) = __ldg(reinterpret_cast<const uint4*>(src));
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] += s * to_float(x[v]);
  }

  alignas(16) T y[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) y[v] = from_float<T>(acc[v]);
  if constexpr (VEC == 1) {
    out[col] = y[0];
  } else {
    *reinterpret_cast<uint4*>(out + col) = *reinterpret_cast<uint4*>(y);
  }
}

template <typename T>
int launch(const void* theta, const void* scales, void* out, int k_clients,
           long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      n % kVec == 0 && reinterpret_cast<uintptr_t>(theta) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long threads = aligned ? n / kVec : n;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* th = static_cast<const T*>(theta);
  const float* sc = static_cast<const float*>(scales);
  T* o = static_cast<T*>(out);
  if (aligned) {
    weighted_agg_kernel<T, kVec><<<blocks, kThreads, 0, s>>>(th, sc, o,
                                                             k_clients, n);
  } else {
    weighted_agg_kernel<T, 1><<<blocks, kThreads, 0, s>>>(th, sc, o,
                                                          k_clients, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_weighted_agg_f32(const void* theta, const void* scales,
                                      void* out, int k_clients, long long n,
                                      void* stream) {
  return launch<float>(theta, scales, out, k_clients, n, stream);
}

extern "C" int repro_weighted_agg_bf16(const void* theta, const void* scales,
                                       void* out, int k_clients, long long n,
                                       void* stream) {
  return launch<__nv_bfloat16>(theta, scales, out, k_clients, n, stream);
}
