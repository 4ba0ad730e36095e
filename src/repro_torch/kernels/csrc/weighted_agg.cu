// Weighted sums over stacked client parameters on Hopper, every leaf of a
// parameter tree, for every trial of a grid, in one launch:
//   y_i[t, j] = sum_k s[t, k] * theta_i[t, k, j]  (/ denom[t], when given),
//   theta_i (T, K, N_i) float32 or bfloat16, s (T, K) float32, y_i (T, N_i)
//   in theta_i's dtype, accumulated in float32 and rounded once.  T = 1 is
//   the one-model round.
//
// Replaces src/repro/kernels/weighted_agg/weighted_agg.py:weighted_agg_kernel
// (body _agg_kernel), the FedAvg/FedSGD server reduction, which the
// reference calls once per leaf.  The TPU kernel runs a (1 x K) . (K x block)
// product on the matrix unit per tile.  A 1 x K matvec is far below any
// tensor-core tile, and the work is two operations per 4 bytes read, so on
// Hopper it is a column reduction on CUDA cores that is bound by memory
// bandwidth: each thread owns VEC contiguous columns, reads them with 16-byte
// loads for every client k in order, and keeps VEC float32 accumulators in
// registers.  theta is read exactly once and y written once.
//
// Bound on the card: bytes.  At the FL round's shapes (K=30, 421,642 params
// over eight leaves) one round moves about 52 MB, about 16 us at 3.35 TB/s.
// Launched once a leaf, the seven small leaves cost a launch each (3-5 us)
// for a few KB, so the round was set by launches, not bytes.  Here one launch
// takes a table of up to kMaxLeaves leaves, passed by value in the kernel's
// parameter space: each block finds its leaf by a binary search over the
// leaves' first blocks, then sums its columns as a per-leaf launch would, in
// the same order, so each column's float32 sum is the same.  A leaf whose
// size or pointers rule out 16-byte loads takes scalar loads.  The optional
// divide by a device scalar is IEEE float32 division, as torch's `/`, so the
// mean needs no read back to the host.
//
// The trial axis (the grid engine's independent FL runs) is the grid's y
// dimension: block (x, t) sums block x's columns of trial t with trial t's
// weights and denominator, reached through per-trial strides on theta, y, s
// and denom.  Each column is summed over k in the same order as in a
// one-trial launch, so the batched launch is bit-equal to T launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;

// One leaf, as the Python wrapper packs it (repro_torch/kernels/weighted_agg),
// which also numbers the blocks with kThreads threads a block; the wrapper
// checks kThreads, kMaxLeaves and sizeof(LeafEntry) through
// repro_weighted_agg_geometry before its first launch.
struct LeafEntry {
  const void* theta;       // (T, K, n) in the launch's dtype
  void* out;               // (T, n)
  long long n;
  long long first_block;   // the leaf's blocks are first_block, first_block + 1, ...
  long long theta_trial;   // elements from one trial's theta to the next
  long long out_trial;     // elements from one trial's out to the next
  int vec;                 // 1: n, both pointers and both strides allow
                           // 16-byte loads
  int pad;
};

struct LeafTable {
  LeafEntry leaf[kMaxLeaves];
  long long scale_trial;   // floats from one trial's weights to the next
  long long denom_trial;   // floats from one trial's denominator to the next
  int count;
};

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
// path (VEC == 1).
template <typename T, int VEC>
__device__ __forceinline__ void column_sum(const T* __restrict__ theta,
                                           T* __restrict__ out, long long n,
                                           long long thread,
                                           const float* __restrict__ scales,
                                           int k_clients,
                                           const float* __restrict__ denom) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte vectors only");
  const long long col = thread * VEC;
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

  if (denom != nullptr) {
    const float d = *denom;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fdiv_rn(acc[v], d);
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
__global__ void __launch_bounds__(kThreads)
weighted_agg_kernel(const __grid_constant__ LeafTable table,
                    const float* __restrict__ scales, int k_clients,
                    const float* __restrict__ denom) {
  // The last leaf whose first block is at or before this one.
  const long long block = blockIdx.x;
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.leaf[mid].first_block <= block) lo = mid; else hi = mid - 1;
  }
  const LeafEntry& e = table.leaf[lo];
  const long long thread = (block - e.first_block) * kThreads + threadIdx.x;
  const long long trial = blockIdx.y;
  const T* theta = static_cast<const T*>(e.theta) + trial * e.theta_trial;
  T* out = static_cast<T*>(e.out) + trial * e.out_trial;
  scales += trial * table.scale_trial;
  if (denom != nullptr) denom += trial * table.denom_trial;
  if (e.vec) {
    column_sum<T, 16 / sizeof(T)>(theta, out, e.n, thread, scales, k_clients,
                                  denom);
  } else {
    column_sum<T, 1>(theta, out, e.n, thread, scales, k_clients, denom);
  }
}

template <typename T>
int launch(const void* entries, int count, long long blocks, int trials,
           const void* scales, int k_clients, long long scale_trial,
           const void* denom, long long denom_trial, void* stream) {
  if (count <= 0 || blocks <= 0 || trials <= 0)
    return static_cast<int>(cudaGetLastError());
  if (count > kMaxLeaves || blocks > 0x7fffffffLL || trials > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable table;
  memset(&table, 0, sizeof(table));
  memcpy(table.leaf, entries, sizeof(LeafEntry) * count);
  table.count = count;
  table.scale_trial = scale_trial;
  table.denom_trial = denom_trial;
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(trials));
  weighted_agg_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const float*>(scales), k_clients,
      static_cast<const float*>(denom));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// entries: `count` LeafEntry records in host memory, all of one dtype, with
// first blocks numbered from 0 and `blocks` blocks in all, for each of
// `trials` trials; trial t's weights start at scales + t * scale_trial and
// its denominator at denom + t * denom_trial (denom may be null).  Each
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_weighted_agg_f32(const void* entries, int count,
                                      long long blocks, int trials,
                                      const void* scales, int k_clients,
                                      long long scale_trial,
                                      const void* denom,
                                      long long denom_trial, void* stream) {
  return launch<float>(entries, count, blocks, trials, scales, k_clients,
                       scale_trial, denom, denom_trial, stream);
}

extern "C" int repro_weighted_agg_bf16(const void* entries, int count,
                                       long long blocks, int trials,
                                       const void* scales, int k_clients,
                                       long long scale_trial,
                                       const void* denom,
                                       long long denom_trial, void* stream) {
  return launch<__nv_bfloat16>(entries, count, blocks, trials, scales,
                               k_clients, scale_trial, denom, denom_trial,
                               stream);
}

// The launch geometry the Python wrapper plans tables with: threads a block,
// leaves a table and bytes a LeafEntry.
extern "C" int repro_weighted_agg_geometry(int* threads, int* max_leaves,
                                           int* entry_bytes) {
  *threads = kThreads;
  *max_leaves = kMaxLeaves;
  *entry_bytes = static_cast<int>(sizeof(LeafEntry));
  return 0;
}
