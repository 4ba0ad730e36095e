// Per-client label histograms on Hopper: labels (B, n) int32 and valid (B, n)
// bool -> counts (B, C) float32.
//
// Replaces src/repro/kernels/label_hist/label_hist.py:label_hist_kernel (body
// _hist_kernel).  The TPU kernel walks the sample axis as a *sequential* grid
// dimension and keeps the (rows, C) accumulator in its output tile across grid
// steps; GPU blocks run in parallel and in no order, so that accumulator would
// race.  Here one block owns one client row: the sample loop runs inside the
// block, counts go into an int32 histogram in dynamic shared memory with
// atomicAdd, and the block writes each bin once as float.  Counts are integers
// below 2^24, so the result is bit-exact whatever order the atomics land in.
//
// Bound on the card: bytes.  At the FL round's shape (B=100, n=290, C=10) the
// kernel moves about 150 KB, a few hundredths of a microsecond at 3.35 TB/s, so
// a launch costs more than the work; the design keeps it to one launch a round.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void label_hist_kernel(const int32_t* __restrict__ labels,
                                  const uint8_t* __restrict__ valid,
                                  float* __restrict__ out, long long n,
                                  int num_classes) {
  extern __shared__ int bins[];
  for (int c = threadIdx.x; c < num_classes; c += blockDim.x) bins[c] = 0;
  __syncthreads();

  const long long row = blockIdx.x;
  const int32_t* lab = labels + row * n;
  const uint8_t* val = valid + row * n;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t l = lab[i];
    // Invalid entries and labels outside [0, C) count toward nothing.
    if (val[i] && l >= 0 && l < num_classes) atomicAdd(&bins[l], 1);
  }
  __syncthreads();

  float* o = out + row * num_classes;
  for (int c = threadIdx.x; c < num_classes; c += blockDim.x)
    o[c] = static_cast<float>(bins[c]);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The caller has
// checked shapes and that num_classes * 4 bytes fit in 48 KB of shared memory.
extern "C" int repro_label_hist(const void* labels, const void* valid,
                                void* out, long long rows, long long n,
                                int num_classes, void* stream) {
  if (rows > 0 && num_classes > 0) {
    label_hist_kernel<<<static_cast<unsigned int>(rows), kThreads,
                        num_classes * sizeof(int),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(labels),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out), n,
        num_classes);
  }
  return static_cast<int>(cudaGetLastError());
}
