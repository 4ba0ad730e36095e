// The Mamba2 SSD scan on Hopper, as the plain recurrence:
//   S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (outer) B_t,   S_0 = 0,
//   y_t = S_t . C_t,
// per (batch b, head h) with a (P, N) float32 state.  x (batch, S, H, P),
// dt (batch, S, H), A indexed A[b * a_stride + h], B/C (batch, S, G, N) read
// for group g = h / (H / G); y (batch, S, H, P) and the final state
// (batch, H, P, N), all float32.
//
// Replaces src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan (body _ssd_kernel).
// The TPU kernel hoists the sequential scan to the chunk level: inside a
// chunk it builds the masked Q x Q decay matrix exp(cum_t - cum_s) and runs
// two matrix-unit products, and only the (P, N) state crosses its sequential
// chunk grid axis in VMEM scratch.  At mamba2-1.3b's shapes (chunk 128,
// P 64, N 128) a chunk's x, B, C, the state and the Q x Q matrix take about
// 256 KB in float32, over the 227 KB a CUDA block may have.  This kernel
// takes the other simple form the model allows: one block per (b, h) walks
// the sequence step by step with the state in registers.  Thread (p, lane)
// owns row p of the state and 32 of its N columns, in float4 groups
// lane, lane + NG, ... (NG = N / 32 lanes a row, adjacent in the warp),
// so y_t[p] is a sum over the row's NG lanes, a few xor-shuffles.  x, dt, B
// and C are staged through shared memory TS steps at a time; B/C are read
// once per group, never repeated per head.  The recurrence evaluates
// exp(dt * A) <= 1 only, so the chunked form's exp(cum_t - cum_s) for s > t,
// which overflows and is masked afterwards on the TPU, never arises; padded
// steps with dt = 0 leave the state as it was, as the model's padding needs.
//
// Bound on the card: operations.  At mamba2-1.3b's prefill (batch 4,
// S 1024, H 64, P 64, N 128, G 1) the recurrence does 5 flops per
// (t, p, n), 10.7 GFLOP, 160 us at the 67 TFLOP/s of float32 on CUDA cores,
// against 148 MB moved (44 us at 3.35 TB/s).  With 256 blocks of 256
// threads on 132 SMs the card is under-occupied and every step waits on the
// one before it; the chunked form on tensor cores is the redesign
// (ROADMAP.md, Queue 2).
#include <cuda_runtime.h>

namespace {

constexpr int TS = 32;  // steps staged in shared memory at a time
constexpr int V4 = 8;   // float4 groups of the state a thread holds

__global__ void ssd_scan_kernel(const float* __restrict__ x,
                                const float* __restrict__ dt,
                                const float* __restrict__ A,
                                const float* __restrict__ Bm,
                                const float* __restrict__ Cm,
                                float* __restrict__ y,
                                float* __restrict__ fin, int seq, int heads,
                                int P, int groups, int N, int a_stride) {
  extern __shared__ float smem[];
  float* xs = smem;             // [TS][P]
  float* bs = xs + TS * P;      // [TS][N]  (N % 4 == 0: float4-aligned)
  float* cs = bs + TS * N;      // [TS][N]
  float* dts = cs + TS * N;     // [TS]

  const int NG = N / (4 * V4);
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int g = h / (heads / groups);
  const int tid = threadIdx.x;
  const int p = tid / NG, lane = tid % NG;
  const bool active = p < P;
  const int pr = active ? p : 0;  // rows past P compute on row 0, store nothing
  const float a = A[static_cast<long long>(b) * a_stride + h];

  float st[4 * V4];
#pragma unroll
  for (int i = 0; i < 4 * V4; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < seq; t0 += TS) {
    const int nt = min(TS, seq - t0);
    __syncthreads();  // the previous stage is consumed
    for (int idx = tid; idx < nt * P; idx += blockDim.x) {
      const int tau = idx / P, pp = idx % P;
      xs[tau * P + pp] =
          x[((static_cast<long long>(b) * seq + t0 + tau) * heads + h) * P + pp];
    }
    for (int idx = tid; idx < nt * N; idx += blockDim.x) {
      const int tau = idx / N, n = idx % N;
      const long long off =
          ((static_cast<long long>(b) * seq + t0 + tau) * groups + g) * N + n;
      bs[tau * N + n] = Bm[off];
      cs[tau * N + n] = Cm[off];
    }
    for (int tau = tid; tau < nt; tau += blockDim.x)
      dts[tau] = dt[(static_cast<long long>(b) * seq + t0 + tau) * heads + h];
    __syncthreads();

    for (int tau = 0; tau < nt; ++tau) {
      const float d = dts[tau];
      const float decay = expf(d * a);
      const float dx = d * xs[tau * P + pr];
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < V4; ++v) {
        const int n4 = 4 * (v * NG + lane);
        const float4 bb = *reinterpret_cast<const float4*>(bs + tau * N + n4);
        const float4 cc = *reinterpret_cast<const float4*>(cs + tau * N + n4);
        float* s = st + 4 * v;
        s[0] = s[0] * decay + dx * bb.x;
        s[1] = s[1] * decay + dx * bb.y;
        s[2] = s[2] * decay + dx * bb.z;
        s[3] = s[3] * decay + dx * bb.w;
        acc += s[0] * cc.x + s[1] * cc.y + s[2] * cc.z + s[3] * cc.w;
      }
      for (int off = NG / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off, NG);
      if (active && lane == 0)
        y[((static_cast<long long>(b) * seq + t0 + tau) * heads + h) * P + p] =
            acc;
    }
  }

  if (active) {
    float* f = fin + (static_cast<long long>(bh) * P + p) * N;
#pragma unroll
    for (int v = 0; v < V4; ++v)
      *reinterpret_cast<float4*>(f + 4 * (v * NG + lane)) =
          make_float4(st[4 * v], st[4 * v + 1], st[4 * v + 2], st[4 * v + 3]);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take: N a multiple
// of 32 with N / 32 a power of two up to 32 lanes, P * lanes up to 1024
// threads, groups dividing heads.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* fin, int batch, int seq, int heads, int P,
                              int groups, int N, int a_stride, void* stream) {
  if (batch <= 0 || heads <= 0 || P <= 0)
    return static_cast<int>(cudaGetLastError());
  const int ng = N / (4 * V4);
  if (groups <= 0 || heads % groups != 0 || N <= 0 || N % (4 * V4) != 0 ||
      ng > 32 || (ng & (ng - 1)) != 0 || P * ng > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seq <= 0) {
    // No steps: the final state is the zero initial state.
    cudaError_t err = cudaMemsetAsync(
        fin, 0, sizeof(float) * static_cast<size_t>(batch) * heads * P * N,
        static_cast<cudaStream_t>(stream));
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = ((P * ng + 31) / 32) * 32;
  const int bytes = (TS * (P + 2 * N) + TS) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<batch * heads, threads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(fin), seq, heads, P, groups, N, a_stride);
  return static_cast<int>(cudaGetLastError());
}
