// Causal / sliding-window attention with online softmax on Hopper:
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, kh, :] / sqrt(D)) v[b, j, kh, :]
// over the keys j that query i may see (j <= i when causal, j > i - window
// when window > 0, j < S always), kh = h / (H / KV).  q (B, S, H, D),
// k/v (B, S, KV, D), o like q; float32 or bfloat16 in, o in q's dtype; the
// scores, softmax and accumulators are float32.  D is 64 or 128.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:flash_attention
// (body _flash_kernel).  The TPU kernel walks a grid (BH, Sq/BQ, Sk/BK) whose
// key axis runs in order on one core and carries the running max, the
// denominator and the output tile in VMEM scratch from one key block to the
// next.  CUDA blocks run in no order, so here one block owns one
// (b, h, q-tile) and loops over the key tiles itself, keeping the running
// statistics and the output tile in registers.  Key tiles wholly past the
// causal frontier or wholly before the window are never visited, as the
// TPU kernel skips them with pl.when.  The numerics follow the TPU kernel:
// s = (q . k) * scale, masked scores are NEG_INF = -1e30, masked
// probabilities are set to 0 after the exponential, and the final divide
// uses max(l, 1e-30).  The kv head is read in place (h / (H / KV)); the
// reference's wrapper materialises the repeat instead.  Query rows and key
// rows at or past S are masked here, so S needs no padding (the TPU wrapper
// pads S and relies on the causal mask to hide the padded keys).
//
// Layout of one block (256 threads, BQ = 64 query rows, BK = 32 keys a tile):
// thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty .. 4*ty+3, score
// columns tx and tx+16 of each key tile, and output columns tx + 16*c.  The
// 16 threads of a row group are one half-warp, so row max and row sum are
// four xor-shuffles.  Q (transposed), K (transposed), V and the tile's
// probabilities sit in shared memory as float32, padded against bank
// conflicts; Q is loaded once, K/V once a tile.
//
// Bound on the card: operations.  At qwen3-14b's prefill (B=4, S=1024,
// H=40, KV=8, D=128, bf16) the causal half of Q.K^T and P.V is 43 GFLOP,
// 43 us at the 989 TFLOP/s of the bf16 tensor cores, against 101 MB of
// q/k/v/o (30 us at 3.35 TB/s).  This first kernel multiplies on the CUDA
// cores in float32, so it sits far above that bound; wgmma/TMA tiles are the
// redesign (ROADMAP.md, Queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;          // query rows a block
constexpr int BK = 32;          // keys a tile
constexpr int QS = BQ + 4;      // row stride of Qs/Ps (float4-aligned)
constexpr int KS = BK + 1;      // row stride of Ks (odd: conflict-free)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <int D>
constexpr int smem_floats() {
  return D * QS + D * KS + BK * D + BK * QS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int seq,
                       int heads, int kv_heads, int causal, int window,
                       float scale) {
  static_assert(D % 16 == 0 && D <= 128, "D is 64 or 128");
  constexpr int DC = D / 16;      // output columns a thread
  constexpr int D4 = D / 4;       // float4 groups in a row
  extern __shared__ float smem[];
  float* Qs = smem;               // [D][QS]  Q transposed
  float* Ks = Qs + D * QS;        // [D][KS]  K transposed
  float* Vs = Ks + D * KS;        // [BK][D]
  float* Ps = Vs + BK * D;        // [BK][QS] probabilities transposed

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * BQ;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const T* qb = q + (static_cast<long long>(b) * seq * heads + h) * D;
  const T* kb = k + (static_cast<long long>(b) * seq * kv_heads + kh) * D;
  const T* vb = v + (static_cast<long long>(b) * seq * kv_heads + kh) * D;

  for (int idx = tid; idx < BQ * D4; idx += kThreads) {
    const int r = idx / D4, d = (idx % D4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < seq) load4(qb + (q0 + r) * q_row + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) Qs[(d + e) * QS + r] = x[e];
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // Keys any row of this tile may see: [k_lo, k_hi).
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(seq, q0 + BQ) : seq;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile is done with Ks, Vs and Ps
    for (int idx = tid; idx < BK * D4; idx += kThreads) {
      const int j = idx / D4, d = (idx % D4) * 4;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < seq) {
        load4(kb + (k0 + j) * k_row + d, kx);
        load4(vb + (k0 + j) * k_row + d, vx);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) Ks[(d + e) * KS + j] = kx[e];
      *reinterpret_cast<float4*>(Vs + j * D + d) =
          make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + d * QS + 4 * ty);
      const float k0v = Ks[d * KS + tx], k1v = Ks[d * KS + tx + 16];
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qa[i], k0v, s[i][0]);
        s[i][1] = fmaf(qa[i], k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      bool ok[2];
      float rmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        ok[jj] = kpos < seq && (!causal || kpos <= qpos) &&
                 (!window || kpos > qpos - window);
        s[i][jj] = ok[jj] ? s[i][jj] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        Ps[(tx + 16 * jj) * QS + 4 * ty + i] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + j * QS + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= seq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<long long>(b) * seq + qpos) * q_row +
              static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + 16 * c, acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int batch,
             int seq, int heads, int kv_heads, int causal, int window,
             cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, heads, kv_heads,
      causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq, int heads, int kv_heads, int head_dim, int causal,
           int window, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0)
    return static_cast<int>(cudaGetLastError());
  if (kv_heads <= 0 || heads % kv_heads != 0 || window < 0 ||
      batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_d<T, 64>(q, k, v, o, batch, seq, heads, kv_heads, causal,
                           window, s);
  if (head_dim == 128)
    return launch_d<T, 128>(q, k, v, o, batch, seq, heads, kv_heads, causal,
                            window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, int batch,
                                         int seq, int heads, int kv_heads,
                                         int head_dim, int causal, int window,
                                         void* stream) {
  return launch<float>(q, k, v, o, batch, seq, heads, kv_heads, head_dim,
                       causal, window, stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int batch,
                                          int seq, int heads, int kv_heads,
                                          int head_dim, int causal, int window,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, seq, heads, kv_heads,
                               head_dim, causal, window, stream);
}
