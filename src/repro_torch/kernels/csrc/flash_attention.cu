// Causal / sliding-window attention with online softmax on Hopper:
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, kh, :] / sqrt(D)) v[b, j, kh, :]
// over the keys j that query i may see (j <= i when causal, j > i - window
// when window > 0, j < S always), kh = h / (H / KV).  q (B, S, H, D),
// k/v (B, S, KV, D), o like q; float32 or bfloat16 in, o in q's dtype; the
// scores, softmax and accumulators are float32.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:flash_attention
// (body _flash_kernel).  The TPU kernel walks a grid (BH, Sq/BQ, Sk/BK) whose
// key axis runs in order on one core and carries the running max, the
// denominator and the output tile in VMEM scratch from one key block to the
// next.  CUDA blocks run in no order, so here one block owns one (b, h,
// q-tile) and loops over the key tiles itself, keeping the running
// statistics and the output tile in registers.  Key tiles wholly past the
// causal frontier or wholly before the window are never visited, as the TPU
// kernel skips them with pl.when; only tiles that straddle the diagonal, the
// window edge or S apply the element mask.  The numerics follow the TPU
// kernel: s = (q . k) * scale, masked scores are NEG_INF = -1e30, masked
// probabilities are 0 after the exponential, l sums the float32
// probabilities and the output is acc / max(l, 1e-30).  The kv head is read
// in place (h / (H / KV)); the reference's wrapper materialises the repeat.
// Query and key rows at or past S are masked here, so S needs no padding.
//
// Bound on the card: operations.  At qwen3-14b's prefill (B=4, S=1024,
// H=40, KV=8, D=128, bf16, causal) the live half of Q.K^T and P.V is
// 43 GFLOP, 43.5 us at the 989 TFLOP/s of the bf16 tensor cores, against
// 101 MB of q/k/v/o (30 us at 3.35 TB/s).
//
// bfloat16, the serving dtype: a tensor-core kernel (flash_attention_wgmma).
// * A work item is 128 query rows (a q-tile) of one (b, h).  A block of
//   three warpgroups owns one at a time: two consumer warpgroups of 64 rows
//   each and a producer warpgroup, whose one thread starts the TMA copies and
//   whose registers go to the consumers (setmaxnreg 24 / 240).  Registers
//   allow one such block a multiprocessor, so the grid is persistent: one
//   block a multiprocessor walks the items, numbered with the last q-tiles
//   first so the causal triangle's long tiles start first, and the producer
//   loads the next item's Q and K/V while the consumers finish the last one.
// * Q's tile arrives once an item by TMA, into one of two buffers; K/V tiles
//   of 64 keys stay bf16 in a 3-stage shared-memory ring, each stage filled
//   by TMA and completed on an mbarrier, released by the consumers on
//   another.  The tensor maps span (B, S, KV, D) in place, so GQA makes no
//   copy; rows past S arrive as zeros.  All tiles use the 128-byte swizzle
//   that wgmma reads.  64-key tiles keep S (32), P_hi and P_lo (32) and O
//   (64 at D=128) in a consumer's 240 registers with no spill.
// * S = Q.K^T by wgmma m64n64k16 (Q and K K-major in shared memory), the
//   online softmax on the accumulator fragment (row max and sum over the four
//   threads of a fragment row by shuffles, alpha = exp(m_old - m_new) applied
//   to O's accumulators), then O += P.V by wgmma with P a register fragment
//   built from S's accumulator layout and V read through an MN-major
//   (transposed) descriptor.  The producer's loads of the next stages overlap
//   both products, and each warpgroup keeps two wgmma groups in flight: tile
//   t's Q.K^T is started with tile t - 1's P.V, and tile t's softmax runs
//   while that P.V is still on the tensor cores.
// * Why P is split: rounding P to bf16 once before P.V, as FlashAttention-2/3
//   do, moves the bf16 output by more than one bf16 ulp of the float32 plain
//   version at many positions (tests/test_torch_attention_ssd.py emulates it).
//   So P = P_hi + P_lo with P_hi = bf16(P), P_lo = bf16(P - P_hi), and
//   O += P_hi.V + P_lo.V, which carries P to about 16 bits: 1.5x the tensor
//   work of Q.K^T and P.V once.
// * Epilogue: acc / max(l, 1e-30), rounded to bf16 and stored from the
//   fragment; rows at or past S are not written.
//
// float32, the check dtype (tests and the self-checks) and the dtype of the
// FL LM workloads (head_dim 16 to 128), not the serving dtype, stays on a
// CUDA-core kernel by design (flash_attention_f32_kernel): 256 threads own
// 64 query rows, 32-key tiles, float32 FMAs, Q/K transposed and V in shared
// memory.  D is 16, 32, 64 or 128 in float32, 64 or 128 in bfloat16.
//
// The backward pair for both dtypes is at the end of the file.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int BQ = 64;          // query rows a block
constexpr int BK = 32;          // keys a tile
constexpr int QS = BQ + 4;      // row stride of Qs/Ps (float4-aligned)
constexpr int KS = BK + 1;      // row stride of Ks (odd: conflict-free)

__device__ __forceinline__ void load4_f32(const float* p, float out[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <int D>
constexpr int smem_floats() {
  return D * QS + D * KS + BK * D + BK * QS;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int seq, int heads, int kv_heads, int causal,
                           int window, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "D is 16, 32, 64 or 128");
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
  const float* qb = q + (static_cast<long long>(b) * seq * heads + h) * D;
  const float* kb = k + (static_cast<long long>(b) * seq * kv_heads + kh) * D;
  const float* vb = v + (static_cast<long long>(b) * seq * kv_heads + kh) * D;

  for (int idx = tid; idx < BQ * D4; idx += kThreads) {
    const int r = idx / D4, d = (idx % D4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < seq) load4_f32(qb + (q0 + r) * q_row + d, x);
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
        load4_f32(kb + (k0 + j) * k_row + d, kx);
        load4_f32(vb + (k0 + j) * k_row + d, vx);
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
    float* orow = o + (static_cast<long long>(b) * seq + qpos) * q_row +
              static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int seq, int heads, int kv_heads, int causal,
               int window, cudaStream_t stream) {
  if (batch * heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kern = flash_attention_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), seq, heads,
      kv_heads, causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 128;            // query rows a block
constexpr int kTcBK = 64;             // keys a tile
constexpr int kStages = 3;            // K/V ring
constexpr int kConsumers = 2;         // consumer warpgroups of 64 rows
constexpr int kTcThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRow = 128;             // bytes of one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcLayout {
  static constexpr int kHalves = D / 64;              // 64-column slabs
  static constexpr int kQBytes = kHalves * kTcBQ * kRow;
  static constexpr int kTileBytes = kHalves * kTcBK * kRow;   // K or V
  static constexpr int kRingBytes = kStages * 2 * kTileBytes;
  static constexpr int kBarBytes = 8 * (4 + 2 * kStages);
  // Q double-buffered; + 1024: the base is rounded up to the swizzle's
  // 1024-byte period.
  static constexpr int kSmemBytes =
      1024 + 2 * kQBytes + kRingBytes + kBarBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  A wait
// that lasts ~17 s at the top clock is a deadlock: trap, so the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 35)) {
      __trap();
    }
  }
}

// One TMA box of a 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.  K-major operands step 8
// rows by the stride offset (1024 bytes) and ignore the leading one;
// MN-major operands step 8 rows of K by the stride offset and the next 64
// columns of M/N by the leading one.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are in
// flight (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching wgmma's registers across its async window:
// every use after the wait depends on this, and every register stays live
// until it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64, float32 fragment) = A . B^T (+ d if accumulate): A (64 x 16) and
// B (64 x 16) bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, float32 fragment) += A . B: A a bf16 register fragment (64 x 16),
// B (16 x 64) bf16 in shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, float32 fragment) += A . B: A a bf16 register fragment (64 x 16),
// B (16 x 128) bf16 in shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// S = Q . K^T for one 64-key tile of this warpgroup's 64 rows, one wgmma
// group: over D in steps of 16, +32 bytes inside a 128-byte swizzled row,
// the next 64-column slab after four steps.
template <int D>
__device__ __forceinline__ void start_scores(float (&sc)[kTcBK / 2],
                                             uint32_t qs, uint32_t ks) {
#pragma unroll
  for (int j = 0; j < kTcBK / 2; ++j) sc[j] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(sc, sw128_desc(qs + (kk / 4) * kTcBQ * kRow + off, 16, 1024),
                 sw128_desc(ks + (kk / 4) * kTcBK * kRow + off, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
}

// O += P_hi . V + P_lo . V for one tile, one wgmma group: 16 keys a step
// (two 8-row groups of 1024 bytes), the second 64 columns of D one slab
// (kTcBK rows) further.
template <int D>
__device__ __forceinline__ void start_pv(float (&acc)[D / 2],
                                         const uint32_t (&p_hi)[kTcBK / 16][4],
                                         const uint32_t (&p_lo)[kTcBK / 16][4],
                                         uint32_t vs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk) {
    const uint64_t dv = sw128_desc(vs + kk * 16 * kRow, kTcBK * kRow, 1024);
    if constexpr (D == 128) {
      wgmma_rs_n128(acc, p_hi[kk], dv);
      wgmma_rs_n128(acc, p_lo[kk], dv);
    } else {
      wgmma_rs_n64(acc, p_hi[kk], dv);
      wgmma_rs_n64(acc, p_lo[kk], dv);
    }
  }
  wgmma_commit();
}

// The online softmax of one tile's scores, in place.  Fragment element j
// is row (j & 2) ? qb : qa, key k0 + 8 (j / 4) + c0 + (j & 1).  Scores go to
// log2 units (scale_log2 = log2(e) / sqrt(D)); on an edge tile the keys the
// row may not see become NEG_INF.  The running max m takes the row's max
// over its four threads; sc becomes p = exp2(s - m) (0 where masked); l, this
// thread's share of the denominator, becomes alpha l + sum p; alpha =
// exp2(m_old - m_new) is returned for the caller to apply to O.
__device__ __forceinline__ void softmax_tile(float (&sc)[kTcBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int k0, int qa, int qb, int c0,
                                             int seq, int causal, int window,
                                             float scale_log2) {
#pragma unroll
  for (int j = 0; j < kTcBK / 2; ++j) {
    sc[j] *= scale_log2;
    if (edge) {
      const int key = k0 + 8 * (j / 4) + c0 + (j & 1);
      const int qp = (j & 2) ? qb : qa;
      const bool ok = key < seq && (!causal || key <= qp) &&
                      (!window || key > qp - window);
      if (!ok) sc[j] = kNegInf;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < kTcBK / 2; ++j)
      if (((j >> 1) & 1) == r) mx = fmaxf(mx, sc[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[r] = exp2f(m[r] - mx);
    m[r] = mx;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kTcBK / 2; ++j) {
    const int r = (j >> 1) & 1;
    float p = exp2f(sc[j] - m[r]);
    if (edge && sc[j] == kNegInf) p = 0.f;
    sc[j] = p;
    l[r] += p;
  }
}

// P as two bf16 register fragments, P_hi = bf16(P) and P_lo = bf16(P -
// P_hi): A-fragment register g of key step kk holds S's accumulator elements
// 8 kk + 2 g and 8 kk + 2 g + 1 (the wgmma accumulator and A layouts share
// rows and column pairs).
__device__ __forceinline__ void split_p(const float (&sc)[kTcBK / 2],
                                        uint32_t (&p_hi)[kTcBK / 16][4],
                                        uint32_t (&p_lo)[kTcBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float x = sc[8 * kk + 2 * g], y = sc[8 * kk + 2 * g + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      p_hi[kk][g] = bf16x2_bits(hi);
      p_lo[kk][g] = bf16x2_bits(__floats2bfloat162_rn(x - __low2float(hi),
                                                      y - __high2float(hi)));
    }
  }
}

// One work item: 128 query rows (q-tile) of one (b, h), and the key tiles
// [t_lo, t_hi) that any of its rows may see.
struct Item {
  int b, h, kh, q0, t_lo, t_hi;
};

// Items are numbered heaviest first: the last q-tiles (the causal
// triangle's longest rows) of every (b, h), then the ones before.
__device__ __forceinline__ Item decode_item(int item, int bh_count,
                                            int q_tiles, int seq, int heads,
                                            int kv_heads, int causal,
                                            int window) {
  Item it;
  const int bh = item % bh_count;
  it.b = bh / heads;
  it.h = bh % heads;
  it.kh = it.h / (heads / kv_heads);
  it.q0 = (q_tiles - 1 - item / bh_count) * kTcBQ;
  const int k_lo = window ? max(0, it.q0 - window + 1) : 0;
  const int k_hi = causal ? min(seq, it.q0 + kTcBQ) : seq;
  it.t_lo = k_lo / kTcBK;
  it.t_hi = (k_hi + kTcBK - 1) / kTcBK;
  return it;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, int batch, int seq,
                      int heads, int kv_heads, int causal, int window,
                      float scale_log2) {
  using L = TcLayout<D>;
  constexpr int kSlabQ = kTcBQ * kRow;     // bytes of one 64-column Q slab
  constexpr int kSlabKV = kTcBK * kRow;    // bytes of one 64-column K/V slab
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                  // [2][slab][128 rows][128 B]
  const uint32_t ring = sq + 2 * L::kQBytes; // stage: K slabs, V slabs
  const uint32_t q_full = ring + L::kRingBytes;        // [2]
  const uint32_t q_empty = q_full + 16;                 // [2]
  const uint32_t full_bar = q_empty + 16;               // [kStages]
  const uint32_t empty_bar = full_bar + 8 * kStages;    // [kStages]

  const int bh_count = batch * heads;
  const int q_tiles = (seq + kTcBQ - 1) / kTcBQ;
  const int items = bh_count * q_tiles;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int j = 0; j < 2; ++j) {
      mbar_init(q_full + 8 * j, 1);
      mbar_init(q_empty + 8 * j, 128 * kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every role walks the same items (blockIdx.x, + gridDim.x, ...) and the
  // same key tiles, counting items j (Q buffer j % 2) and tiles n (ring
  // stage n % kStages) from 0.
  const int wg = tid / 128;
  if (wg == kConsumers) {
    // Producer warpgroup: one thread starts every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 128 * kConsumers) {
      int n = 0;
      for (int item = blockIdx.x, j = 0; item < items;
           item += gridDim.x, ++j) {
        const Item it = decode_item(item, bh_count, q_tiles, seq, heads,
                                    kv_heads, causal, window);
        const int qb = j & 1;
        if (j >= 2) mbar_wait(q_empty + 8 * qb, ((j >> 1) - 1) & 1);
        mbar_expect_tx(q_full + 8 * qb, L::kQBytes);
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf)
          tma_load(sq + qb * L::kQBytes + hf * kSlabQ, &tm_q, q_full + 8 * qb,
                   64 * hf, it.h, it.q0, it.b);
        for (int t = it.t_lo; t < it.t_hi; ++t, ++n) {
          const int s = n % kStages;
          if (n >= kStages)
            mbar_wait(empty_bar + 8 * s, (n / kStages - 1) & 1);
          const uint32_t ks = ring + s * 2 * L::kTileBytes;
          const uint32_t vs = ks + L::kTileBytes;
          mbar_expect_tx(full_bar + 8 * s, 2 * L::kTileBytes);
#pragma unroll
          for (int hf = 0; hf < L::kHalves; ++hf) {
            tma_load(ks + hf * kSlabKV, &tm_k, full_bar + 8 * s, 64 * hf,
                     it.kh, t * kTcBK, it.b);
            tma_load(vs + hf * kSlabKV, &tm_v, full_bar + 8 * s, 64 * hf,
                     it.kh, t * kTcBK, it.b);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg .. + 63 of each item.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = tid % 32, warp = (tid % 128) / 32;
    // This thread's fragment rows (qa, qa + 8) within the warpgroup's 64 and
    // its column pair 2 * (lane % 4).
    const int r0 = 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    int n = 0;
    for (int item = blockIdx.x, j = 0; item < items;
         item += gridDim.x, ++j) {
      const Item it = decode_item(item, bh_count, q_tiles, seq, heads,
                                  kv_heads, causal, window);
      const int t_lo = it.t_lo, t_hi = it.t_hi;
      const int row_lo = it.q0 + 64 * wg;
      const int qa = row_lo + r0, qb = qa + 8;
      const int qbuf = j & 1;
      const uint32_t qs = sq + qbuf * L::kQBytes + wg * 64 * kRow;

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      // Running max in log2 units (score * scale * log2 e) and this
      // thread's share of the denominator, for rows qa and qb.
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      // This warpgroup's live tiles [a, b) of the item's [t_lo, t_hi): none
      // past its causal frontier or wholly before its window, none at all
      // if its rows all lie at or past S.  It still waits for and releases
      // every stage of the ring, in order.
      const int b_live = row_lo >= seq ? t_lo
                         : causal ? min(t_hi, (row_lo + 63) / kTcBK + 1)
                                  : t_hi;
      int a_live = t_lo;
      while (window && a_live < b_live &&
             a_live * kTcBK + kTcBK - 1 <= row_lo - window)
        ++a_live;
      const int n0 = n - t_lo;   // ring count of tile t is n0 + t
      auto stage = [&](int t) { return (n0 + t) % kStages; };
      auto wait_full = [&](int t) {
        mbar_wait(full_bar + 8 * stage(t), ((n0 + t) / kStages) & 1);
      };
      auto release = [&](int t) { mbar_arrive(empty_bar + 8 * stage(t)); };
      auto k_tile = [&](int t) {
        return ring + stage(t) * 2 * L::kTileBytes;
      };
      auto edge = [&](int t) {
        const int k0 = t * kTcBK;
        return (causal && k0 + kTcBK - 1 > row_lo) ||
               (window && k0 <= row_lo + 63 - window) || k0 + kTcBK > seq;
      };

      mbar_wait(q_full + 8 * qbuf, (j >> 1) & 1);
      for (int t = t_lo; t < a_live; ++t) {
        wait_full(t);
        release(t);
      }
      if (a_live < b_live) {
        float sc[kTcBK / 2], alpha[2];
        uint32_t p_hi[kTcBK / 16][4], p_lo[kTcBK / 16][4];
        wait_full(a_live);
        start_scores<D>(sc, qs, k_tile(a_live));
        wgmma_wait<0>();
        reg_fence(sc);
        softmax_tile(sc, m, l, alpha, edge(a_live), a_live * kTcBK, qa, qb,
                     c0, seq, causal, window, scale_log2);  // O is 0
        split_p(sc, p_hi, p_lo);
        // Tile t's scores and softmax overlap tile t - 1's P.V on the
        // tensor cores; O is rescaled once that product has landed.
        for (int t = a_live + 1; t < b_live; ++t) {
          wait_full(t);
          start_scores<D>(sc, qs, k_tile(t));
          start_pv<D>(acc, p_hi, p_lo, k_tile(t - 1) + L::kTileBytes);
          wgmma_wait<1>();
          reg_fence(sc);
          softmax_tile(sc, m, l, alpha, edge(t), t * kTcBK, qa, qb, c0, seq,
                       causal, window, scale_log2);
          wgmma_wait<0>();
          reg_fence(acc);
          reg_fence(p_hi);
          reg_fence(p_lo);
          release(t - 1);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
          split_p(sc, p_hi, p_lo);
        }
        // Every Q.K^T of this item has landed: the producer may refill the
        // Q buffer while the last P.V and the epilogue run.
        mbar_arrive(q_empty + 8 * qbuf);
        start_pv<D>(acc, p_hi, p_lo, k_tile(b_live - 1) + L::kTileBytes);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(p_hi);
        reg_fence(p_lo);
        release(b_live - 1);
      } else {
        mbar_arrive(q_empty + 8 * qbuf);
      }
      for (int t = b_live; t < t_hi; ++t) {
        wait_full(t);
        release(t);
      }
      n = n0 + t_hi;

      // Epilogue: the row's denominator over its four threads, then
      // acc / max(l, 1e-30) rounded to bf16.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
      }
      const long long row_stride = static_cast<long long>(heads) * D;
      __nv_bfloat16* oa = o +
                          (static_cast<long long>(it.b) * seq + qa) * row_stride +
                          static_cast<long long>(it.h) * D + c0;
      __nv_bfloat16* ob = oa + 8 * row_stride;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        if (qa < seq)
          *reinterpret_cast<__nv_bfloat162*>(oa + 8 * i) =
              __floats2bfloat162_rn(acc[4 * i] / l[0], acc[4 * i + 1] / l[0]);
        if (qb < seq)
          *reinterpret_cast<__nv_bfloat162*>(ob + 8 * i) =
              __floats2bfloat162_rn(acc[4 * i + 2] / l[1],
                                    acc[4 * i + 3] / l[1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// links without -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Tensor map over a (B, S, heads, D) bf16 tensor in place; one box is 64
// columns of D of `rows` consecutive positions of one (b, head), written to
// shared memory with the 128-byte swizzle.  Rows past S read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d,
              int heads, int seq, int batch, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(heads) * d * 2,
      static_cast<cuuint64_t>(seq) * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int batch, int seq, int heads, int kv_heads, int causal,
                int window, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, D, heads, seq, batch, kTcBQ) ||
      !make_map(encode, &tm_k, k, D, kv_heads, seq, batch, kTcBK) ||
      !make_map(encode, &tm_v, v, D, kv_heads, seq, batch, kTcBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_attention_wgmma<D>;
  // setmaxnreg moves registers within the block's allocation: refuse to
  // launch (rather than deadlock) if the allocation cannot cover it.
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kTcThreads <
      128 * (kProducerRegs + kConsumers * kConsumerRegs))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int bytes = TcLayout<D>::kSmemBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent: one block a multiprocessor, each walking the work items.
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>(batch) * heads * ((seq + kTcBQ - 1) / kTcBQ);
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < sms ? items : sms);
  kern<<<grid, kTcThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), batch, seq, heads,
      kv_heads, causal, window, kLog2e / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward, both dtypes: CUDA cores, float32 accumulation, no atomics
// ---------------------------------------------------------------------------
//
// dQ, dK and dV of the function above: with P = exp(scale * Q.K^T - L) on
// the visible pairs (L the row's logsumexp), dP = dO.V^T,
// delta = rowsum(dO o O) and dS = P o (dP - delta):
//   dQ = scale * dS.K,  dK = scale * dS^T.Q,  dV = P^T.dO,
// dK and dV summed over the H / KV q-heads that read a kv-head.  Two
// kernels, in order on one stream:
// (a) flash_bwd_dq_kernel: one block a (b, h, 64-row q-tile).  A first pass
//     over the live key tiles recomputes each row's L (online max and sum,
//     the forward's masking and scale; the forward does not write L); it
//     forms delta from O and dO, writes L and delta to the scratch, and a
//     second pass accumulates dQ in registers.
// (b) flash_bwd_dkv_kernel: one block a (b, kv-head, 64-key tile).  It loops
//     over its group's q-heads and their live 32-row q-tiles, recomputes P
//     and dS from L and delta, and accumulates dK and dV in registers.
// Every output element is written by one thread of one block, so the result
// does not depend on the schedule.  Tiles live in shared memory in float32
// (bfloat16 inputs are widened on load); outputs are rounded once to the
// input dtype.  Bound on the card: operations.  The five S x S x D products
// of the live pairs (Q.K^T, dO.V^T, dS.K, dS^T.Q, P^T.dO) are 2.5x the
// forward's; at qwen3-14b's (4, 1024, 40, 128) bf16 that is 107.5 GFLOP,
// 108.7 us at the tensor cores' 989 TFLOP/s.  This first version runs on
// the CUDA cores (67 TFLOP/s float32 FMA peak) and recomputes Q.K^T three
// times and dO.V^T twice (8 products): a wgmma/TMA version is later work.

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p, float out[4]) {
    load4_f32(p, out);
  }
  static __device__ __forceinline__ float load1(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  // Four bf16 (8 bytes) widened exactly: a bf16 is the top half of a float.
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float out[4]) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    out[0] = __uint_as_float(raw.x << 16);
    out[1] = __uint_as_float(raw.x & 0xffff0000u);
    out[2] = __uint_as_float(raw.y << 16);
    out[3] = __uint_as_float(raw.y & 0xffff0000u);
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

constexpr int BKB = 64;          // keys a dK/dV block
constexpr int BQB = 32;          // q rows a dK/dV tile
constexpr int KT = BKB + 4;      // row stride of Kt/Vt/Ps/dSs (float4 reads)
constexpr int QT = BQB + 1;      // row stride of Qt/dOt (odd)

template <int D>
constexpr int dq_smem_floats() {
  return 2 * D * QS + 2 * D * KS + BK * QS;
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * D * KT + 2 * D * QT + 2 * BQB * KT + 2 * BQB;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int seq,
                                        int causal, int window) {
  return kpos < seq && qpos < seq && (!causal || kpos <= qpos) &&
         (!window || kpos > qpos - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ lse, float* __restrict__ delta,
                    int seq, int heads, int kv_heads, int causal, int window,
                    float scale) {
  constexpr int DC = D / 16;
  constexpr int D4 = D / 4;
  extern __shared__ float smem[];
  float* Qs = smem;                // [D][QS]  Q transposed
  float* dOs = Qs + D * QS;        // [D][QS]  dO transposed
  float* Ks = dOs + D * QS;        // [D][KS]  K transposed
  float* Vs = Ks + D * KS;         // [D][KS]  V transposed
  float* dSs = Vs + D * KS;        // [BK][QS] dS transposed

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int kh = h / (heads / kv_heads);
  const int q0 = blockIdx.y * BQ;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long q_base = (static_cast<long long>(b) * seq * heads + h) * D;
  const long long k_base =
      (static_cast<long long>(b) * seq * kv_heads + kh) * D;

  for (int idx = tid; idx < BQ * D4; idx += kThreads) {
    const int r = idx / D4, d = (idx % D4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f}, g[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < seq) {
      Io<T>::load4(q + q_base + (q0 + r) * q_row + d, x);
      Io<T>::load4(dout + q_base + (q0 + r) * q_row + d, g);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      Qs[(d + e) * QS + r] = x[e];
      dOs[(d + e) * QS + r] = g[e];
    }
  }
  __syncthreads();

  // delta = rowsum(dO o O): 16 threads a row, D / 16 columns each.
  float dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    float acc = 0.f;
    if (q0 + r < seq) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        acc = fmaf(dOs[d * QS + r],
                   Io<T>::load1(o + q_base + (q0 + r) * q_row + d), acc);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    dlt[i] = acc;
  }

  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(seq, q0 + BQ) : seq;
  const int k_first = (k_lo / BK) * BK;

  // Pass 1: each row's logsumexp over its visible keys.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = k_first; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * D4; idx += kThreads) {
      const int j = idx / D4, d = (idx % D4) * 4;
      float kx[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < seq) Io<T>::load4(k + k_base + (k0 + j) * k_row + d, kx);
#pragma unroll
      for (int e = 0; e < 4; ++e) Ks[(d + e) * KS + j] = kx[e];
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
        ok[jj] = visible(qpos, k0 + tx + 16 * jj, seq, causal, window);
        s[i][jj] = ok[jj] ? s[i][jj] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        rsum += ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = expf(m[i] - m_new) * l[i] + rsum;
      m[i] = m_new;
    }
  }
  float L[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    L[i] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
    if (qpos < seq && tx == 0) {
      const long long at = static_cast<long long>(bh) * seq + qpos;
      lse[at] = L[i];
      delta[at] = dlt[i];
    }
  }

  // Pass 2: dQ.
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  for (int k0 = k_first; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * D4; idx += kThreads) {
      const int j = idx / D4, d = (idx % D4) * 4;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < seq) {
        Io<T>::load4(k + k_base + (k0 + j) * k_row + d, kx);
        Io<T>::load4(v + k_base + (k0 + j) * k_row + d, vx);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Ks[(d + e) * KS + j] = kx[e];
        Vs[(d + e) * KS + j] = vx[e];
      }
    }
    __syncthreads();
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + d * QS + 4 * ty);
      const float4 gv = *reinterpret_cast<const float4*>(dOs + d * QS + 4 * ty);
      const float k0v = Ks[d * KS + tx], k1v = Ks[d * KS + tx + 16];
      const float v0v = Vs[d * KS + tx], v1v = Vs[d * KS + tx + 16];
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qa[i], k0v, s[i][0]);
        s[i][1] = fmaf(qa[i], k1v, s[i][1]);
        dp[i][0] = fmaf(ga[i], v0v, dp[i][0]);
        dp[i][1] = fmaf(ga[i], v1v, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = tx + 16 * jj;
        const bool ok = visible(qpos, k0 + j, seq, causal, window);
        const float p = ok ? expf(s[i][jj] * scale - L[i]) : 0.f;
        dSs[j * QS + 4 * ty + i] = p * (dp[i][jj] - dlt[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 dv4 = *reinterpret_cast<const float4*>(dSs + j * QS + 4 * ty);
      const float da[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[(tx + 16 * c) * KS + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(da[i], kv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= seq) continue;
    T* row = dq + q_base + qpos * q_row;
#pragma unroll
    for (int c = 0; c < DC; ++c) Io<T>::store(row + tx + 16 * c,
                                              acc[i][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int heads, int kv_heads,
                     int causal, int window, float scale) {
  constexpr int DC = D / 16;
  constexpr int D4 = D / 4;
  extern __shared__ float smem[];
  float* Kt = smem;                // [D][KT]  K transposed
  float* Vt = Kt + D * KT;         // [D][KT]  V transposed
  float* Qt = Vt + D * KT;         // [D][QT]  Q transposed
  float* dOt = Qt + D * QT;        // [D][QT]  dO transposed
  float* Ps = dOt + D * QT;        // [BQB][KT]
  float* dSs = Ps + BQB * KT;      // [BQB][KT]
  float* Ls = dSs + BQB * KT;      // [BQB]
  float* Ds = Ls + BQB;            // [BQB]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // keys 4ty.., q rows tx, tx+16
  const int bkh = blockIdx.x;
  const int b = bkh / kv_heads, kh = bkh % kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.y * BKB;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long k_base =
      (static_cast<long long>(b) * seq * kv_heads + kh) * D;

  for (int idx = tid; idx < BKB * D4; idx += kThreads) {
    const int j = idx / D4, d = (idx % D4) * 4;
    float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
    if (k0 + j < seq) {
      Io<T>::load4(k + k_base + (k0 + j) * k_row + d, kx);
      Io<T>::load4(v + k_base + (k0 + j) * k_row + d, vx);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      Kt[(d + e) * KT + j] = kx[e];
      Vt[(d + e) * KT + j] = vx[e];
    }
  }

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[r][c] = adv[r][c] = 0.f;

  // q rows that see a key of [k0, k0 + BKB): from k0 when causal, below
  // k0 + BKB - 1 + window with a window.
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(seq, k0 + BKB - 1 + window) : seq;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kh * group + hh;
    const long long q_base =
        (static_cast<long long>(b) * seq * heads + h) * D;
    const long long stat = (static_cast<long long>(b) * heads + h) * seq;
    for (int q0 = (q_lo / BQB) * BQB; q0 < q_hi; q0 += BQB) {
      __syncthreads();  // the previous tile is done with Qt, dOt, Ps, dSs
      for (int idx = tid; idx < BQB * D4; idx += kThreads) {
        const int r = idx / D4, d = (idx % D4) * 4;
        float x[4] = {0.f, 0.f, 0.f, 0.f}, g[4] = {0.f, 0.f, 0.f, 0.f};
        if (q0 + r < seq) {
          Io<T>::load4(q + q_base + (q0 + r) * q_row + d, x);
          Io<T>::load4(dout + q_base + (q0 + r) * q_row + d, g);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Qt[(d + e) * QT + r] = x[e];
          dOt[(d + e) * QT + r] = g[e];
        }
      }
      if (tid < BQB) {
        const bool in = q0 + tid < seq;
        Ls[tid] = in ? lse[stat + q0 + tid] : 0.f;
        Ds[tid] = in ? delta[stat + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][2], dp[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kv = *reinterpret_cast<const float4*>(Kt + d * KT + 4 * ty);
        const float4 vv = *reinterpret_cast<const float4*>(Vt + d * KT + 4 * ty);
        const float q0v = Qt[d * QT + tx], q1v = Qt[d * QT + tx + 16];
        const float g0v = dOt[d * QT + tx], g1v = dOt[d * QT + tx + 16];
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[r][0] = fmaf(ka[r], q0v, s[r][0]);
          s[r][1] = fmaf(ka[r], q1v, s[r][1]);
          dp[r][0] = fmaf(va[r], g0v, dp[r][0]);
          dp[r][1] = fmaf(va[r], g1v, dp[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kpos = k0 + 4 * ty + r;
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int i = tx + 16 * ii;
          const bool ok = visible(q0 + i, kpos, seq, causal, window);
          const float p = ok ? expf(s[r][ii] * scale - Ls[i]) : 0.f;
          Ps[i * KT + 4 * ty + r] = p;
          dSs[i * KT + 4 * ty + r] = p * (dp[r][ii] - Ds[i]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQB; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + i * KT + 4 * ty);
        const float4 sv = *reinterpret_cast<const float4*>(dSs + i * KT + 4 * ty);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float gv = dOt[(tx + 16 * c) * QT + i];
          const float qv = Qt[(tx + 16 * c) * QT + i];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            adv[r][c] = fmaf(pa[r], gv, adv[r][c]);
            adk[r][c] = fmaf(sa[r], qv, adk[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kpos = k0 + 4 * ty + r;
    if (kpos >= seq) continue;
    const long long at = k_base + kpos * k_row;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      Io<T>::store(dk + at + tx + 16 * c, adk[r][c] * scale);
      Io<T>::store(dv + at + tx + 16 * c, adv[r][c]);
    }
  }
}

template <typename T, int D>
int launch_bwd_d(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv,
                 void* scratch, int batch, int seq, int heads, int kv_heads,
                 int causal, int window, cudaStream_t stream) {
  const int q_tiles = (seq + BQ - 1) / BQ, k_tiles = (seq + BKB - 1) / BKB;
  if (q_tiles > 65535 || k_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int dq_bytes = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  constexpr int dkv_bytes =
      dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kdq = flash_bwd_dq_kernel<T, D>;
  auto kdkv = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  float* lse = static_cast<float*>(scratch);
  float* delta = lse + static_cast<long long>(batch) * heads * seq;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  kdq<<<dim3(batch * heads, q_tiles), kThreads, dq_bytes, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tdo, static_cast<T*>(dq), lse,
      delta, seq, heads, kv_heads, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdkv<<<dim3(batch * kv_heads, k_tiles), kThreads, dkv_bytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      seq, heads, kv_heads, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, void* scratch,
               int batch, int seq, int heads, int kv_heads, int head_dim,
               int causal, int window, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0)
    return static_cast<int>(cudaGetLastError());
  if (kv_heads <= 0 || heads % kv_heads != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(D)                                                        \
  return launch_bwd_d<T, D>(q, k, v, o, dout, dq, dk, dv, scratch, batch,  \
                            seq, heads, kv_heads, causal, window, s)
  constexpr bool kF32 = sizeof(T) == 4;
  switch (head_dim) {
    case 16:
      if constexpr (kF32) REPRO_BWD(16);
      break;
    case 32:
      if constexpr (kF32) REPRO_BWD(32);
      break;
    case 64:
      REPRO_BWD(64);
    case 128:
      REPRO_BWD(128);
    default:
      break;
  }
#undef REPRO_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kBf16>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq, int heads, int kv_heads, int head_dim, int causal,
           int window, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0)
    return static_cast<int>(cudaGetLastError());
  if (kv_heads <= 0 || heads % kv_heads != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kBf16) {
    if (head_dim == 64)
      return launch_bf16<64>(q, k, v, o, batch, seq, heads, kv_heads, causal,
                             window, s);
    if (head_dim == 128)
      return launch_bf16<128>(q, k, v, o, batch, seq, heads, kv_heads,
                              causal, window, s);
  } else {
    switch (head_dim) {
      case 16:
        return launch_f32<16>(q, k, v, o, batch, seq, heads, kv_heads,
                              causal, window, s);
      case 32:
        return launch_f32<32>(q, k, v, o, batch, seq, heads, kv_heads,
                              causal, window, s);
      case 64:
        return launch_f32<64>(q, k, v, o, batch, seq, heads, kv_heads,
                              causal, window, s);
      case 128:
        return launch_f32<128>(q, k, v, o, batch, seq, heads, kv_heads,
                               causal, window, s);
      default:
        break;
    }
  }
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
  return launch<false>(q, k, v, o, batch, seq, heads, kv_heads, head_dim,
                       causal, window, stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int batch,
                                          int seq, int heads, int kv_heads,
                                          int head_dim, int causal, int window,
                                          void* stream) {
  return launch<true>(q, k, v, o, batch, seq, heads, kv_heads, head_dim,
                      causal, window, stream);
}

// The backward pair (two launches on the stream); scratch holds 2 x B x H x
// S floats (each row's logsumexp, then delta).  Returns as above.
extern "C" int repro_flash_attention_f32_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* scratch, int batch,
    int seq, int heads, int kv_heads, int head_dim, int causal, int window,
    void* stream) {
  return launch_bwd<float>(q, k, v, o, dout, dq, dk, dv, scratch, batch, seq,
                           heads, kv_heads, head_dim, causal, window, stream);
}

extern "C" int repro_flash_attention_bf16_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* scratch, int batch,
    int seq, int heads, int kv_heads, int head_dim, int causal, int window,
    void* stream) {
  return launch_bwd<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, scratch,
                                   batch, seq, heads, kv_heads, head_dim,
                                   causal, window, stream);
}
