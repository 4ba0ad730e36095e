// Causal / sliding-window / bidirectional attention with online softmax on
// Hopper:
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
// 101 MB of q/k/v/o (30 us at 3.35 TB/s).  At nemotron-4-340b's (4, 1024,
// 96/8, 192) it is 154.8 GFLOP, 156.5 us; at phi-3-vision-4.2b's (4, 2048,
// 32/32, 96) 103.1 GFLOP, 104.3 us; at whisper-tiny's encoder (16, 1500,
// 6/6, 64, no causal mask: every pair live) 55.3 GFLOP, 55.9 us.
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
//   (64 at D=128, 96 at D=192) in a consumer's 240 registers.
// * D = 192 (nemotron-4-340b) is three 64-column slabs: Q.K^T takes twelve
//   k16 steps over them, P.V one m64n192k16 product a step whose B operand
//   steps from slab to slab by the descriptor's leading offset, and Q gets
//   one buffer instead of two (TcLayout: two do not fit beside the ring).
// * D = 96 (phi-3-vision-4.2b): a 192-byte row fits no 128-byte swizzled
//   box, and wgmma's 128-byte MN-major layout steps N in 64-column atoms, so
//   Q, K and V are three 32-column slabs of 64-byte rows under the 64-byte
//   swizzle (TMA boxes of 32 columns, descriptors of swizzle mode 2 whose 8
//   rows span 512 bytes).  Q.K^T takes six k16 steps, two a slab; P.V is one
//   m64n96k16 product a step, the slabs one leading offset apart, O 48
//   floats a thread.  A Q tile is 24,576 bytes and a K+V stage 24,576, so
//   two Q buffers and the 3-stage ring take 123,984 bytes.
// * causal = 0 (the audio encoder): every key tile below S is live for
//   every row, and only the last, straddling S, takes the element mask.
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
// memory.  D is 16, 32, 64, 96, 128 or 192 in float32, 64, 96, 128 or 192
// in bfloat16, in the forward and the backward alike.
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
                           float* __restrict__ lse, int seq, int heads,
                           int kv_heads, int causal, int window, float scale) {
  static_assert(D % 16 == 0 && D <= 192, "D is 16, 32, 64, 96, 128 or 192");
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
    if (lse != nullptr && tx == 0)
      lse[static_cast<long long>(bh) * seq + qpos] = m[i] + logf(l[i]);
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float* orow = o + (static_cast<long long>(b) * seq + qpos) * q_row +
              static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, int seq, int heads, int kv_heads,
               int causal, int window, cudaStream_t stream) {
  if (batch * heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kern = flash_attention_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq, heads,
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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Q, K and V tiles are column slabs of 64 bf16 (128-byte rows, 128-byte
// swizzle) where D is a multiple of 64; at D = 96 three slabs of 32 (64-byte
// rows, 64-byte swizzle), so that P.V is one m64n96k16 product over
// canonical MN-major slabs (no 64-column layout holds 96 columns).
template <int D>
struct TcLayout {
  static constexpr int kSlabCols = D % 64 == 0 ? 64 : 32;
  static constexpr int kRowBytes = 2 * kSlabCols;      // one swizzled row
  static constexpr int kHalves = D / kSlabCols;        // column slabs
  static constexpr int kQBytes = kHalves * kTcBQ * kRowBytes;
  static constexpr int kTileBytes = kHalves * kTcBK * kRowBytes;  // K or V
  static constexpr int kRingBytes = kStages * 2 * kTileBytes;
  static constexpr int kBarBytes = 8 * (4 + 2 * kStages);
  // The forward's Q buffers: two, so that the next item's Q arrives while
  // this one's last P.V and epilogue run; one at D = 192, where two Q tiles
  // and the 3-stage ring (246,864 bytes) exceed the 232,448 a block may opt
  // into.  One Q (197,712 bytes) keeps the ring's depth, which every tile
  // waits on, and exposes the Q load once an item instead.
  static constexpr int kQBufs = D > 128 ? 1 : 2;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period.
  static constexpr int kSmemBytes =
      1024 + kQBufs * kQBytes + kRingBytes + kBarBytes;
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

// The descriptor of TcLayout<D>'s slabs: 128-byte swizzle (mode 1) over
// 128-byte rows, or 64-byte swizzle (mode 2) over 64-byte rows, where 8 rows
// span 512 bytes and an MN-major operand's next 32 columns lie one slab on.
template <int D>
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  if constexpr (TcLayout<D>::kSlabCols == 64) {
    return sw128_desc(addr, lbo, sbo);
  } else {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
  }
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

// d (64 x 96, float32 fragment) += A . B: A a bf16 register fragment (64 x 16),
// B (16 x 96) bf16 in shared memory, MN-major (transposed), 64-byte swizzle:
// three 32-column slabs one leading offset apart.
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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

// d (64 x 192, float32 fragment) += A . B: A a bf16 register fragment (64 x 16),
// B (16 x 192) bf16 in shared memory, MN-major (transposed), 128-byte swizzle:
// three 64-column slabs one leading offset apart.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S = Q . K^T for one 64-key tile of this warpgroup's 64 rows, one wgmma
// group: over D in steps of 16, +32 bytes inside a swizzled row, the next
// column slab after four steps (two at D = 96).
template <int D>
__device__ __forceinline__ void start_scores(float (&sc)[kTcBK / 2],
                                             uint32_t qs, uint32_t ks) {
  using L = TcLayout<D>;
  constexpr int kSteps = L::kSlabCols / 16;    // k16 steps a slab
  constexpr uint32_t kSbo = 8 * L::kRowBytes;  // 8 rows
#pragma unroll
  for (int j = 0; j < kTcBK / 2; ++j) sc[j] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % kSteps) * 32;
    const int slab = kk / kSteps;
    wgmma_ss_n64(
        sc, tc_desc<D>(qs + slab * kTcBQ * L::kRowBytes + off, 16, kSbo),
        tc_desc<D>(ks + slab * kTcBK * L::kRowBytes + off, 16, kSbo), kk > 0);
  }
  wgmma_commit();
}

// O += P_hi . V + P_lo . V for one tile, one wgmma group: 16 keys a step
// (two 8-row groups), each further slab of D's columns one slab (kTcBK rows)
// further.
template <int D>
__device__ __forceinline__ void start_pv(float (&acc)[D / 2],
                                         const uint32_t (&p_hi)[kTcBK / 16][4],
                                         const uint32_t (&p_lo)[kTcBK / 16][4],
                                         uint32_t vs) {
  using L = TcLayout<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk) {
    const uint64_t dv = tc_desc<D>(vs + kk * 16 * L::kRowBytes,
                                   kTcBK * L::kRowBytes, 8 * L::kRowBytes);
    if constexpr (D == 192) {
      wgmma_rs_n192(acc, p_hi[kk], dv);
      wgmma_rs_n192(acc, p_lo[kk], dv);
    } else if constexpr (D == 128) {
      wgmma_rs_n128(acc, p_hi[kk], dv);
      wgmma_rs_n128(acc, p_lo[kk], dv);
    } else if constexpr (D == 96) {
      wgmma_rs_n96(acc, p_hi[kk], dv);
      wgmma_rs_n96(acc, p_lo[kk], dv);
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

// The live key tiles [a, b) of [t_lo, t_hi) for the 64 query rows from
// row_lo: none past their causal frontier or wholly before their window,
// none at all if the rows all lie at or past S.
__device__ __forceinline__ void live_tiles(int row_lo, int t_lo, int t_hi,
                                           int seq, int causal, int window,
                                           int& a, int& b) {
  b = row_lo >= seq ? t_lo
      : causal      ? min(t_hi, (row_lo + 63) / kTcBK + 1)
                    : t_hi;
  a = t_lo;
  while (window && a < b && a * kTcBK + kTcBK - 1 <= row_lo - window) ++a;
}

// Whether key tile t needs the element mask for the 64 query rows from
// row_lo: it straddles their causal frontier, their window's edge or S.
__device__ __forceinline__ bool edge_tile(int t, int row_lo, int seq,
                                          int causal, int window) {
  const int k0 = t * kTcBK;
  return (causal && k0 + kTcBK - 1 > row_lo) ||
         (window && k0 <= row_lo + 63 - window) || k0 + kTcBK > seq;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int batch, int seq, int heads, int kv_heads,
                      int causal, int window, float scale_log2) {
  using L = TcLayout<D>;
  constexpr int kSlabQ = kTcBQ * L::kRowBytes;   // bytes of one Q slab
  constexpr int kSlabKV = kTcBK * L::kRowBytes;  // bytes of one K/V slab
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;          // [kQBufs][slab][128 rows][128 B]
  const uint32_t ring = sq + L::kQBufs * L::kQBytes;  // stage: K, V slabs
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
  // same key tiles, counting items j (Q buffer j % kQBufs) and tiles n (ring
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
        const int qb = j % L::kQBufs;
        if (j >= L::kQBufs)
          mbar_wait(q_empty + 8 * qb, (j / L::kQBufs - 1) & 1);
        mbar_expect_tx(q_full + 8 * qb, L::kQBytes);
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf)
          tma_load(sq + qb * L::kQBytes + hf * kSlabQ, &tm_q, q_full + 8 * qb,
                   L::kSlabCols * hf, it.h, it.q0, it.b);
        for (int t = it.t_lo; t < it.t_hi; ++t, ++n) {
          const int s = n % kStages;
          if (n >= kStages)
            mbar_wait(empty_bar + 8 * s, (n / kStages - 1) & 1);
          const uint32_t ks = ring + s * 2 * L::kTileBytes;
          const uint32_t vs = ks + L::kTileBytes;
          mbar_expect_tx(full_bar + 8 * s, 2 * L::kTileBytes);
#pragma unroll
          for (int hf = 0; hf < L::kHalves; ++hf) {
            tma_load(ks + hf * kSlabKV, &tm_k, full_bar + 8 * s,
                     L::kSlabCols * hf, it.kh, t * kTcBK, it.b);
            tma_load(vs + hf * kSlabKV, &tm_v, full_bar + 8 * s,
                     L::kSlabCols * hf, it.kh, t * kTcBK, it.b);
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
      const int qbuf = j % L::kQBufs;
      const uint32_t qs = sq + qbuf * L::kQBytes + wg * 64 * L::kRowBytes;

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      // Running max in log2 units (score * scale * log2 e) and this
      // thread's share of the denominator, for rows qa and qb.
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      // This warpgroup's live tiles [a_live, b_live); it still waits for
      // and releases every stage of the ring, in order.
      int a_live, b_live;
      live_tiles(row_lo, t_lo, t_hi, seq, causal, window, a_live, b_live);
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
        return edge_tile(t, row_lo, seq, causal, window);
      };

      mbar_wait(q_full + 8 * qbuf, (j / L::kQBufs) & 1);
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
      // acc / max(l, 1e-30) rounded to bf16; with lse, the row's logsumexp
      // of the scaled scores in natural-log units, ln 2 (m + log2 l).
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
      }
      if (lse != nullptr && c0 == 0) {
        float* lrow = lse + (static_cast<long long>(it.b) * heads + it.h) * seq;
        if (qa < seq) lrow[qa] = (m[0] + log2f(l[0])) * kLn2;
        if (qb < seq) lrow[qb] = (m[1] + log2f(l[1])) * kLn2;
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

// Tensor map over a (B, S, heads, D) bf16 tensor in place; one box is
// `cols` columns of D (64, or 32 at D = 96) of `rows` consecutive positions
// of one (b, head), written to shared memory with the 128-byte (64-byte)
// swizzle.  Rows past S read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d,
              int heads, int seq, int batch, int rows, int cols = 64) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(heads) * d * 2,
      static_cast<cuuint64_t>(seq) * heads * d * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// setmaxnreg moves registers within the block's allocation: refuse to
// launch (rather than deadlock) a warp-specialised kernel whose allocation
// cannot cover the producer's and the consumers' shares.
template <typename Kernel>
cudaError_t check_reg_split(Kernel kern) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kTcThreads <
      128 * (kProducerRegs + kConsumers * kConsumerRegs))
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int batch, int seq, int heads, int kv_heads,
                int causal, int window, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v;
  constexpr int cols = TcLayout<D>::kSlabCols;
  if (!make_map(encode, &tm_q, q, D, heads, seq, batch, kTcBQ, cols) ||
      !make_map(encode, &tm_k, k, D, kv_heads, seq, batch, kTcBK, cols) ||
      !make_map(encode, &tm_v, v, D, kv_heads, seq, batch, kTcBK, cols))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_attention_wgmma<D>;
  cudaError_t err = check_reg_split(kern);
  if (err != cudaSuccess) return static_cast<int>(err);
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
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, batch, seq,
      heads, kv_heads, causal, window, kLog2e / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
//
// dQ, dK and dV of the function above: with P = exp(scale * Q.K^T - L) on
// the visible pairs (L the row's logsumexp), dP = dO.V^T,
// delta = rowsum(dO o O) and dS = P o (dP - delta):
//   dQ = scale * dS.K,  dK = scale * dS^T.Q,  dV = P^T.dO,
// dK and dV summed over the H / KV q-heads that read a kv-head.  Every
// output element is written by one thread of one block (no atomics), so the
// result does not depend on the schedule; outputs are rounded once to the
// input dtype.  Bound on the card: operations.  The five S x S x D products
// of the live pairs (Q.K^T, dO.V^T, dS.K, dS^T.Q, P^T.dO) are 2.5x the
// forward's; at qwen3-14b's (4, 1024, 40, 128) bf16 that is 107.5 GFLOP,
// 108.7 us at the tensor cores' 989 TFLOP/s.
//
// float32, the check dtype and the FL LM workloads' dtype (head_dim 16 to
// 192): CUDA cores, float32 throughout, two kernels in order on one stream.
// (a) flash_bwd_dq_kernel: one block a (b, h, 64-row q-tile).  A first pass
//     over the live key tiles recomputes each row's L (online max and sum,
//     the forward's masking and scale); it forms delta from O and dO,
//     writes L and delta to the scratch, and a second pass accumulates dQ
//     in registers.
// (b) flash_bwd_dkv_kernel: one block a (b, kv-head, 64-key tile).  It loops
//     over its group's q-heads and their live 32-row q-tiles, recomputes P
//     and dS from L and delta, and accumulates dK and dV in registers.
// Tiles live in shared memory in float32.  It recomputes Q.K^T three times
// and dO.V^T twice (8 products) on the CUDA cores (67 TFLOP/s float32 FMA
// peak); TF32 tensor cores would break the check dtype's limits.
//
// bfloat16, the training dtype: tensor cores (wgmma), TMA, warp-specialised
// like the forward (a producer warpgroup whose one thread starts every copy,
// two consumer warpgroups of 64 rows, setmaxnreg 24 / 240), two kernels in
// order on one stream, from the row logsumexp L that the forward wrote in
// its epilogue (natural-log units, B x H x S), so that no pass recomputes
// it:
// (q) flash_bwd_dq_wgmma: one block a (b, h, 128-row q-tile), heaviest
//     (last) q-tiles first.  Q and dO arrive once by TMA; meanwhile each
//     thread forms its two rows' delta in float32 from O and dO in global
//     memory and turns L into log2 units, and writes both to a scratch
//     [2][B x H][S_pad] whose rows are padded to the 64-row q-tile with
//     zeros, so that every dK/dV tile's slice is one aligned 256-byte bulk
//     copy.  K/V tiles of 64 keys stream through the forward's 3-stage
//     ring.  Per live key tile: S = Q.K^T and dP = dO.V^T (SS wgmma, both
//     operands K-major), P and dS on the accumulator fragment, then
//     dQ += dS.K (RS wgmma, dS a register fragment built in place from the
//     accumulator layout, K read through an MN-major descriptor as the
//     forward reads V); tile t's S, dP and dS overlap tile t - 1's dS.K
//     (a second set of dS fragments, so that dS's split overlaps it too,
//     measured slower).
//     Q and dO as register fragments (RS for S and dP) measured no faster
//     and spilled.
// (k) flash_bwd_dkv_wgmma: one block a (b, kv-head, 128-key tile), the
//     first key tiles (the causal triangle's longest columns) first (a
//     block taking a long and a short column together measured no faster:
//     the hardware's in-order dispatch already balances them).  K and V
//     stay resident; each consumer warpgroup owns 64 keys.
//     Q and dO tiles of 64 rows, with their slices of L and delta (bulk
//     copies), stream through a 3-stage ring over the group's q-heads and
//     the item's live q-range (causal: q >= k0; window: q < k0 + 127 +
//     window).  Per tile: S^T = K.Q^T (SS), P^T in registers, then
//     dV += P^T.dO (RS, dO MN-major) while dP^T = V.dO^T (SS) runs, dS^T
//     from P^T's split halves, then dK += dS^T.Q (RS), one after the
//     other.  Two accumulators of 64 x D leave no registers for a second
//     tile in flight (a version that started the next S^T behind
//     dK's products spilled and ran slower).
// Both kernels take the forward's slab layout (TcLayout<D>) for every
// operand, K-major or MN-major: D = 96 (phi-3-vision-4.2b) is three
// 32-column slabs under the 64-byte swizzle, so dS.K, P^T.dO and dS^T.Q
// are m64n96k16 products whose B operand steps slab by slab as the
// forward's P.V does, with 48 floats a thread an accumulator.
// D = 192 (nemotron-4-340b) meets two limits (BwdLayout):
// * Shared memory.  Two resident 128-row tiles of three 64-column slabs
//   (98,304 bytes) and a 3-stage ring of two 64-row tiles (147,456) exceed
//   the 232,448 bytes a block may opt into, in both kernels.  At 192 the
//   ring has 2 stages (198,696 bytes at most), so a tile's loads overlap
//   the tile before it only.
// * Registers.  Two 64 x 192 accumulators are 192 floats a thread, and
//   with S^T, dP^T and the hi/lo fragments beside them they pass a
//   consumer warpgroup's 240.  So the dK/dV kernel walks its q-tiles twice
//   with one accumulator: dV += P^T.dO on the first walk, stored when it
//   ends, then dK += dS^T.Q on the second, which recomputes S^T (7
//   products a tile against the one walk's 6, and Q/dO loaded twice).
//   Splitting D's columns between the consumer warpgroups instead would
//   halve the keys a block owns and recompute S^T and dP^T in each.  The
//   dQ kernel's one accumulator is 96 floats a thread, but with tile t's S
//   and dP beside tile t - 1's dS fragments it spilled (332 bytes of
//   spill stores and loads, ptxas), so at 192 it runs each tile's
//   products one after the other, without that overlap.
// Why P and dS are split: rounding them to bf16 once before their products,
// as FlashAttention-2/3 do, puts the gradients within 0.999 of BWD_TOL
// (7e-3 of each gradient's largest magnitude, chip_smoke.py phase 16a) of
// the plain backward at (1, 512, 5/1, 128) causal
// (tests/test_torch_attention_ssd.py emulates it).  So, as in the forward,
// X = X_hi + X_lo with X_hi = bf16(X), X_lo = bf16(X - X_hi), and each
// product with P or dS runs twice: 10 products in all against the bound's 5
// (215 GFLOP at qwen3-14b's shape, 217 us at the bf16 peak).

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

// ---------------------------------------------------------------------------
// bfloat16 backward: tensor cores
// ---------------------------------------------------------------------------

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 2^x by the multi-function unit's approximation (a few float32 ulps, far
// below the split's 2^-16; 0 for a very negative x).  exp2f's accurate
// path makes the backward 18% slower at qwen3-14b's shape on an H100
// (scripts/torch_flash_bwd_variants.py).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// split_p's split with a truncated high half: X_hi keeps X's top 16 bits
// (one byte permute a pair) and X_lo = bf16(X - X_hi), one conversion a
// pair instead of two; X_hi + X_lo still carries X to about 16 bits.
__device__ __forceinline__ void split_trunc(const float (&x)[kTcBK / 2],
                                            uint32_t (&hi)[kTcBK / 16][4],
                                            uint32_t (&lo)[kTcBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint32_t a = __float_as_uint(x[8 * kk + 2 * g]);
      const uint32_t b = __float_as_uint(x[8 * kk + 2 * g + 1]);
      asm("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(hi[kk][g]) : "r"(a), "r"(b));
      lo[kk][g] = bf16x2_bits(__floats2bfloat162_rn(
          __uint_as_float(a) - __uint_as_float(a & 0xffff0000u),
          __uint_as_float(b) - __uint_as_float(b & 0xffff0000u)));
    }
  }
}

// P of one tile's fragment, in place: the scores sc become
// P = exp2(sc * scale_log2 - L), 0 where visible(j) is false; l2(j) gives
// fragment element j's row statistic L (log2 units).
template <class Stat, class Visible>
__device__ __forceinline__ void probs_tile(float (&sc)[kTcBK / 2], Stat l2,
                                           Visible visible_j,
                                           float scale_log2) {
#pragma unroll
  for (int j = 0; j < kTcBK / 2; ++j)
    sc[j] = visible_j(j) ? fast_exp2(sc[j] * scale_log2 - l2(j)) : 0.f;
}

// dS of one tile's fragment, in place: dp (dO.V^T) becomes
// dS = P (dp - delta), with p(j) and delta(j) fragment element j's P and
// row statistic.
template <class Prob, class Stat>
__device__ __forceinline__ void dscores_tile(float (&dp)[kTcBK / 2], Prob p,
                                             Stat delta) {
#pragma unroll
  for (int j = 0; j < kTcBK / 2; ++j) dp[j] = p(j) * (dp[j] - delta(j));
}

// Element j of a fragment split by split_trunc, X_hi + X_lo, back in
// float32.
__device__ __forceinline__ float unsplit(
    const uint32_t (&hi)[kTcBK / 16][4], const uint32_t (&lo)[kTcBK / 16][4],
    int j) {
  const uint32_t h = hi[j / 8][(j % 8) / 2], l = lo[j / 8][(j % 8) / 2];
  return (j & 1) ? __uint_as_float(h & 0xffff0000u) +
                       __uint_as_float(l & 0xffff0000u)
                 : __uint_as_float(h << 16) + __uint_as_float(l << 16);
}

// Rows ra and rb of a (64 x D) float32 fragment, times scale, rounded to
// bf16 at pa and pb (each the row's column c0); a row flagged off is not
// written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* pa,
                                           __nv_bfloat16* pb,
                                           const float (&acc)[D / 2],
                                           float scale, bool a_ok,
                                           bool b_ok) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (a_ok)
      *reinterpret_cast<__nv_bfloat162*>(pa + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i] * scale, acc[4 * i + 1] * scale);
    if (b_ok)
      *reinterpret_cast<__nv_bfloat162*>(pb + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
  }
}

// Rows of the bf16 pair's statistics scratch: S padded to the dK/dV
// kernel's 64-row q-tile.
__host__ __device__ __forceinline__ int padded_rows(int seq) {
  return (seq + kTcBK - 1) / kTcBK * kTcBK;
}

// The bf16 backward's shared memory over the forward's slabs: two resident
// 128-row tiles (Q and dO in the dQ kernel, K and V in the dK/dV kernel), a
// ring of kStages stages of two 64-row tiles (K and V, or Q and dO), the
// dK/dV kernel's L and delta slices a stage, and the barriers.  At D = 192
// three stages do not fit (the source note above), so two.  kPasses: the
// dK/dV kernel's walks over its q-tiles, one for both accumulators or, at
// D = 192, where two 64 x D accumulators do not fit the registers, one for
// dV and one for dK.
template <int D>
struct BwdLayout {
  using L = TcLayout<D>;
  static constexpr int kStages = D > 128 ? 2 : 3;
  static constexpr int kPasses = D > 128 ? 2 : 1;
  // Whether the dQ kernel overlaps tile t's S and dP with tile t - 1's
  // dS.K: at D = 192 the second set of fragments beside the 96-float
  // accumulator spills.
  static constexpr bool kOverlapDq = D <= 128;
  static constexpr int kRingBytes = kStages * 2 * L::kTileBytes;
  static constexpr int kStatBytes = 2 * kTcBK * 4;  // a tile's L, delta
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  // + 1024: the base is rounded up to the swizzle's 1024-byte period.
  static constexpr int kDqBytes = 1024 + 2 * L::kQBytes + kRingBytes +
                                  kBarBytes;
  static constexpr int kDkvBytes = kDqBytes + kStages * kStatBytes;
  static_assert(kDkvBytes <= 232448, "over a block's shared memory");
};

// An integral constant for the generic lambdas' compile-time switches.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// (q) dQ: one block a (b, h, 128-row q-tile), numbered as the forward's
// items (decode_item), so the causal triangle's longest rows start first.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ stats,
                   __nv_bfloat16* __restrict__ dq, int batch, int seq,
                   int heads, int kv_heads, int causal, int window,
                   float scale_log2, float scale) {
  using L = TcLayout<D>;
  constexpr int kStages = BwdLayout<D>::kStages;
  constexpr int kSlabQ = kTcBQ * L::kRowBytes;   // a slab of 128 rows
  constexpr int kSlabKV = kTcBK * L::kRowBytes;  // a slab of 64 keys
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                     // Q: [slab][128 rows][row]
  const uint32_t sdo = sq + L::kQBytes;         // dO, likewise
  const uint32_t ring = sdo + L::kQBytes;       // stage: K slabs, V slabs
  const uint32_t q_full = ring + BwdLayout<D>::kRingBytes;
  const uint32_t full_bar = q_full + 8;              // [kStages]
  const uint32_t empty_bar = full_bar + 8 * kStages; // [kStages]

  const int bh_count = batch * heads;
  const Item it = decode_item(blockIdx.x, bh_count, (seq + kTcBQ - 1) / kTcBQ,
                              seq, heads, kv_heads, causal, window);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Both roles walk the key tiles [t_lo, t_hi) in order, tile t in ring
  // stage (t - t_lo) % kStages.
  const int wg = tid / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 128 * kConsumers) {
      mbar_expect_tx(q_full, 2 * L::kQBytes);
#pragma unroll
      for (int hf = 0; hf < L::kHalves; ++hf) {
        tma_load(sq + hf * kSlabQ, &tm_q, q_full, L::kSlabCols * hf, it.h,
                 it.q0, it.b);
        tma_load(sdo + hf * kSlabQ, &tm_do, q_full, L::kSlabCols * hf, it.h,
                 it.q0, it.b);
      }
      for (int t = it.t_lo, n = 0; t < it.t_hi; ++t, ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(empty_bar + 8 * s, (n / kStages - 1) & 1);
        const uint32_t ks = ring + s * 2 * L::kTileBytes;
        const uint32_t vs = ks + L::kTileBytes;
        mbar_expect_tx(full_bar + 8 * s, 2 * L::kTileBytes);
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf) {
          tma_load(ks + hf * kSlabKV, &tm_k, full_bar + 8 * s,
                   L::kSlabCols * hf, it.kh, t * kTcBK, it.b);
          tma_load(vs + hf * kSlabKV, &tm_v, full_bar + 8 * s,
                   L::kSlabCols * hf, it.kh, t * kTcBK, it.b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg .. + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int r0 = 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int row_lo = it.q0 + 64 * wg;
    const int qa = row_lo + r0, qb = qa + 8;
    // While Q and dO arrive: L in log2 units and delta = rowsum(dO o O) of
    // rows qa and qb, delta over the row's four threads (16-byte chunks
    // lane % 4, + 4, ... of O and dO each), into the scratch for the dK/dV
    // kernel.  Rows at or past S take L = delta = 0 (zeros up to S_pad):
    // their dS is 0 and their dQ is not written.
    const long long seq_pad = padded_rows(seq);
    const long long bh = static_cast<long long>(it.b) * heads + it.h;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? qb : qa;
      float d = 0.f;
      if (row < seq) {
        const long long at =
            ((static_cast<long long>(it.b) * seq + row) * heads + it.h) * D;
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          const long long e = at + 8 * (lane % 4 + 4 * i);
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(o + e));
          const uint4 y = __ldg(reinterpret_cast<const uint4*>(dout + e));
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
          const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            d = fmaf(__uint_as_float(xs[w] << 16),
                     __uint_as_float(ys[w] << 16), d);
            d = fmaf(__uint_as_float(xs[w] & 0xffff0000u),
                     __uint_as_float(ys[w] & 0xffff0000u), d);
          }
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      dl[r] = d;
      l2[r] = row < seq ? lse[bh * seq + row] * kLog2e : 0.f;
      if (lane % 4 == 0 && row < seq_pad) {
        stats[bh * seq_pad + row] = l2[r];
        stats[bh_count * seq_pad + bh * seq_pad + row] = d;
      }
    }
    const uint32_t qs = sq + wg * 64 * L::kRowBytes;
    const uint32_t dos = sdo + wg * 64 * L::kRowBytes;
    int a_live, b_live;
    live_tiles(row_lo, it.t_lo, it.t_hi, seq, causal, window, a_live, b_live);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    auto stage = [&](int t) { return (t - it.t_lo) % kStages; };
    auto wait_full = [&](int t) {
      mbar_wait(full_bar + 8 * stage(t), ((t - it.t_lo) / kStages) & 1);
    };
    auto release = [&](int t) { mbar_arrive(empty_bar + 8 * stage(t)); };
    auto k_tile = [&](int t) { return ring + stage(t) * 2 * L::kTileBytes; };
    // S and dP of key tile t: 2 wgmma groups.
    auto start_s_dp = [&](float (&sc)[kTcBK / 2], float (&dp)[kTcBK / 2],
                          int t) {
      start_scores<D>(sc, qs, k_tile(t));
      start_scores<D>(dp, dos, k_tile(t) + L::kTileBytes);
    };
    auto ds_tile = [&](float (&sc)[kTcBK / 2], float (&dp)[kTcBK / 2],
                       int t) {
      const bool edge = edge_tile(t, row_lo, seq, causal, window);
      const int k0 = t * kTcBK;
      probs_tile(
          sc, [&](int j) { return l2[(j >> 1) & 1]; },
          [&](int j) {
            return !edge || visible((j & 2) ? qb : qa,
                                    k0 + 8 * (j / 4) + c0 + (j & 1), seq,
                                    causal, window);
          },
          scale_log2);
      dscores_tile(
          dp, [&](int j) { return sc[j]; },
          [&](int j) { return dl[(j >> 1) & 1]; });
    };

    mbar_wait(q_full, 0);
    for (int t = it.t_lo; t < a_live; ++t) {
      wait_full(t);
      release(t);
    }
    if constexpr (!BwdLayout<D>::kOverlapDq) {
      if (a_live < b_live) {
        // One tile's products after the other: S and dP, then dS.K.
        float sc[kTcBK / 2], dp[kTcBK / 2];
        uint32_t ds_hi[kTcBK / 16][4], ds_lo[kTcBK / 16][4];
        for (int t = a_live; t < b_live; ++t) {
          wait_full(t);
          start_s_dp(sc, dp, t);
          wgmma_wait<0>();
          reg_fence(sc);
          reg_fence(dp);
          ds_tile(sc, dp, t);
          split_trunc(dp, ds_hi, ds_lo);
          start_pv<D>(acc, ds_hi, ds_lo, k_tile(t));
          wgmma_wait<0>();
          reg_fence(acc);
          reg_fence(ds_hi);
          reg_fence(ds_lo);
          release(t);
        }
      }
    } else if (a_live < b_live) {
      float sc[kTcBK / 2], dp[kTcBK / 2];
      uint32_t ds_hi[kTcBK / 16][4], ds_lo[kTcBK / 16][4];
      wait_full(a_live);
      start_s_dp(sc, dp, a_live);
      wgmma_wait<0>();
      reg_fence(sc);
      reg_fence(dp);
      ds_tile(sc, dp, a_live);
      split_trunc(dp, ds_hi, ds_lo);
      // Tile t's S, dP and dS overlap tile t - 1's dS.K on the tensor
      // cores; dS's fragments are rebuilt once that product has landed.
      for (int t = a_live + 1; t < b_live; ++t) {
        wait_full(t);
        start_s_dp(sc, dp, t);
        start_pv<D>(acc, ds_hi, ds_lo, k_tile(t - 1));
        wgmma_wait<1>();
        reg_fence(sc);
        reg_fence(dp);
        ds_tile(sc, dp, t);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(ds_hi);
        reg_fence(ds_lo);
        release(t - 1);
        split_trunc(dp, ds_hi, ds_lo);
      }
      start_pv<D>(acc, ds_hi, ds_lo, k_tile(b_live - 1));
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(ds_hi);
      reg_fence(ds_lo);
      release(b_live - 1);
    }
    for (int t = b_live; t < it.t_hi; ++t) {
      wait_full(t);
      release(t);
    }
    const long long row_stride = static_cast<long long>(heads) * D;
    __nv_bfloat16* pa = dq + (static_cast<long long>(it.b) * seq + qa) *
                                 row_stride +
                        static_cast<long long>(it.h) * D + c0;
    store_rows<D>(pa, pa + 8 * row_stride, acc, scale, qa < seq, qb < seq);
  }
}

// One dK/dV work item: 128 keys [k0, k0 + 128) of one (b, kv-head), and
// the walk over the q-tiles of 64 rows that see one of them, for each of
// the group's q-heads: tile n of the walk is q-head kh * group + n / tiles,
// q-tile qt_lo + n % tiles (causal: from the diagonal; window: below
// k0 + 127 + window).  Items are numbered key tile by key tile from the
// first, so the causal triangle's longest columns start first.
struct KvItem {
  int b, kh, k0, qt_lo, tiles, walk;
};

__device__ __forceinline__ KvItem decode_kv_item(int item, int batch,
                                                 int seq, int kv_heads,
                                                 int group, int causal,
                                                 int window) {
  KvItem it;
  const int bkv_count = batch * kv_heads;
  it.b = (item % bkv_count) / kv_heads;
  it.kh = item % kv_heads;
  it.k0 = (item / bkv_count) * kTcBQ;
  it.qt_lo = causal ? it.k0 / kTcBK : 0;
  const int q_hi = window ? min(seq, it.k0 + kTcBQ - 1 + window) : seq;
  it.tiles = (q_hi + kTcBK - 1) / kTcBK - it.qt_lo;
  it.walk = group * it.tiles;
  return it;
}

// (k) dK and dV: one block an item.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ stats,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int batch, int seq,
                    int heads, int kv_heads, int causal, int window,
                    float scale_log2, float scale) {
  using L = TcLayout<D>;
  using B = BwdLayout<D>;
  constexpr int kStages = B::kStages;
  constexpr int kSlabK = kTcBQ * L::kRowBytes;   // a slab of 128 keys
  constexpr int kSlabQ = kTcBK * L::kRowBytes;   // a slab of 64 q rows
  constexpr int kStatBytes = B::kStatBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;                     // K: [slab][128 keys][row]
  const uint32_t sv = sk + L::kQBytes;          // V, likewise
  const uint32_t ring = sv + L::kQBytes;        // stage: Q slabs, dO slabs
  const uint32_t sstat = ring + B::kRingBytes;  // [kStages][L, delta][64]
  const uint32_t kv_full = sstat + kStages * kStatBytes;
  const uint32_t full_bar = kv_full + 8;              // [kStages]
  const uint32_t empty_bar = full_bar + 8 * kStages;  // [kStages]

  const int group = heads / kv_heads;
  const KvItem it = decode_kv_item(blockIdx.x, batch, seq, kv_heads, group,
                                   causal, window);
  const long long seq_pad = padded_rows(seq);
  const long long delta_at = static_cast<long long>(batch) * heads * seq_pad;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Both roles walk the item's tiles in order, kPasses times: ring count
  // u = pass * walk + n for tile n, in stage u % kStages.
  const int wg = tid / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 128 * kConsumers) {
      mbar_expect_tx(kv_full, 2 * L::kQBytes);
#pragma unroll
      for (int hf = 0; hf < L::kHalves; ++hf) {
        tma_load(sk + hf * kSlabK, &tm_k, kv_full, L::kSlabCols * hf, it.kh,
                 it.k0, it.b);
        tma_load(sv + hf * kSlabK, &tm_v, kv_full, L::kSlabCols * hf, it.kh,
                 it.k0, it.b);
      }
      for (int u = 0; u < B::kPasses * it.walk; ++u) {
        const int n = u % it.walk;
        const int h = it.kh * group + n / it.tiles;
        const int q0 = (it.qt_lo + n % it.tiles) * kTcBK;
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(empty_bar + 8 * s, (u / kStages - 1) & 1);
        const uint32_t qs = ring + s * 2 * L::kTileBytes;
        const uint32_t dos = qs + L::kTileBytes;
        const uint32_t st = sstat + s * kStatBytes;
        const float* lrow =
            stats + (static_cast<long long>(it.b) * heads + h) * seq_pad + q0;
        mbar_expect_tx(full_bar + 8 * s, 2 * L::kTileBytes + kStatBytes);
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf) {
          tma_load(qs + hf * kSlabQ, &tm_q, full_bar + 8 * s,
                   L::kSlabCols * hf, h, q0, it.b);
          tma_load(dos + hf * kSlabQ, &tm_do, full_bar + 8 * s,
                   L::kSlabCols * hf, h, q0, it.b);
        }
        bulk_load(st, lrow, kStatBytes / 2, full_bar + 8 * s);
        bulk_load(st + kStatBytes / 2, lrow + delta_at, kStatBytes / 2,
                  full_bar + 8 * s);
      }
    }
  } else {
    // Consumer warpgroup wg: keys k0 + 64 wg .. + 63, fragment rows ka, kb.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int r0 = 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t ks = sk + wg * 64 * L::kRowBytes;
    const uint32_t vs = sv + wg * 64 * L::kRowBytes;
    const int kw0 = it.k0 + 64 * wg;
    const int ka = kw0 + r0, kb = ka + 8;
    // One walk over the item's tiles, ring counts u0 + n: dV's products
    // (dv_on), dK's (dk_on), or both.
    auto walk = [&](auto dv_on, auto dk_on, float (&acc_dv)[D / 2],
                    float (&acc_dk)[D / 2], int u0) {
      constexpr bool kDv = decltype(dv_on)::value;
      constexpr bool kDk = decltype(dk_on)::value;
      for (int n = 0; n < it.walk; ++n) {
        const int u = u0 + n;
        const int q0 = (it.qt_lo + n % it.tiles) * kTcBK;
        const int s = u % kStages;
        mbar_wait(full_bar + 8 * s, (u / kStages) & 1);
        // Skip a tile none of whose (q, key) pairs is visible to these
        // keys; mask the elements of one that straddles the diagonal, the
        // window's edge or S.
        const bool live = kw0 < seq && (!causal || q0 + kTcBK - 1 >= kw0) &&
                          (!window || q0 < kw0 + 63 + window);
        if (live) {
          const uint32_t qs = ring + s * 2 * L::kTileBytes;
          const uint32_t dos = qs + L::kTileBytes;
          const float* st = reinterpret_cast<const float*>(
              smem_raw + (sstat + s * kStatBytes - raw));
          const bool edge = (causal && q0 < kw0 + 63) ||
                            (window && q0 + kTcBK - 1 >= kw0 + window) ||
                            q0 + kTcBK > seq || kw0 + 64 > seq;
          // S^T, then P^T, which feeds dV's products while dP^T = V.dO^T
          // runs; then dS^T (from P^T's split halves, so that the float32
          // P^T is not live beside dP^T), which feeds dK's.
          float sc[kTcBK / 2], dp[kTcBK / 2];
          start_scores<D>(sc, ks, qs);     // S^T = K.Q^T
          wgmma_wait<0>();
          reg_fence(sc);
          probs_tile(
              sc,
              [&](int j) {
                const float2 l =
                    *reinterpret_cast<const float2*>(st + 8 * (j / 4) + c0);
                return (j & 1) ? l.y : l.x;
              },
              [&](int j) {
                return !edge || visible(q0 + 8 * (j / 4) + c0 + (j & 1),
                                        (j & 2) ? kb : ka, seq, causal,
                                        window);
              },
              scale_log2);
          uint32_t p_hi[kTcBK / 16][4], p_lo[kTcBK / 16][4];
          split_trunc(sc, p_hi, p_lo);
          if constexpr (kDv) start_pv<D>(acc_dv, p_hi, p_lo, dos);  // dV
          if constexpr (kDk) start_scores<D>(dp, vs, dos);  // dP^T = V.dO^T
          wgmma_wait<0>();
          reg_fence(p_hi);
          reg_fence(p_lo);
          if constexpr (kDv) reg_fence(acc_dv);
          if constexpr (kDk) {
            reg_fence(dp);
            dscores_tile(
                dp, [&](int j) { return unsplit(p_hi, p_lo, j); },
                [&](int j) {
                  const float2 d = *reinterpret_cast<const float2*>(
                      st + kTcBK + 8 * (j / 4) + c0);
                  return (j & 1) ? d.y : d.x;
                });
            uint32_t ds_hi[kTcBK / 16][4], ds_lo[kTcBK / 16][4];
            split_trunc(dp, ds_hi, ds_lo);
            start_pv<D>(acc_dk, ds_hi, ds_lo, qs);   // dK += dS^T.Q
            wgmma_wait<0>();
            reg_fence(acc_dk);
            reg_fence(ds_hi);
            reg_fence(ds_lo);
          }
        }
        mbar_arrive(empty_bar + 8 * s);
      }
    };
    const long long row_stride = static_cast<long long>(kv_heads) * D;
    const long long at = (static_cast<long long>(it.b) * seq + ka) *
                             row_stride +
                         static_cast<long long>(it.kh) * D + c0;
    mbar_wait(kv_full, 0);
    if constexpr (B::kPasses == 1) {
      float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
      walk(Flag<true>(), Flag<true>(), acc_dv, acc_dk, 0);
      store_rows<D>(dk + at, dk + at + 8 * row_stride, acc_dk, scale,
                    ka < seq, kb < seq);
      store_rows<D>(dv + at, dv + at + 8 * row_stride, acc_dv, 1.f, ka < seq,
                    kb < seq);
    } else {
      // dV on the first walk, then dK on the second, in one accumulator.
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      walk(Flag<true>(), Flag<false>(), acc, acc, 0);
      store_rows<D>(dv + at, dv + at + 8 * row_stride, acc, 1.f, ka < seq,
                    kb < seq);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      walk(Flag<false>(), Flag<true>(), acc, acc, it.walk);
      store_rows<D>(dk + at, dk + at + 8 * row_stride, acc, scale, ka < seq,
                    kb < seq);
    }
  }
}

template <int D>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const float* lse, const void* dout,
                    void* dq, void* dk, void* dv, float* stats, int batch,
                    int seq, int heads, int kv_heads, int causal, int window,
                    cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // dQ reads Q/dO in 128-row boxes and K/V in 64-key boxes; dK/dV the
  // other way round; a box is one slab of TcLayout<D>'s columns.
  constexpr int cols = TcLayout<D>::kSlabCols;
  CUtensorMap q128, do128, k64, v64, k128, v128, q64, do64;
  if (!make_map(encode, &q128, q, D, heads, seq, batch, kTcBQ, cols) ||
      !make_map(encode, &do128, dout, D, heads, seq, batch, kTcBQ, cols) ||
      !make_map(encode, &k64, k, D, kv_heads, seq, batch, kTcBK, cols) ||
      !make_map(encode, &v64, v, D, kv_heads, seq, batch, kTcBK, cols) ||
      !make_map(encode, &k128, k, D, kv_heads, seq, batch, kTcBQ, cols) ||
      !make_map(encode, &v128, v, D, kv_heads, seq, batch, kTcBQ, cols) ||
      !make_map(encode, &q64, q, D, heads, seq, batch, kTcBK, cols) ||
      !make_map(encode, &do64, dout, D, heads, seq, batch, kTcBK, cols))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kdq = flash_bwd_dq_wgmma<D>;
  auto kdkv = flash_bwd_dkv_wgmma<D>;
  constexpr int dq_bytes = BwdLayout<D>::kDqBytes;
  constexpr int dkv_bytes = BwdLayout<D>::kDkvBytes;
  cudaError_t err = check_reg_split(kdq);
  if (err == cudaSuccess) err = check_reg_split(kdkv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long dq_items =
      static_cast<long long>(batch) * heads * ((seq + kTcBQ - 1) / kTcBQ);
  if (dq_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int dkv_items = batch * kv_heads * ((seq + kTcBQ - 1) / kTcBQ);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  kdq<<<static_cast<int>(dq_items), kTcThreads, dq_bytes, stream>>>(
      q128, do128, k64, v64, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, stats,
      static_cast<__nv_bfloat16*>(dq), batch, seq, heads, kv_heads, causal,
      window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdkv<<<dkv_items, kTcThreads, dkv_bytes, stream>>>(
      k128, v128, q64, do64, stats, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), batch, seq, heads, kv_heads, causal,
      window, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, void* scratch, int batch, int seq, int heads,
               int kv_heads, int head_dim, int causal, int window, bool bf16,
               void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0)
    return static_cast<int>(cudaGetLastError());
  if (kv_heads <= 0 || heads % kv_heads != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
#define REPRO_BWD_BF16(D)                                                  \
  return launch_bwd_bf16<D>(q, k, v, o, lse, dout, dq, dk, dv,             \
                            static_cast<float*>(scratch), batch, seq, heads, \
                            kv_heads, causal, window, s)
    switch (head_dim) {
      case 64:
        REPRO_BWD_BF16(64);
      case 96:
        REPRO_BWD_BF16(96);
      case 128:
        REPRO_BWD_BF16(128);
      case 192:
        REPRO_BWD_BF16(192);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef REPRO_BWD_BF16
  }
#define REPRO_BWD(D)                                                        \
  return launch_bwd_d<float, D>(q, k, v, o, dout, dq, dk, dv, scratch,     \
                                batch, seq, heads, kv_heads, causal, window, \
                                s)
  switch (head_dim) {
    case 16:
      REPRO_BWD(16);
    case 32:
      REPRO_BWD(32);
    case 64:
      REPRO_BWD(64);
    case 96:
      REPRO_BWD(96);
    case 128:
      REPRO_BWD(128);
    case 192:
      REPRO_BWD(192);
    default:
      break;
  }
#undef REPRO_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kBf16>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int seq, int heads, int kv_heads, int head_dim,
           int causal, int window, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0)
    return static_cast<int>(cudaGetLastError());
  if (kv_heads <= 0 || heads % kv_heads != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kBf16) {
    if (head_dim == 64)
      return launch_bf16<64>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                             causal, window, s);
    if (head_dim == 96)
      return launch_bf16<96>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                             causal, window, s);
    if (head_dim == 128)
      return launch_bf16<128>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                              causal, window, s);
    if (head_dim == 192)
      return launch_bf16<192>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                              causal, window, s);
  } else {
    switch (head_dim) {
      case 16:
        return launch_f32<16>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                              causal, window, s);
      case 32:
        return launch_f32<32>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                              causal, window, s);
      case 64:
        return launch_f32<64>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                              causal, window, s);
      case 96:
        return launch_f32<96>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                              causal, window, s);
      case 128:
        return launch_f32<128>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                               causal, window, s);
      case 192:
        return launch_f32<192>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                               causal, window, s);
      default:
        break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.  lse, when not
// null, receives each row's logsumexp of the scaled scores, B x H x S
// floats (natural-log units); o is the same either way.
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int batch, int seq, int heads,
                                         int kv_heads, int head_dim,
                                         int causal, int window,
                                         void* stream) {
  return launch<false>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                       head_dim, causal, window, stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int batch, int seq, int heads,
                                          int kv_heads, int head_dim,
                                          int causal, int window,
                                          void* stream) {
  return launch<true>(q, k, v, o, lse, batch, seq, heads, kv_heads, head_dim,
                      causal, window, stream);
}

// Bytes of scratch the backward needs for these shapes: two floats a row
// of B x H x S (each row's logsumexp, then delta), the rows padded to the
// bf16 dK/dV kernel's 64-row q-tile in bfloat16.
extern "C" long long repro_flash_attention_bwd_scratch_bytes(int batch,
                                                             int seq,
                                                             int heads,
                                                             int bf16) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  return 2LL * 4 * batch * heads * (bf16 ? padded_rows(seq) : seq);
}

// The float32 backward pair (two launches on the stream), with its
// scratch; it recomputes each row's logsumexp.  Returns as above.
extern "C" int repro_flash_attention_f32_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* scratch, int batch,
    int seq, int heads, int kv_heads, int head_dim, int causal, int window,
    void* stream) {
  return launch_bwd(q, k, v, o, nullptr, dout, dq, dk, dv, scratch, batch,
                    seq, heads, kv_heads, head_dim, causal, window, false,
                    stream);
}

// The bfloat16 backward (two launches on the stream) from the forward's
// lse (B x H x S floats), with its scratch.  Returns as above.
extern "C" int repro_flash_attention_bf16_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    void* scratch, int batch, int seq, int heads, int kv_heads, int head_dim,
    int causal, int window, void* stream) {
  return launch_bwd(q, k, v, o, lse, dout, dq, dk, dv, scratch, batch, seq,
                    heads, kv_heads, head_dim, causal, window, true, stream);
}
