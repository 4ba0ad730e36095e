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
// FL LM workloads (fl-lm-12m at head_dim 64, the micro lm at 16): tensor
// cores in split TF32 (flash_fwd_tf32 here, flash_bwd_dq_tf32 and
// flash_bwd_dkv_tf32 for the backward; the section "float32: tensor cores
// in split TF32" says how).  Every float32 product is wgmma in TF32 with
// each operand split once, v = hi + lo (hi = v rounded to TF32, lo the
// exact rest), summed as hi.hi + hi.lo + lo.hi into float32.  One TF32 pass
// is 40x over FLASH_F32_TOL and 200x over the backward's float32 limit in
// tests/test_torch_attention_ssd.py's emulation; the split is as close to
// float64 as the plain float32 version.  So float32 stays the check dtype,
// and torch.backends.cuda.matmul.allow_tf32 does not govern these kernels:
// they never take one TF32 pass.  D is 16, 32, 64, 96, 128 or 192 in
// float32, 64, 96, 128 or 192 in bfloat16, in the forward and the backward
// alike.
//
// The backward pair for both dtypes is at the end of the file.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

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
// float32, the check dtype and the FL LM workloads' dtype: tensor cores in
// split TF32, two kernels in order on one stream from the forward's L, each
// block two warpgroups that share a tile's products between them (the
// section "float32: tensor cores in split TF32" below).
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

__device__ __forceinline__ bool visible(int qpos, int kpos, int seq,
                                        int causal, int window) {
  return kpos < seq && qpos < seq && (!causal || kpos <= qpos) &&
         (!window || kpos > qpos - window);
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

// ---------------------------------------------------------------------------
// float32: tensor cores in split TF32
// ---------------------------------------------------------------------------
//
// The float32 forward and backward of the function above, with the TPU
// kernel's numerics: s = (q . k) scale, masked scores NEG_INF and
// masked probabilities 0, float32 expf and row sums, acc / max(l, 1e-30),
// rows and keys at or past S masked here, the kv head read in place.
//
// Bound on the card: at long sequences the products.  At qwen3-14b's
// (4, 1024, 40/8, 128) causal the live pairs' products are 43.0 GFLOP
// forward and 107.5 backward, 86.9 and 217.1 us at the 495 TFLOP/s of TF32
// once (the split runs each three times); at the lm round's (960, 64, 4/2,
// 64) the bytes: 189.7 MB forward and 378.5 MB backward, 56.6 and 113.0 us
// at 3.35 TB/s.
//
// * The split.  wgmma reads TF32 operands from shared memory K-major only,
//   so each tile arrives raw (cp.async, the next tile's copy in flight
//   while this one's products run) and every thread of the block writes
//   its hi and lo images under the 128-byte swizzle (Img), transposed where
//   a product needs it: S = Q.K^T, dP = dO.V^T, S^T = K.Q^T and dP^T =
//   V.dO^T read K, V, Q and dO as they arrive; P.V, dS.K, dS^T.Q and P^T.dO
//   read V^T, K^T, Q^T and dO^T.  The block-resident operand of a product
//   (Q in the forward, Q and dO in dQ, K and V in dK/dV) is its A, kept
//   raw: its fragments are split in registers once for the block where
//   they fit (F32Tiles), else a few k-steps ahead of the products.
//   P and dS are A fragments split in registers, the keys of each 8
//   permuted 0 2 4 6 1 3 5 7 in the transposed images so that the
//   accumulator's columns are the fragment's k as they stand (frag_split).
//   No kernel writes split images to global memory: at the lm round's
//   S = 64 the function is bound by its bytes, which they would add to.
// * Partial sums.  The tensor cores add into a float32 accumulator without
//   rounding to nearest, so a sum that takes every k-step of a long
//   contraction, or every tile of a walk, on the tensor cores drifts: in
//   development builds that did, dK and dV, summed over every q-tile and
//   q-head of a group, missed the backward's float32 limit at every head
//   dim.  Here a few k-steps (mma_split_a, and the backward's dQ, dK and dV
//   products in mma_frag_a_partial) go into a partial of their own, which
//   is added to the running sum in float32.  The forward's O keeps its
//   online softmax's one accumulator: its limit (2e-5) is far.
// * Forward (flash_fwd_tf32): one block a (b, h, q-tile of 64 kWgs rows),
//   the last q-tiles first; each warpgroup runs its 64 rows' S, online
//   softmax and O += P.V on every live key tile.
// * Backward, from the forward's L, no atomics (each output element summed
//   by one thread of one block, so repeat calls give the same bits):
//   flash_bwd_dq_tf32, one block a (b, h, 64-row q-tile), then
//   flash_bwd_dkv_tf32, one block a (b, kv-head, 64-key tile) over the
//   group's q-heads, each with two warpgroups on the same rows: one runs
//   the score product and P, the other dP, then P and dS change hands
//   through shared memory (named barriers) and the output products are
//   shared: dQ's columns in halves; dV in one warpgroup, dK in the other.
//   The scratch is delta, B x H x S floats, written by the dQ kernel.
// * Tiles by head_dim (F32Tiles) fit shared memory: a 64-key tile beside
//   Q's raw rows, the raw tile being copied and the images; a head_dim that
//   would not fit gets a narrower tile (16 keys or q rows at 192, whose
//   transposed images take the 64-byte swizzle).

// v = hi + lo: hi = v rounded to TF32 (to nearest, ties away), lo the exact
// rest, which the tensor cores read truncated to TF32.
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// 16 (4) bytes global -> shared by cp.async, zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Plain shared-memory stores become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A float32 tile as it arrives (cp.async), row-major: rows of D floats with
// the 16-byte chunk c of row r at c ^ (r % 8) within its group of 8 (reads
// of a TF32 A fragment, eight rows at one column, then hit eight banks);
// D = 16 rows are padded to 20 floats instead.
template <int D>
struct RawTile {
  static constexpr int kLd = D >= 32 ? D : D + 4;
  static __device__ __forceinline__ int at(int r, int k) {
    if constexpr (D >= 32) {
      const int c = k >> 2;
      return r * D + (((c ^ r) & 7) | (c & ~7)) * 4 + (k & 3);
    } else {
      return r * kLd + k;
    }
  }
  static constexpr int bytes(int rows) { return rows * kLd * 4; }
};

// A wgmma operand image in shared memory, K-major: R rows (M or N) of C
// columns (K).  C a multiple of 32: slabs of 32 columns, 128-byte rows under
// the 128-byte swizzle (the 16-byte chunk c of row r at c ^ (r % 8)); C =
// 16: one slab of 64-byte rows under the 64-byte swizzle (chunk c at
// c ^ (r / 2 % 4)).  A split operand has two, hi and lo.
template <int R, int C>
struct Img {
  static_assert(R % 8 == 0 && (C == 16 || C % 32 == 0), "image shape");
  static constexpr bool kWide = C % 32 == 0;
  static constexpr int kSlab = R * (kWide ? 128 : 64);
  static constexpr int kBytes = (kWide ? C / 32 : 1) * kSlab;
  // Byte offset of the chunk holding columns 4c .. 4c + 3 of row r.
  static __device__ __forceinline__ uint32_t chunk(int r, int c) {
    if constexpr (kWide) {
      return (c >> 3) * kSlab + r * 128 + (((c ^ r) & 7) << 4);
    } else {
      return r * 64 + (((c ^ (r >> 1)) & 3) << 4);
    }
  }
  // Descriptor of k-step j (columns 8j .. 8j + 7): +32 bytes along the
  // swizzled row, 8 rows a stride.
  static __device__ __forceinline__ uint64_t desc(uint32_t base, int j) {
    if constexpr (kWide) {
      return sw128_desc(base + (j >> 2) * kSlab + (j & 3) * 32, 16, 1024);
    } else {
      const uint32_t addr = base + j * 32;
      return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
             (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
    }
  }
};

// d (64 x N, float32 fragment) = A . B (+ d if acc): A (64 x 8) a TF32
// register fragment (as mma.m16n8k8's, one warp each 16 rows: a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), lane = 4 g + t), B (8 x
// N) TF32 in shared memory, K-major (Img<N, K>).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int acc);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[24],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<192>(float (&d)[96],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

// The rows [r0, r0 + R) of one head of a (B, S, heads, D) float32 tensor
// (src: its row 0 at that (b, head); stride: heads * D) into a RawTile,
// zeros at rows past S.
template <int R, int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int r0, int seq,
                                          int tid, int nthreads) {
  for (int idx = tid; idx < R * D / 4; idx += nthreads) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    const bool ok = r0 + r < seq;
    cp_async16(dst + RawTile<D>::at(r, 4 * c),
               ok ? src + (r0 + r) * stride + 4 * c : src, ok);
  }
}

// The split images (hi, lo) of a RawTile's R rows x D columns as loaded:
// Img<R, D>, image row r = raw row r.
template <int R, int D>
__device__ __forceinline__ void image_rows(const float* raw,
                                           unsigned char* hi,
                                           unsigned char* lo, int tid,
                                           int nthreads) {
  using I = Img<R, D>;
  for (int idx = tid; idx < R * D / 4; idx += nthreads) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    const float4 v =
        *reinterpret_cast<const float4*>(raw + RawTile<D>::at(r, 4 * c));
    uint4 h, l;
    tf32_split(v.x, h.x, l.x);
    tf32_split(v.y, h.y, l.y);
    tf32_split(v.z, h.z, l.z);
    tf32_split(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + I::chunk(r, c)) = h;
    *reinterpret_cast<uint4*>(lo + I::chunk(r, c)) = l;
  }
}

// The split images of a RawTile's transpose: Img<D, R>, image row d holds
// raw column d, its columns the raw rows with each 8 permuted 0 2 4 6 1 3 5
// 7, so that column 8j + t (t + 4) of the image is row 8j + 2t (+ 1): the
// order in which a wgmma accumulator's columns become the k of a TF32 A
// fragment (P, dS, their transposes).
template <int R, int D>
__device__ __forceinline__ void image_cols(const float* raw,
                                           unsigned char* hi,
                                           unsigned char* lo, int tid,
                                           int nthreads) {
  using I = Img<D, R>;
  for (int idx = tid; idx < (R / 8) * D; idx += nthreads) {
    const int d = idx % D, j0 = 8 * (idx / D);
    uint32_t h[8], l[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      tf32_split(raw[RawTile<D>::at(j0 + e, d)], h[e], l[e]);
    const int c = j0 / 4;
    *reinterpret_cast<uint4*>(hi + I::chunk(d, c)) =
        make_uint4(h[0], h[2], h[4], h[6]);
    *reinterpret_cast<uint4*>(hi + I::chunk(d, c + 1)) =
        make_uint4(h[1], h[3], h[5], h[7]);
    *reinterpret_cast<uint4*>(lo + I::chunk(d, c)) =
        make_uint4(l[0], l[2], l[4], l[6]);
    *reinterpret_cast<uint4*>(lo + I::chunk(d, c + 1)) =
        make_uint4(l[1], l[3], l[5], l[7]);
  }
}

// This thread's TF32 A fragment of k-step j (columns 8j .. 8j + 7) of a
// RawTile's 64 rows from row rw (this warp's 16 at rw + 16 warp), split.
template <int D>
__device__ __forceinline__ void raw_frag(const float* raw, int rw, int j,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int ra = rw + 16 * warp + lane / 4, k = 8 * j + lane % 4;
  tf32_split(raw[RawTile<D>::at(ra, k)], hi[0], lo[0]);
  tf32_split(raw[RawTile<D>::at(ra + 8, k)], hi[1], lo[1]);
  tf32_split(raw[RawTile<D>::at(ra, k + 4)], hi[2], lo[2]);
  tf32_split(raw[RawTile<D>::at(ra + 8, k + 4)], hi[3], lo[3]);
}

// acc (64 x N) += A . B over KS k-steps in split TF32, B an image pair
// (ImgB) at b_hi / b_lo, each k-step hi.lo, lo.hi, hi.hi.  The k-steps go
// in groups of G, each group's products on the tensor cores into a partial
// of its own (two, in turn), which is added to acc in float32 once the
// group has landed, while the next group's products run.  A's fragments:
// with kResident, ah / al hold all KS k-steps (split once for the block);
// otherwise they are split from the RawTile's rows from rw a group ahead,
// into two sets of G in turn.  Waits for the products before it returns.
template <int N, int KS, int G, class ImgB, int D, bool kResident>
__device__ __forceinline__ void mma_split_a(
    float (&acc)[N / 2], uint32_t (&ah)[kResident ? KS : 2 * G][4],
    uint32_t (&al)[kResident ? KS : 2 * G][4], const float* raw, int rw,
    uint32_t b_hi, uint32_t b_lo) {
  constexpr int kGroups = (KS + G - 1) / G;
  float part[2][N / 2];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int buf = g & 1;
    // Slot of k-step j in ah / al.
    auto slot = [&](int j) { return kResident ? j : buf * G + j % G; };
    if constexpr (!kResident) {
#pragma unroll
      for (int j = g * G; j < g * G + G && j < KS; ++j)
        raw_frag<D>(raw, rw, j, ah[slot(j)], al[slot(j)]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = g * G; j < g * G + G && j < KS; ++j) {
      wgmma_tf32<N>(part[buf], ah[slot(j)], ImgB::desc(b_lo, j), j > g * G);
      wgmma_tf32<N>(part[buf], al[slot(j)], ImgB::desc(b_hi, j), 1);
      wgmma_tf32<N>(part[buf], ah[slot(j)], ImgB::desc(b_hi, j), 1);
    }
    wgmma_commit();
    if (g > 0) {
      wgmma_wait<1>();
      reg_fence(part[buf ^ 1]);
      if constexpr (!kResident) {
        // The last group's fragments stay in their registers until its
        // products have landed (the compiler must not reuse them sooner).
#pragma unroll
        for (int i = (buf ^ 1) * G; i < (buf ^ 1) * G + G; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            asm volatile("" : "+r"(ah[i][e]), "+r"(al[i][e])::"memory");
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] += part[buf ^ 1][i];
    }
  }
  constexpr int last = (kGroups - 1) & 1;
  wgmma_wait<0>();
  reg_fence(part[last]);
  reg_fence(ah);
  reg_fence(al);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += part[last][i];
}

// A (64 x 8 KS) as split TF32 A fragments from a (64 x 8 KS) accumulator
// fragment x: k-step j's a0..a3 are x's elements 4j, 4j + 2, 4j + 1,
// 4j + 3 (columns 8j + 2t, 2t + 1 of rows g, g + 8), which the images of
// image_cols meet with their 0 2 4 6 1 3 5 7 order.
template <int KS>
__device__ __forceinline__ void frag_split(const float (&x)[4 * KS],
                                           uint32_t (&hi)[KS][4],
                                           uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    tf32_split(x[4 * j], hi[j][0], lo[j][0]);
    tf32_split(x[4 * j + 2], hi[j][1], lo[j][1]);
    tf32_split(x[4 * j + 1], hi[j][2], lo[j][2]);
    tf32_split(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// acc (64 x N) += A . B, A split register fragments (frag_split), B an
// image pair; one wgmma group, committed, not waited for.
template <int N, int KS, class ImgB>
__device__ __forceinline__ void mma_frag_a(float (&acc)[N / 2],
                                           const uint32_t (&ah)[KS][4],
                                           const uint32_t (&al)[KS][4],
                                           uint32_t b_hi, uint32_t b_lo) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    wgmma_tf32<N>(acc, ah[j], ImgB::desc(b_lo, j), 1);
    wgmma_tf32<N>(acc, al[j], ImgB::desc(b_hi, j), 1);
    wgmma_tf32<N>(acc, ah[j], ImgB::desc(b_hi, j), 1);
  }
  wgmma_commit();
}

// acc (64 x N) += A . B as mma_frag_a, but the products go on the tensor
// cores into a partial, S k-steps at a time, each added to acc in float32
// once it has landed.  Waits for the products before it returns.
template <int N, int KS, class ImgB, int S>
__device__ __forceinline__ void mma_frag_a_partial(float (&acc)[N / 2],
                                                   uint32_t (&ah)[KS][4],
                                                   uint32_t (&al)[KS][4],
                                                   uint32_t b_hi,
                                                   uint32_t b_lo) {
#pragma unroll
  for (int j0 = 0; j0 < KS; j0 += S) {
    float part[N / 2];
    wgmma_fence();
#pragma unroll
    for (int j = j0; j < j0 + S && j < KS; ++j) {
      wgmma_tf32<N>(part, ah[j], ImgB::desc(b_lo, j), j > j0);
      wgmma_tf32<N>(part, al[j], ImgB::desc(b_hi, j), 1);
      wgmma_tf32<N>(part, ah[j], ImgB::desc(b_hi, j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(ah);
    reg_fence(al);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
  }
}

// Tile shapes by head_dim, within the 232,448 bytes of shared memory a
// block may opt into.
// * Forward: kWgs warpgroups of 64 query rows share each key tile of kBK
//   keys; kept are Q's rows (RawTile), the tile's K and V as they arrive,
//   K's image pair and V^T's.  At D = 128 a 64-key tile does not fit beside
//   128 rows of Q; at 192 a 16-key tile keeps the registers from spilling.
// * dQ: two warpgroups on one 64-row q-tile, kDqBK keys a tile; Q and dO
//   rows, the tile's K and V as they arrive, the K, V and K^T image pairs.
// * dK/dV: two warpgroups on one 64-key tile, q-tiles of kBQ rows; K and V
//   rows, the tile's Q and dO as they arrive and two slots of their L and
//   delta, the Q, dO, Q^T and dO^T image pairs (230,912 bytes at D = 128).
// * kAliasX: the backward's warpgroups hand P and dS over where an image
//   pair was that no product reads any more, which holds 64 x 64 floats from
//   D = 32; at D = 16 they get a buffer of their own.
// kG, kFwdG: the k-steps of a contraction over D that go into one partial
// (and, where A's fragments are split as they go, one group of them), in
// the backward and the forward; kOutSteps: those of one partial of the
// backward's output products.  The tensor cores cut their sums toward
// zero, so a sum's error grows with the additions made into it: summed
// straight into the running sums, dK and dV over a GQA group's q-rows miss
// the backward's float32 limit (tests/test_torch_attention_ssd.py
// emulates it).  Partials of 2 k-steps (6 tensor-core additions) hold the
// backward within 0.9e-6 of float64 at every head_dim; partials of 4
// reached 1.5e-6, as large as the plain float32 backward's own error,
// which the check against it adds to (scripts/torch_flash_f32_variants.py).
template <int D>
struct F32Tiles {
  static constexpr int kWgs = (D == 96 || D == 128) ? 2 : 1;
  static constexpr int kBK = D == 192 ? 16 : D == 128 ? 32 : 64;
  static constexpr int kDqBK = D <= 32 ? 64 : D == 192 ? 16 : 32;
  static constexpr int kBQ = D <= 64 ? 64 : D == 192 ? 16 : 32;
  static constexpr int kG = 2;
  static constexpr int kFwdG = D >= 96 ? 2 : 4;
  // Whether a backward warpgroup keeps its resident operand's fragments
  // split in registers for the whole block (D / 8 k-steps, D registers a
  // thread) instead of splitting them from its rows at every tile.
  static constexpr bool kDqResident = D <= 128;
  static constexpr bool kDkvResident = D <= 96;
  static constexpr int kOutSteps = 2;
  static constexpr bool kAliasX = D >= 32;
  static constexpr int kFwdBytes =
      1024 + RawTile<D>::bytes(64 * kWgs + 2 * kBK) +
      2 * (Img<kBK, D>::kBytes + Img<D, kBK>::kBytes);
  static constexpr int kDqBytes =
      1024 + RawTile<D>::bytes(128 + 2 * kDqBK) +
      2 * (2 * Img<kDqBK, D>::kBytes + Img<D, kDqBK>::kBytes) +
      (kAliasX ? 0 : 2 * 4 * 64 * kDqBK);
  static constexpr int kDkvBytes =
      1024 + RawTile<D>::bytes(128 + 2 * kBQ) +
      4 * (Img<kBQ, D>::kBytes + Img<D, kBQ>::kBytes) + 4 * 4 * kBQ +
      (kAliasX ? 0 : 4 * 64 * kBQ);
  static_assert(kFwdBytes <= 232448 && kDqBytes <= 232448 &&
                    kDkvBytes <= 232448,
                "over a block's shared memory");
  static_assert(!kAliasX || (2 * Img<kBQ, D>::kBytes >= 4 * 64 * kBQ &&
                             2 * Img<kDqBK, D>::kBytes >= 4 * 64 * kDqBK),
                "P and dS do not fit where an image pair was");
};

// The shared-memory base rounded up to the 1024-byte swizzle period.
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// The live tiles [a, b) of width w among [t_lo, t_hi) for the 64 rows from
// row_lo, and whether tile t needs the element mask for them: as
// live_tiles and edge_tile, for any tile width.
__device__ __forceinline__ void live_range(int row_lo, int t_lo, int t_hi,
                                           int w, int seq, int causal,
                                           int window, int& a, int& b) {
  b = row_lo >= seq ? t_lo
      : causal      ? min(t_hi, (row_lo + 63) / w + 1)
                    : t_hi;
  a = t_lo;
  while (window && a < b && a * w + w - 1 <= row_lo - window) ++a;
}
__device__ __forceinline__ bool edge_of(int t, int w, int row_lo, int seq,
                                        int causal, int window) {
  const int k0 = t * w;
  return (causal && k0 + w - 1 > row_lo) ||
         (window && k0 <= row_lo + 63 - window) || k0 + w > seq ||
         row_lo + 64 > seq;
}

// Forward: one block a (b, h, 64 kWgs-row q-tile), the last q-tiles first.
// Per key tile: the tile lands (cp.async), every thread splits it into the
// K and V^T images, then the next tile's copy starts while each warpgroup
// runs S = Q.K^T (Q's fragments split from its rows), the online softmax
// on S's fragment, and O += P.V (P split in registers).
template <int D>
__global__ void __launch_bounds__(128 * F32Tiles<D>::kWgs, 1)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int batch, int seq, int heads,
               int kv_heads, int causal, int window, float scale) {
  using T = F32Tiles<D>;
  constexpr int BK = T::kBK, RQ = 64 * T::kWgs, NT = 128 * T::kWgs;
  using KImg = Img<BK, D>;
  using VImg = Img<D, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* k_hi = smem_base(smem_raw);
  unsigned char* k_lo = k_hi + KImg::kBytes;
  unsigned char* v_hi = k_lo + KImg::kBytes;
  unsigned char* v_lo = v_hi + VImg::kBytes;
  float* qs = reinterpret_cast<float*>(v_lo + VImg::kBytes);
  float* ks = qs + RQ * RawTile<D>::kLd;
  float* vs = ks + BK * RawTile<D>::kLd;

  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int bh_count = batch * heads, q_tiles = (seq + RQ - 1) / RQ;
  const int bh = blockIdx.x % bh_count;
  const int b = bh / heads, h = bh % heads, kh = h / (heads / kv_heads);
  const int q0 = (q_tiles - 1 - blockIdx.x / bh_count) * RQ;
  const int k_first = window ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(seq, q0 + RQ) : seq;
  const int t_lo = k_first / BK, t_hi = (k_end + BK - 1) / BK;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const float* kb = k + (static_cast<long long>(b) * seq * kv_heads + kh) * D;
  const float* vb = v + (static_cast<long long>(b) * seq * kv_heads + kh) * D;

  load_rows<RQ, D>(qs, q + (static_cast<long long>(b) * seq * heads + h) * D,
                   q_row, q0, seq, tid, NT);
  load_rows<BK, D>(ks, kb, k_row, t_lo * BK, seq, tid, NT);
  load_rows<BK, D>(vs, vb, k_row, t_lo * BK, seq, tid, NT);
  cp_async_commit();

  const int row_lo = q0 + 64 * wg;
  const int qa = row_lo + 16 * warp + lane / 4, qb = qa + 8;
  const int c0 = 2 * (lane % 4);
  int a_live, b_live;
  live_range(row_lo, t_lo, t_hi, BK, seq, causal, window, a_live, b_live);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t has landed; tile t - 1's products are done
    image_rows<BK, D>(ks, k_hi, k_lo, tid, NT);
    image_cols<BK, D>(vs, v_hi, v_lo, tid, NT);
    fence_proxy_async();
    __syncthreads();   // the images are written; ks and vs are free
    if (t + 1 < t_hi) {
      load_rows<BK, D>(ks, kb, k_row, (t + 1) * BK, seq, tid, NT);
      load_rows<BK, D>(vs, vb, k_row, (t + 1) * BK, seq, tid, NT);
    }
    cp_async_commit();
    if (t < a_live || t >= b_live) continue;
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    uint32_t q_hi[2 * T::kFwdG][4], q_lo[2 * T::kFwdG][4];
    mma_split_a<BK, D / 8, T::kFwdG, KImg, D, false>(
        sc, q_hi, q_lo, qs, 64 * wg, smem_addr(k_hi), smem_addr(k_lo));
    // The online softmax, in natural units: s = (q.k) scale, masked scores
    // NEG_INF, p = exp(s - m) (0 where masked), l the thread's share of
    // the denominator.  Element j: row (j & 2) ? qb : qa, key
    // t BK + 8 (j / 4) + c0 + (j & 1).
    const bool edge = edge_of(t, BK, row_lo, seq, causal, window);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      sc[j] *= scale;
      if (edge && !visible((j & 2) ? qb : qa, t * BK + 8 * (j / 4) + c0 +
                                                  (j & 1),
                           seq, causal, window))
        sc[j] = kNegInf;
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        if (((j >> 1) & 1) == r) mx = fmaxf(mx, sc[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = expf(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int r = (j >> 1) & 1;
      const float p = sc[j] == kNegInf ? 0.f : expf(sc[j] - m[r]);
      sc[j] = p;
      l[r] += p;
    }
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
    frag_split<BK / 8>(sc, p_hi, p_lo);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    mma_frag_a<D, BK / 8, VImg>(acc, p_hi, p_lo, smem_addr(v_hi),
                                smem_addr(v_lo));
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(p_hi);
    reg_fence(p_lo);
  }

  // Epilogue: the row's denominator over its four threads, acc / max(l,
  // 1e-30), and with lse the row's logsumexp m + log l.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (lse != nullptr && c0 == 0) {
    float* lrow = lse + static_cast<long long>(bh) * seq;
    if (qa < seq) lrow[qa] = m[0] + logf(l[0]);
    if (qb < seq) lrow[qb] = m[1] + logf(l[1]);
  }
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  float* oa = o + (static_cast<long long>(b) * seq + qa) * q_row +
              static_cast<long long>(h) * D + c0;
  float* ob = oa + 8 * q_row;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (qa < seq)
      *reinterpret_cast<float2*>(oa + 8 * i) =
          make_float2(acc[4 * i] * inv[0], acc[4 * i + 1] * inv[0]);
    if (qb < seq)
      *reinterpret_cast<float2*>(ob + 8 * i) =
          make_float2(acc[4 * i + 2] * inv[1], acc[4 * i + 3] * inv[1]);
  }
}

// Rows qa and qb (qb = qa + 8) of a (64 x N) float32 fragment, times
// scale, at pa and pb (each the row's column c0); a row flagged off is not
// written.
template <int N>
__device__ __forceinline__ void store_rows_f32(float* pa, float* pb,
                                               const float (&acc)[N / 2],
                                               float scale, bool a_ok,
                                               bool b_ok) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    if (a_ok)
      *reinterpret_cast<float2*>(pa + 8 * i) =
          make_float2(acc[4 * i] * scale, acc[4 * i + 1] * scale);
    if (b_ok)
      *reinterpret_cast<float2*>(pb + 8 * i) =
          make_float2(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
  }
}

// Named barriers between the backward's two warpgroups (barrier 0 is
// __syncthreads): one warpgroup arrives when what it wrote is ready, the
// other waits for it.
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// A (64 x N) fragment handed from a thread of one warpgroup to the thread
// of the same rank in the other, through shared memory: float4 chunk c of
// thread t at [c][t], so that a warp's stores and loads are contiguous.
template <int N>
__device__ __forceinline__ void put_frag(float* buf, const float (&x)[N / 2],
                                         int t) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
    reinterpret_cast<float4*>(buf)[c * 128 + t] =
        make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
}
template <int N>
__device__ __forceinline__ void get_frag(const float* buf, float (&x)[N / 2],
                                         int t) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    const float4 v = reinterpret_cast<const float4*>(buf)[c * 128 + t];
    x[4 * c] = v.x;
    x[4 * c + 1] = v.y;
    x[4 * c + 2] = v.z;
    x[4 * c + 3] = v.w;
  }
}

// (q) dQ: one block a (b, h, 64-row q-tile), the last q-tiles first, two
// warpgroups on the same rows.  Warpgroup 1 forms delta = rowsum(dO o O)
// of the rows into the scratch for the dK/dV kernel; warpgroup 0 reads L
// from the forward's lse.  Per live key tile: all 256 threads split the
// tile into the K, V and K^T images; then warpgroup 0 runs S = Q.K^T (Q's
// fragments split from its rows) and P = exp(s scale - L) while
// warpgroup 1 runs dP = dO.V^T; warpgroup 1 takes P (through shared
// memory, where K's image was), forms dS = P (dP - delta) and hands it
// back (where V's image was); each warpgroup then adds dS.K to its half of
// dQ's columns.
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  float* __restrict__ dq, int batch, int seq, int heads,
                  int kv_heads, int causal, int window, float scale) {
  using T = F32Tiles<D>;
  constexpr int BK = T::kDqBK;
  using KImg = Img<BK, D>;
  using KtImg = Img<D, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* k_hi = smem_base(smem_raw);
  unsigned char* k_lo = k_hi + KImg::kBytes;
  unsigned char* v_hi = k_lo + KImg::kBytes;
  unsigned char* v_lo = v_hi + KImg::kBytes;
  unsigned char* kt_hi = v_lo + KImg::kBytes;
  unsigned char* kt_lo = kt_hi + KtImg::kBytes;
  float* qs = reinterpret_cast<float*>(kt_lo + KtImg::kBytes);
  float* dos = qs + 64 * RawTile<D>::kLd;
  float* ks = dos + 64 * RawTile<D>::kLd;
  float* vs = ks + BK * RawTile<D>::kLd;
  // P where K's image was, dS where V's was (each free once the product
  // that reads it has landed), or after the raw tiles where an image pair
  // is smaller than 64 x BK floats (D = 16).
  float* x_p = T::kAliasX ? reinterpret_cast<float*>(k_hi)
                          : vs + BK * RawTile<D>::kLd;
  float* x_ds = T::kAliasX ? reinterpret_cast<float*>(v_hi) : x_p + 64 * BK;

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int bh_count = batch * heads, q_tiles = (seq + 63) / 64;
  const int bh = blockIdx.x % bh_count;
  const int b = bh / heads, h = bh % heads, kh = h / (heads / kv_heads);
  const int q0 = (q_tiles - 1 - blockIdx.x / bh_count) * 64;
  const int k_first = window ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(seq, q0 + 64) : seq;
  int a_live, b_live;
  live_range(q0, k_first / BK, (k_end + BK - 1) / BK, BK, seq, causal,
             window, a_live, b_live);
  const long long q_row = static_cast<long long>(heads) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long q_base = (static_cast<long long>(b) * seq * heads + h) * D;
  const float* kb = k + (static_cast<long long>(b) * seq * kv_heads + kh) * D;
  const float* vb = v + (static_cast<long long>(b) * seq * kv_heads + kh) * D;

  load_rows<64, D>(qs, q + q_base, q_row, q0, seq, tid, 256);
  load_rows<64, D>(dos, dout + q_base, q_row, q0, seq, tid, 256);
  if (a_live < b_live) {
    load_rows<BK, D>(ks, kb, k_row, a_live * BK, seq, tid, 256);
    load_rows<BK, D>(vs, vb, k_row, a_live * BK, seq, tid, 256);
  }
  cp_async_commit();

  // This thread's fragment rows qa and qb: L (warpgroup 0), or delta over
  // the row's four threads (float4 column groups lane % 4, + 4, ...),
  // written for the dK/dV kernel (warpgroup 1).  Rows past S: neither is
  // read.
  const int qa = q0 + 16 * warp + lane / 4, qb = qa + 8;
  const int c0 = 2 * (lane % 4);
  float stat[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? qb : qa;
    if (wg == 0) {
      stat[r] = row < seq ? lse[static_cast<long long>(bh) * seq + row] : 0.f;
      continue;
    }
    float d = 0.f;
    if (row < seq) {
      const long long at = q_base + row * q_row;
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const int col = 4 * (lane % 4 + 4 * i);
        const float4 x = __ldg(reinterpret_cast<const float4*>(o + at + col));
        const float4 y =
            __ldg(reinterpret_cast<const float4*>(dout + at + col));
        d = fmaf(x.x, y.x, d);
        d = fmaf(x.y, y.y, d);
        d = fmaf(x.z, y.z, d);
        d = fmaf(x.w, y.w, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    stat[r] = d;
    if (lane % 4 == 0 && row < seq)
      delta[static_cast<long long>(bh) * seq + row] = d;
  }

  float acc[D / 4];   // this warpgroup's half of dQ's columns
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  // Q's (warpgroup 0) or dO's (warpgroup 1) fragments: all D / 8 k-steps
  // split once where they fit the registers, else two groups streamed.
  constexpr int kSlots = T::kDqResident ? D / 8 : 2 * T::kG;
  uint32_t a_hi[kSlots][4], a_lo[kSlots][4];
  for (int tile = a_live; tile < b_live; ++tile) {
    cp_async_wait_all();
    __syncthreads();   // the tile has landed; the last one's products are done
    image_rows<BK, D>(ks, k_hi, k_lo, tid, 256);
    image_rows<BK, D>(vs, v_hi, v_lo, tid, 256);
    image_cols<BK, D>(ks, kt_hi, kt_lo, tid, 256);
    fence_proxy_async();
    __syncthreads();   // the images are written; ks and vs are free
    if (tile + 1 < b_live) {
      load_rows<BK, D>(ks, kb, k_row, (tile + 1) * BK, seq, tid, 256);
      load_rows<BK, D>(vs, vb, k_row, (tile + 1) * BK, seq, tid, 256);
    }
    cp_async_commit();
    // Warpgroup 0: S = Q.K^T; warpgroup 1: dP = dO.V^T.
    if constexpr (T::kDqResident) {
      if (tile == a_live) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          raw_frag<D>(wg == 0 ? qs : dos, 0, j, a_hi[j], a_lo[j]);
      }
    }
    float x[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) x[i] = 0.f;
    mma_split_a<BK, D / 8, T::kG, KImg, D, T::kDqResident>(
        x, a_hi, a_lo, wg == 0 ? qs : dos, 0,
        smem_addr(wg == 0 ? k_hi : v_hi), smem_addr(wg == 0 ? k_lo : v_lo));
    if (wg == 0) {
      const bool edge = edge_of(tile, BK, q0, seq, causal, window);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {   // element j: row (j & 2) ? qb : qa
        const bool ok = !edge || visible((j & 2) ? qb : qa,
                                         tile * BK + 8 * (j / 4) + c0 +
                                             (j & 1),
                                         seq, causal, window);
        x[j] = ok ? expf(x[j] * scale - stat[(j >> 1) & 1]) : 0.f;
      }
      put_frag<BK>(x_p, x, t);
      bar_arrive(1);
      bar_wait(2);
      get_frag<BK>(x_ds, x, t);
    } else {
      float p[BK / 2];
      bar_wait(1);
      get_frag<BK>(x_p, p, t);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        x[j] = p[j] * (x[j] - stat[(j >> 1) & 1]);
      put_frag<BK>(x_ds, x, t);
      bar_arrive(2);
    }
    uint32_t ds_hi[BK / 8][4], ds_lo[BK / 8][4];
    frag_split<BK / 8>(x, ds_hi, ds_lo);
    const uint32_t half = wg * (D / 2) * (KtImg::kWide ? 128 : 64);
    mma_frag_a_partial<D / 2, BK / 8, KtImg, T::kOutSteps>(
        acc, ds_hi, ds_lo, smem_addr(kt_hi) + half, smem_addr(kt_lo) + half);
  }
  float* pa = dq + q_base + qa * q_row + wg * (D / 2) + c0;
  store_rows_f32<D / 2>(pa, pa + 8 * q_row, acc, scale, qa < seq, qb < seq);
}

// (k) dK and dV: one block a (b, kv-head, 64-key tile), the first key tiles
// first, two warpgroups on the same keys.  K and V stay; the block walks
// the q-tiles of kBQ rows that see one of its keys (causal: from the
// diagonal; window: below k0 + 63 + window), for each q-head of the group
// in turn.  Per tile: its Q and dO land with their L and delta, all 256
// threads split them into the Q, dO, Q^T and dO^T images; then warpgroup 0
// runs S^T = K.Q^T (K's fragments split from its rows) and P^T while
// warpgroup 1 runs dP^T = V.dO^T; warpgroup 0 hands P^T to warpgroup 1
// through shared memory (where Q's image was) and adds P^T.dO to dV, while
// warpgroup 1 forms dS^T = P^T (dP^T - delta) and adds dS^T.Q to dK.
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int batch, int seq, int heads,
                   int kv_heads, int causal, int window, float scale) {
  using T = F32Tiles<D>;
  constexpr int BQ = T::kBQ;
  using QImg = Img<BQ, D>;
  using QtImg = Img<D, BQ>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* q_hi = smem_base(smem_raw);
  unsigned char* q_lo = q_hi + QImg::kBytes;
  unsigned char* do_hi = q_lo + QImg::kBytes;
  unsigned char* do_lo = do_hi + QImg::kBytes;
  unsigned char* qt_hi = do_lo + QImg::kBytes;
  unsigned char* qt_lo = qt_hi + QtImg::kBytes;
  unsigned char* dot_hi = qt_lo + QtImg::kBytes;
  unsigned char* dot_lo = dot_hi + QtImg::kBytes;
  float* ks = reinterpret_cast<float*>(dot_lo + QtImg::kBytes);
  float* vs = ks + 64 * RawTile<D>::kLd;
  float* qs = vs + 64 * RawTile<D>::kLd;
  float* dos = qs + BQ * RawTile<D>::kLd;
  // L and delta of the tile's rows, two slots (tile n in slot n % 2), so
  // that the next tile's copy does not overwrite the ones being read.
  float* stat_s = dos + BQ * RawTile<D>::kLd;   // [2][L, delta][BQ]
  // P^T where Q's image was (free once S^T has landed), or after the
  // statistics where that image is smaller than 64 x BQ floats (D = 16).
  float* x_p = T::kAliasX ? reinterpret_cast<float*>(q_hi) : stat_s + 4 * BQ;

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int group = heads / kv_heads, bkv_count = batch * kv_heads;
  const int b = (blockIdx.x % bkv_count) / kv_heads;
  const int kh = blockIdx.x % kv_heads;
  const int k0 = (blockIdx.x / bkv_count) * 64;
  const int qt_first = causal ? k0 / BQ : 0;
  const int q_end = window ? min(seq, k0 + 63 + window) : seq;
  const int tiles = (q_end + BQ - 1) / BQ - qt_first;
  const int walk = group * tiles;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long k_base =
      (static_cast<long long>(b) * seq * kv_heads + kh) * D;

  // Tile n: q-head kh * group + n / tiles, rows from q0_of(n).
  auto q0_of = [&](int n) { return (qt_first + n % tiles) * BQ; };
  auto load_tile = [&](int n) {
    const int h = kh * group + n / tiles, q0 = q0_of(n);
    const long long q_base =
        (static_cast<long long>(b) * seq * heads + h) * D;
    load_rows<BQ, D>(qs, q + q_base, q_row, q0, seq, tid, 256);
    load_rows<BQ, D>(dos, dout + q_base, q_row, q0, seq, tid, 256);
    const long long stat = (static_cast<long long>(b) * heads + h) * seq;
    float* st = stat_s + (n & 1) * 2 * BQ;
    for (int i = tid; i < BQ; i += 256) {
      const bool ok = q0 + i < seq;
      cp_async4(st + i, ok ? lse + stat + q0 + i : lse, ok);
      cp_async4(st + BQ + i, ok ? delta + stat + q0 + i : delta, ok);
    }
  };
  load_rows<64, D>(ks, k + k_base, k_row, k0, seq, tid, 256);
  load_rows<64, D>(vs, v + k_base, k_row, k0, seq, tid, 256);
  load_tile(0);
  cp_async_commit();

  const int ka = k0 + 16 * warp + lane / 4, kb = ka + 8;  // fragment rows
  const int c0 = 2 * (lane % 4);
  float acc[D / 2];   // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // K's (warpgroup 0) or V's (warpgroup 1) fragments: all D / 8 k-steps
  // split once where they fit the registers, else two groups streamed.
  constexpr int kSlots = T::kDkvResident ? D / 8 : 2 * T::kG;
  uint32_t a_hi[kSlots][4], a_lo[kSlots][4];
  if constexpr (T::kDkvResident) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      raw_frag<D>(wg == 0 ? ks : vs, 0, j, a_hi[j], a_lo[j]);
  }
  for (int n = 0; n < walk; ++n) {
    const int q0 = q0_of(n);
    cp_async_wait_all();
    __syncthreads();   // tile n has landed; tile n - 1's products are done
    image_rows<BQ, D>(qs, q_hi, q_lo, tid, 256);
    image_rows<BQ, D>(dos, do_hi, do_lo, tid, 256);
    image_cols<BQ, D>(qs, qt_hi, qt_lo, tid, 256);
    image_cols<BQ, D>(dos, dot_hi, dot_lo, tid, 256);
    fence_proxy_async();
    __syncthreads();   // the images are written; qs and dos are free
    if (n + 1 < walk) load_tile(n + 1);
    cp_async_commit();
    const float* lt = stat_s + (n & 1) * 2 * BQ;   // L, then delta
    // Warpgroup 0: S^T = K.Q^T; warpgroup 1: dP^T = V.dO^T.
    float x[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) x[j] = 0.f;
    mma_split_a<BQ, D / 8, T::kG, QImg, D, T::kDkvResident>(
        x, a_hi, a_lo, wg == 0 ? ks : vs, 0,
        smem_addr(wg == 0 ? q_hi : do_hi), smem_addr(wg == 0 ? q_lo : do_lo));
    if (wg == 0) {
      // Whether a (q, key) pair of the tile is hidden: past the diagonal,
      // before the window, or past S.
      const bool edge = (causal && q0 < k0 + 63) ||
                        (window && q0 + BQ - 1 >= k0 + window) ||
                        q0 + BQ > seq || k0 + 64 > seq;
      // P^T = exp(s scale - L).  Element j: key row (j & 2) ? kb : ka, q
      // column q0 + 8 (j / 4) + c0 + (j & 1).
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int i = 8 * (j / 4) + c0 + (j & 1);
        const bool ok = !edge || visible(q0 + i, (j & 2) ? kb : ka, seq,
                                         causal, window);
        x[j] = ok ? expf(x[j] * scale - lt[i]) : 0.f;
      }
      put_frag<BQ>(x_p, x, t);
      bar_arrive(1);
    } else {
      // dS^T = P^T (dP^T - delta).
      float p[BQ / 2];
      bar_wait(1);
      get_frag<BQ>(x_p, p, t);
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j)
        x[j] = p[j] * (x[j] - lt[BQ + 8 * (j / 4) + c0 + (j & 1)]);
    }
    // dV += P^T.dO (warpgroup 0), dK += dS^T.Q (warpgroup 1).
    uint32_t x_hi[BQ / 8][4], x_lo[BQ / 8][4];
    frag_split<BQ / 8>(x, x_hi, x_lo);
    mma_frag_a_partial<D, BQ / 8, QtImg, T::kOutSteps>(
        acc, x_hi, x_lo, smem_addr(wg == 0 ? dot_hi : qt_hi),
        smem_addr(wg == 0 ? dot_lo : qt_lo));
  }
  float* pa = (wg == 0 ? dv : dk) + k_base + ka * k_row + c0;
  store_rows_f32<D>(pa, pa + 8 * k_row, acc, wg == 0 ? 1.f : scale,
                    ka < seq, kb < seq);
}

// The float32 forward: one launch.
template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int seq, int heads, int kv_heads,
                   int causal, int window, cudaStream_t stream) {
  using T = F32Tiles<D>;
  auto kern = flash_fwd_tf32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kFwdBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = 64 * T::kWgs;
  const long long blocks =
      static_cast<long long>(batch) * heads * ((seq + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<int>(blocks), 128 * T::kWgs, T::kFwdBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, batch, seq,
      heads, kv_heads, causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// The float32 backward: dQ (which writes delta to the scratch), then dK/dV,
// in order on the stream.
template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* delta, int batch,
                   int seq, int heads, int kv_heads, int causal, int window,
                   cudaStream_t stream) {
  using T = F32Tiles<D>;
  auto kdq = flash_bwd_dq_tf32<D>;
  auto kdkv = flash_bwd_dkv_tf32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kDqBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kDkvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (seq + 63) / 64;
  const long long dq_blocks = static_cast<long long>(batch) * heads * tiles;
  const long long dkv_blocks =
      static_cast<long long>(batch) * kv_heads * tiles;
  if (dq_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  kdq<<<static_cast<int>(dq_blocks), 256, T::kDqBytes, stream>>>(
      tq, tk, tv, static_cast<const float*>(o), tdo, lse, delta,
      static_cast<float*>(dq), batch, seq, heads, kv_heads, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdkv<<<static_cast<int>(dkv_blocks), 256, T::kDkvBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), batch, seq, heads, kv_heads, causal, window,
      scale);
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
#define REPRO_BWD_F32(D)                                                   \
  return launch_bwd_f32<D>(q, k, v, o, lse, dout, dq, dk, dv,              \
                           static_cast<float*>(scratch), batch, seq, heads, \
                           kv_heads, causal, window, s)
  switch (head_dim) {
    case 16:
      REPRO_BWD_F32(16);
    case 32:
      REPRO_BWD_F32(32);
    case 64:
      REPRO_BWD_F32(64);
    case 96:
      REPRO_BWD_F32(96);
    case 128:
      REPRO_BWD_F32(128);
    case 192:
      REPRO_BWD_F32(192);
    default:
      break;
  }
#undef REPRO_BWD_F32
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
#define REPRO_FWD_F32(D)                                                   \
  return launch_fwd_f32<D>(q, k, v, o, lse, batch, seq, heads, kv_heads,  \
                           causal, window, s)
    switch (head_dim) {
      case 16:
        REPRO_FWD_F32(16);
      case 32:
        REPRO_FWD_F32(32);
      case 64:
        REPRO_FWD_F32(64);
      case 96:
        REPRO_FWD_F32(96);
      case 128:
        REPRO_FWD_F32(128);
      case 192:
        REPRO_FWD_F32(192);
      default:
        break;
    }
#undef REPRO_FWD_F32
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

// Bytes of scratch the backward needs for these shapes: bfloat16, two
// floats a row of B x H x S (each row's logsumexp in log2 units, then
// delta), the rows padded to the dK/dV kernel's 64-row q-tile; float32, one
// (delta).
extern "C" long long repro_flash_attention_bwd_scratch_bytes(int batch,
                                                             int seq,
                                                             int heads,
                                                             int bf16) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  return bf16 ? 2LL * 4 * batch * heads * padded_rows(seq)
              : 4LL * batch * heads * seq;
}

// The float32 backward (two launches on the stream) from the forward's lse
// (B x H x S floats), with its scratch.  Returns as above.
extern "C" int repro_flash_attention_f32_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    void* scratch, int batch, int seq, int heads, int kv_heads, int head_dim,
    int causal, int window, void* stream) {
  return launch_bwd(q, k, v, o, lse, dout, dq, dk, dv, scratch, batch, seq,
                    heads, kv_heads, head_dim, causal, window, false, stream);
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
