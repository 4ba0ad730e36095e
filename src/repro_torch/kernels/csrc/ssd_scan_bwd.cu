// The gradients of the Mamba2 SSD scan (csrc/ssd_scan.cu) on Hopper: given
// x (batch, S, H, P), dt (batch, S, H), A read at A[b * a_stride + h],
// B/C (batch, S, G, N) read for group g = h / (H / G), and the gradients gy
// (batch, S, H, P) of y and gfin (batch, H, P, N) of the final state, all
// float32, it writes dx, ddt, dA (batch, H), dB and dC, the gradients of
//   S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (outer) B_t,   S_0 = 0,
//   y_t = S_t . C_t.
//
// Replaces no TPU kernel.  The reference trains by differentiating its XLA
// chunked form (src/repro/models/layers.py:_ssd_chunked) under jax.grad; the
// TPU kernel (src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan) has no
// backward.  The port's plain backward, the vjp of ref.ssd_chunked_ref,
// serves the CPU and the tests.
//
// Bound on the card: bytes.  At mamba2-1.3b's training shape (batch 4,
// S 1024, H 64, P 64, N 128, G 1) the function reads x, gy, dt, B, C, gfin
// and writes dx, ddt, dA, dB, dC once: 220 MB, 65.8 us at 3.35 TB/s.  The
// chunked form's backward products, done once at the model's chunk of 128,
// are 30.5 GFLOP (61.6 us at the 495 TFLOP/s of TF32).
//
// The arithmetic, per chunk of Q steps, with cum the inclusive sum of
// dA = dt.A inside the chunk, L[t,s] = e^(sum over (s, t] of dA) for s <= t
// and 0 above, w_s = e^(sum over (s, Q) of dA) dt_s, dec = e^(sum of the
// chunk's dA), CB = C.B^T, S_in the state entering the chunk and G the
// gradient of the state leaving it:
//   dx     = (CB o L o dt)^T . gy + diag(w) . B . G^T
//   dS_h   = (gy . X^T) o L o dt
//   dC     = (sum_h dS_h) . B + sum_h diag(e^cum_h) . (gy_h . S_in,h)
//   dB     = (sum_h dS_h)^T . C + sum_h diag(w_h) . (X_h . G_h)
//   G_prev = dec . G + (gy o e^cum)^T . C,   S_out = dec . S_in + (X o w)^T . B
// and the decay gradients d(dA_r) summed directly over the pairs that hold
// dA_r (no difference of row and column sums):
//   d(dA_r) = sum_{t>=r, s<r} dS o CB + sum_{t>=r} F_t + dec <G, S_in>
//             + sum_{s<r} dt_s K'_s,
//   F_t = e^cum_t C_t . (gy . S_in)_t,   K'_s = e^(sum over (s, Q)) B_s . (X . G)_s,
//   ddt_r   = A d(dA_r) + sum_t (gy . X^T o L o CB)[t, r] + K'_r,
//   dA      = sum over the sequence of dt_r d(dA_r).
// * Exponents as the forward takes them: each a sum of terms of one sign
//   over its own steps, never a difference of two running sums (which
//   cancels when the decay is strong).
// * Products: wgmma in TF32 on the tensor cores, float32 accumulators, each
//   operand split once into hi = tf32(v) and lo = v - hi and summed as
//   hi.lo + lo.hi + hi.hi: one TF32 pass misses float32 by 1e3x
//   (tests/test_torch_attention_ssd.py emulates both).
// * Six kernels a call, no float atomics: two calls on the same inputs give
//   the same bits.
//   - ssd_bwd_prep_kernel, once per (b, 64-step chunk, group): C.B^T (64 x
//     64, mma.sync in split TF32) and B^T, C^T and B (columns permuted)
//     split into hi and lo in wgmma's K-major swizzled layout, for both of
//     the chunk's 32-step halves, to scratch.  Every head of the group reads
//     them from L2: no product splits a shared operand again.  Its other
//     blocks write each (b, head, chunk)'s decay record (dt, e^cum, e^rest,
//     w and the exponentials that make up L), a warp each.
//   - ssd_bwd_walk_kernel<.., false> walks the 32-step chunks of HPB heads
//     and 64 state rows forwards, the state a warpgroup's wgmma accumulator
//     in registers (as the forward kernel keeps it), and writes the state
//     entering every 64-step chunk to scratch.
//   - ssd_bwd_walk_kernel<.., true> walks them backwards from gfin, the
//     gradient G in registers: the forward kernel transposed (gy for x, C
//     for B, B for C, e^cum and w swapped), it writes dx whole and G at
//     every 64-step boundary.  Both walks prefetch the next chunk into the
//     other half of a double buffer while the current one computes.
//   - ssd_bwd_group_kernel, once per (b, 64-step chunk, group, share of the
//     group's heads), two warpgroups, one block a multiprocessor: a thread
//     block cluster shares the group's heads; a block takes its heads in
//     order, 32 rows of P at a time, splits x, gy, S_in and G once into
//     swizzled hi/lo planes (the next share in flight by cp.async), and runs
//     gy.X^T, gy.S_in and X.G on wgmma with both operands in shared memory.
//     dC and dB sum the heads in registers, in order; (sum_h dS_h) . B and
//     its C twin run once at the end; the blocks of the cluster then add
//     their sums in rank order through distributed shared memory.  A head's
//     Q x Q terms (L, dS, the decay gradients' pair sums) run from shared
//     memory, a row to four threads.
//   - ssd_bwd_ddt_kernel turns each (b, head, chunk)'s sums into ddt and the
//     chunk's dA share, a warp each; ssd_bwd_da_kernel sums the shares over
//     the chunks in order.
//   The scratch, allocated by the wrapper for the call, is the prep's images,
//   the states S_in and G at the 64-step boundaries and the heads' records
//   (308.6 MB at mamba2-1.3b's shape, 268 MB of it the states).
// * Padding: N padded to 16, 32, 64 or 128 columns with zeros, P to a
//   multiple of 32 in the boundary states and cut into slabs of 64 rows in
//   the walks; steps past S load as dt = 0 and x = B = C = gy = 0, which
//   contribute nothing, and are not written.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int QW = 32;          // steps a chunk of the two walks
constexpr int QP = 2 * QW;      // steps a chunk of the head-summed pass
constexpr int LDM = QW + 4;     // row stride of a walk chunk's C.B^T block
constexpr unsigned FULL = 0xffffffffu;

// Row strides that make the fragment loads free of bank conflicts.
__host__ __device__ constexpr int pad8(int n) { return n + ((8 - n) % 32 + 32) % 32; }
__host__ __device__ constexpr int pad4(int n) { return n + ((4 - n) % 32 + 32) % 32; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read,
// but must be a valid address).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !ok.
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory written by the threads (or by cp.async) is read by wgmma.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// v = hi + lo with hi = v rounded to TF32 (to nearest, ties away) and lo the
// exact rest, which the tensor cores read to TF32 by dropping its low bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(v - __uint_as_float(h));
}

// v -> (hi, lo) of four floats, stored as two float4.
__device__ __forceinline__ void split4(const float (&v)[4], void* hi, void* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], h[i], l[i]);
  *static_cast<float4*>(hi) = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                          __uint_as_float(h[2]), __uint_as_float(h[3]));
  *static_cast<float4*>(lo) = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                          __uint_as_float(l[2]), __uint_as_float(l[3]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[u] += a . b[u] for T tiles in split TF32 (mma.m16n8k8, lane = 4 gq + tq:
// A a0 (gq, tq), a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8, tq + 4);
// B b0 (tq, gq), b1 (tq + 4, gq); D d0 (gq, 2tq), d1 (gq, 2tq + 1),
// d2 (gq + 8, 2tq), d3 (gq + 8, 2tq + 1)).
template <int T>
__device__ __forceinline__ void mma3(float (&d)[T][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[T][2],
                                     const uint32_t (&bl)[T][2]) {
#pragma unroll
  for (int u = 0; u < T; ++u) mma(d[u], ah, bl[u][0], bl[u][1]);
#pragma unroll
  for (int u = 0; u < T; ++u) mma(d[u], al, bh[u][0], bh[u][1]);
#pragma unroll
  for (int u = 0; u < T; ++u) mma(d[u], ah, bh[u][0], bh[u][1]);
}

// wgmma's shared operands are K-major with the 128-byte swizzle: rows of 32
// floats (128 bytes), 8-row groups 1024 bytes apart, the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8); a k-step of 8 floats moves the start
// address 32 bytes along the row.  A K of 64 is two such planes.  sw128 is
// the byte offset of (row r, column k < 32) in a plane.
__host__ __device__ constexpr int sw128(int r, int k) {
  return r * 128 + (((k >> 2) ^ (r & 7)) << 4) + ((k & 3) << 2);
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t addr = smem_u32(p);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching wgmma's registers across its async
// window: each use after the wait depends on this, and each register stays
// live until it.
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

// d (64 x N, float32 fragment) += A . B in TF32, B (8 x N) in shared memory
// (descriptor db); A (64 x 8) either a register fragment (wgmma_rs, as
// mma.m16n8k8's, one warp each 16 rows) or in shared memory (wgmma_ss,
// descriptor da).  The accumulator's register 4j + 2 half + e is row
// 16 warp + gq + 8 half, column 8j + 2 tq + e.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

int padded_n(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128; }

// A head's decay record for one 64-step chunk, in floats: dt, e^cum,
// e^rest, w, then the exponentials of the one-signed sums that make up
// L[t][s] = e^(sum over (s, t] of dA): over [8 (t / 8), t] (the start of t's
// block), over (s, 8 (s / 8) + 7] (the rest of s's block), over the 8-step
// blocks strictly between blocks i and j (8 x 8), and over (t - d, t] inside
// t's block (by d = 1..7, then t); the chunk's decay and A.
constexpr int DREC = 964;
constexpr int kDdt = 0, kDecum = 64, kDerest = 128, kDw = 192, kDepre = 256;
constexpr int kDesuf = 320, kDebb = 384, kDetri = 448, kDdec = 960, kDa = 961;
// A head's sums for one 64-step chunk from the group pass, for
// ssd_bwd_ddt_kernel, in floats: C_t . (gy . S_in)_t and B_t . (X . G)_t
// over each warpgroup's n ([4][64] each), the column sums of gy.X^T o L o
// C.B^T, d(dA)'s E term, and <G, S_in> of each warp.
constexpr int PREC = 656;
constexpr int kPF = 0, kPK = 256, kPcol = 512, kPdE = 576, kPgs = 640;

// One warp writes the decay record of the 64 steps at dtc (stride between
// steps; steps at and past `valid` are dt = 0), lane r the steps r and
// r + 32.  All dA have one sign, so every sum adds terms of one sign.
__device__ __forceinline__ void decay_record(const float* __restrict__ dtc,
                                             long long stride, int valid,
                                             float a, float* __restrict__ out,
                                             int lane) {
  const float d0 = lane < valid ? dtc[lane * stride] : 0.f;
  const float d1 = lane + 32 < valid ? dtc[(lane + 32) * stride] : 0.f;
  const float a0 = d0 * a, a1 = d1 * a;
  out[kDdt + lane] = d0;
  out[kDdt + lane + 32] = d1;
  float c0 = a0, c1 = a1, r0 = a0, r1 = a1, p0 = a0, p1 = a1, s0 = a0, s1 = a1;
#pragma unroll
  for (int k = 1; k < 32; k *= 2) {
    const float u0 = __shfl_up_sync(FULL, c0, k), u1 = __shfl_up_sync(FULL, c1, k);
    const float v0 = __shfl_down_sync(FULL, r0, k), v1 = __shfl_down_sync(FULL, r1, k);
    if (lane >= k) { c0 += u0; c1 += u1; }
    if (lane + k < 32) { r0 += v0; r1 += v1; }
  }
  c1 += __shfl_sync(FULL, c0, 31);             // cum over [0, t]
  const float tot1 = __shfl_sync(FULL, r1, 0);
  r0 = __shfl_down_sync(FULL, r0, 1);           // over (t, 32)
  r1 = __shfl_down_sync(FULL, r1, 1);           // over (t, 64)
  if (lane == 31) r0 = r1 = 0.f;
  r0 += tot1;
  out[kDecum + lane] = expf(c0);
  out[kDecum + lane + 32] = expf(c1);
  const float e0 = expf(r0), e1 = expf(r1);
  out[kDerest + lane] = e0;
  out[kDerest + lane + 32] = e1;
  out[kDw + lane] = e0 * d0;
  out[kDw + lane + 32] = e1 * d1;
  const float cl = __shfl_sync(FULL, c1, 31);
  if (lane == 0) out[kDdec] = expf(cl);
#pragma unroll
  for (int k = 1; k < 8; k *= 2) {
    const float u0 = __shfl_up_sync(FULL, p0, k, 8), u1 = __shfl_up_sync(FULL, p1, k, 8);
    const float w0 = __shfl_down_sync(FULL, s0, k, 8), w1 = __shfl_down_sync(FULL, s1, k, 8);
    if (lane % 8 >= k) { p0 += u0; p1 += u1; }
    if (lane % 8 + k < 8) { s0 += w0; s1 += w1; }
  }
  s0 = __shfl_down_sync(FULL, s0, 1, 8);
  s1 = __shfl_down_sync(FULL, s1, 1, 8);
  if (lane % 8 == 7) s0 = s1 = 0.f;
  out[kDepre + lane] = expf(p0);        // over [8 (t / 8), t]
  out[kDepre + lane + 32] = expf(p1);
  out[kDesuf + lane] = expf(s0);        // over (s, 8 (s / 8) + 7]
  out[kDesuf + lane + 32] = expf(s1);
  float blk[8];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    blk[m] = __shfl_sync(FULL, p0, 8 * m + 7);
    blk[m + 4] = __shfl_sync(FULL, p1, 8 * m + 7);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = lane / 8 + 4 * e, j = lane % 8;   // sum over blocks (i, j)
    float bb = 0.f;
#pragma unroll
    for (int m = 1; m < 8; ++m)
      if (m > i && m < j) bb += blk[m];
    out[kDebb + 8 * i + j] = expf(bb);
  }
  // The sums over (t - d, t] for d = 1..7 inside t's block.
  float run0 = 0.f, run1 = 0.f;
#pragma unroll
  for (int d = 1; d < 8; ++d) {
    const float u0 = __shfl_up_sync(FULL, a0, d - 1, 8);
    const float u1 = __shfl_up_sync(FULL, a1, d - 1, 8);
    run0 += u0;
    run1 += u1;
    out[kDetri + d * QP + lane] = expf(run0);
    out[kDetri + d * QP + lane + 32] = expf(run1);
  }
  if (lane == 0) out[kDa] = a;
}

// The prep kernel's record for one (b, 64-step chunk, group), in bytes:
// C.B^T (64 x 64 floats, row t, column s), then for each 32-step half the
// planes B^T (NP rows n of the half's 32 steps s), C^T (likewise) and B
// (32 rows s, N in slabs of 32 columns, each 8 columns permuted 0 2 4 6 1 3
// 5 7 to match a state fragment), each as hi then lo.
template <int NP>
struct Rec {
  static constexpr int kT = NP * 128;                      // a B^T or C^T plane
  static constexpr int kP = QW * 128 * ((NP + 31) / 32);   // a B plane
  static constexpr int kCB = QP * QP * 4;
  static constexpr int kBT = 0, kCT = 2 * kT, kBP = 4 * kT;
  static constexpr int kHalf = 4 * kT + 2 * kP;
  static constexpr int kBytes = kCB + 2 * kHalf;
};

// Blocks [0, records): one (b, chunk, group) each.  The blocks after: the
// decay records, a warp each (b, h, chunk).
template <int NP>
__global__ void __launch_bounds__(256)
ssd_bwd_prep_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    unsigned char* __restrict__ rec, float* __restrict__ drec,
                    int records, int batch, int seq, int heads, int groups,
                    int N, int a_stride) {
  constexpr int LDK = pad4(NP);
  using R = Rec<NP>;
  extern __shared__ __align__(16) float prep_sm[];
  float* Bs = prep_sm;
  float* Cs = prep_sm + QP * LDK;
  const int n64 = (seq + QP - 1) / QP;
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= records) {
    const int i = (blockIdx.x - records) * 8 + tid / 32;
    if (i >= batch * heads * n64) return;
    const int c = i % n64, h = (i / n64) % heads, b = i / (n64 * heads);
    decay_record(dt + (static_cast<long long>(b) * seq + c * QP) * heads + h,
                 heads, seq - c * QP,
                 A[static_cast<long long>(b) * a_stride + h],
                 drec + static_cast<long long>(i) * DREC, tid % 32);
    return;
  }
  const int g = blockIdx.x % groups, c = (blockIdx.x / groups) % n64;
  const int b = blockIdx.x / (groups * n64);
  for (int idx = tid; idx < QP * NP / 4; idx += blockDim.x) {
    const int s = idx / (NP / 4), n = 4 * (idx % (NP / 4));
    const int t = c * QP + s;
    const bool ok = t < seq && n < N;
    const long long off =
        ok ? ((static_cast<long long>(b) * seq + t) * groups + g) * N + n : 0;
    cp16(Bs + s * LDK + n, Bm + off, ok);
    cp16(Cs + s * LDK + n, Cm + off, ok);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  unsigned char* out = rec + static_cast<long long>(blockIdx.x) * R::kBytes;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    unsigned char* half = out + R::kCB + j * R::kHalf;
    const float* Bj = Bs + QW * j * LDK;
    const float* Cj = Cs + QW * j * LDK;
    // B^T and C^T: row n, chunk pc holds steps 4 (pc ^ (n % 8)) + 0..3.
    for (int idx = tid; idx < NP * 8; idx += blockDim.x) {
      const int n = idx / 8, pc = idx % 8, s0 = 4 * (pc ^ (n & 7));
      float vb[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vb[i] = Bj[(s0 + i) * LDK + n];
        vc[i] = Cj[(s0 + i) * LDK + n];
      }
      const int o = n * 128 + pc * 16;
      split4(vb, half + R::kBT + o, half + R::kBT + R::kT + o);
      split4(vc, half + R::kCT + o, half + R::kCT + R::kT + o);
    }
    // B: slab q, row s, chunk pc holds columns k = 4 (pc ^ (s % 8)) + 0..3
    // of the slab, which are n = 8 (k / 8) + 2 (k % 4) (+1 for the upper
    // half of each 8).
    for (int idx = tid; idx < (R::kP / 128) * 8; idx += blockDim.x) {
      const int row = idx / 8, pc = idx % 8, q = row / QW, s = row % QW;
      const int k0 = 4 * (pc ^ (s & 7));
      const int n0 = 32 * q + (k0 & 24) + (k0 & 4 ? 1 : 0);
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = n0 + 2 * i < NP ? Bj[s * LDK + n0 + 2 * i] : 0.f;
      unsigned char* o = half + R::kBP + row * 128 + pc * 16;
      split4(v, o, o + R::kP);
    }
  }

  // C.B^T: warp w the 16 rows 16 (w / 2) and 32 columns 32 (w % 2) + 0..31.
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int r0 = 16 * (warp / 2), s0 = 32 * (warp % 2);
  float acc[4][4] = {};
#pragma unroll 4
  for (int k = 0; k < NP; k += 8) {
    uint32_t ah[4], al[4];
    split(Cs[(r0 + gq) * LDK + k + tq], ah[0], al[0]);
    split(Cs[(r0 + gq + 8) * LDK + k + tq], ah[1], al[1]);
    split(Cs[(r0 + gq) * LDK + k + tq + 4], ah[2], al[2]);
    split(Cs[(r0 + gq + 8) * LDK + k + tq + 4], ah[3], al[3]);
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      split(Bs[(s0 + 8 * u + gq) * LDK + k + tq], bh[u][0], bl[u][0]);
      split(Bs[(s0 + 8 * u + gq) * LDK + k + tq + 4], bh[u][1], bl[u][1]);
    }
    mma3(acc, ah, al, bh, bl);
  }
  float* cb = reinterpret_cast<float*>(out);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int s = s0 + 8 * u + 2 * tq;
    *reinterpret_cast<float2*>(cb + (r0 + gq) * QP + s) =
        make_float2(acc[u][0], acc[u][1]);
    *reinterpret_cast<float2*>(cb + (r0 + gq + 8) * QP + s) =
        make_float2(acc[u][2], acc[u][3]);
  }
}

// A boundary state (or its gradient) of one (b, h, 64-step chunk) in
// scratch: PP x NP floats in the group pass's plane order (32 rows p a
// plane of NP rows n, sw128), so that cp.async lands it ready to split.
// Writes this thread's fragment of a walk's 64 x NP accumulator, rows
// p0 + pw + gq (+8) < PP.
template <int NP>
__device__ __forceinline__ void store_state(const float (&st)[NP / 2],
                                            float* __restrict__ dst, int prow,
                                            int PP, int tq) {
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = prow + 8 * half;
      if (p < PP) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * tq + e;
          dst[(p / 32) * NP * 32 + sw128(n, p % 32) / 4] = st[4 * j + 2 * half + e];
        }
      }
    }
  }
}

// One warp, lane t = step t of a 32-step chunk (every warp of a warpgroup
// computes the same): dA_t = dt_t a, e^cum_t with cum_t the sum over [0, t],
// w_t = e^(sum over (t, 32)) dt_t and the chunk's decay.  Every dA has one
// sign, so each sum adds terms of one sign.
struct WalkScalars {
  float ecum, w, dec;
};

__device__ __forceinline__ WalkScalars walk_scalars(float dt, float a, int lane) {
  const float d = dt * a;
  float cum = d, rest = d;
#pragma unroll
  for (int k = 1; k < 32; k *= 2) {
    const float u = __shfl_up_sync(FULL, cum, k);
    const float v = __shfl_down_sync(FULL, rest, k);
    if (lane >= k) cum += u;
    if (lane + k < 32) rest += v;
  }
  rest = __shfl_down_sync(FULL, rest, 1);   // sum over (t, 32)
  if (lane == 31) rest = 0.f;
  WalkScalars out;
  out.ecum = expf(cum);
  out.w = expf(rest) * dt;
  out.dec = expf(__shfl_sync(FULL, cum, 31));
  return out;
}

// Shared memory of the walks, from a 1024-byte aligned base: two stages of
// the chunk's planes as cp.async lands them (IMG bytes each), each head's
// decay matrix (32 x 32, hi and lo; the gradient walk only), two stages of
// the raw {x or gy: 32 x LDX; C.B^T: 32 x LDM (gradient walk); dt: 32 x
// HPB}, then e^cum, w and the chunk's decay of each head.
template <int IMG, int HPB, bool GRAD>
struct WalkLayout {
  static constexpr int LDX = pad8(64 * HPB);
  static constexpr int kM = GRAD ? QW * 128 : 0;                   // bytes
  static constexpr int kStage = QW * LDX + (GRAD ? QW * LDM : 0) + QW * HPB;
  static constexpr int kBytes = 1024 + 2 * IMG + 2 * HPB * kM +
                                4 * (2 * kStage + HPB * (2 * QW + 1));
};

// The walks' block: HPB heads of one group (one warpgroup each) and 64 state
// rows p of each; chunks of 32 steps.  GRAD = false: forwards from S = 0,
// writing the state entering every 64-step chunk to Sst.  GRAD = true:
// backwards from gfin, writing dx and the gradient of the state leaving
// every 64-step chunk to Sst.
template <int NP, int HPB, bool GRAD>
__global__ void __launch_bounds__(128 * HPB, NP == 16 ? 2 : 1)
ssd_bwd_walk_kernel(const float* __restrict__ xin, const float* __restrict__ dt,
                    const float* __restrict__ A, const unsigned char* __restrict__ rec,
                    const float* __restrict__ gfin, float* __restrict__ Sst,
                    float* __restrict__ dx, int seq, int heads, int P,
                    int groups, int N, int a_stride, int PP) {
  using R = Rec<NP>;
  // Forwards: B^T.  Backwards: C^T then B (permuted), contiguous in a half.
  constexpr int IMG = GRAD ? 2 * R::kT + 2 * R::kP : 2 * R::kT;
  using L = WalkLayout<IMG, HPB, GRAD>;
  constexpr int LDX = L::LDX, NT = NP / 8;
  constexpr int G3 = NT < 4 ? NT : 4;   // k-steps of G . B^T a group
  constexpr bool LEAN = GRAD && NP <= 32;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Mh = base + 2 * IMG;   // the decay matrix's hi, lo a head
  unsigned char* Ml = Mh + HPB * L::kM;
  float* stage0 = reinterpret_cast<float*>(Ml + HPB * L::kM);
  float* ecumv = stage0 + 2 * L::kStage;   // [HPB][QW]
  float* wv = ecumv + HPB * QW;            // [HPB][QW]
  float* decv = wv + HPB * QW;             // [HPB]

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int hblocks = heads / HPB;
  const int b = blockIdx.x / hblocks, h0 = (blockIdx.x % hblocks) * HPB;
  const int h = h0 + wg, p0 = blockIdx.y * 64;
  const int g = h0 / (heads / groups);
  const int n32 = (seq + QW - 1) / QW, n64 = (seq + QP - 1) / QP;
  const float a = A[static_cast<long long>(b) * a_stride + h];
  const int pw = 16 * warp;   // the warp's first row of its head's 64
  unsigned char* Mhw = Mh + wg * L::kM;
  unsigned char* Mlw = Ml + wg * L::kM;

  const long long HP = static_cast<long long>(heads) * P;
  const float* xb = xin + static_cast<long long>(b) * seq * HP + h0 * P + p0;
  const float* dtb = dt + static_cast<long long>(b) * seq * heads + h0;
  float* sb = Sst + static_cast<long long>(b * heads + h) * n64 * PP * NP;

  auto load_chunk = [&](int c) {
    unsigned char* im = base + (c & 1) * IMG;
    float* Xs = stage0 + (c & 1) * L::kStage;
    float* CBs = Xs + QW * LDX;
    float* dts = CBs + (GRAD ? QW * LDM : 0);
    const int t0 = c * QW;
    const unsigned char* rc =
        rec + ((static_cast<long long>(b) * n64 + c / 2) * groups + g) * R::kBytes;
    const unsigned char* src =
        rc + R::kCB + (c % 2) * R::kHalf + (GRAD ? R::kCT : R::kBT);
    for (int idx = tid; idx < IMG / 16; idx += blockDim.x)
      cp16(im + 16 * idx, src + 16 * idx, true);
    const float* xc = xb + t0 * HP;
    for (int idx = tid; idx < QW * HPB * 16; idx += blockDim.x) {
      const int s = idx / (HPB * 16), hs = (idx / 16) % HPB;
      const int col = 4 * (idx % 16);
      const bool ok = t0 + s < seq && p0 + col < P;
      const int off = ok ? s * static_cast<int>(HP) + hs * P + col : 0;
      cp16(Xs + s * LDX + hs * 64 + col, xc + off, ok);
    }
    if (GRAD) {
      // The half's diagonal 32 x 32 block of the record's 64 x 64 C.B^T.
      const float* cbc = reinterpret_cast<const float*>(rc) +
                         (c % 2) * QW * (QP + 1);
      for (int idx = tid; idx < QW * QW / 4; idx += blockDim.x) {
        const int t = idx / (QW / 4), k = 4 * (idx % (QW / 4));
        cp16(CBs + t * LDM + k, cbc + t * QP + k, true);
      }
    }
    const float* dtc = dtb + static_cast<long long>(t0) * heads;
    for (int idx = tid; idx < QW * HPB; idx += blockDim.x) {
      const int s = idx / HPB, hs = idx % HPB;
      const bool ok = t0 + s < seq;
      cp4(dts + idx, dtc + (ok ? s * heads + hs : 0), ok);
    }
  };

  float st[NP / 2];   // the state or its gradient, 64 x NP: wgmma's accumulator
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + pw + gq + 8 * half;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * tq + e;
        st[4 * j + 2 * half + e] =
            GRAD && p < P && n < N
                ? gfin[(static_cast<long long>(b * heads + h) * P + p) * N + n]
                : 0.f;
      }
    }
  }
  float* dxb = dx + static_cast<long long>(b) * seq * HP + h * P + p0 + pw;

  load_chunk(GRAD ? n32 - 1 : 0);
  cp_commit();
  for (int i = 0; i < n32; ++i) {
    const int c = GRAD ? n32 - 1 - i : i;
    cp_wait<0>();
    // Chunk c has landed, and every warpgroup is done with the chunk before
    // (its products have completed): the other stage, M, e^cum and w are free.
    __syncthreads();
    if (i + 1 < n32) load_chunk(GRAD ? c - 1 : c + 1);
    cp_commit();
    const unsigned char* Ph = base + (c & 1) * IMG;   // B^T or C^T, hi and lo
    const unsigned char* Pl = Ph + R::kT;
    const unsigned char* Bh = Ph + R::kBP - R::kCT;   // B (permuted), hi, lo
    const unsigned char* Bl = Bh + R::kP;
    const float* Xs = stage0 + (c & 1) * L::kStage;
    const float* CBs = Xs + QW * LDX;
    const float* dts = CBs + (GRAD ? QW * LDM : 0);

    // The boundary states: forwards the state entering each 64-step chunk,
    // backwards the gradient of the state leaving it.
    if (GRAD ? (c % 2 == 1 || c == n32 - 1) : c % 2 == 0)
      store_state<NP>(st, sb + static_cast<long long>(c / 2) * PP * NP,
                      p0 + pw + gq, PP, tq);

    const float dtl = dts[lane * HPB + wg];
    const WalkScalars sc = walk_scalars(dtl, a, lane);
    if (warp == 0) {
      ecumv[wg * QW + lane] = sc.ecum;
      wv[wg * QW + lane] = sc.w;
      if (lane == 0) decv[wg] = sc.dec;
    }
    if (GRAD) {
      // M'[s][t] = C.B^T[t][s] e^(sum_{s<r<=t} dA_r) dt_s for t >= s, 0
      // below, as hi and lo; this thread: row s, the 8 columns t of block k.
      const float d = dtl * a;
      float pre = d, suf = d;   // sums over [8 (t / 8), t] and [t, 8 (t / 8) + 7]
#pragma unroll
      for (int k = 1; k < 8; k *= 2) {
        const float u = __shfl_up_sync(FULL, pre, k, 8);
        const float v = __shfl_down_sync(FULL, suf, k, 8);
        if (lane % 8 >= k) pre += u;
        if (lane % 8 + k < 8) suf += v;
      }
      suf = __shfl_down_sync(FULL, suf, 1, 8);   // over (t, 8 (t / 8) + 7]
      if (lane % 8 == 7) suf = 0.f;
      float blk[QW / 8];
#pragma unroll
      for (int k = 0; k < QW / 8; ++k) blk[k] = __shfl_sync(FULL, pre, 8 * k + 7);
      const int item = tid % 128;
      const int s = item / (QW / 8), k = item % (QW / 8), js = s / 8;
      const float suf_s = __shfl_sync(FULL, suf, s);
      const float dts_s = dts[s * HPB + wg];
      float seg = 0.f;   // sum over (s, 8k): the rest of s's block, then whole blocks
      if (k > js) {
        seg = suf_s;
#pragma unroll
        for (int m = 1; m < QW / 8; ++m)
          if (m > js && m < k) seg += blk[m];
      }
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
        const int t = 8 * k + tt;
        const float dA_t = __shfl_sync(FULL, d, t);
        float m = 0.f;
        if (t >= s) {
          if (t > s) seg += dA_t;
          m = CBs[t * LDM + s] * expf(seg) * dts_s;
        }
        uint32_t hi, lo;
        split(m, hi, lo);
        const int o = sw128(s, t);
        *reinterpret_cast<uint32_t*>(Mhw + o) = hi;
        *reinterpret_cast<uint32_t*>(Mlw + o) = lo;
      }
    }
    // The planes (cp.async) and M (plain stores) are read by wgmma.
    fence_async_shared();
    __syncthreads();
    const float dec = decv[wg];

    float acc[QW / 2];   // GRAD: dx^T[p][s] of this warpgroup's 64 rows
    if (GRAD) {
#pragma unroll
      for (int i2 = 0; i2 < QW / 2; ++i2) acc[i2] = 0.f;
      // G . B^T, k-steps over n: the gradient's accumulator slab j is this
      // product's A fragment when column 8j + 2tq (+1) plays k = tq (tq + 4).
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += G3) {
        uint32_t ah[G3][4], al[G3][4];
#pragma unroll
        for (int u = 0; u < G3; ++u) {
          const float* sj = st + 4 * (j0 + u);
          split(sj[0], ah[u][0], al[u][0]);
          split(sj[2], ah[u][1], al[u][1]);
          split(sj[1], ah[u][2], al[u][2]);
          split(sj[3], ah[u][3], al[u][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < G3; ++u) {
          const int j = j0 + u;
          const int off = (j / 4) * (QW * 128) + (j % 4) * 32;
          const uint64_t dh = sw128_desc(Bh + off);
          const uint64_t dl = sw128_desc(Bl + off);
          wgmma_rs<QW>(acc, ah[u], dl);
          wgmma_rs<QW>(acc, al[u], dh);
          wgmma_rs<QW>(acc, ah[u], dh);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(ah);
        reg_fence(al);
      }
      // (G . B^T) o w.
#pragma unroll
      for (int jt = 0; jt < QW / 8; ++jt) {
        const float e0 = wv[wg * QW + 8 * jt + 2 * tq];
        const float e1 = wv[wg * QW + 8 * jt + 2 * tq + 1];
        acc[4 * jt] *= e0;
        acc[4 * jt + 1] *= e1;
        acc[4 * jt + 2] *= e0;
        acc[4 * jt + 3] *= e1;
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < NP / 2; ++i2) st[i2] *= dec;

    // Fragments of this warp's rows of gy^T (backwards; k = step t) for
    // dx, and of X^T o w (gy^T o e^cum backwards) for the state.  At
    // N <= 32 dx completes before the second set is made, so that the two
    // sets share registers.
    const float* scale = GRAD ? ecumv : wv;
    uint32_t xh[QW / 8][4], xl[QW / 8][4], wh[QW / 8][4], wl[QW / 8][4];
    auto store_dx = [&]() {
      float* dc = dxb + c * QW * HP;
#pragma unroll
      for (int i2 = 0; i2 < QW / 2; ++i2) {
        const int s = 8 * (i2 / 4) + 2 * tq + (i2 & 1);
        const int r = gq + 8 * ((i2 / 2) & 1);
        if (c * QW + s < seq && p0 + pw + r < P) dc[s * HP + r] = acc[i2];
      }
    };
    auto fragments = [&](bool plain, bool scaled) {
#pragma unroll
      for (int ks = 0; ks < QW / 8; ++ks) {
        const float* xr = Xs + (8 * ks + tq) * LDX + wg * 64 + pw + gq;
        const float xv[4] = {xr[0], xr[8], xr[4 * LDX], xr[4 * LDX + 8]};
        const float w0 = scale[wg * QW + 8 * ks + tq];
        const float w1 = scale[wg * QW + 8 * ks + tq + 4];
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          if (plain) split(xv[i2], xh[ks][i2], xl[ks][i2]);
          if (scaled) split(xv[i2] * (i2 < 2 ? w0 : w1), wh[ks][i2], wl[ks][i2]);
        }
      }
    };
    fragments(GRAD, !LEAN);
    wgmma_fence();
    if (GRAD) {
      // dx^T += gy^T . M'^T, k-steps over t.
#pragma unroll
      for (int ks = 0; ks < QW / 8; ++ks) {
        const uint64_t dh = sw128_desc(Mhw + 32 * ks);
        const uint64_t dl = sw128_desc(Mlw + 32 * ks);
        wgmma_rs<QW>(acc, xh[ks], dl);
        wgmma_rs<QW>(acc, xl[ks], dh);
        wgmma_rs<QW>(acc, xh[ks], dh);
      }
      wgmma_commit();
      if (LEAN) {
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(xh);
        reg_fence(xl);
        store_dx();
        fragments(false, true);
        wgmma_fence();
      }
    }
    // S += (X o w)^T . B, or G += (gy o e^cum)^T . C, k-steps over s.
#pragma unroll
    for (int ks = 0; ks < QW / 8; ++ks) {
      const uint64_t dh = sw128_desc(Ph + 32 * ks);
      const uint64_t dl = sw128_desc(Pl + 32 * ks);
      wgmma_rs<NP>(st, wh[ks], dl);
      wgmma_rs<NP>(st, wl[ks], dh);
      wgmma_rs<NP>(st, wh[ks], dh);
    }
    wgmma_commit();
    if (GRAD && !LEAN) {
      wgmma_wait<1>();
      reg_fence(acc);
      reg_fence(xh);
      reg_fence(xl);
      store_dx();
    }
    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(wh);
    reg_fence(wl);
  }
}

template <int NP, int HPB, bool GRAD>
int launch_walk(const float* xin, const float* dt, const float* A,
                const unsigned char* rec, const float* gfin, float* Sst,
                float* dx, int batch, int seq, int heads, int P, int groups,
                int N, int a_stride, int PP, cudaStream_t stream) {
  using R = Rec<NP>;
  constexpr int IMG = GRAD ? 2 * R::kT + 2 * R::kP : 2 * R::kT;
  const int bytes = WalkLayout<IMG, HPB, GRAD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_walk_kernel<NP, HPB, GRAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_walk_kernel<NP, HPB, GRAD>
      <<<dim3(batch * heads / HPB, (P + 63) / 64), 128 * HPB, bytes, stream>>>(
          xin, dt, A, rec, gfin, Sst, dx, seq, heads, P, groups, N, a_stride,
          PP);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of ssd_bwd_group_kernel, from a 1024-byte aligned base: the
// planes (hi and lo) of x and gy (64 rows t of 32 p: kQ bytes) and of S_in
// and G (NP rows n of 32 p: kN bytes) the warpgroups' products read; the raw
// staging of the next share in the same layout; the chunk's C.B^T on and
// below the diagonal, row by row; the decay records of the current and the
// next head; the chunk's C and B (64 x LDC floats each).
template <int NP>
struct GroupLayout {
  static constexpr int WGS = 2;                   // warpgroups
  static constexpr int NW = NP / WGS;             // columns n a warpgroup
  static constexpr int SW = QP / WGS;             // columns s of gy . X^T
  static constexpr int kQ = QP * 128, kN = NP * 128;
  static constexpr int kXh = 0, kXl = kQ, kYh = 2 * kQ, kYl = 3 * kQ;
  static constexpr int kSh = 4 * kQ, kSl = kSh + kN, kGh = kSl + kN, kGl = kGh + kN;
  static constexpr int kPlanes = 4 * kQ + 4 * kN;
  static constexpr int kStX = kPlanes, kStY = kStX + kQ, kStS = kStY + kQ;
  static constexpr int kStG = kStS + kN;
  static constexpr int kCB = kStG + kN;   // C.B^T on and below the diagonal, row t at t (t + 1) / 2
  static constexpr int kVec = kCB + QP * (QP + 1) / 2 * 4;   // two decay records
  static constexpr int LDC = NP + 4;               // row stride of C and B
  static constexpr int kC = kVec + 4 * 2 * DREC;   // the chunk's C, then B
  static constexpr int kBytes = 1024 + kC + 4 * 2 * QP * LDC;
};

// Block (b, 64-step chunk, group) x the cluster's share of the group's
// heads: WGS warpgroups, warpgroup w the columns n in [NW w, NW (w + 1)) of
// gy . S_in, X . G, dC and dB, and s in [SW w, SW (w + 1)) of gy . X^T.
template <int NP>
__global__ void __launch_bounds__(128 * GroupLayout<NP>::WGS, 1)
ssd_bwd_group_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ gy,
                     const unsigned char* __restrict__ rec,
                     const float* __restrict__ Sst, const float* __restrict__ Gst,
                     const float* __restrict__ drec, float* __restrict__ prec,
                     float* __restrict__ dB, float* __restrict__ dC, int seq,
                     int heads, int P, int groups, int N, int PP) {
  using Lg = GroupLayout<NP>;
  using R = Rec<NP>;
  constexpr int WGS = Lg::WGS, NW = Lg::NW, SW = Lg::SW;
  constexpr int kQ = Lg::kQ, kN = Lg::kN, NTH = 128 * WGS;
  // The epilogue's rows: PARTS threads a row t, CWD columns s each; the
  // row stride (floats) of gy.X^T in shared memory.
  constexpr int PARTS = NTH / QP, CWD = QP / PARTS, LDD = QP + 1;
  static_assert(4 * (QP * LDD + QP * (QP + 1) / 2) <= Lg::kPlanes,
                "gy.X^T and E's row sums fit over the planes");
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* CBp = reinterpret_cast<float*>(base + Lg::kCB);
  float* vrec = reinterpret_cast<float*>(base + Lg::kVec);   // [2][DREC]

  const int tid = threadIdx.x, wg = tid / 128, wi = (tid % 128) / 32;
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int n64 = (seq + QP - 1) / QP;
  const int rid = blockIdx.x / ks;   // the record (b, chunk, group)
  const int g = rid % groups, c = (rid / groups) % n64, b = rid / (groups * n64);
  const int rep = heads / groups;
  const int h_lo = g * rep + rank * rep / ks;
  const int h_hi = g * rep + (rank + 1) * rep / ks;
  const int t0 = c * QP, PQ = PP / 32;
  const long long HP = static_cast<long long>(heads) * P;
  const unsigned char* rc = rec + static_cast<long long>(rid) * R::kBytes;
  const int rt = 16 * wi + gq;   // the thread's first accumulator row

  const uint64_t d0 = sw128_desc(base);   // + offset / 16: a plane's descriptor
  // The chunk's C and B rows, for F and K'.
  float* Cs = reinterpret_cast<float*>(base + Lg::kC);
  float* Bs = Cs + QP * Lg::LDC;
  for (int idx = tid; idx < QP * NP / 4; idx += blockDim.x) {
    const int t = idx / (NP / 4), n = 4 * (idx % (NP / 4));
    const bool ok = t0 + t < seq && n < N;
    const long long off =
        ok ? ((static_cast<long long>(b) * seq + t0 + t) * groups + g) * N + n : 0;
    cp16(Cs + t * Lg::LDC + n, Cm + off, ok);
    cp16(Bs + t * Lg::LDC + n, Bm + off, ok);
  }
  for (int idx = tid; idx < QP * QP; idx += blockDim.x) {
    const int t = idx / QP, s = idx % QP;
    if (s <= t) CBp[t * (t + 1) / 2 + s] = reinterpret_cast<const float*>(rc)[idx];
  }

  // sdS: sum_h dS_h at row t = tid / PARTS, columns CWD (tid % PARTS) + i.
  float dCa[NW / 2], dBa[NW / 2], tC[NW / 2], tB[NW / 2], Da[SW / 2], sdS[CWD];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) dCa[i] = dBa[i] = tC[i] = tB[i] = 0.f;
#pragma unroll
  for (int i = 0; i < SW / 2; ++i) Da[i] = 0.f;
#pragma unroll
  for (int i = 0; i < CWD; ++i) sdS[i] = 0.f;

  // Stage share q (32 rows of P) of head h: x and gy rows t in 8 chunks of
  // 4 floats at p = 32 q + 4 k, S_in and G as scratch holds them, and with
  // the first share the head's decay record.
  auto load_share = [&](int h, int q) {
    unsigned char* st = base;
    for (int idx = tid; idx < QP * 8; idx += blockDim.x) {
      const int t = idx / 8, k = idx % 8, p = 32 * q + 4 * k;
      const bool ok = t0 + t < seq && p < P;
      const long long off =
          ok ? (static_cast<long long>(b) * seq + t0 + t) * HP + h * P + p : 0;
      const int o = t * 128 + ((k ^ (t & 7)) << 4);
      cp16(st + Lg::kStX + o, x + off, ok);
      cp16(st + Lg::kStY + o, gy + off, ok);
    }
    const long long so =
        (static_cast<long long>(b * heads + h) * n64 + c) * PP * NP +
        static_cast<long long>(q) * NP * 32;
    for (int idx = tid; idx < NP * 8; idx += blockDim.x) {
      cp16(st + Lg::kStS + 16 * idx, Sst + so + 4 * idx, true);
      cp16(st + Lg::kStG + 16 * idx, Gst + so + 4 * idx, true);
    }
    if (q == 0) {
      const float* src =
          drec + (static_cast<long long>(b * heads + h) * n64 + c) * DREC;
      float* dst = vrec + ((h - h_lo) & 1) * DREC;
      for (int idx = tid; idx < DREC / 4; idx += blockDim.x)
        cp16(dst + 4 * idx, src + 4 * idx, true);
    }
  };

  float gs = 0.f;   // this thread's share of <G, S_in> for the current head
  int h = h_lo, q = 0;
  if (h < h_hi) load_share(h, 0);
  cp_commit();
  while (h < h_hi) {
    cp_wait<0>();
    // The share has landed; every warpgroup's products of the last one have
    // completed, and the head before is done with the vectors.
    __syncthreads();
    for (int idx = tid; idx < 2 * QP * 8; idx += blockDim.x) {
      const int o = 16 * (idx % (QP * 8));
      const int y = idx / (QP * 8);
      const float4 v = *reinterpret_cast<const float4*>(
          base + (y ? Lg::kStY : Lg::kStX) + o);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      split4(vv, base + (y ? Lg::kYh : Lg::kXh) + o,
             base + (y ? Lg::kYl : Lg::kXl) + o);
    }
    for (int idx = tid; idx < NP * 8; idx += blockDim.x) {
      const int o = 16 * idx;
      const float4 s4 = *reinterpret_cast<const float4*>(base + Lg::kStS + o);
      const float4 g4 = *reinterpret_cast<const float4*>(base + Lg::kStG + o);
      gs += s4.x * g4.x + s4.y * g4.y + s4.z * g4.z + s4.w * g4.w;
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
      split4(sv, base + Lg::kSh + o, base + Lg::kSl + o);
      split4(gv, base + Lg::kGh + o, base + Lg::kGl + o);
    }
    fence_async_shared();
    __syncthreads();
    int nh = h, nq = q + 1;
    if (nq == PQ) {
      nq = 0;
      ++nh;
    }
    if (nh < h_hi) load_share(nh, nq);
    cp_commit();

    // gy . X^T (this warpgroup's 32 columns s), gy . S_in and X . G (its NW
    // columns n), k-steps over the share's 32 p.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int ko = 32 * kk;
      const uint64_t yh = d0 + ((Lg::kYh + ko) >> 4);
      const uint64_t yl = d0 + ((Lg::kYl + ko) >> 4);
      const uint64_t xh = d0 + ((Lg::kXh + ko) >> 4);
      const uint64_t xl = d0 + ((Lg::kXl + ko) >> 4);
      const uint64_t xsh = xh + wg * SW * 8, xsl = xl + wg * SW * 8;
      const uint64_t sh = d0 + ((Lg::kSh + ko) >> 4) + wg * NW * 8;
      const uint64_t sl = d0 + ((Lg::kSl + ko) >> 4) + wg * NW * 8;
      const uint64_t gh = d0 + ((Lg::kGh + ko) >> 4) + wg * NW * 8;
      const uint64_t gl = d0 + ((Lg::kGl + ko) >> 4) + wg * NW * 8;
      wgmma_ss<SW>(Da, yh, xsl);
      wgmma_ss<SW>(Da, yl, xsh);
      wgmma_ss<SW>(Da, yh, xsh);
      wgmma_ss<NW>(tC, yh, sl);
      wgmma_ss<NW>(tC, yl, sh);
      wgmma_ss<NW>(tC, yh, sh);
      wgmma_ss<NW>(tB, xh, gl);
      wgmma_ss<NW>(tB, xl, gh);
      wgmma_ss<NW>(tB, xh, gh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(Da);
    reg_fence(tC);
    reg_fence(tB);

    if (q + 1 == PQ) {
      // The head is complete: dC += e^cum o gy.S_in and dB += w o X.G in
      // the fragments; gy.S_in, X.G and gy.X^T to shared memory (over the
      // planes, free until the next share's split), where thread (t, k)
      // takes part k of row t.
      const float* V = vrec + ((h - h_lo) & 1) * DREC;
      const float* v_dt = V + kDdt;
      const float* v_ecum = V + kDecum;
      const float* v_w = V + kDw;
      const float* v_epre = V + kDepre;
      const float* v_esuf = V + kDesuf;
      const float* v_ebb = V + kDebb;
      const float* v_etri = V + kDetri;
      float* ps = prec + (static_cast<long long>(b * heads + h) * n64 + c) * PREC;
      // F_t = e^cum_t C_t . (gy . S_in)_t and K'_t = e^rest_t B_t .
      // (X . G)_t over this warpgroup's n (the factors and the sum over
      // warpgroups in ssd_bwd_ddt_kernel).
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt + 8 * half;
        float f = 0.f, kp = 0.f;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            const int n = NW * wg + 8 * j + 2 * tq + e;
            f += Cs[r * Lg::LDC + n] * tC[i];
            kp += Bs[r * Lg::LDC + n] * tB[i];
            dCa[i] += v_ecum[r] * tC[i];
            dBa[i] += v_w[r] * tB[i];
            tC[i] = tB[i] = 0.f;
          }
        }
        f += __shfl_xor_sync(FULL, f, 1);
        f += __shfl_xor_sync(FULL, f, 2);
        kp += __shfl_xor_sync(FULL, kp, 1);
        kp += __shfl_xor_sync(FULL, kp, 2);
        if (tq == 0) {
          ps[kPF + wg * QP + r] = f;
          ps[kPK + wg * QP + r] = kp;
        }
      }
      float* Dd = reinterpret_cast<float*>(base);   // QP x LDD
      float* Es = Dd + QP * LDD;   // the row sums of E, row t at t (t + 1) / 2
      __syncthreads();   // every warpgroup's products have read the planes
#pragma unroll
      for (int j = 0; j < SW / 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            Dd[(rt + 8 * half) * LDD + SW * wg + 8 * j + 2 * tq + e] = Da[i];
            Da[i] = 0.f;
          }
        }
      }
      const float gsum = warp_sum(gs);
      if (lane == 0) ps[kPgs + warp] = gsum;
      gs = 0.f;
      __syncthreads();
      const int t = tid / PARTS, k = tid % PARTS;
      {
        // dS = gy.X^T o L o dt into sum_h dS, on and below the diagonal;
        // E = dS o C.B^T summed along the row over s' < s to the packed E;
        // V = gy.X^T o L o C.B^T in place of gy.X^T for the column sums.
        // L[t][s] is the product of the record's exponentials of one-signed
        // sums: the rest of s's block, the blocks between, the start of t's
        // block; inside one block its own.
        const int jt = t / 8;
        const float ept = v_epre[t];
        float* erow = Es + t * (t + 1) / 2;
        float run = 0.f;
#pragma unroll
        for (int i = 0; i < CWD; ++i) {
          const int s = CWD * k + i, js = s / 8;
          float en = 0.f, vv = 0.f;
          if (s <= t) {
            const float l = js < jt ? v_esuf[s] * v_ebb[8 * js + jt] * ept
                            : s < t ? v_etri[(t - s) * QP + t] : 1.f;
            const float dl = Dd[t * LDD + s] * l;
            const float ds = dl * v_dt[s];
            const float cb = CBp[t * (t + 1) / 2 + s];
            sdS[i] += ds;
            en = ds * cb;
            vv = dl * cb;
          }
          Dd[t * LDD + s] = vv;
          if (s <= t) erow[s] = run;
          run += en;
        }
        float incl = run;
#pragma unroll
        for (int d = 1; d < PARTS; d *= 2) {
          const float u = __shfl_up_sync(FULL, incl, d, PARTS);
          if (k >= d) incl += u;
        }
        float off = __shfl_up_sync(FULL, incl, 1, PARTS);
        if (k == 0) off = 0.f;
#pragma unroll
        for (int i = 0; i < CWD; ++i) {
          const int s = CWD * k + i;
          if (s <= t) erow[s] += off;
        }
      }
      __syncthreads();
      {
        // Columns: d(dA_r)'s E term, the sum over t >= r of the row sums
        // over s < r, and the column sums of V; thread (r, k) the rows
        // [CWD k, CWD (k + 1)).
        const int r = t;
        float v = 0.f, cs = 0.f;
#pragma unroll
        for (int i = 0; i < CWD; ++i) {
          const int tt = CWD * k + i;
          if (tt >= r) {
            v += Es[tt * (tt + 1) / 2 + r];
            cs += Dd[tt * LDD + r];
          }
        }
#pragma unroll
        for (int d = 1; d < PARTS; d *= 2) {
          v += __shfl_xor_sync(FULL, v, d);
          cs += __shfl_xor_sync(FULL, cs, d);
        }
        if (k == 0) {
          ps[kPdE + r] = v;
          ps[kPcol + r] = cs;
        }
      }
    }
    h = nh;
    q = nq;
  }

  // dC += (sum_h dS_h) . B and dB += (sum_h dS_h)^T . C, k-steps over the
  // chunk's 64 steps in two planes: B^T and C^T from the record's halves,
  // sum_h dS_h (rows t) and its transpose (rows s) split into hi and lo.
  const unsigned char* halves = rc + R::kCB;
  auto end_product = [&](float (&acc)[NW / 2], bool with_c) {
    __syncthreads();   // the planes are free
    const int src = with_c ? R::kCT : R::kBT;
    for (int idx = tid; idx < 4 * kN / 16; idx += blockDim.x) {
      const int u = idx / (2 * kN / 16), o = 16 * (idx % (2 * kN / 16));
      cp16(base + u * 2 * kN + o, halves + u * R::kHalf + src + o, true);
    }
    cp_commit();
    unsigned char* sd = base + 4 * kN;   // [plane of 32 columns][hi, lo]
#pragma unroll
    for (int i = 0; i < CWD; ++i) {
      const int t = tid / PARTS, s = CWD * (tid % PARTS) + i;
      uint32_t hi, lo;
      split(sdS[i], hi, lo);
      const int row = with_c ? s : t, col = with_c ? t : s;
      unsigned char* pl = sd + (col / 32) * 2 * kQ + sw128(row, col % 32);
      *reinterpret_cast<uint32_t*>(pl) = hi;
      *reinterpret_cast<uint32_t*>(pl + kQ) = lo;
    }
    cp_wait<0>();
    fence_async_shared();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int u = kk / 4, ko = 32 * (kk % 4);
      const uint64_t ah = sw128_desc(sd + u * 2 * kQ + ko);
      const uint64_t al = sw128_desc(sd + u * 2 * kQ + kQ + ko);
      const uint64_t bh = sw128_desc(base + u * 2 * kN + wg * NW * 128 + ko);
      const uint64_t bl = sw128_desc(base + u * 2 * kN + kN + wg * NW * 128 + ko);
      wgmma_ss<NW>(acc, ah, bl);
      wgmma_ss<NW>(acc, al, bh);
      wgmma_ss<NW>(acc, ah, bh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
  };
  end_product(dCa, false);
  end_product(dBa, true);

  // The cluster's blocks add their sums in rank order: each writes its dC
  // and dB to shared memory, and block r sums its rows of every block's.
  __syncthreads();
  float* RC = reinterpret_cast<float*>(base);
  float* RB = RC + QP * NP;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = rt + 8 * half, n = NW * wg + 8 * j + 2 * tq + e;
        RC[r * NP + n] = dCa[4 * j + 2 * half + e];
        RB[r * NP + n] = dBa[4 * j + 2 * half + e];
      }
    }
  }
  cluster.sync();
  const int row0 = rank * QP / ks, row1 = (rank + 1) * QP / ks;
  for (int idx = tid; idx < (row1 - row0) * NP; idx += blockDim.x) {
    const int t = row0 + idx / NP, n = idx % NP;
    float vc = 0.f, vb = 0.f;
    for (int k = 0; k < ks; ++k) {
      vc += cluster.map_shared_rank(RC, k)[t * NP + n];
      vb += cluster.map_shared_rank(RB, k)[t * NP + n];
    }
    if (t0 + t < seq && n < N) {
      const long long o =
          ((static_cast<long long>(b) * seq + t0 + t) * groups + g) * N + n;
      dC[o] = vc;
      dB[o] = vb;
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

// ddt and each chunk's dA share from the group pass's partial sums, a warp
// each (b, h, 64-step chunk): d(dA_r), lane r the steps r and r + 32, with
// F summed over t >= r and dt K' over s < r.
__global__ void __launch_bounds__(256)
ssd_bwd_ddt_kernel(const float* __restrict__ drec, const float* __restrict__ prec,
                   float* __restrict__ ddt, float* __restrict__ dApart,
                   int batch, int seq, int heads, int wgs) {
  const int n64 = (seq + QP - 1) / QP;
  const int i = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (i >= batch * heads * n64) return;
  const int c = i % n64, h = (i / n64) % heads, b = i / (n64 * heads);
  const int t0 = c * QP;
  const float* V = drec + static_cast<long long>(i) * DREC;
  const float* ps = prec + static_cast<long long>(i) * PREC;
  // d(dA_r), ddt_r and the chunk's dA share, lane r the steps r and
  // r + 32: F summed over t >= r, dt K' over s < r.
  const float a = V[kDa];
  const int r0 = lane, r1 = lane + 32;
  float F0 = 0.f, F1 = 0.f, K0 = 0.f, K1 = 0.f;
  for (int w = 0; w < wgs; ++w) {
    F0 += ps[kPF + w * QP + r0];
    F1 += ps[kPF + w * QP + r1];
    K0 += ps[kPK + w * QP + r0];
    K1 += ps[kPK + w * QP + r1];
  }
  F0 *= V[kDecum + r0];
  F1 *= V[kDecum + r1];
  K0 *= V[kDerest + r0];
  K1 *= V[kDerest + r1];
  float fs0 = F0, fs1 = F1, kp0 = V[kDdt + r0] * K0, kp1 = V[kDdt + r1] * K1;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const float u0 = __shfl_down_sync(FULL, fs0, d);
    const float u1 = __shfl_down_sync(FULL, fs1, d);
    const float w0 = __shfl_up_sync(FULL, kp0, d);
    const float w1 = __shfl_up_sync(FULL, kp1, d);
    if (lane + d < 32) { fs0 += u0; fs1 += u1; }
    if (lane >= d) { kp0 += w0; kp1 += w1; }
  }
  fs0 += __shfl_sync(FULL, fs1, 0);             // F over t >= r
  const float ktot0 = __shfl_sync(FULL, kp0, 31);
  float ke0 = __shfl_up_sync(FULL, kp0, 1);     // dt K' over s < r
  float ke1 = __shfl_up_sync(FULL, kp1, 1);
  if (lane == 0) ke0 = ke1 = 0.f;
  ke1 += ktot0;
  float gsv = 0.f;
#pragma unroll
  for (int w = 0; w < 4 * wgs; ++w) gsv += ps[kPgs + w];
  const float hs = V[kDdec] * gsv;
  const float dd0 = ps[kPdE + r0] + fs0 + hs + ke0;
  const float dd1 = ps[kPdE + r1] + fs1 + hs + ke1;
  const float col0 = ps[kPcol + r0], col1 = ps[kPcol + r1];
  float* dd = ddt + (static_cast<long long>(b) * seq + t0) * heads + h;
  if (t0 + r0 < seq) dd[static_cast<long long>(r0) * heads] = a * dd0 + col0 + K0;
  if (t0 + r1 < seq) dd[static_cast<long long>(r1) * heads] = a * dd1 + col1 + K1;
  const float da = warp_sum(V[kDdt + r0] * dd0 + V[kDdt + r1] * dd1);
  if (lane == 0)
    dApart[static_cast<long long>(b * heads + h) * n64 + c] = da;
}

// dA (batch, H): each head's chunk shares in order.
__global__ void __launch_bounds__(256)
ssd_bwd_da_kernel(const float* __restrict__ part, float* __restrict__ dA,
                  int total, int n64) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int c = 0; c < n64; ++c) s += part[static_cast<long long>(i) * n64 + c];
  dA[i] = s;
}

// Cluster size of the group pass: the group's heads shared by enough blocks
// to fill the card's multiprocessors once (one block each), at most 8 and
// at most the group's heads.
int cluster_size(int records, int rep) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  int ks = sms / records;
  if (ks > 8) ks = 8;
  if (ks > rep) ks = rep;
  return ks < 1 ? 1 : ks;
}

// Scratch, in bytes: the prep's records, the boundary states S_in and G,
// the heads' decay records and partial sums, then the dA shares.
struct Scratch {
  long long rec, states, heads, part;
  long long total() const { return rec + 2 * states + heads * 4 * (DREC + PREC) + part; }
};

template <int NP>
Scratch scratch_parts(int batch, int seq, int heads, int P, int groups) {
  const long long n64 = (static_cast<long long>(seq) + QP - 1) / QP;
  const long long PP = (P + 31) / 32 * 32;
  Scratch s;
  s.rec = static_cast<long long>(batch) * n64 * groups * Rec<NP>::kBytes;
  s.states = 4LL * batch * heads * n64 * PP * NP;
  s.heads = static_cast<long long>(batch) * heads * n64;
  s.part = 4 * s.heads;
  return s;
}

Scratch scratch_for(int np, int batch, int seq, int heads, int P, int groups) {
  switch (np) {
    case 16: return scratch_parts<16>(batch, seq, heads, P, groups);
    case 32: return scratch_parts<32>(batch, seq, heads, P, groups);
    case 64: return scratch_parts<64>(batch, seq, heads, P, groups);
    default: return scratch_parts<128>(batch, seq, heads, P, groups);
  }
}

template <int NP>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* gy, const float* gfin, float* dx,
           float* ddt, float* dA, float* dB, float* dC, unsigned char* scratch,
           int batch, int seq, int heads, int P, int groups, int N,
           int a_stride, cudaStream_t stream) {
  const Scratch sc = scratch_parts<NP>(batch, seq, heads, P, groups);
  unsigned char* rec = scratch;
  float* Sst = reinterpret_cast<float*>(scratch + sc.rec);
  float* Gst = Sst + sc.states / 4;
  float* drec = Gst + sc.states / 4;
  float* prec = drec + sc.heads * DREC;
  float* part = prec + sc.heads * PREC;
  const int n64 = (seq + QP - 1) / QP, PP = (P + 31) / 32 * 32;
  const int records = batch * n64 * groups, rep = heads / groups;

  const int prep_bytes = 2 * QP * pad4(NP) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_prep_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      prep_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dblocks = static_cast<int>((sc.heads + 7) / 8);
  ssd_bwd_prep_kernel<NP><<<records + dblocks, 256, prep_bytes, stream>>>(
      Bm, Cm, dt, A, rec, drec, records, batch, seq, heads, groups, N,
      a_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // Two heads a walk block where a group's heads pair up and one block
  // covers P.
  const bool two = rep % 2 == 0 && P <= 64;
  int e = two ? launch_walk<NP, 2, false>(x, dt, A, rec, gfin, Sst, dx, batch,
                                          seq, heads, P, groups, N, a_stride,
                                          PP, stream)
              : launch_walk<NP, 1, false>(x, dt, A, rec, gfin, Sst, dx, batch,
                                          seq, heads, P, groups, N, a_stride,
                                          PP, stream);
  if (e) return e;
  e = two ? launch_walk<NP, 2, true>(gy, dt, A, rec, gfin, Gst, dx, batch, seq,
                                     heads, P, groups, N, a_stride, PP, stream)
          : launch_walk<NP, 1, true>(gy, dt, A, rec, gfin, Gst, dx, batch, seq,
                                     heads, P, groups, N, a_stride, PP, stream);
  if (e) return e;

  const int ks = cluster_size(records, rep);
  const int bytes = GroupLayout<NP>::kBytes;
  err = cudaFuncSetAttribute(ssd_bwd_group_kernel<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(records * ks);
  cfg.blockDim = dim3(128 * GroupLayout<NP>::WGS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_bwd_group_kernel<NP>, x, Bm, Cm, gy, static_cast<const unsigned char*>(rec),
                           static_cast<const float*>(Sst),
                           static_cast<const float*>(Gst),
                           static_cast<const float*>(drec), prec, dB, dC,
                           seq, heads, P, groups, N, PP);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_ddt_kernel<<<dblocks, 256, 0, stream>>>(
      drec, prec, ddt, part, batch, seq, heads, GroupLayout<NP>::WGS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int total = batch * heads;
  ssd_bwd_da_kernel<<<(total + 255) / 256, 256, 0, stream>>>(part, dA, total,
                                                             n64);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch repro_ssd_scan_bwd needs for these shapes (0 for none).
extern "C" long long repro_ssd_scan_bwd_scratch_bytes(int batch, int seq,
                                                      int heads, int P,
                                                      int groups, int N) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || P <= 0 || groups <= 0 || N <= 0)
    return 0;
  const Scratch s = scratch_for(padded_n(N), batch, seq, heads, P, groups);
  return s.total();
}

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a shape the kernels do not take: N a multiple
// of 8 up to 128, P a multiple of 4, groups dividing heads, batch x heads
// and batch x chunks x groups x 8 blocks under 2^31, P / 64 blocks up to
// 65535.  scratch holds repro_ssd_scan_bwd_scratch_bytes, 16-byte aligned;
// every tensor is float32 and contiguous.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm,
                                  const void* gy, const void* gfin, void* dx,
                                  void* ddt, void* dA, void* dB, void* dC,
                                  void* scratch, int batch, int seq, int heads,
                                  int P, int groups, int N, int a_stride,
                                  void* stream) {
  if (batch <= 0 || heads <= 0 || P <= 0)
    return static_cast<int>(cudaGetLastError());
  const long long chunks = (static_cast<long long>(seq) + QP - 1) / QP;
  if (groups <= 0 || heads % groups != 0 || N <= 0 || N % 8 != 0 ||
      N > 128 || P % 4 != 0 ||
      static_cast<long long>(batch) * heads > 0x7fffffff ||
      8LL * batch * chunks * groups > 0x7fffffff || P > 65535LL * 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq <= 0) {
    // No steps: only dA exists, and it is 0.
    const cudaError_t err = cudaMemsetAsync(
        dA, 0, sizeof(float) * static_cast<size_t>(batch) * heads, s);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  const auto* gyf = static_cast<const float*>(gy);
  const auto* gff = static_cast<const float*>(gfin);
  auto* dxf = static_cast<float*>(dx);
  auto* ddtf = static_cast<float*>(ddt);
  auto* daf = static_cast<float*>(dA);
  auto* dbf = static_cast<float*>(dB);
  auto* dcf = static_cast<float*>(dC);
  auto* sc = static_cast<unsigned char*>(scratch);
  switch (padded_n(N)) {
    case 16:
      return launch<16>(xf, dtf, af, bf, cf, gyf, gff, dxf, ddtf, daf, dbf,
                        dcf, sc, batch, seq, heads, P, groups, N, a_stride, s);
    case 32:
      return launch<32>(xf, dtf, af, bf, cf, gyf, gff, dxf, ddtf, daf, dbf,
                        dcf, sc, batch, seq, heads, P, groups, N, a_stride, s);
    case 64:
      return launch<64>(xf, dtf, af, bf, cf, gyf, gff, dxf, ddtf, daf, dbf,
                        dcf, sc, batch, seq, heads, P, groups, N, a_stride, s);
    default:
      return launch<128>(xf, dtf, af, bf, cf, gyf, gff, dxf, ddtf, daf, dbf,
                         dcf, sc, batch, seq, heads, P, groups, N, a_stride, s);
  }
}
