// The Mamba2 SSD scan on Hopper, as the chunked SSD form on the tensor cores:
//   S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (outer) B_t,   S_0 = 0,
//   y_t = S_t . C_t,
// per (batch b, head h) with a (P, N) float32 state.  x (batch, S, H, P),
// dt (batch, S, H), A indexed A[b * a_stride + h], B/C (batch, S, G, N) read
// for group g = h / (H / G); y (batch, S, H, P) and the final state
// (batch, H, P, N), all float32.
//
// Replaces src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan (body _ssd_kernel).
// The TPU kernel hoists the scan to the chunk level: inside a chunk it runs
// matrix-unit products on a masked decay matrix, and only the (P, N) state
// crosses its sequential chunk grid axis in VMEM scratch.
//
// Bound on the card: bytes.  At mamba2-1.3b's prefill (batch 4, S 1024,
// H 64, P 64, N 128, G 1) the kernel must move 147.8 MB (44.1 us at
// 3.35 TB/s); the chunked form's products, done once at the model's chunk
// of 128, are 13.0 GFLOP (26.3 us at the 495 TFLOP/s of TF32).
//
// The design, per chunk of Q = 32 steps (the kernel's own chunk; the result
// does not depend on it beyond rounding):
//   y      = (C.B^T o L o dt) . X + (C o e^cum) . S_in^T
//   S_out  = e^cum_last . S_in + (X o w)^T . B,   w_s = e^(cum_last - cum_s) dt_s
// with cum the inclusive sum of dt.A inside the chunk and L[t,s] the decay
// from step s to t for s <= t, 0 above the diagonal.
// * No exponential sees a positive exponent, and no exponent is a difference
//   of two running sums: L's exponent sum_{s<r<=t} dt_r.A and w's
//   sum_{r>s} dt_r.A are sums of terms of one sign, taken directly.  The
//   difference cum_t - cum_s of two large sums (|cum| reaches thousands when
//   the decay is strong) cancels, and costs more than the 1e-4 the kernel is
//   held to (tests/test_torch_attention_ssd.py emulates both).
// * Products: wgmma in TF32 on the tensor cores, float32 accumulators, each
//   operand split once into hi = tf32(v) and lo = v - hi and summed as
//   hi.hi + hi.lo + lo.hi: one TF32 pass is 40x over the 1e-4 limit, the
//   split as close to float32 as the plain form (the same emulation).
// * Two kernels a call.  ssd_prep_kernel, once per (b, chunk, group),
//   computes C.B^T (mma.sync, split TF32) and writes B^T and C split into
//   hi and lo, already in wgmma's swizzled shared-memory layout, to a scratch
//   the wrapper allocates.  Every head of the group then reads them from L2:
//   nothing is recomputed or re-split per head.
// * ssd_chunk_kernel: a block of one warpgroup per head owns two heads of a
//   group (one where the group's heads are odd or P > 64) and 64 state rows
//   p of each (y[:, p] and S[p, :] depend on x[:, p] alone), and walks the
//   chunks in order, the TPU's sequential grid axis turned into a loop.  A
//   warpgroup keeps its 64 x N state in registers as the wgmma accumulator
//   of (X o w)^T . B for the whole sequence; the same registers, permuted
//   within each 8-column slab, are the register A operand of S_in . C^T, so
//   the state never goes through shared memory.  x^T and (x o w)^T are the
//   register A operands of the two other products; B^T, C and each head's M
//   are read by descriptor.  The next chunk's image, x, dt and C.B^T arrive
//   by cp.async into the other half of a double buffer while the current
//   chunk computes.  One block a multiprocessor (194 KB of shared memory at
//   N = 128), 128 blocks at mamba2-1.3b's prefill.
// * wgmma for TF32 reads shared operands K-major only: B is transposed and
//   C's columns permuted by the prep kernel, which also makes the hi/lo
//   split once per group instead of once per head.
// * Padding: N is padded to 16, 32, 64 or 128 columns with zeros and P to
//   64 rows a head; steps past S load as dt = 0 and x = B = C = 0, which
//   leave the state as it was.  No float atomics: two calls on the same
//   inputs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 32;           // steps a chunk
constexpr int LDM = Q + 4;      // row stride of the decay matrix (= 4 mod 32)

// Row strides that make the fragment loads free of bank conflicts: rows read
// by the 4 lanes of a fragment column step 8 banks (= 8 mod 32) or 4 banks
// (= 4 mod 32).
__host__ __device__ constexpr int pad8(int n) { return n + ((8 - n) % 32 + 32) % 32; }
__host__ __device__ constexpr int pad4(int n) { return n + ((4 - n) % 32 + 32) % 32; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok.
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

// v = hi + lo with hi = v rounded to TF32 (to nearest, ties away) and lo the
// exact rest, which the tensor cores read to TF32 by dropping its low bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(v - __uint_as_float(h));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[u] += a . b[u] for T tiles in split TF32: a as hi/lo A fragments, b[u]
// as hi/lo B fragments; the three terms go tile after tile, so that
// consecutive products write different accumulators.
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

// Fragments of mma.m16n8k8 (.tf32), lane = 4 * gq + tq:
//   A (16 x 8): a0 (gq, tq), a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8, tq + 4)
//   B (8 x 8):  b0 (tq, gq), b1 (tq + 4, gq)
//   D (16 x 8): d0 (gq, 2tq), d1 (gq, 2tq + 1), d2 (gq + 8, 2tq), d3 (gq + 8, 2tq + 1)

// The chunk's shared operands, split into hi and lo, as the chunk kernel's
// wgmma reads them (K-major, 128-byte swizzle; see sw128): B^T (NP rows n of
// the chunk's 32 steps s), then C (32 rows t, N in slabs of 32 columns, each
// 8 columns permuted 0 2 4 6 1 3 5 7 to match the state's fragment); hi
// then lo of each.  ssd_prep_kernel writes one such image per (b, chunk,
// group) to global scratch; ssd_chunk_kernel copies it to shared memory.
template <int NP>
struct Image {
  static constexpr int kBt = NP * 128;                    // bytes, hi or lo
  static constexpr int kC = Q * 128 * ((NP + 31) / 32);   // bytes, hi or lo
  static constexpr int kBytes = 2 * kBt + 2 * kC;
};

__host__ __device__ constexpr int sw128(int r, int k) {
  return r * 128 + (((k >> 2) ^ (r & 7)) << 4) + ((k & 3) << 2);
}

// v -> (hi, lo) of four floats, stored as two float4.
__device__ __forceinline__ void split4(const float (&v)[4], float4* hi,
                                       float4* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], h[i], l[i]);
  *hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
  *lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// For one (b, chunk, group): C.B^T, cb[t][s] = sum_n C[t, n] B[s, n], Q x Q,
// all of it (the chunk kernel masks s > t), four warps each a 16 x 16
// quarter on the tensor cores; and the split image of B^T and C.
template <int NP>
__global__ void __launch_bounds__(128)
ssd_prep_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ cb, unsigned char* __restrict__ img,
                int seq, int groups, int N) {
  constexpr int LDK = pad4(NP);
  using I = Image<NP>;
  __shared__ __align__(16) float Bs[Q * LDK];
  __shared__ __align__(16) float Cs[Q * LDK];
  // Block (b, c, g) in the scratch's order.
  const int nchunks = (seq + Q - 1) / Q;
  const int g = blockIdx.x % groups, c = (blockIdx.x / groups) % nchunks;
  const int b = blockIdx.x / (groups * nchunks);
  const int tid = threadIdx.x;
  for (int idx = tid; idx < Q * NP / 4; idx += blockDim.x) {
    const int s = idx / (NP / 4), n = 4 * (idx % (NP / 4));
    const int t = c * Q + s;
    const bool ok = t < seq && n < N;
    const long long off =
        ok ? ((static_cast<long long>(b) * seq + t) * groups + g) * N + n : 0;
    cp16(Bs + s * LDK + n, Bm + off, ok);
    cp16(Cs + s * LDK + n, Cm + off, ok);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  unsigned char* out_img = img + static_cast<long long>(blockIdx.x) * I::kBytes;
  // B^T: row n, physical chunk pc holds steps 4 (pc ^ (n % 8)) + 0..3.
  for (int idx = tid; idx < NP * 8; idx += blockDim.x) {
    const int n = idx / 8, pc = idx % 8, s0 = 4 * (pc ^ (n & 7));
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = Bs[(s0 + i) * LDK + n];
    split4(v, reinterpret_cast<float4*>(out_img + n * 128 + pc * 16),
           reinterpret_cast<float4*>(out_img + I::kBt + n * 128 + pc * 16));
  }
  // C: slab q, row t, physical chunk pc holds columns k = 4 (pc ^ (t % 8))
  // + 0..3 of the slab, which are n = 8 (k / 8) + 2 (k % 4) (+1 for the
  // upper half of each 8).
  for (int idx = tid; idx < (I::kC / 128) * 8; idx += blockDim.x) {
    const int row = idx / 8, pc = idx % 8, q = row / Q, t = row % Q;
    const int k0 = 4 * (pc ^ (t & 7));
    const int n0 = 32 * q + (k0 & 24) + (k0 & 4 ? 1 : 0);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = n0 + 2 * i < NP ? Cs[t * LDK + n0 + 2 * i] : 0.f;
    unsigned char* o = out_img + 2 * I::kBt + row * 128 + pc * 16;
    split4(v, reinterpret_cast<float4*>(o),
           reinterpret_cast<float4*>(o + I::kC));
  }

  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int r0 = 16 * (warp / 2), s0 = 16 * (warp % 2);
  float acc[2][4] = {};
#pragma unroll
  for (int k = 0; k < NP; k += 8) {
    uint32_t ah[4], al[4];
    split(Cs[(r0 + gq) * LDK + k + tq], ah[0], al[0]);
    split(Cs[(r0 + gq + 8) * LDK + k + tq], ah[1], al[1]);
    split(Cs[(r0 + gq) * LDK + k + tq + 4], ah[2], al[2]);
    split(Cs[(r0 + gq + 8) * LDK + k + tq + 4], ah[3], al[3]);
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      split(Bs[(s0 + 8 * u + gq) * LDK + k + tq], bh[u][0], bl[u][0]);
      split(Bs[(s0 + 8 * u + gq) * LDK + k + tq + 4], bh[u][1], bl[u][1]);
    }
    mma3(acc, ah, al, bh, bl);
  }
  float* out = cb + static_cast<long long>(blockIdx.x) * (Q * Q);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = s0 + 8 * u + 2 * tq;
    *reinterpret_cast<float2*>(out + (r0 + gq) * Q + s) =
        make_float2(acc[u][0], acc[u][1]);
    *reinterpret_cast<float2*>(out + (r0 + gq + 8) * Q + s) =
        make_float2(acc[u][2], acc[u][3]);
  }
}

// wgmma helpers.  Shared operands are K-major with the 128-byte swizzle:
// rows of 32 floats (128 bytes), 8-row groups 1024 bytes apart, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8); a k-step of 8 floats moves
// the start address 32 bytes along the row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
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

// d (64 x N, float32 fragment) += A . B: A (64 x 8) a TF32 register fragment
// (as mma.m16n8k8's, one warp each 16 rows), B (8 x N) TF32 in shared memory,
// K-major, 128-byte swizzle.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Shared memory of ssd_chunk_kernel, from a 1024-byte aligned base: two
// stages of the chunk's split image (Image<NP>) as cp.async lands it, each
// head's decay matrix M (32 x 32) as hi and lo in the same layout, two
// stages of the raw {x: Q x LDX; C.B^T: Q x LDM; dt: Q x HPB}, then e^cum, w
// and the chunk's decay of each head.
template <int NP, int HPB>
struct ChunkLayout {
  static constexpr int LDX = pad8(64 * HPB);
  static constexpr int kM = Q * 128;                     // bytes, hi or lo
  static constexpr int kStage = Q * LDX + Q * LDM + Q * HPB;   // floats
  static constexpr int kBytes = 1024 + 2 * Image<NP>::kBytes + 2 * HPB * kM +
                                4 * (2 * kStage + HPB * (2 * Q + 1));
};

// A block owns HPB heads of one group (one warpgroup each) and 64 state rows
// p of each, so the heads share the chunk's image and C.B^T.
template <int NP, int HPB>
__global__ void __launch_bounds__(128 * HPB, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ cb,
                 const unsigned char* __restrict__ img, float* __restrict__ y,
                 float* __restrict__ fin, int seq, int heads, int P,
                 int groups, int N, int a_stride) {
  using L = ChunkLayout<NP, HPB>;
  using I = Image<NP>;
  constexpr int LDX = L::LDX, NT = NP / 8;
  constexpr int G3 = NT < 4 ? NT : 4;   // k-steps of S_in . C^T a group
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Mh = base + 2 * I::kBytes;  // M hi, lo of each head
  unsigned char* Ml = Mh + HPB * L::kM;
  float* stage0 = reinterpret_cast<float*>(Ml + HPB * L::kM);
  float* ecum = stage0 + 2 * L::kStage;      // [HPB][Q]
  float* wv = ecum + HPB * Q;                // [HPB][Q]
  float* chunk_decay = wv + HPB * Q;         // [HPB]

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int hblocks = heads / HPB;
  const int b = blockIdx.x / hblocks, h0 = (blockIdx.x % hblocks) * HPB;
  const int h = h0 + wg, p0 = blockIdx.y * 64;
  const int g = h0 / (heads / groups);
  const int nchunks = (seq + Q - 1) / Q;
  const float a = A[static_cast<long long>(b) * a_stride + h];
  const int pw = 16 * warp;   // the warp's first row of its head's 64
  unsigned char* Mhw = Mh + wg * L::kM;
  unsigned char* Mlw = Ml + wg * L::kM;

  // Per-block bases; the copies below add 32-bit offsets within a chunk.
  const long long HP = static_cast<long long>(heads) * P;
  const float* xb = x + static_cast<long long>(b) * seq * HP + h0 * P + p0;
  const float* dtb = dt + static_cast<long long>(b) * seq * heads + h0;
  const long long rec = static_cast<long long>(b) * nchunks * groups + g;
  const float* cbb = cb + rec * (Q * Q);
  const unsigned char* imgb = img + rec * I::kBytes;

  auto load_chunk = [&](int c) {
    unsigned char* im = base + (c & 1) * I::kBytes;
    float* Xs = stage0 + (c & 1) * L::kStage;
    float* CBs = Xs + Q * LDX;
    float* dts = CBs + Q * LDM;
    const int t0 = c * Q;
    const unsigned char* imc =
        imgb + static_cast<long long>(c) * groups * I::kBytes;
    for (int idx = tid; idx < I::kBytes / 16; idx += blockDim.x)
      cp16(im + 16 * idx, imc + 16 * idx, true);
    const float* xc = xb + t0 * HP;
    for (int idx = tid; idx < Q * HPB * 16; idx += blockDim.x) {
      const int s = idx / (HPB * 16), hs = (idx / 16) % HPB;
      const int col = 4 * (idx % 16);
      const bool ok = t0 + s < seq && p0 + col < P;
      const int off = ok ? s * static_cast<int>(HP) + hs * P + col : 0;
      cp16(Xs + s * LDX + hs * 64 + col, xc + off, ok);
    }
    const float* cbc = cbb + static_cast<long long>(c) * groups * (Q * Q);
    for (int idx = tid; idx < Q * Q / 4; idx += blockDim.x)
      cp16(CBs + (idx / (Q / 4)) * LDM + 4 * (idx % (Q / 4)), cbc + 4 * idx,
           true);
    const float* dtc = dtb + static_cast<long long>(t0) * heads;
    for (int idx = tid; idx < Q * HPB; idx += blockDim.x) {
      const int s = idx / HPB, hs = idx % HPB;
      const bool ok = t0 + s < seq;
      cp4(dts + idx, dtc + (ok ? s * heads + hs : 0), ok);
    }
  };

  float* yb = y + static_cast<long long>(b) * seq * HP + h * P + p0 + pw;
  float st[NP / 2];    // the state, 64 x NP: wgmma's accumulator fragment
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) st[i] = 0.f;

  load_chunk(0);
  cp_commit();
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<0>();
    // Chunk c has landed, and every warpgroup is done with chunk c - 1 (its
    // products have completed): the other stage, M, e^cum and w are free.
    __syncthreads();
    if (c + 1 < nchunks) load_chunk(c + 1);
    cp_commit();
    const unsigned char* Bth = base + (c & 1) * I::kBytes;   // B^T hi, lo
    const unsigned char* Btl = Bth + I::kBt;
    const unsigned char* Ch = Btl + I::kBt;                  // C hi, lo
    const unsigned char* Cl = Ch + I::kC;
    const float* Xs = stage0 + (c & 1) * L::kStage;
    const float* CBs = Xs + Q * LDX;
    const float* dts = CBs + Q * LDM;

    // Log-decays dA_r = dt_r A of this warpgroup's head, by lane r of each
    // warp.  All are <= 0, so every sum below adds terms of one sign and
    // none is a difference.
    const float dA = dts[lane * HPB + wg] * a;
    float pre8 = dA;   // sum over [8 (r / 8), r]
#pragma unroll
    for (int d = 1; d < 8; d *= 2) {
      const float v = __shfl_up_sync(0xffffffffu, pre8, d, 8);
      if (lane % 8 >= d) pre8 += v;
    }
    float blk[Q / 8];  // sums of the 8-step blocks
#pragma unroll
    for (int k = 0; k < Q / 8; ++k)
      blk[k] = __shfl_sync(0xffffffffu, pre8, 8 * k + 7);
    {
      // M[t][s] = C.B^T[t][s] e^(sum_{s<r<=t} dA_r) dt_s for s <= t, 0
      // above, as hi and lo; this thread: the 8 columns of block k of row t.
      const int item = tid % 128;
      const int t = item / (Q / 8), k = item % (Q / 8), jb = t / 8;
      // sum over [8k + 8, t]: the whole blocks between, then t's own.
      const float own = __shfl_sync(0xffffffffu, pre8, t);
      float seg = 0.f;
#pragma unroll
      for (int m = 1; m < Q / 8; ++m)
        if (m > k && m < jb) seg += blk[m];
      if (jb > k) seg += own;
#pragma unroll
      for (int s = 8 * k + 7; s >= 8 * k; --s) {
        float m = 0.f;
        if (s <= t) {
          const float ds = dts[s * HPB + wg];
          m = CBs[t * LDM + s] * expf(seg) * ds;
          seg += ds * a;
        }
        uint32_t hi, lo;
        split(m, hi, lo);
        const int o = sw128(t, s);
        *reinterpret_cast<uint32_t*>(Mhw + o) = hi;
        *reinterpret_cast<uint32_t*>(Mlw + o) = lo;
      }
    }
    if (warp == 0) {
      // e^cum_t, cum_t = sum over [0, t], and w_t = e^(sum over (t, Q)) dt_t.
      float cum = dA, rest = dA;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, cum, d);
        const float v = __shfl_down_sync(0xffffffffu, rest, d);
        if (lane >= d) cum += u;
        if (lane + d < 32) rest += v;
      }
      rest = __shfl_down_sync(0xffffffffu, rest, 1);   // sum over (t, Q)
      if (lane == 31) rest = 0.f;
      ecum[wg * Q + lane] = expf(cum);
      wv[wg * Q + lane] = expf(rest) * dts[lane * HPB + wg];
      if (lane == Q - 1) chunk_decay[wg] = expf(cum);
    }
    // The image (cp.async) and M (plain stores) are read by wgmma.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // y^T[p][t] (64 x Q a warpgroup): first S_in . C^T, k-steps over n.
    float yacc[Q / 2];
#pragma unroll
    for (int i = 0; i < Q / 2; ++i) yacc[i] = 0.f;
    if (c > 0) {
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += G3) {
        // The state's accumulator slab j is this product's A fragment when
        // column 8j + 2tq (+1) plays k = tq (tq + 4); C's columns follow.
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
          const int off = (j / 4) * (Q * 128) + (j % 4) * 32;
          const uint64_t dh = sw128_desc(smem_u32(Ch + off));
          const uint64_t dl = sw128_desc(smem_u32(Cl + off));
          wgmma_tf32<Q>(yacc, ah[u], dl);
          wgmma_tf32<Q>(yacc, al[u], dh);
          wgmma_tf32<Q>(yacc, ah[u], dh);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(yacc);
        reg_fence(ah);
        reg_fence(al);
      }
    }

    // (S_in . C^T) o e^cum; the state decays by the chunk.
#pragma unroll
    for (int jt = 0; jt < Q / 8; ++jt) {
      const float e0 = ecum[wg * Q + 8 * jt + 2 * tq];
      const float e1 = ecum[wg * Q + 8 * jt + 2 * tq + 1];
      yacc[4 * jt] *= e0;
      yacc[4 * jt + 1] *= e1;
      yacc[4 * jt + 2] *= e0;
      yacc[4 * jt + 3] *= e1;
    }
    const float dec = chunk_decay[wg];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) st[i] *= dec;

    // x^T fragments of this warp's rows (k = step s), and x^T o w.
    uint32_t xh[Q / 8][4], xl[Q / 8][4], wh[Q / 8][4], wl[Q / 8][4];
#pragma unroll
    for (int ks = 0; ks < Q / 8; ++ks) {
      const float* xr = Xs + (8 * ks + tq) * LDX + wg * 64 + pw + gq;
      const float xv[4] = {xr[0], xr[8], xr[4 * LDX], xr[4 * LDX + 8]};
      const float w0 = wv[wg * Q + 8 * ks + tq];
      const float w1 = wv[wg * Q + 8 * ks + tq + 4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split(xv[i], xh[ks][i], xl[ks][i]);
        split(xv[i] * (i < 2 ? w0 : w1), wh[ks][i], wl[ks][i]);
      }
    }
    wgmma_fence();
    // y^T += X^T . M^T and S += (X o w)^T . B, k-steps over s.
#pragma unroll
    for (int ks = 0; ks < Q / 8; ++ks) {
      const uint64_t dh = sw128_desc(smem_u32(Mhw + 32 * ks));
      const uint64_t dl = sw128_desc(smem_u32(Mlw + 32 * ks));
      wgmma_tf32<Q>(yacc, xh[ks], dl);
      wgmma_tf32<Q>(yacc, xl[ks], dh);
      wgmma_tf32<Q>(yacc, xh[ks], dh);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < Q / 8; ++ks) {
      const uint64_t dh = sw128_desc(smem_u32(Bth + 32 * ks));
      const uint64_t dl = sw128_desc(smem_u32(Btl + 32 * ks));
      wgmma_tf32<NP>(st, wh[ks], dl);
      wgmma_tf32<NP>(st, wl[ks], dh);
      wgmma_tf32<NP>(st, wh[ks], dh);
    }
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(yacc);
    reg_fence(xh);
    reg_fence(xl);

    float* yc = yb + c * Q * HP;
#pragma unroll
    for (int i = 0; i < Q / 2; ++i) {
      const int t = 8 * (i / 4) + 2 * tq + (i & 1), r = gq + 8 * ((i / 2) & 1);
      if (c * Q + t < seq && p0 + pw + r < P)
        yc[t * static_cast<int>(HP) + r] = yacc[i];
    }
    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(wh);
    reg_fence(wl);
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = 8 * j + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + pw + gq + 8 * half;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(
            fin + ((static_cast<long long>(b) * heads + h) * P + p) * N + n) =
            make_float2(st[4 * j + 2 * half], st[4 * j + 2 * half + 1]);
    }
  }
}

template <int NP, int HPB>
int launch_chunks(const float* x, const float* dt, const float* A,
                  const float* cb, const unsigned char* img, float* y,
                  float* fin, int batch, int seq, int heads, int P,
                  int groups, int N, int a_stride, cudaStream_t stream) {
  const int bytes = ChunkLayout<NP, HPB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<NP, HPB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<NP, HPB><<<dim3(batch * heads / HPB, (P + 63) / 64),
                              128 * HPB, bytes, stream>>>(
      x, dt, A, cb, img, y, fin, seq, heads, P, groups, N, a_stride);
  return static_cast<int>(cudaGetLastError());
}

// The scratch of one call: C.B^T (Q x Q floats) then the image, for each
// (b, chunk, group).
long long scratch_bytes(int np, long long records) {
  const long long image = np == 16   ? Image<16>::kBytes
                          : np == 32 ? Image<32>::kBytes
                          : np == 64 ? Image<64>::kBytes
                                     : Image<128>::kBytes;
  return records * (Q * Q * static_cast<long long>(sizeof(float)) + image);
}

int padded_n(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128; }

template <int NP>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* fin, unsigned char* scratch,
           int batch, int seq, int heads, int P, int groups, int N,
           int a_stride, cudaStream_t stream) {
  const int nchunks = (seq + Q - 1) / Q;
  const int records = batch * nchunks * groups;
  float* cb = reinterpret_cast<float*>(scratch);
  unsigned char* img = scratch + static_cast<long long>(records) * Q * Q *
                                     static_cast<long long>(sizeof(float));
  ssd_prep_kernel<NP><<<records, 128, 0, stream>>>(Bm, Cm, cb, img, seq,
                                                    groups, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Two heads a block where a group's heads pair up and one block covers P.
  if ((heads / groups) % 2 == 0 && P <= 64)
    return launch_chunks<NP, 2>(x, dt, A, cb, img, y, fin, batch, seq, heads,
                                P, groups, N, a_stride, stream);
  return launch_chunks<NP, 1>(x, dt, A, cb, img, y, fin, batch, seq, heads, P,
                              groups, N, a_stride, stream);
}

}  // namespace

// Bytes of scratch repro_ssd_scan needs for these shapes (0 for none).
extern "C" long long repro_ssd_scan_scratch_bytes(int batch, int seq,
                                                  int groups, int N) {
  if (batch <= 0 || seq <= 0 || groups <= 0 || N <= 0) return 0;
  return scratch_bytes(padded_n(N),
                       static_cast<long long>(batch) * ((seq + Q - 1) / Q) *
                           groups);
}

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a shape the kernels do not take: N a multiple
// of 8 up to 128, P a multiple of 4, groups dividing heads, batch x heads
// and batch x chunks x groups blocks under 2^31, P / 64 blocks up to 65535.
// scratch holds repro_ssd_scan_scratch_bytes, 16-byte aligned.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* fin, void* scratch, int batch, int seq,
                              int heads, int P, int groups, int N,
                              int a_stride, void* stream) {
  if (batch <= 0 || heads <= 0 || P <= 0)
    return static_cast<int>(cudaGetLastError());
  const long long chunks = (static_cast<long long>(seq) + Q - 1) / Q;
  if (groups <= 0 || heads % groups != 0 || N <= 0 || N % 8 != 0 ||
      N > 128 || P % 4 != 0 ||
      static_cast<long long>(batch) * heads > 0x7fffffff ||
      batch * chunks * groups > 0x7fffffff || P > 65535LL * 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq <= 0) {
    // No steps: the final state is the zero initial state.
    cudaError_t err = cudaMemsetAsync(
        fin, 0, sizeof(float) * static_cast<size_t>(batch) * heads * P * N, s);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  auto* yf = static_cast<float*>(y);
  auto* ff = static_cast<float*>(fin);
  auto* sc = static_cast<unsigned char*>(scratch);
  switch (padded_n(N)) {
    case 16:
      return launch<16>(xf, dtf, af, bf, cf, yf, ff, sc, batch, seq, heads, P,
                        groups, N, a_stride, s);
    case 32:
      return launch<32>(xf, dtf, af, bf, cf, yf, ff, sc, batch, seq, heads, P,
                        groups, N, a_stride, s);
    case 64:
      return launch<64>(xf, dtf, af, bf, cf, yf, ff, sc, batch, seq, heads, P,
                        groups, N, a_stride, s);
    default:
      return launch<128>(xf, dtf, af, bf, cf, yf, ff, sc, batch, seq, heads,
                         P, groups, N, a_stride, s);
  }
}
