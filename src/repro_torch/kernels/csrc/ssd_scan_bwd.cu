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
// The design, per chunk of Q = 32 steps (the result does not depend on Q
// beyond rounding), with cum the inclusive sum of dA = dt.A inside the
// chunk, L[t,s] = e^(sum over (s, t] of dA) for s <= t and 0 above,
// w_s = e^(sum over (s, Q) of dA) dt_s, dec = e^(sum of the chunk's dA),
// S_in the state entering the chunk and G the gradient of the state
// leaving it:
//   dx     = (CB o L o dt)^T . gy + diag(w) . B . G^T
//   dS     = (gy . X^T) o L o dt           (the gradient of CB, a head)
//   dC_h   = dS . B + diag(e^cum) . (gy . S_in)
//   dB_h   = dS^T . C + diag(w) . (X . G)
//   G_prev = dec . G + (gy o e^cum)^T . C
// and the decay gradients d(dA_r) summed directly over the pairs that hold
// dA_r (no difference of row and column sums):
//   d(dA_r) = sum_{t>=r, s<r} dS o CB + sum_{t>=r} e^cum_t C_t . (gy . S_in)_t
//             + dec <G, S_in> + sum_{s<r} w_s B_s . (X . G)_s,
//   ddt_r   = A d(dA_r) + sum_t (gy . X^T o L o CB)[t, r]
//             + e^(sum over (r, Q)) B_r . (X . G)_r,
//   dA      = sum over the sequence of dt_r d(dA_r).
// * Exponents as the forward takes them: each a sum of terms of one sign
//   over its own steps, never a difference of two running sums (which
//   cancels when the decay is strong).
// * Products: mma.sync m16n8k8 in TF32 on the tensor cores, float32
//   accumulators, each operand split into hi = tf32(v) and lo = v - hi and
//   summed as hi.lo + lo.hi + hi.hi: one TF32 pass misses float32 by 1e3x
//   (tests/test_torch_attention_ssd.py emulates both).
// * Three kernels a call.  ssd_bwd_state_kernel walks the chunks of one
//   (b, h, 64-row slab of P) in order, the state in shared memory, and
//   writes each chunk's entering state to a scratch the wrapper allocates
//   (batch x H x chunks x P x N floats: 268 MB at mamba2-1.3b's shape).
//   ssd_bwd_chunk_kernel walks the same slab backwards from gfin, G in
//   shared memory, reads S_in back, and writes dx and, per (head, slab),
//   partial dB, dC, ddt and dA to scratch.  ssd_bwd_reduce_kernel sums the
//   partials over a group's heads and the slabs in a fixed order: no float
//   atomics, so two calls on the same inputs give the same bits.  The
//   scratch traffic (S_in and the head partials written and read, 1.07 GB
//   at mamba2-1.3b's shape) is the design's, over the bound's 220 MB.
// * Padding: N padded to 16, 32, 64 or 128 columns with zeros, P cut into
//   slabs of 64 rows (zero rows past P); steps past S load as dt = 0 and
//   x = B = C = gy = 0, which contribute nothing, and are not written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 32;            // steps a chunk: one lane each
constexpr int PS = 64;           // state rows p of a slab
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDQ = Q + 4;       // row strides in shared memory (floats)
constexpr int LDP = PS + 4;
constexpr unsigned FULL = 0xffffffffu;
static_assert(Q == 32, "the chunk's scans run one step a lane");

// split and mma as in csrc/ssd_scan.cu (each source is a translation unit
// of its own, built by its own nvcc process).
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

// A matrix in shared memory: element (r, k) at p[r * SR + k * SK].  The
// strides are compile-time, so a product's loads fold into fixed offsets.
template <int SR, int SK>
struct View {
  const float* p;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return p[r * SR + k * SK];
  }
};

// acc[u] += a . b over one k-step of 8 at k0 for the TN column tiles of a
// strip (m0, n0), in split TF32: the A fragment split once, the three terms
// of every tile issued term by term, so consecutive products write
// different accumulators.
template <int TN, class VA, class VB>
__device__ __forceinline__ void mma_step(float (&acc)[TN][4], const VA& a,
                                         const VB& bt, int m0, int n0,
                                         int k0, int gq, int tq) {
  uint32_t ah[4], al[4], bh[TN][2], bl[TN][2];
  split(a(m0 + gq, k0 + tq), ah[0], al[0]);
  split(a(m0 + gq + 8, k0 + tq), ah[1], al[1]);
  split(a(m0 + gq, k0 + tq + 4), ah[2], al[2]);
  split(a(m0 + gq + 8, k0 + tq + 4), ah[3], al[3]);
#pragma unroll
  for (int u = 0; u < TN; ++u) {
    split(bt(n0 + 8 * u + gq, k0 + tq), bh[u][0], bl[u][0]);
    split(bt(n0 + 8 * u + gq, k0 + tq + 4), bh[u][1], bl[u][1]);
  }
#pragma unroll
  for (int u = 0; u < TN; ++u) mma(acc[u], ah, bl[u][0], bl[u][1]);
#pragma unroll
  for (int u = 0; u < TN; ++u) mma(acc[u], al, bh[u][0], bh[u][1]);
#pragma unroll
  for (int u = 0; u < TN; ++u) mma(acc[u], ah, bh[u][0], bh[u][1]);
}

// out (M x Nn) = a (M x K) . b (K x Nn), with b given as its transpose bt
// (element (k, n) at bt(n, k)), in split TF32 on mma.m16n8k8, lane
// = 4 gq + tq:
//   A (16 x 8): a0 (gq, tq), a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8, tq + 4)
//   B (8 x 8):  b0 (tq, gq), b1 (tq + 4, gq)
//   D (16 x 8): d0 (gq, 2tq), d1 (gq, 2tq + 1), d2 (gq + 8, 2tq), d3 (gq + 8, 2tq + 1)
// Each warp takes strips of 16 rows x 8 TN columns in turn and hands every
// sum to epi(m, n, v).  Even and odd k-steps go to two accumulator sets,
// added at the end, so that 2 TN products are in flight.  M is a multiple
// of 16, NN of 8 TN and K of 16.
template <int M, int NN, int K, int TN, class VA, class VB, class Epi>
__device__ __forceinline__ void block_mm(VA a, VB bt, Epi epi) {
  static_assert(M % 16 == 0 && NN % (8 * TN) == 0 && K % 16 == 0,
                "block_mm's tiles");
  constexpr int strips_n = NN / (8 * TN), strips = (M / 16) * strips_n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  for (int st = warp; st < strips; st += WARPS) {
    const int m0 = 16 * (st / strips_n), n0 = 8 * TN * (st % strips_n);
    float even[TN][4], odd[TN][4];
#pragma unroll
    for (int u = 0; u < TN; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) even[u][i] = odd[u][i] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      mma_step<TN>(even, a, bt, m0, n0, k0, gq, tq);
      mma_step<TN>(odd, a, bt, m0, n0, k0 + 8, gq, tq);
    }
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      const int n = n0 + 8 * u + 2 * tq;
      epi(m0 + gq, n, even[u][0] + odd[u][0]);
      epi(m0 + gq, n + 1, even[u][1] + odd[u][1]);
      epi(m0 + gq + 8, n, even[u][2] + odd[u][2]);
      epi(m0 + gq + 8, n + 1, even[u][3] + odd[u][3]);
    }
  }
}

// Column tiles a warp's strip takes in the products N columns wide.
template <int NP>
__host__ __device__ constexpr int wide_tn() { return NP >= 64 ? 4 : 2; }

// 16 bytes global -> shared by cp.async, zero-filled when !ok (src is then
// not read, but must be a valid address).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Wait for this thread's cp.async copies; a __syncthreads() after it makes
// every thread's copies visible.
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows r < nrows of cols floats (cols % 4 == 0) into dst[r * ld + j] from
// src + r * stride + j, zero where r >= vrows or j >= vcols (vcols % 4 ==
// 0); src, stride and ld keep every row 16-byte aligned.  Asynchronous: all
// of a chunk's copies are in flight together until cp_wait_all().
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long stride, int nrows,
                                          int cols, int vrows, int vcols) {
  const int per_row = cols / 4;
  for (int idx = threadIdx.x; idx < nrows * per_row; idx += THREADS) {
    const int r = idx / per_row, j = 4 * (idx % per_row);
    const bool ok = r < vrows && j < vcols;
    cp16(dst + r * ld + j, ok ? src + r * stride + j : src, ok);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One warp, lane t = step t of the chunk: dA_t = dt_t a, e^cum_t with cum_t
// the sum over [0, t], e^rest_t with rest_t the sum over (t, Q), w_t =
// e^rest_t dt_t and the chunk's decay e^(sum over [0, Q)).  Every dA has one
// sign, so each sum adds terms of one sign.
__device__ __forceinline__ void chunk_scalars(const float* dts, float a,
                                              float* dAs, float* ecum,
                                              float* erest, float* ws,
                                              float* decv) {
  const int lane = threadIdx.x % 32;
  const float d = dts[lane] * a;
  float cum = d, rest = d;
#pragma unroll
  for (int k = 1; k < 32; k *= 2) {
    const float u = __shfl_up_sync(FULL, cum, k);
    const float v = __shfl_down_sync(FULL, rest, k);
    if (lane >= k) cum += u;
    if (lane + k < 32) rest += v;
  }
  rest = __shfl_down_sync(FULL, rest, 1);   // sum over (t, Q)
  if (lane == 31) rest = 0.f;
  const float er = expf(rest);
  dAs[lane] = d;
  ecum[lane] = expf(cum);
  erest[lane] = er;
  ws[lane] = er * dts[lane];
  if (lane == 31) *decv = expf(cum);
}

// Shared memory of ssd_bwd_state_kernel (floats): the state S (PS x LDN),
// x of the chunk (Q x LDP), B (Q x LDN), then dt, dA, e^cum, e^rest, w and
// the decay.
template <int NP>
struct StateLayout {
  static constexpr int LDN = NP + 4;
  static constexpr int kS = 0;
  static constexpr int kX = kS + PS * LDN;
  static constexpr int kB = kX + Q * LDP;
  static constexpr int kVec = kB + Q * LDN;
  static constexpr int kBytes = 4 * (kVec + 5 * Q + 4);
};

// Block (b, h) x slab: the entering state of every chunk, in order, to
// enter (batch x H, chunks, P, NP).
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     float* __restrict__ enter, int seq, int heads, int P,
                     int groups, int N, int a_stride) {
  using L = StateLayout<NP>;
  constexpr int LDN = L::LDN;
  extern __shared__ __align__(16) float sm[];
  float* Ss = sm + L::kS;
  float* Xs = sm + L::kX;
  float* Bs = sm + L::kB;
  float* dts = sm + L::kVec;
  float* dAs = dts + Q;
  float* ecum = dAs + Q;
  float* erest = ecum + Q;
  float* ws = erest + Q;
  float* decv = ws + Q;

  const int tid = threadIdx.x, warp = tid / 32;
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int p0 = blockIdx.y * PS, prow = min(PS, P - p0);
  const int g = h / (heads / groups);
  const int nchunks = (seq + Q - 1) / Q;
  const float a = A[static_cast<long long>(b) * a_stride + h];
  const long long HP = static_cast<long long>(heads) * P;
  const long long GN = static_cast<long long>(groups) * N;
  const float* xb = x + static_cast<long long>(b) * seq * HP +
                    static_cast<long long>(h) * P + p0;
  const float* Bb = Bm + static_cast<long long>(b) * seq * GN +
                    static_cast<long long>(g) * N;
  const float* dtb = dt + static_cast<long long>(b) * seq * heads + h;
  float* sinb = enter + (static_cast<long long>(bh) * nchunks * P + p0) * NP;

  for (int idx = tid; idx < PS * LDN; idx += THREADS) Ss[idx] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Q, tv = min(Q, seq - t0);
    __syncthreads();   // the previous chunk's update is done
    load_rows(Xs, LDP, xb + t0 * HP, HP, Q, PS, tv, prow);
    load_rows(Bs, LDN, Bb + t0 * GN, GN, Q, NP, tv, N);
    if (tid < Q) dts[tid] = tid < tv ? dtb[static_cast<long long>(t0 + tid) * heads] : 0.f;
    cp_wait_all();
    // The state entering chunk c.
    float* out = sinb + static_cast<long long>(c) * P * NP;
    for (int idx = tid; idx < prow * (NP / 4); idx += THREADS) {
      const int p = idx / (NP / 4), n = 4 * (idx % (NP / 4));
      *reinterpret_cast<float4*>(out + static_cast<long long>(p) * NP + n) =
          *reinterpret_cast<const float4*>(Ss + p * LDN + n);
    }
    __syncthreads();
    if (warp == 0) chunk_scalars(dts, a, dAs, ecum, erest, ws, decv);
    __syncthreads();
    for (int idx = tid; idx < Q * PS; idx += THREADS) {
      const int s = idx / PS, p = idx % PS;
      Xs[s * LDP + p] *= ws[s];
    }
    __syncthreads();
    // S = dec S + (X o w)^T . B.
    const float dec = *decv;
    block_mm<PS, NP, Q, wide_tn<NP>()>(View<1, LDP>{Xs}, View<1, LDN>{Bs},
                [&](int p, int n, float v) {
                  Ss[p * LDN + n] = dec * Ss[p * LDN + n] + v;
                });
  }
}

// Shared memory of ssd_bwd_chunk_kernel (floats): G and S_in (PS x LDN);
// x, gy and the intra-chunk dx (Q x LDP); B, C, X.G and gy.S_in (Q x LDN);
// C.B^T, gy.X^T, L, M = CB o L o dt and dS (Q x LDQ); then dt, dA, e^cum,
// e^rest, w, the F and K' terms and the decay; the warps' partial sums.
template <int NP>
struct ChunkLayout {
  static constexpr int LDN = NP + 4;
  static constexpr int kG = 0;
  static constexpr int kSin = kG + PS * LDN;
  static constexpr int kX = kSin + PS * LDN;
  static constexpr int kGY = kX + Q * LDP;
  static constexpr int kDX = kGY + Q * LDP;
  static constexpr int kB = kDX + Q * LDP;
  static constexpr int kC = kB + Q * LDN;
  static constexpr int kXG = kC + Q * LDN;
  static constexpr int kGYS = kXG + Q * LDN;
  static constexpr int kCB = kGYS + Q * LDN;
  static constexpr int kD = kCB + Q * LDQ;
  static constexpr int kL = kD + Q * LDQ;
  static constexpr int kM = kL + Q * LDQ;
  static constexpr int kDS = kM + Q * LDQ;
  static constexpr int kVec = kDS + Q * LDQ;
  static constexpr int kPart = kVec + 8 * Q;
  static constexpr int kBytes = 4 * (kPart + 2 * WARPS * Q + WARPS);
};

// The partial outputs of one (head, slab), in scratch: dB and dC
// (slabs, batch, S, H, N), ddt (slabs, batch, S, H), dA (slabs, batch, H,
// chunks).
struct Partials {
  float* dB;
  float* dC;
  float* ddt;
  float* dA;
};

// Block (b, h) x slab: the chunks backwards from gfin.
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ gy,
                     const float* __restrict__ gfin,
                     const float* __restrict__ enter, float* __restrict__ dx,
                     Partials part, int batch, int seq, int heads, int P,
                     int groups, int N, int a_stride) {
  using L = ChunkLayout<NP>;
  constexpr int LDN = L::LDN;
  extern __shared__ __align__(16) float sm[];
  float* Gs = sm + L::kG;
  float* Sin = sm + L::kSin;
  float* Xs = sm + L::kX;
  float* GYs = sm + L::kGY;
  float* DXs = sm + L::kDX;
  float* Bs = sm + L::kB;
  float* Cs = sm + L::kC;
  float* XGs = sm + L::kXG;
  float* GYSs = sm + L::kGYS;
  float* CBs = sm + L::kCB;
  float* Ds = sm + L::kD;
  float* Ls = sm + L::kL;
  float* Ms = sm + L::kM;
  float* DSs = sm + L::kDS;
  float* dts = sm + L::kVec;
  float* dAs = dts + Q;
  float* ecum = dAs + Q;
  float* erest = ecum + Q;
  float* ws = erest + Q;
  float* Fv = ws + Q;
  float* Kv = Fv + Q;
  float* decv = Kv + Q;
  float* part1 = sm + L::kPart;      // [WARPS][Q]
  float* part2 = part1 + WARPS * Q;  // [WARPS][Q]
  float* red = part2 + WARPS * Q;    // [WARPS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int slab = blockIdx.y, p0 = slab * PS, prow = min(PS, P - p0);
  const int g = h / (heads / groups);
  const int nchunks = (seq + Q - 1) / Q;
  const float a = A[static_cast<long long>(b) * a_stride + h];
  const long long HP = static_cast<long long>(heads) * P;
  const long long GN = static_cast<long long>(groups) * N;
  const long long xoff = static_cast<long long>(b) * seq * HP +
                         static_cast<long long>(h) * P + p0;
  const float* xb = x + xoff;
  const float* gyb = gy + xoff;
  float* dxb = dx + xoff;
  const long long boff = static_cast<long long>(b) * seq * GN +
                         static_cast<long long>(g) * N;
  const float* Bb = Bm + boff;
  const float* Cb = Cm + boff;
  const float* dtb = dt + static_cast<long long>(b) * seq * heads + h;
  const float* sinb = enter + (static_cast<long long>(bh) * nchunks * P + p0) * NP;
  // Row (b, t = 0, h) of this slab's partials.
  const long long prow0 =
      (static_cast<long long>(slab) * batch + b) * seq * heads + h;
  float* dBp = part.dB + prow0 * N;
  float* dCp = part.dC + prow0 * N;
  float* ddtp = part.ddt + prow0;
  float* dAp = part.dA +
               ((static_cast<long long>(slab) * batch + b) * heads + h) * nchunks;

  load_rows(Gs, LDN, gfin + (static_cast<long long>(bh) * P + p0) * N, N, PS,
            NP, prow, N);
  cp_wait_all();
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * Q, tv = min(Q, seq - t0);
    __syncthreads();   // the previous chunk is done with every buffer
    load_rows(Xs, LDP, xb + t0 * HP, HP, Q, PS, tv, prow);
    load_rows(GYs, LDP, gyb + t0 * HP, HP, Q, PS, tv, prow);
    load_rows(Bs, LDN, Bb + t0 * GN, GN, Q, NP, tv, N);
    load_rows(Cs, LDN, Cb + t0 * GN, GN, Q, NP, tv, N);
    load_rows(Sin, LDN, sinb + static_cast<long long>(c) * P * NP, NP, PS, NP,
              prow, NP);
    if (tid < Q) dts[tid] = tid < tv ? dtb[static_cast<long long>(t0 + tid) * heads] : 0.f;
    cp_wait_all();
    __syncthreads();
    if (warp == 0) chunk_scalars(dts, a, dAs, ecum, erest, ws, decv);
    // CB = C . B^T and D = gy . X^T.
    block_mm<Q, Q, NP, 1>(View<LDN, 1>{Cs}, View<LDN, 1>{Bs},
                [&](int t, int s, float v) { CBs[t * LDQ + s] = v; });
    block_mm<Q, Q, PS, 1>(View<LDP, 1>{GYs}, View<LDP, 1>{Xs},
                [&](int t, int s, float v) { Ds[t * LDQ + s] = v; });
    __syncthreads();
    // L[t][s] = e^(sum over (s, t] of dA), taken directly: thread (t, k)
    // sums over (4k + 3, t] once, then adds one step a column down to 4k;
    // M = CB o L o dt and dS = D o L o dt.
    {
      static_assert(THREADS == 8 * Q, "a thread four columns of a row");
      const int t = tid / 8, k = tid % 8;
      float seg = 0.f;
      for (int r = t; r > 4 * k + 3; --r) seg += dAs[r];
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const int s = 4 * k + j;
        const float l = s <= t ? expf(seg) : 0.f;
        if (s <= t) seg += dAs[s];
        const float lds = l * dts[s];
        Ls[t * LDQ + s] = l;
        Ms[t * LDQ + s] = CBs[t * LDQ + s] * lds;
        DSs[t * LDQ + s] = Ds[t * LDQ + s] * lds;
      }
    }
    __syncthreads();
    // The intra-chunk dx = M^T . gy, X . G and gy . S_in.
    block_mm<Q, PS, Q, 2>(View<1, LDQ>{Ms}, View<1, LDP>{GYs},
                [&](int s, int p, float v) { DXs[s * LDP + p] = v; });
    block_mm<Q, NP, PS, wide_tn<NP>()>(View<LDP, 1>{Xs}, View<1, LDN>{Gs},
                [&](int s, int n, float v) { XGs[s * LDN + n] = v; });
    block_mm<Q, NP, PS, wide_tn<NP>()>(View<LDP, 1>{GYs}, View<1, LDN>{Sin},
                [&](int t, int n, float v) { GYSs[t * LDN + n] = v; });
    __syncthreads();
    // dx = M^T . gy + diag(w) . B . G^T.
    block_mm<Q, PS, NP, 2>(View<LDN, 1>{Bs}, View<LDN, 1>{Gs},
                [&](int s, int p, float v) {
                  if (s < tv && p < prow)
                    dxb[(t0 + s) * HP + p] = DXs[s * LDP + p] + ws[s] * v;
                });
    // dC_h = dS . B + diag(e^cum) . gy . S_in; dB_h = dS^T . C + diag(w) . X . G.
    block_mm<Q, NP, Q, wide_tn<NP>()>(View<LDQ, 1>{DSs}, View<1, LDN>{Bs},
                [&](int t, int n, float v) {
                  if (t < tv && n < N)
                    dCp[static_cast<long long>(t0 + t) * heads * N + n] =
                        v + ecum[t] * GYSs[t * LDN + n];
                });
    block_mm<Q, NP, Q, wide_tn<NP>()>(View<1, LDQ>{DSs}, View<1, LDN>{Cs},
                [&](int s, int n, float v) {
                  if (s < tv && n < N)
                    dBp[static_cast<long long>(t0 + s) * heads * N + n] =
                        v + ws[s] * XGs[s * LDN + n];
                });
    // The decay gradients' terms.  Warp w takes rows t = w + 8i: F_t =
    // e^cum_t C_t . (gy . S_in)_t and K'_t = e^rest_t B_t . (X . G)_t; over
    // lane s of row t, E = dS o CB summed over s < r for r <= t (part1), and
    // the column sums of D o L o CB (part2).
    float t1 = 0.f, col = 0.f;
#pragma unroll
    for (int i = 0; i < Q / WARPS; ++i) {
      const int t = warp + WARPS * i;
      float f = 0.f, k = 0.f;
      for (int n = lane; n < NP; n += 32) {
        f += GYSs[t * LDN + n] * Cs[t * LDN + n];
        k += XGs[t * LDN + n] * Bs[t * LDN + n];
      }
      f = warp_sum(f);
      k = warp_sum(k);
      if (lane == 0) {
        Fv[t] = ecum[t] * f;
        Kv[t] = erest[t] * k;
      }
      const float cb = CBs[t * LDQ + lane];
      float incl = DSs[t * LDQ + lane] * cb;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float u = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += u;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);   // sum over s < lane
      if (lane == 0) excl = 0.f;
      if (t >= lane) t1 += excl;
      col += Ds[t * LDQ + lane] * Ls[t * LDQ + lane] * cb;
    }
    part1[warp * Q + lane] = t1;
    part2[warp * Q + lane] = col;
    float hs = 0.f;   // <G, S_in> of this slab
    for (int idx = tid; idx < PS * NP; idx += THREADS) {
      const int p = idx / NP, n = idx % NP;
      hs += Gs[p * LDN + n] * Sin[p * LDN + n];
    }
    hs = warp_sum(hs);
    if (lane == 0) red[warp] = hs;
    // gy o e^cum for G's update (no product reads gy any more).
    for (int idx = tid; idx < Q * PS; idx += THREADS) {
      const int t = idx / PS, p = idx % PS;
      GYs[t * LDP + p] *= ecum[t];
    }
    __syncthreads();
    if (warp == 0) {
      float T1 = 0.f, colsum = 0.f, H = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        T1 += part1[w * Q + lane];
        colsum += part2[w * Q + lane];
        H += red[w];
      }
      float fs = Fv[lane];   // sum over t >= lane
      float kp = dts[lane] * Kv[lane];
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float v = __shfl_down_sync(FULL, fs, d);
        const float u = __shfl_up_sync(FULL, kp, d);
        if (lane + d < 32) fs += v;
        if (lane >= d) kp += u;
      }
      float ks = __shfl_up_sync(FULL, kp, 1);   // sum over s < lane
      if (lane == 0) ks = 0.f;
      const float dd = T1 + fs + *decv * H + ks;
      if (lane < tv)
        ddtp[static_cast<long long>(t0 + lane) * heads] = a * dd + colsum + Kv[lane];
      const float da = warp_sum(dts[lane] * dd);
      if (lane == 0) dAp[c] = da;
    }
    // G = dec G + (gy o e^cum)^T . C: the gradient of the state entering
    // this chunk, which leaves the one before.
    const float dec = *decv;
    block_mm<PS, NP, Q, wide_tn<NP>()>(View<1, LDP>{GYs}, View<1, LDN>{Cs},
                [&](int p, int n, float v) {
                  Gs[p * LDN + n] = dec * Gs[p * LDN + n] + v;
                });
  }
}

// dB, dC (batch, S, G, N): the head partials of each group and the slabs,
// summed slab by slab, head by head; ddt over the slabs; dA over the slabs
// and the chunks in order.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(Partials part, float* __restrict__ ddt,
                      float* __restrict__ dA, float* __restrict__ dB,
                      float* __restrict__ dC, int batch, int seq, int heads,
                      int groups, int N, int nslab, int nchunks) {
  const long long nbc = static_cast<long long>(batch) * seq * groups * N;
  const long long nt = static_cast<long long>(batch) * seq * heads;
  const long long na = static_cast<long long>(batch) * heads;
  const long long total = 2 * nbc + nt + na;
  const int rep = heads / groups;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const long long j = is_c ? i - nbc : i;
      const long long bt = j / (static_cast<long long>(groups) * N);
      const int g = static_cast<int>((j / N) % groups);
      const int n = static_cast<int>(j % N);
      const float* src = is_c ? part.dC : part.dB;
      float s = 0.f;
      for (int sl = 0; sl < nslab; ++sl)
        for (int r = 0; r < rep; ++r)
          s += src[((sl * static_cast<long long>(batch) * seq + bt) * heads +
                    g * rep + r) * N + n];
      (is_c ? dC : dB)[j] = s;
    } else if (i < 2 * nbc + nt) {
      const long long j = i - 2 * nbc;
      float s = 0.f;
      for (int sl = 0; sl < nslab; ++sl) s += part.ddt[sl * nt + j];
      ddt[j] = s;
    } else {
      const long long j = i - 2 * nbc - nt;
      float s = 0.f;
      for (int sl = 0; sl < nslab; ++sl)
        for (int c = 0; c < nchunks; ++c)
          s += part.dA[(sl * na + j) * nchunks + c];
      dA[j] = s;
    }
  }
}

int padded_n(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128; }

// Scratch, in floats: the entering states, then the partial dB, dC, ddt
// and dA.
struct Scratch {
  long long enter, dB, dC, ddt, dA;
  long long total() const { return enter + dB + dC + ddt + dA; }
};

Scratch scratch_floats(int batch, int seq, int heads, int P, int N) {
  const long long chunks = (static_cast<long long>(seq) + Q - 1) / Q;
  const long long slabs = (P + PS - 1) / PS;
  const long long rows = slabs * batch * seq * heads;
  Scratch s;
  s.enter = static_cast<long long>(batch) * heads * chunks * P * padded_n(N);
  s.dB = s.dC = rows * N;
  s.ddt = rows;
  s.dA = slabs * batch * heads * chunks;
  return s;
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int NP>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* gy, const float* gfin, float* dx,
           float* ddt, float* dA, float* dB, float* dC, float* scratch,
           int batch, int seq, int heads, int P, int groups, int N,
           int a_stride, cudaStream_t stream) {
  const Scratch sc = scratch_floats(batch, seq, heads, P, N);
  float* enter = scratch;
  Partials part{enter + sc.enter, enter + sc.enter + sc.dB,
                enter + sc.enter + sc.dB + sc.dC,
                enter + sc.enter + sc.dB + sc.dC + sc.ddt};
  const int nslab = (P + PS - 1) / PS, nchunks = (seq + Q - 1) / Q;
  const dim3 grid(batch * heads, nslab);
  const int state_bytes = StateLayout<NP>::kBytes;
  cudaError_t err = allow_smem(ssd_bwd_state_kernel<NP>, state_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state_kernel<NP><<<grid, THREADS, state_bytes, stream>>>(
      x, dt, A, Bm, enter, seq, heads, P, groups, N, a_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk_bytes = ChunkLayout<NP>::kBytes;
  err = allow_smem(ssd_bwd_chunk_kernel<NP>, chunk_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<NP><<<grid, THREADS, chunk_bytes, stream>>>(
      x, dt, A, Bm, Cm, gy, gfin, enter, dx, part, batch, seq, heads, P, groups,
      N, a_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = 2 * static_cast<long long>(batch) * seq * groups * N +
                          static_cast<long long>(batch) * seq * heads +
                          static_cast<long long>(batch) * heads;
  const long long blocks = (total + THREADS - 1) / THREADS;
  ssd_bwd_reduce_kernel<<<static_cast<int>(blocks < 8192 ? blocks : 8192),
                          THREADS, 0, stream>>>(
      part, ddt, dA, dB, dC, batch, seq, heads, groups, N, nslab, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch repro_ssd_scan_bwd needs for these shapes (0 for none).
extern "C" long long repro_ssd_scan_bwd_scratch_bytes(int batch, int seq,
                                                      int heads, int P, int N) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || P <= 0 || N <= 0) return 0;
  return 4 * scratch_floats(batch, seq, heads, P, N).total();
}

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a shape the kernels do not take: N a multiple
// of 8 up to 128, P a multiple of 4, groups dividing heads, batch x heads
// blocks under 2^31, P / 64 blocks up to 65535.  scratch holds
// repro_ssd_scan_bwd_scratch_bytes, 16-byte aligned; every tensor is
// float32 and contiguous.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm,
                                  const void* gy, const void* gfin, void* dx,
                                  void* ddt, void* dA, void* dB, void* dC,
                                  void* scratch, int batch, int seq, int heads,
                                  int P, int groups, int N, int a_stride,
                                  void* stream) {
  if (batch <= 0 || heads <= 0 || P <= 0)
    return static_cast<int>(cudaGetLastError());
  if (groups <= 0 || heads % groups != 0 || N <= 0 || N % 8 != 0 ||
      N > 128 || P % 4 != 0 ||
      static_cast<long long>(batch) * heads > 0x7fffffff ||
      P > 65535LL * PS)
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
  auto* sc = static_cast<float*>(scratch);
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
