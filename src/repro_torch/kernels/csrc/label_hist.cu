// Per-client label histograms on Hopper: labels (B, n) int32 and valid (B, n)
// bool -> counts (B, C) float32.  Invalid entries and labels outside [0, C)
// count toward nothing.
//
// Replaces src/repro/kernels/label_hist/label_hist.py:label_hist_kernel (body
// _hist_kernel).  The TPU kernel walks the sample axis as a *sequential* grid
// dimension and keeps the (rows, C) accumulator in its output tile across grid
// steps; GPU blocks run in parallel and in no order, so that accumulator would
// race.
//
// Bound on the card: bytes (5 a sample read once, 4C a row written once).  The
// work is cut to fill the card whatever B and n are.  A *team* of threads
// counts one segment of one row; the Python plan (kernels/label_hist/
// label_hist.py:plan_hist) sets the team's width and the segment's length:
//   * short rows: one warp a row, a few rows a block;
//   * longer rows: 2-8 warps of one block share a row;
//   * long rows: a row is cut into chunks, one block of 8 warps a chunk, and
//     each block adds its partial counts into a zeroed output with global
//     atomicAdd.  Partial counts are integers below 2^24, so float adds of
//     them are exact in any order.
// Counting takes no contended atomics:
//   * C <= 32: lane c of each warp of a team owns bin c.  Each
//     lane first counts its own samples in registers, four classes a
//     register in 8-bit fields (R = ceil(C / 4) registers, a template
//     argument), and the lanes fold them into the bins with
//     __reduce_add_sync (two a register, fields in 16-bit halves) before a
//     field can reach 256.  No shared memory, no atomics, no vote: a sample
//     costs about 13 instructions a lane at C = 10 (one compare and add a
//     register).  One __ballot_sync a class for each 32 samples costs 3C
//     instructions a 32 samples and measured slower (PERF.md, section 6).
//   * C > 32: each warp counts into its own sub-histogram in shared memory, so
//     only a warp's own lanes contend; a team sums its warps' bins once.
// Loads: labels as int4 and valid as 4-byte words, four samples a lane and
// kUnroll loads in flight a lane (a row of 290 in one batch at one warp),
// from the first sample of the segment whose label address is 16-byte
// aligned.  The head and tail (at most three samples each) go one a lane of
// the team's first warp, loaded and counted with its first batch.  Where the
// two arrays' addresses differ in phase modulo 4 samples (a view at an odd
// offset), the whole segment goes scalar.
// Stores: a row that is not cut writes each bin once as float; a chunk adds
// each non-zero bin once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;   // the key of a sample counted nowhere
constexpr int kMaxWarps = 8;              // warps a block (the plan's MAX_WARPS)
constexpr int kUnroll = 5;                // 16-byte label loads a lane in flight
constexpr int kFieldMax = 255;            // samples a lane between two folds
constexpr int kMinBlocks = 4;             // resident blocks of 8 warps an SM

struct Plan {
  long long rows, n, chunk;
  int num_classes, rows_per_block, team_threads, chunks_per_row;
};

// Counts of one warp of a team.  R > 0: lane c's bin `bin` and each lane's
// own counts in `field` (class 4r + k in bits 8k..8k+7 of field[r]); R == 0:
// the warp's shared-memory bins.
template <int R>
struct Counter {
  unsigned field[R > 0 ? R : 1];
  unsigned bin = 0;
  int pending = 0;                        // samples a lane since the last fold
  int* bins;
  int num_classes;

  __device__ Counter(int* b, int c) : bins(b), num_classes(c) {
#pragma unroll
    for (int r = 0; r < R; ++r) field[r] = 0;
  }

  // Fold the lanes' fields into their bins: lane 4r + k takes the warp's
  // sum of field k of register r.
  __device__ void fold(int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned even = __reduce_add_sync(kFull, field[r] & 0x00ff00ffu);
      const unsigned odd =
          __reduce_add_sync(kFull, (field[r] >> 8) & 0x00ff00ffu);
      if ((lane >> 2) == r) {
        const unsigned s = (lane & 1) ? odd : even;
        bin += (lane & 2) ? (s >> 16) : (s & 0xffffu);
      }
      field[r] = 0;
    }
    pending = 0;
  }

  // Make room for `count` more samples a lane (uniform over the warp).
  __device__ void reserve(int count, int lane) {
    if constexpr (R > 0) {
      if (pending + count > kFieldMax) fold(lane);
      pending += count;
    }
  }

  __device__ void add(unsigned key) {
    if constexpr (R > 0) {
      const unsigned q = key >> 2;
      const unsigned inc = 1u << ((key & 3u) << 3);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (q == static_cast<unsigned>(r)) field[r] += inc;
    } else {
      if (key < static_cast<unsigned>(num_classes)) atomicAdd(&bins[key], 1);
    }
  }
};

__device__ __forceinline__ unsigned key_of(bool ok, int label) {
  return ok ? static_cast<unsigned>(label) : kNone;
}

// One team's samples [0, len) from `lab`/`val`: the body [a, b) in nv
// 16-byte label loads, the head [0, a) and tail [b, len) (`scalar` samples).
struct Segment {
  const int32_t* lab;
  const uint8_t* val;
  int a, b, nv, scalar;
  bool vec;

  __device__ Segment(const int32_t* labels, const uint8_t* valid,
                     const Plan& p, int team) {
    long long s = 0;
    int len = 0;
    if (team < p.rows * p.chunks_per_row) {
      const int row =
          p.chunks_per_row == 1 ? team : team / p.chunks_per_row;
      const long long k = team - static_cast<long long>(row) * p.chunks_per_row;
      s = row * p.n + k * p.chunk;
      len = static_cast<int>(min(p.chunk, p.n - k * p.chunk));
    }
    lab = labels + s;
    val = valid + s;
    const uintptr_t la = reinterpret_cast<uintptr_t>(lab);
    vec = (((la >> 2) - reinterpret_cast<uintptr_t>(val)) & 3) == 0;
    a = b = len;
    if (vec) {
      a = min(len, static_cast<int>((0 - (la >> 2)) & 3));
      b = a + ((len - a) & ~3);
    }
    nv = (b - a) >> 2;
    scalar = a + (len - b);
  }

  // Head or tail sample j of [0, scalar).
  __device__ unsigned edge_key(int j) const {
    const int g = j < a ? j : b + (j - a);
    return key_of(__ldg(val + g), __ldg(lab + g));
  }
};

// kUnroll 16-byte loads a lane (vectors base + u * team_threads + lane) and,
// in a team's first batch, one head or tail sample a lane of its first
// warp.
struct Batch {
  int4 l[kUnroll];
  uint32_t w[kUnroll];
  unsigned edge;

  __device__ void load(const Segment& g, int base, int team_threads,
                       int lane, bool with_edges) {
    const int4* lab4 = reinterpret_cast<const int4*>(g.lab + g.a);
    const uint32_t* val4 = reinterpret_cast<const uint32_t*>(g.val + g.a);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * team_threads + lane;
      l[u] = make_int4(0, 0, 0, 0);
      w[u] = 0;
      if (v < g.nv) {
        l[u] = __ldg(lab4 + v);
        w[u] = __ldg(val4 + v);
      }
    }
    edge = with_edges && g.vec && lane < g.scalar ? g.edge_key(lane) : kNone;
  }

  template <int R>
  __device__ void count(Counter<R>& cnt, const Segment& g, int base,
                        int team_threads, int lane, bool with_edges) const {
    cnt.reserve(4 * kUnroll + 1, lane);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * team_threads >= g.nv) break;   // no lane has a load
      cnt.add(key_of(w[u] & 0xffu, l[u].x));
      cnt.add(key_of(w[u] & 0xff00u, l[u].y));
      cnt.add(key_of(w[u] & 0xff0000u, l[u].z));
      cnt.add(key_of(w[u] & 0xff000000u, l[u].w));
    }
    if (with_edges) cnt.add(edge);
  }
};

// A team is p.team_threads threads: 1, 2, 4 or 8 whole warps.  Each of a
// team's warps counts its part of the team's segment; a team of several warps
// sums them through shared memory.
template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
label_hist_kernel(const int32_t* __restrict__ labels,
                  const uint8_t* __restrict__ valid, float* __restrict__ out,
                  const Plan p) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team_threads = p.team_threads;
  const int team_in_block = threadIdx.x >> (__ffs(team_threads) - 1);
  const int rank = threadIdx.x & (team_threads - 1);
  const int warp_rank = rank - lane;         // this warp's first rank
  const bool lead = warp_rank == 0;          // the team's first warp
  const int team = blockIdx.x * p.rows_per_block + team_in_block;
  const bool live = team < p.rows * p.chunks_per_row;
  const bool split = p.chunks_per_row > 1;
  const Segment seg(labels, valid, p, team);

  Counter<R> cnt(smem + warp * p.num_classes, p.num_classes);
  if constexpr (R == 0) {
    for (int c = lane; c < p.num_classes; c += 32) cnt.bins[c] = 0;
    __syncwarp();
  }
  // The first batch carries the head and tail samples (the lead warp's).
  if (warp_rank < seg.nv || lead) {
    Batch x;
    x.load(seg, warp_rank, team_threads, lane, lead);
    x.count(cnt, seg, warp_rank, team_threads, lane, lead);
  }
  const int step = team_threads * kUnroll;
  for (int base = warp_rank + step; base < seg.nv; base += step) {
    Batch x;
    x.load(seg, base, team_threads, lane, false);
    x.count(cnt, seg, base, team_threads, lane, false);
  }
  if (!seg.vec) {                            // every sample one a lane
    for (int base = warp_rank; base < seg.scalar; base += team_threads) {
      const int j = base + lane;
      cnt.reserve(1, lane);
      cnt.add(j < seg.scalar ? seg.edge_key(j) : kNone);
    }
  }

  // Fold the team's warps and write each bin once: a store when the team
  // owns the whole row, an add of the non-zero bins when it owns a chunk.
  const int row = split ? team / p.chunks_per_row : team;
  float* o = out + static_cast<long long>(row) * p.num_classes;
  if constexpr (R > 0) {
    cnt.fold(lane);
    unsigned bin = cnt.bin;
    if (team_threads > 32) {
      smem[threadIdx.x] = static_cast<int>(bin);
      __syncthreads();
      if (!lead) return;
      for (int w = 32; w < team_threads; w += 32)
        bin += smem[threadIdx.x + w];
    }
    if (!live || lane >= p.num_classes) return;
    if (!split) o[lane] = static_cast<float>(bin);
    else if (bin) atomicAdd(o + lane, static_cast<float>(bin));
  } else {
    if (team_threads > 32) __syncthreads();
    else __syncwarp();
    if (!live) return;
    const int* team_bins = smem + (warp - (warp_rank >> 5)) * p.num_classes;
    for (int c = rank; c < p.num_classes; c += team_threads) {
      int sum = 0;
      for (int w = 0; w < team_threads / 32; ++w)
        sum += team_bins[w * p.num_classes + c];
      if (!split) o[c] = static_cast<float>(sum);
      else if (sum) atomicAdd(o + c, static_cast<float>(sum));
    }
  }
}

template <int R>
void launch(const int32_t* labels, const uint8_t* valid, float* out,
            const Plan& p, long long blocks, int smem_bytes,
            cudaStream_t stream) {
  const int threads = p.rows_per_block * p.team_threads;
  label_hist_kernel<R><<<static_cast<unsigned>(blocks), threads, smem_bytes,
                         stream>>>(labels, valid, out, p);
}

}  // namespace

// Launches one plan (kernels/label_hist/label_hist.py:HistPlan): `blocks`
// blocks of rows_per_block teams of team_threads threads (32, 64, 128 or
// 256), `smem_bytes` of dynamic shared memory (at most 48 KB).
// The caller zeroes `out` when chunks_per_row > 1.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_label_hist(const void* labels, const void* valid,
                                void* out, long long rows, long long n,
                                int num_classes, int rows_per_block,
                                int team_threads, int chunks_per_row,
                                long long chunk, long long blocks,
                                int smem_bytes, void* stream) {
  const Plan p{rows, n, chunk, num_classes, rows_per_block, team_threads,
               chunks_per_row};
  const auto* lab = static_cast<const int32_t*>(labels);
  const auto* val = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    switch (num_classes <= 32 ? (num_classes + 3) / 4 : 0) {
      case 1: launch<1>(lab, val, o, p, blocks, smem_bytes, s); break;
      case 2: launch<2>(lab, val, o, p, blocks, smem_bytes, s); break;
      case 3: launch<3>(lab, val, o, p, blocks, smem_bytes, s); break;
      case 4: launch<4>(lab, val, o, p, blocks, smem_bytes, s); break;
      case 5: launch<5>(lab, val, o, p, blocks, smem_bytes, s); break;
      case 6: launch<6>(lab, val, o, p, blocks, smem_bytes, s); break;
      case 7: launch<7>(lab, val, o, p, blocks, smem_bytes, s); break;
      case 8: launch<8>(lab, val, o, p, blocks, smem_bytes, s); break;
      default: launch<0>(lab, val, o, p, blocks, smem_bytes, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
