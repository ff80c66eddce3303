// Streamed-noise kernels for Hopper (sm_90a), with a plain C interface.
//
// Both kernels read member noise straight from the shared float32 noise
// table and never materialize a member's noise vector.  They are the
// counterparts of the two Pallas TPU kernels in
// estorch_tpu/ops/pallas_noise.py; their plain PyTorch versions live in
// estorch_tpu_torch/ops/noise_kernels.py, which also builds this file
// (ops/_build.py) and binds it with ctypes.
//
// Every launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// seen by the caller.
//
// Out-of-range table offsets follow jax.lax.dynamic_slice, which the JAX
// package's table slices use: a negative start counts from the end, then the
// start is clamped to [0, table_size - length].  In-range offsets (what the
// engine samples) are unchanged.

#include <cooperative_groups.h>
#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ int64_t slice_start(int64_t start, int64_t table_size,
                                               int64_t max_start) {
  if (start < 0) start += table_size;
  return start < 0 ? 0 : (start > max_start ? max_start : start);
}

// ---------------------------------------------------------------------------
// weighted_noise_sum: out[j] = sum_k w[k] * table[s_k + j], j < dim,
//   s_k = slice_start(o[k]), summed in float64
//
// Replaces estorch_tpu/ops/pallas_noise.py:weighted_noise_sum
// (_weighted_sum_kernel), the ES update reduction.
//
// Bound on this card: bytes.  The distinct table floats the rows cover are
// read once (32.3 MB at the Pendulum MLP64x64 pop-4096 shape, n = 2048 rows
// of dim 4481 from a 2^25-float table), for 2 flops per float.  An exact
// kernel moves more than that from L2: each table element meets one weight
// per row that covers it, and feeds another output column for each, so n *
// dim floats cross from L2 to the SMs however the rows overlap.  The
// distinct bytes are what must come from HBM.
//
// Design.  The TPU kernel keeps the whole output in VMEM and walks the rows
// in order.  Here the sum is one launch (two where the rows are sorted: the
// sort first), and no partial sum goes to global memory:
//  - A window of output columns belongs to a cluster of G blocks (1 to 8).
//    A block's 8 warps stand in R row groups of 8 / R warps side by side;
//    a warp covers 32 * C neighbouring columns (C = 1, 2 or 4 a lane, each
//    lane C float64 sums in registers), so a window is 256 * C / R columns.
//    The rows are split over the cluster's P = R * G row groups: group q
//    takes visiting positions q, q + P, q + 2P, ...  A warp's rows come 32
//    at a time (lane l loads the l-th one's start and weight, broadcast by
//    shuffles when its turn comes; where a group has one batch of rows, it
//    is loaded once for all windows), and 16 table loads a lane are issued
//    before their FMAs, unconditionally, so that all are in flight.
//  - The block adds its row groups' sums in shared memory in group order;
//    block r of the cluster then adds the G blocks' sums of its share of the
//    window in rank order through distributed shared memory and writes
//    them.  There are no atomics: the same inputs give the same bits.
//  - The grid holds as many clusters as stay resident (4 blocks an SM); each
//    walks windows w, w + clusters, ...  The last window ends at dim (it
//    overlaps the one before and writes the same bits there).
//  - Visiting order.  Where the table is larger than L2, each of its floats
//    meets kSortOverlap rows or more on average (n * dim >= 4 * table size)
//    and n <= kSortRows, sort_row_starts (one block: a bitonic sort of the
//    (clamped start, row) keys in shared memory) writes the rows' starts and
//    weights in that order into the caller's scratch, and the windows in
//    flight walk the sorted rows together.  Neighbouring sorted rows share
//    most of their table lines (dim - gap of them, gap ~ table / n), so a
//    line comes from HBM about once and its other uses hit in L2.  Visited
//    by index, the rows that share a line come a whole pass over the table
//    apart, after L2 has evicted it.  Elsewhere the rows are visited by
//    index and nothing is sorted: the sort's launch costs more than it
//    saves where the table stays in L2 (pong84's 2^23 floats) or the rows
//    overlap little (the recurrent shape's 1.5 rows a float), and rows that
//    do not overlap (the cell's and the host paths') gain nothing from it.
//  - Mapping: sum_mapping below.
//
// The sum is carried in float64 and rounded to float32 once, as the plain
// version's is.  A float32 product is exact in float64, so both sums are
// within a few float64 ulps of the exact one and round to the same float32
// but for a tie-near value, whatever their order.  A float32 accumulator
// would leave the result depending on the order, and Adam's per-coordinate
// normalisation turns that rounding into parameter differences of up to
// lr * |rounding| / |g_j| where a coordinate's gradient g_j is small.
//
// Tried on the card and not kept (each slower than this design at most of
// chip_smoke.py's shapes): each block sorting the rows itself in shared
// memory (the sort then costs every block); one column a lane at 8 blocks
// an SM (32 registers: spills); 5 or 6 blocks an SM; 16-warp blocks; the
// next step's loads, or the next batch's rows, issued before a step's
// FMAs, and C = 8 or 16 (spills at 64 registers); 32 loads a lane; loads
// predicated on the row and column instead of unconditional (several times
// slower); every overlapping shape sorted.
//
// What Hopper offers: clusters with distributed shared memory carry the
// split-row sum at small dims (the cell's 4481 columns make 36 windows of
// 128), which this kernel's first, two-pass version (weighted_sum_partials
// + sum_partials) wrote to a (ceil(n / 64), dim) float64 buffer in global
// memory and read back in a second launch.  Rows start at arbitrary float
// offsets, so 16-byte loads and TMA would need an aligned interior with
// scalar ends; at the pong84 shape both kernels already read at about the
// L2's rate, so that lead is left open.  wgmma has nothing to reuse: each
// table element meets one weight a row.
// ---------------------------------------------------------------------------

constexpr int kSumWarps = 8;
constexpr int kSumThreads = kSumWarps * kWarp;
constexpr int kNominalSMs = 132;        // the mapping's, fixed: see sum_mapping
constexpr int kSumBlocksPerSM = 4;      // resident: <= 64 registers a thread
constexpr int kLoadsInFlight = 16;      // table loads a lane issues before their FMAs
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kSumCols = 4;             // columns a lane, where dim allows
constexpr int kTargetBlocks = 2 * kNominalSMs;
constexpr int64_t kL2Floats = (50 << 20) / 4;  // the H100's L2, in table floats
constexpr int kSortOverlap = 4;          // rows a table float meets, on average, to sort
constexpr int kSortThreads = 1024;
constexpr int kSortRows = 8192;         // rows the sort kernel takes (64 KB of keys)
constexpr int kKeyIndexBits = 13;       // log2(kSortRows): a key is start << 13 | row
constexpr int kMaxSumRows = 65535 * 64;

struct SumMapping {
  int cols;        // C: columns a lane, 32 * C a warp
  int row_groups;  // R: row groups a block, 8 / R warps side by side in each
  int cluster;     // G: blocks a window
  bool sorted;     // rows visited by clamped start (else by index)
};

// A function of (n, dim, table size) only, never of the card: the order of
// the float64 sum follows from it, and the same inputs give the same bits
// on any card.  C = kSumCols where dim allows.  Rows are split over the 8
// warps of a block (R = 8), and over a cluster of G blocks until the windows
// make kTargetBlocks blocks (G <= 8, and no more row groups than rows).
// Where the windows alone make them (G = 1), R is the largest whose windows,
// widening to 8 / R warps side by side, the resident blocks take in one
// round; where none is, R halves while a row group has fewer rows than a
// batch (32) and the windows still make kTargetBlocks blocks: fewer block
// sums for the same rows.
int64_t sum_windows(int dim, int cols, int row_groups) {
  const int64_t width = static_cast<int64_t>(kWarp) * cols * (kSumWarps / row_groups);
  return (dim + width - 1) / width;
}

SumMapping sum_mapping(int n, int dim, int64_t table_size) {
  SumMapping m{kSumCols, kSumWarps, 1,
               n >= 2 && n <= kSortRows && table_size > kL2Floats &&
                   static_cast<int64_t>(n) * dim >= kSortOverlap * table_size};
  while (m.cols > 1 && kWarp * m.cols > dim) m.cols /= 2;
  const int64_t windows = sum_windows(dim, m.cols, m.row_groups);
  while (m.cluster < kMaxCluster && windows * m.cluster < kTargetBlocks &&
         m.cluster * m.row_groups < n) {
    m.cluster *= 2;
  }
  if (m.cluster > 1) return m;
  for (int r = kSumWarps; r >= 1; r /= 2) {  // the largest R whose windows take one round
    if (sum_windows(dim, m.cols, r) <= kNominalSMs * kSumBlocksPerSM) {
      m.row_groups = r;
      return m;
    }
  }
  while (m.row_groups > 1 && n / m.row_groups < kWarp &&
         sum_windows(dim, m.cols, m.row_groups / 2) >= kTargetBlocks) {
    m.row_groups /= 2;
  }
  return m;
}

// Sorts size (a power of two) keys ascending; every thread of the block
// takes part.
__device__ void bitonic_sort(uint64_t* key, int size) {
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));  // (t / j) * 2j + t % j: i & j == 0
        const uint64_t a = key[i], b = key[i + j];
        if ((a > b) == ((i & k) == 0)) {
          key[i] = b;
          key[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// A row as the sum walks it: its clamped start and its weight.  A warp's
// rows come 32 at a time: lane l holds the l-th, broadcast by shuffles when
// its turn comes.
struct __align__(16) RowBatch {
  long long start;
  double w;
};

// The visiting order: rows[i] = the row of the i-th smallest (clamped
// start, row) key (n <= kSortRows, one block).
__global__ void __launch_bounds__(kSortThreads)
sort_row_starts(const int32_t* __restrict__ offsets, const float* __restrict__ weights,
                int64_t table_size, int n, int dim, RowBatch* __restrict__ rows) {
  extern __shared__ uint64_t s_key[];
  int size = 1;
  while (size < n) size <<= 1;
  const int64_t max_start = table_size - dim;
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    s_key[i] = i < n ? (static_cast<uint64_t>(slice_start(offsets[i], table_size, max_start))
                        << kKeyIndexBits) | static_cast<uint64_t>(i)
                     : ~0ull;
  }
  __syncthreads();
  bitonic_sort(s_key, size);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t key = s_key[i];
    rows[i] = {static_cast<long long>(key >> kKeyIndexBits), weights[key & (kSortRows - 1)]};
  }
}

template <bool kSorted>
__device__ __forceinline__ RowBatch row_batch(const int32_t* __restrict__ offsets,
                                              const float* __restrict__ weights,
                                              const RowBatch* __restrict__ sorted, int p,
                                              int64_t table_size, int64_t max_start) {
  if constexpr (kSorted) {
    return sorted[p];
  } else {
    return {slice_start(offsets[p], table_size, max_start), weights[p]};
  }
}

// acc[m] += the rows of one batch (U a step: the step's U * C loads, then
// their FMAs), column col + 32 m.  The loads are unconditional, so that all
// U * C of them are in flight at once: a position past the batch's count
// reads the batch's first row, whose FMAs are skipped; with kClamp (a
// window wider than dim) a column past dim reads column dim - 1 and is
// never written.
template <int C, int U, bool kClamp>
__device__ __forceinline__ void add_batch(const float* __restrict__ table, const RowBatch& rows,
                                          int count, int col, int dim, double (&acc)[C]) {
  for (int u0 = 0; u0 < count; u0 += U) {
    float v[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* row = table + __shfl_sync(0xffffffffu, rows.start, u0 + u);
#pragma unroll
      for (int m = 0; m < C; ++m) {
        v[u][m] = __ldg(row + (kClamp ? min(col + m * kWarp, dim - 1) : col + m * kWarp));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const double w = __shfl_sync(0xffffffffu, rows.w, u0 + u);
      if (u0 + u < count) {
#pragma unroll
        for (int m = 0; m < C; ++m) acc[m] = fma(w, static_cast<double>(v[u][m]), acc[m]);
      }
    }
  }
}

template <int C, bool kSorted, typename Out>
__global__ void __launch_bounds__(kSumThreads, kSumBlocksPerSM)
weighted_sum_windows(const float* __restrict__ table, int64_t table_size,
                     const int32_t* __restrict__ offsets, const float* __restrict__ weights,
                     const RowBatch* __restrict__ sorted, int n, int dim, int row_groups,
                     int n_windows, Out* __restrict__ out) {
  constexpr int W = kWarp * C;              // a warp's columns
  constexpr int U = kLoadsInFlight / C;     // rows a step; divides 32
  __shared__ double s_part[kSumWarps * W];  // [row group][column]: each group's sums
  __shared__ double s_slots[2 * kMaxCluster * W];  // the cluster's sums, two buffers
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int slabs = kSumWarps / row_groups;  // warps side by side over a row
  const int width = slabs * W;               // a window's columns
  const int p_groups = g * row_groups;
  const int q = rank * row_groups + warp / slabs;  // this warp's row group in the cluster
  const int64_t max_start = table_size - dim;

  // a warp's rows at visiting positions q, q + P, ..., 32 a batch: lane l
  // holds the start and weight of the batch's l-th; where they fit in one
  // batch it is loaded once for every window
  const bool one_batch = n <= kWarp * p_groups;
  const int one_count = q < n ? (n - q + p_groups - 1) / p_groups : 0;
  RowBatch rows{0, 0.0};
  if (one_batch && one_count > 0) {
    const int p = q + lane * p_groups;
    rows = row_batch<kSorted>(offsets, weights, sorted, p < n ? p : q, table_size, max_start);
  }

  int parity = 0;
  for (int win = blockIdx.x / g; win < n_windows; win += gridDim.x / g) {
    // the last window ends at dim (it overlaps the one before it and
    // writes the same bits there); only C = 1, one slab, meets dim < width
    const int first = dim >= width ? min(win * width, dim - width) : win * width;
    const int col = first + (warp % slabs) * W + lane;
    double acc[C];
#pragma unroll
    for (int m = 0; m < C; ++m) acc[m] = 0.0;
    const auto add = [&](const RowBatch& batch, int count) {
      if (C == 1 && dim < width) {
        add_batch<C, U, true>(table, batch, count, col, dim, acc);
      } else {
        add_batch<C, U, false>(table, batch, count, col, dim, acc);
      }
    };
    if (one_batch) {
      add(rows, one_count);
    } else {
      for (int p0 = q; p0 < n; p0 += kWarp * p_groups) {
        const int p = p0 + lane * p_groups;
        add(row_batch<kSorted>(offsets, weights, sorted, p < n ? p : p0, table_size, max_start),
            min(kWarp, (n - p0 + p_groups - 1) / p_groups));
      }
    }

    if (row_groups == 1 && g == 1) {  // each column summed by one lane
#pragma unroll
      for (int m = 0; m < C; ++m) {
        if (col + m * kWarp < dim) out[col + m * kWarp] = static_cast<Out>(acc[m]);
      }
      continue;
    }
    // the block's sums: its row groups' in order (warp w writes
    // s_part[(w / slabs) * width + (w % slabs) * W + lane + 32 m])
#pragma unroll
    for (int m = 0; m < C; ++m) s_part[warp * W + lane + m * kWarp] = acc[m];
    __syncthreads();
    // with G > 1 (so R = 8 and width = W) block r owns the window's columns
    // [r * share, (r + 1) * share): each block writes its sums of them into
    // block r's shared memory, slot rank, in one of two buffers by window
    const int share = (width + g - 1) / g;
    double* slots = s_slots + (parity & 1) * kMaxCluster * W;  // [rank][column]
    for (int t = threadIdx.x; t < width; t += kSumThreads) {
      double v = s_part[t];
      for (int r = 1; r < row_groups; ++r) v += s_part[r * width + t];
      if (g == 1) {
        if (first + t < dim) out[first + t] = static_cast<Out>(v);
      } else {
        const int owner = t / share;
        *cluster.map_shared_rank(slots + rank * W + t - owner * share, owner) = v;
      }
    }
    if (g == 1) {
      __syncthreads();  // s_part is read before the next window writes it
      continue;
    }
    // once every block's sums are in, block r adds its columns' G sums in
    // rank order.  No block reads another's memory after the sync, and the
    // next window writes the other buffer, which every block has finished
    // reading before it reaches the next sync.
    cluster.sync();
    for (int t = threadIdx.x; t < share && rank * share + t < width; t += kSumThreads) {
      double v = slots[t];
      for (int r = 1; r < g; ++r) v += slots[r * W + t];
      if (first + rank * share + t < dim) out[first + rank * share + t] = static_cast<Out>(v);
    }
    ++parity;
  }
}

// ---------------------------------------------------------------------------
// population_noise_matvec: y[i, :] = c[i] * (x[i, :] @ E_i),
//   E_i = table[o_i + L : o_i + L + d*h] viewed row-major as (d, h)
//
// Replaces estorch_tpu/ops/pallas_noise.py:population_noise_matvec
// (_noise_matvec_kernel), the per-member noise term of the streamed MLP
// forward.
//
// Bound on this card: bytes.  The distinct noise floats are read once for 2
// flops each.  Mirrored pairs share E_i, so at one Pendulum MLP64x64 env
// step (n = 4096, layers (3, 64), (64, 64), (64, 1)) that is about 36 MB,
// half of the 71.3 MB the members' slices add up to.
//
// Design.  The unit of work is a pair of adjacent members (2p, 2p+1).  It
// computes both slice starts.  When they are equal (every mirrored
// generation) each element of E is loaded once and feeds two FMAs, one
// against each member's x; when they differ both slices are loaded.  Nothing
// in the interface says that the offsets are mirrored: the kernel sees it in
// the starts.  Each member's sum runs in the same order on both paths, so
// y[i] does not depend on its neighbour's offset.  With an odd n the last
// member is alone.  c is applied per member at the end.  There are no
// atomics: every output is summed in one fixed order.  The one-load path
// pays even though the second load of an address would hit L1: with both
// loads kept on mirrored offsets the (64, 64) layer is about 15 % slower
// warm and the (256, 256) one about 7 % (matvec_ab.py; numbers in PERF.md).
//
// Two thread mappings; the launcher picks one from (d, h):
//  - wide (h >= 32): a group of `tile` threads (h rounded up to a warp, at
//    most 256) owns `tile` output columns of one pair, so neighbouring lanes
//    read neighbouring floats of a row of E.  A block of 256 threads holds
//    256 / tile pairs (four at h = 64: 512 blocks for n = 4096, one wave).
//    The block's x rows are staged in shared memory kXChunk rows at a time,
//    the two members interleaved, so that one 8-byte broadcast read gives
//    both members' x[r]; d has no limit.  Each thread walks its column down
//    all d rows, 16 rows unrolled, so 16 loads are in flight; registers are
//    capped for 4 blocks an SM.  Splitting d among warps, with the partials
//    added in shared memory, is not done: the rows of one column are
//    already in flight together, and a first version of this kernel that
//    split them in two (with 8 rows unrolled, twice the blocks) was slower.
//  - narrow (h < 32): one warp owns a pair.  With R the largest power of two
//    with R * h <= 32, lane g * h + j (g < R) takes column j of rows g, g + R,
//    ...: the R * h working lanes read R * h consecutive floats at a time.
//    Each lane keeps one partial sum per member; a butterfly of shuffles
//    over g, in a fixed order, adds them, and lanes g = 0 and g = 1 write
//    the pair's two output rows, which lie next to each other (2h floats).
//
// What Hopper offers, and why most of it does not fit here:
//  - Slices start at arbitrary float offsets, so rows are not 16-byte
//    aligned, and TMA, cp.async.bulk and float4 loads need 16-byte aligned
//    addresses and sizes.  A pair's slice is one contiguous range, though,
//    and its aligned interior can be copied into shared memory that way
//    (the few floats at each end as scalars).  Trials of that with float4
//    loads, 16-byte cp.async and one cp.async.bulk per pair were not seen
//    to beat 4-byte loads coalesced across a warp, 16 in flight a thread,
//    which the kernel keeps; those trials are not kept, so take this as a
//    lead, not a result.
//  - Each E_i meets at most two x rows, so wgmma or mma.sync would have
//    nothing to reuse, and TF32 would lose digits against the float32
//    reference.
//  - What bounds each variant: the wide (64, 64) layer and larger ones are
//    bound by bytes, mostly read from HBM: back to back, the 34 MB of the
//    (64, 64) layer is only partly served from L2, and the (256, 256)
//    layer's 537 MB of member slices is far larger than L2 (their union,
//    which the bound counts, is the 134 MB table).  The thin layers, (3, 64)
//    and the narrow heads, move under 4 MB and are bound by latency: the
//    launch, then the offsets and x, then E, loads that wait on each other,
//    which a single launch cannot bring down to its byte bound.
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 256;
constexpr int kWideBlocksPerSM = 4;
constexpr int kXChunk = 256;
constexpr int kNarrowThreads = 256;

struct PairSlices {
  int64_t m0, m1;  // the pair's members; m1 == m0 for a lone last member
  bool has1;
  bool shared;     // both members read the same slice
  const float* e0;
  const float* e1;
};

__device__ __forceinline__ PairSlices pair_slices(const float* table, int64_t table_size,
                                                  const int32_t* __restrict__ offsets,
                                                  int n, int64_t pair, int64_t length,
                                                  int64_t layer_offset) {
  PairSlices p;
  p.m0 = 2 * pair;
  p.has1 = p.m0 + 1 < n;
  p.m1 = p.has1 ? p.m0 + 1 : p.m0;
  const int64_t max_start = table_size - length;
  const int64_t s0 = slice_start(offsets[p.m0] + layer_offset, table_size, max_start);
  const int64_t s1 = slice_start(offsets[p.m1] + layer_offset, table_size, max_start);
  p.shared = s0 == s1;
  p.e0 = table + s0;
  p.e1 = table + s1;
  return p;
}

// acc0 += sum_k x0[k * x_step] * e0[k * e_step], and the same for member 1,
// in the order of k.  kShared: e1 is e0, and each element is loaded once.
template <bool kShared>
__device__ __forceinline__ void pair_dot(const float* __restrict__ e0,
                                         const float* __restrict__ e1, int64_t e_step,
                                         const float* x0, const float* x1, int x_step,
                                         int count, float& acc0, float& acc1) {
#pragma unroll 16
  for (int k = 0; k < count; ++k) {
    const float v0 = __ldg(e0);
    const float v1 = kShared ? v0 : __ldg(e1);
    acc0 = fmaf(*x0, v0, acc0);
    acc1 = fmaf(*x1, v1, acc1);
    e0 += e_step;
    e1 += e_step;
    x0 += x_step;
    x1 += x_step;
  }
}

__global__ void __launch_bounds__(kWideThreads, kWideBlocksPerSM)
noise_matvec_wide(const float* __restrict__ table, int64_t table_size,
                  const int32_t* __restrict__ offsets, const float* __restrict__ c,
                  const float* __restrict__ x, int n, int d, int h,
                  int64_t layer_offset, int tile, float* __restrict__ y) {
  // x of the block's pairs, kXChunk rows at a time: s_x[q][r] = (x0[r], x1[r])
  __shared__ float2 s_x[kWideThreads / kWarp * kXChunk];
  const int pairs_per_block = blockDim.x / tile;
  const int q = threadIdx.x / tile;  // pair within the block
  const int col = blockIdx.y * tile + threadIdx.x % tile;
  const int64_t n_pairs = (static_cast<int64_t>(n) + 1) / 2;
  const int64_t pair0 = static_cast<int64_t>(blockIdx.x) * pairs_per_block;
  const int64_t pair = pair0 + q;
  const bool live = pair < n_pairs && col < h;
  PairSlices p{};
  if (pair < n_pairs) {
    p = pair_slices(table, table_size, offsets, n, pair, static_cast<int64_t>(d) * h,
                    layer_offset);
  }
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int r0 = 0; r0 < d; r0 += kXChunk) {
    const int rows = min(kXChunk, d - r0);
    __syncthreads();  // the previous chunk is consumed
    for (int k = threadIdx.x; k < pairs_per_block * rows; k += blockDim.x) {
      const int kq = k / rows, r = k - kq * rows;
      const int64_t m0 = 2 * (pair0 + kq);
      float2 v = make_float2(0.0f, 0.0f);
      if (m0 < n) {
        v.x = x[m0 * d + r0 + r];
        v.y = m0 + 1 < n ? x[(m0 + 1) * d + r0 + r] : 0.0f;
      }
      s_x[kq * kXChunk + r] = v;
    }
    __syncthreads();
    if (live) {
      const int64_t e_row = static_cast<int64_t>(r0) * h + col;
      const float* xs = reinterpret_cast<const float*>(s_x + q * kXChunk);
      if (p.shared) {
        pair_dot<true>(p.e0 + e_row, p.e0 + e_row, h, xs, xs + 1, 2, rows, acc0, acc1);
      } else {
        pair_dot<false>(p.e0 + e_row, p.e1 + e_row, h, xs, xs + 1, 2, rows, acc0, acc1);
      }
    }
  }
  if (!live) return;
  y[p.m0 * h + col] = c[p.m0] * acc0;
  if (p.has1) y[p.m1 * h + col] = c[p.m1] * acc1;
}

__global__ void __launch_bounds__(kNarrowThreads)
noise_matvec_narrow(const float* __restrict__ table, int64_t table_size,
                    const int32_t* __restrict__ offsets, const float* __restrict__ c,
                    const float* __restrict__ x, int n, int d, int h,
                    int64_t layer_offset, int row_lanes, float* __restrict__ y) {
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) +
                       threadIdx.x / kWarp;
  if (pair >= (static_cast<int64_t>(n) + 1) / 2) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  const int g = lane / h, j = lane % h;
  const PairSlices p = pair_slices(table, table_size, offsets, n, pair,
                                   static_cast<int64_t>(d) * h, layer_offset);
  float acc0 = 0.0f, acc1 = 0.0f;
  if (g < row_lanes && g < d) {
    const int count = (d - g + row_lanes - 1) / row_lanes;
    const int64_t e_first = static_cast<int64_t>(g) * h + j;
    const int64_t e_step = static_cast<int64_t>(row_lanes) * h;
    const float* x0 = x + p.m0 * d + g;
    const float* x1 = x + p.m1 * d + g;
    if (p.shared) {
      pair_dot<true>(p.e0 + e_first, p.e0 + e_first, e_step, x0, x1, row_lanes, count,
                     acc0, acc1);
    } else {
      pair_dot<false>(p.e0 + e_first, p.e1 + e_first, e_step, x0, x1, row_lanes, count,
                      acc0, acc1);
    }
  }
  // Lanes past R * h take part in the shuffles; their values are not read.
  for (int s = 1; s < row_lanes; s <<= 1) {
    const int src = (g ^ s) * h + j;
    acc0 += __shfl_sync(0xffffffffu, acc0, src);
    acc1 += __shfl_sync(0xffffffffu, acc1, src);
  }
  if (g == 0) y[p.m0 * h + j] = c[p.m0] * acc0;
  if (p.has1 && g == (row_lanes > 1 ? 1 : 0)) y[p.m1 * h + j] = c[p.m1] * acc1;
}

template <int C, bool kSorted, typename Out>
int launch_weighted_sum(const SumMapping& m, const float* table, int64_t table_size,
                        const int32_t* offsets, const float* weights, int n, int dim,
                        RowBatch* sorted, Out* out, cudaStream_t s) {
  cudaError_t err;
  if (kSorted) {
    int size = 1;
    while (size < n) size <<= 1;
    const int smem = size * static_cast<int>(sizeof(uint64_t));
    err = cudaFuncSetAttribute(sort_row_starts, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    sort_row_starts<<<1, kSortThreads, smem, s>>>(offsets, weights, table_size, n, dim, sorted);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int windows = static_cast<int>(sum_windows(dim, C, m.row_groups));
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  // as many clusters as stay resident, each walking several windows
  const int clusters = std::min(windows, std::max(1, sms * kSumBlocksPerSM / m.cluster));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * m.cluster));
  cfg.blockDim = dim3(kSumThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = m.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, weighted_sum_windows<C, kSorted, Out>, table, table_size,
                           offsets, weights, static_cast<const RowBatch*>(sorted), n, dim,
                           m.row_groups, windows, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int C, typename Out>
int launch_weighted_sum_cols(const SumMapping& m, const float* table, int64_t table_size,
                             const int32_t* offsets, const float* weights, int n, int dim,
                             RowBatch* sorted, Out* out, cudaStream_t s) {
  return m.sorted ? launch_weighted_sum<C, true>(m, table, table_size, offsets, weights, n, dim,
                                                 sorted, out, s)
                  : launch_weighted_sum<C, false>(m, table, table_size, offsets, weights, n,
                                                  dim, sorted, out, s);
}

template <typename Out>
int weighted_noise_sum_launch(const float* table, int64_t table_size, const int32_t* offsets,
                              const float* weights, int n, int dim, void* scratch, Out* out,
                              void* stream) {
  RowBatch* sorted = static_cast<RowBatch*>(scratch);
  if (n <= 0 || n > kMaxSumRows || dim <= 0 || dim > table_size) return cudaErrorInvalidValue;
  const SumMapping m = sum_mapping(n, dim, table_size);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m.cols) {
    case 1: return launch_weighted_sum_cols<1>(m, table, table_size, offsets, weights, n, dim,
                                               sorted, out, s);
    case 2: return launch_weighted_sum_cols<2>(m, table, table_size, offsets, weights, n, dim,
                                               sorted, out, s);
    default: return launch_weighted_sum_cols<kSumCols>(m, table, table_size, offsets, weights,
                                                       n, dim, sorted, out, s);
  }
}

}  // namespace

extern "C" {

int estorch_weighted_sum_max_rows() { return kMaxSumRows; }

// The launcher's mapping for (n, dim, table_size): mapping[0] = columns a
// lane (C), mapping[1] = blocks a window (G), mapping[2] = 1 where the rows
// are visited by clamped start, 0 where by index, mapping[3] = row groups a
// block (R).
int estorch_weighted_sum_mapping(int n, int dim, int64_t table_size, int* mapping) {
  if (n <= 0 || dim <= 0 || dim > table_size) return cudaErrorInvalidValue;
  const SumMapping m = sum_mapping(n, dim, table_size);
  mapping[0] = m.cols;
  mapping[1] = m.cluster;
  mapping[2] = m.sorted ? 1 : 0;
  mapping[3] = m.row_groups;
  return 0;
}

// scratch: (n, 16 bytes) from the caller, 16-byte aligned (the visiting
// order, where the rows are sorted).
int estorch_weighted_noise_sum(const float* table, int64_t table_size,
                               const int32_t* offsets, const float* weights,
                               int n, int dim, void* scratch, float* out, void* stream) {
  return weighted_noise_sum_launch(table, table_size, offsets, weights, n, dim, scratch, out,
                                   stream);
}

// The same sum left in float64 (out: (dim,) double), for a caller that adds
// it to other partial sums before its one rounding to float32.
int estorch_weighted_noise_sum_f64(const float* table, int64_t table_size,
                                   const int32_t* offsets, const float* weights,
                                   int n, int dim, void* scratch, double* out,
                                   void* stream) {
  return weighted_noise_sum_launch(table, table_size, offsets, weights, n, dim, scratch, out,
                                   stream);
}

int estorch_population_noise_matvec(const float* table, int64_t table_size,
                                    const int32_t* offsets, const float* c,
                                    const float* x, int n, int d, int h,
                                    int64_t layer_offset, float* y,
                                    void* stream) {
  if (n <= 0 || d <= 0 || h <= 0 ||
      static_cast<int64_t>(d) * h > table_size) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_pairs = (static_cast<int64_t>(n) + 1) / 2;
  if (h < kWarp) {
    int row_lanes = 1;
    while (2 * row_lanes * h <= kWarp) row_lanes *= 2;
    const int pairs_per_block = kNarrowThreads / kWarp;
    const int64_t blocks = (n_pairs + pairs_per_block - 1) / pairs_per_block;
    noise_matvec_narrow<<<static_cast<unsigned>(blocks), kNarrowThreads, 0, s>>>(
        table, table_size, offsets, c, x, n, d, h, layer_offset, row_lanes, y);
    return cudaGetLastError();
  }
  const int tile = min(kWideThreads, (h + kWarp - 1) / kWarp * kWarp);
  const int pairs_per_block = kWideThreads / tile;  // 1 to 8
  const int64_t blocks = (n_pairs + pairs_per_block - 1) / pairs_per_block;
  const int col_tiles = (h + tile - 1) / tile;
  if (col_tiles > 65535) return cudaErrorInvalidValue;
  noise_matvec_wide<<<dim3(static_cast<unsigned>(blocks), col_tiles), pairs_per_block * tile,
                      0, s>>>(table, table_size, offsets, c, x, n, d, h, layer_offset, tile, y);
  return cudaGetLastError();
}

}  // extern "C"
