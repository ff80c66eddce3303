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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t slice_start(int64_t start, int64_t table_size,
                                               int64_t max_start) {
  if (start < 0) start += table_size;
  return start < 0 ? 0 : (start > max_start ? max_start : start);
}

// ---------------------------------------------------------------------------
// weighted_noise_sum: out[j] = sum_k w[k] * table[o[k] + j], j < dim
//
// Replaces estorch_tpu/ops/pallas_noise.py:weighted_noise_sum
// (_weighted_sum_kernel), the ES update reduction.
//
// Bound on this card: bytes.  Each of the n rows of dim floats is read once
// (2048 x 4481 x 4 B = 36.7 MB at the Pendulum MLP64x64 pop-4096 shape) for
// 2 flops per float, far below the float32 rate.
//
// Design: the TPU kernel carries one accumulator across a sequential grid
// over rows.  Blocks here run in parallel and in no order, so the rows are
// cut into chunks of kRowsPerChunk: block (tile, chunk) sums its chunk's
// rows for 256 neighbouring columns (coalesced scalar loads; the offsets
// are arbitrary, so rows start unaligned) and writes a partial; a second
// small kernel adds the partials in chunk order.  That fills the SMs
// (18 column tiles x 32 chunks at the shape above) and keeps the sum
// deterministic: no atomics, the same order on every run.
//
// The sum is carried in float64 and rounded to float32 once, as the plain
// version's is.  A float32 product is exact in float64, so both sums are
// within a few float64 ulps of the exact one and round to the same float32
// but for a tie-near value, whatever their order.  A float32 accumulator
// would leave the result depending on the order, and Adam's per-coordinate
// normalisation turns that rounding into parameter differences of up to
// lr * |rounding| / |g_j| where a coordinate's gradient g_j is small.  The
// float64 FMAs cost nothing visible: the kernel stays bound by its bytes
// (2 flops per 4-byte load, against 34 TFLOP/s of float64 on an H100 SXM).
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 256;
constexpr int kRowsPerChunk = 64;

__global__ void weighted_sum_partials(const float* __restrict__ table,
                                      int64_t table_size,
                                      const int32_t* __restrict__ offsets,
                                      const float* __restrict__ weights,
                                      int n, int dim,
                                      double* __restrict__ partials) {
  __shared__ int64_t s_off[kRowsPerChunk];
  __shared__ double s_w[kRowsPerChunk];
  const int chunk = blockIdx.y;
  const int row0 = chunk * kRowsPerChunk;
  const int rows = min(kRowsPerChunk, n - row0);
  const int64_t max_start = table_size - dim;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    s_off[r] = slice_start(offsets[row0 + r], table_size, max_start);
    s_w[r] = weights[row0 + r];
  }
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= dim) return;
  double acc = 0.0;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    acc = fma(s_w[r], static_cast<double>(__ldg(table + s_off[r] + j)), acc);
  }
  partials[static_cast<int64_t>(chunk) * dim + j] = acc;
}

// Out is float, or double where the caller sums several partial totals
// before rounding once (the ranks' partials of a multi-rank update).
template <typename Out>
__global__ void sum_partials(const double* __restrict__ partials, int n_chunks,
                             int dim, Out* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= dim) return;
  double acc = 0.0;
  for (int c = 0; c < n_chunks; ++c) {
    acc += partials[static_cast<int64_t>(c) * dim + j];
  }
  out[j] = static_cast<Out>(acc);
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

constexpr int kWarp = 32;
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

}  // namespace

extern "C" {

int estorch_weighted_sum_rows_per_chunk() { return kRowsPerChunk; }

}  // extern "C"

namespace {

template <typename Out>
int weighted_noise_sum_launch(const float* table, int64_t table_size,
                              const int32_t* offsets, const float* weights,
                              int n, int dim, double* partials, Out* out,
                              void* stream) {
  if (n <= 0 || dim <= 0 || dim > table_size) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + kRowsPerChunk - 1) / kRowsPerChunk;
  const int tiles = (dim + kSumThreads - 1) / kSumThreads;
  weighted_sum_partials<<<dim3(tiles, n_chunks), kSumThreads, 0, s>>>(
      table, table_size, offsets, weights, n, dim, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials<Out><<<tiles, kSumThreads, 0, s>>>(partials, n_chunks, dim, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// partials: (ceil(n / kRowsPerChunk), dim) float64 scratch from the caller.
int estorch_weighted_noise_sum(const float* table, int64_t table_size,
                               const int32_t* offsets, const float* weights,
                               int n, int dim, double* partials, float* out,
                               void* stream) {
  return weighted_noise_sum_launch(table, table_size, offsets, weights, n, dim,
                                   partials, out, stream);
}

// The same sum left in float64 (out: (dim,) double), for a caller that adds
// it to other partial sums before its one rounding to float32.
int estorch_weighted_noise_sum_f64(const float* table, int64_t table_size,
                                   const int32_t* offsets, const float* weights,
                                   int n, int dim, double* partials, double* out,
                                   void* stream) {
  return weighted_noise_sum_launch(table, table_size, offsets, weights, n, dim,
                                   partials, out, stream);
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
