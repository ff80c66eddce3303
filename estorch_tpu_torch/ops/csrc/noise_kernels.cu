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
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 256;
constexpr int kRowsPerChunk = 64;

__global__ void weighted_sum_partials(const float* __restrict__ table,
                                      int64_t table_size,
                                      const int32_t* __restrict__ offsets,
                                      const float* __restrict__ weights,
                                      int n, int dim,
                                      float* __restrict__ partials) {
  __shared__ int64_t s_off[kRowsPerChunk];
  __shared__ float s_w[kRowsPerChunk];
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
  float acc = 0.0f;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    acc = fmaf(s_w[r], __ldg(table + s_off[r] + j), acc);
  }
  partials[static_cast<int64_t>(chunk) * dim + j] = acc;
}

__global__ void sum_partials(const float* __restrict__ partials, int n_chunks,
                             int dim, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= dim) return;
  float acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    acc += partials[static_cast<int64_t>(c) * dim + j];
  }
  out[j] = acc;
}

// ---------------------------------------------------------------------------
// population_noise_matvec: y[i, :] = c[i] * (x[i, :] @ E_i),
//   E_i = table[o_i + L : o_i + L + d*h] viewed row-major as (d, h)
//
// Replaces estorch_tpu/ops/pallas_noise.py:population_noise_matvec
// (_noise_matvec_kernel), the per-member noise term of the streamed MLP
// forward.
//
// Bound on this card: bytes.  Each member's d*h floats of E_i are read once
// for 2 flops each (4096 x (3x64 + 64x64 + 64x1) x 4 B = 71.3 MB for the
// three layers of one Pendulum MLP64x64 env step; mirrored pairs share an
// offset, so the distinct bytes are about half of that).
//
// Design: one block per (member, tile of up to 128 output columns).  The
// block stages x_i (d floats) in shared memory; each thread owns one output
// column and walks the d rows of E_i, reading table[o_i + L + r*h + col],
// which is coalesced across the columns of the tile.  c_i is applied once
// at the end.  A 1-column head (h = 1) leaves 31 of 32 lanes idle: simple
// and right first, faster in a later change.
// ---------------------------------------------------------------------------

__global__ void noise_matvec(const float* __restrict__ table, int64_t table_size,
                             const int32_t* __restrict__ offsets,
                             const float* __restrict__ c,
                             const float* __restrict__ x, int d, int h,
                             int64_t layer_offset, float* __restrict__ y) {
  extern __shared__ float s_x[];
  const int64_t i = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  for (int r = threadIdx.x; r < d; r += blockDim.x) s_x[r] = x[i * d + r];
  __syncthreads();
  if (col >= h) return;
  const int64_t max_start = table_size - static_cast<int64_t>(d) * h;
  const int64_t start =
      slice_start(static_cast<int64_t>(offsets[i]) + layer_offset, table_size, max_start);
  const float* e = table + start + col;
  float acc = 0.0f;
#pragma unroll 8
  for (int r = 0; r < d; ++r) {
    acc = fmaf(s_x[r], __ldg(e + static_cast<int64_t>(r) * h), acc);
  }
  y[i * h + col] = c[i] * acc;
}

}  // namespace

extern "C" {

int estorch_weighted_sum_rows_per_chunk() { return kRowsPerChunk; }

// partials: (ceil(n / kRowsPerChunk), dim) float32 scratch from the caller.
int estorch_weighted_noise_sum(const float* table, int64_t table_size,
                               const int32_t* offsets, const float* weights,
                               int n, int dim, float* partials, float* out,
                               void* stream) {
  if (n <= 0 || dim <= 0 || dim > table_size) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + kRowsPerChunk - 1) / kRowsPerChunk;
  const int tiles = (dim + kSumThreads - 1) / kSumThreads;
  weighted_sum_partials<<<dim3(tiles, n_chunks), kSumThreads, 0, s>>>(
      table, table_size, offsets, weights, n, dim, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials<<<tiles, kSumThreads, 0, s>>>(partials, n_chunks, dim, out);
  return cudaGetLastError();
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
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        noise_matvec, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int threads = ((h + 31) / 32) * 32;
  if (threads > 128) threads = 128;
  const dim3 grid(n, (h + threads - 1) / threads);
  noise_matvec<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, table_size, offsets, c, x, d, h, layer_offset, y);
  return cudaGetLastError();
}

}  // extern "C"
