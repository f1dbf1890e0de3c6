// Weight gradients of a recurrence as sums over its rows: for each
// problem, C = sum_n A(n)^T B(n) (M x N) and, optionally, the column
// sums of B (the bias gradient), over the n = 0..rows-1 rows of B*P
// (batch row, step) pairs. The recurrent backward kernels write each
// step's operand A(n) and cotangent B(n) to global memory; accumulating
// the outer products inside the recurrence would need M*N accumulators,
// 768 KB for one BiGRU direction at H = 256, which no SM holds (the
// backward GRU walk's cluster of 8 holds the weights themselves in that
// much shared memory).
//
// One block per 64 x 64 output tile (of any problem), 32 rows at a time
// through shared memory, every thread a 4 x 4 sub-tile: deterministic,
// no atomics. A(n) may be row n of its array shifted by `shift` steps
// within its batch row (a zero row where that leaves [0, P)), which is
// how the previous step's state is read from a saved state sequence.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kAtbThreads = 256;
constexpr int kAtbTile = 64;
constexpr int kAtbRows = 32;
constexpr int kAtbMaxProblems = 8;

struct AtbProblem {
  const float* a;  // A(n, i) = a[(n + shift) * lda + i]; unused when c is null
  int lda, shift;
  const float* b;  // B(n, j) = b[n * ldb + j]
  int ldb;
  float* c;        // (M, N) row-major, or null: column sums only
  float* colsum;   // (N,), or null
  int M, N;
};

struct AtbBatch {
  AtbProblem p[kAtbMaxProblems];
  int first_tile[kAtbMaxProblems + 1];
  int count, rows, period;
};

__global__ void __launch_bounds__(kAtbThreads) atb_kernel(const AtbBatch batch) {
  __shared__ float as[kAtbRows][kAtbTile + 4];
  __shared__ float bs[kAtbRows][kAtbTile + 4];
  int q = 0;
  while (q + 1 < batch.count && (int)blockIdx.x >= batch.first_tile[q + 1]) ++q;
  const AtbProblem& p = batch.p[q];
  const int tiles_n = (p.N + kAtbTile - 1) / kAtbTile;
  const int tile = blockIdx.x - batch.first_tile[q];
  const int i0 = (tile / tiles_n) * kAtbTile, j0 = (tile % tiles_n) * kAtbTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const bool with_c = p.c != nullptr, with_sum = p.colsum != nullptr && i0 == 0;

  float acc[4][4] = {};
  float csum = 0.f;
  for (int n0 = 0; n0 < batch.rows; n0 += kAtbRows) {
    for (int idx = tid; idx < kAtbRows * kAtbTile; idx += kAtbThreads) {
      const int k = idx / kAtbTile, x = idx % kAtbTile, n = n0 + k;
      float av = 0.f, bv = 0.f;
      if (n < batch.rows) {
        if (with_c && i0 + x < p.M) {
          const int t = n % batch.period + p.shift;
          if (t >= 0 && t < batch.period) av = p.a[(size_t)(n + p.shift) * p.lda + i0 + x];
        }
        if (j0 + x < p.N) bv = p.b[(size_t)n * p.ldb + j0 + x];
      }
      as[k][x] = av;
      bs[k][x] = bv;
    }
    __syncthreads();
    if (with_c) {
#pragma unroll 8
      for (int k = 0; k < kAtbRows; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = as[k][4 * ty + r], bv[r] = bs[k][4 * tx + r];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
    if (with_sum && tid < kAtbTile)
      for (int k = 0; k < kAtbRows; ++k) csum += bs[k][tid];
    __syncthreads();
  }
  if (with_c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * tx + c;
        if (i < p.M && j < p.N) p.c[(size_t)i * p.N + j] = acc[r][c];
      }
    }
  }
  if (with_sum && tid < kAtbTile && j0 + tid < p.N) p.colsum[j0 + tid] = csum;
}

// Launch one atb_kernel over the batch's problems (count <= 8).
cudaError_t launch_atb(AtbBatch batch, cudaStream_t stream) {
  int tiles = 0;
  for (int q = 0; q < batch.count; ++q) {
    const AtbProblem& p = batch.p[q];
    batch.first_tile[q] = tiles;
    const int tiles_m = p.c ? (p.M + kAtbTile - 1) / kAtbTile : 1;
    tiles += tiles_m * ((p.N + kAtbTile - 1) / kAtbTile);
  }
  batch.first_tile[batch.count] = tiles;
  atb_kernel<<<tiles, kAtbThreads, 0, stream>>>(batch);
  return cudaGetLastError();
}

}  // namespace
