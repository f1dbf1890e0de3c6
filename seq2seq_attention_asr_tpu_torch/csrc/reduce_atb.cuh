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
//
// The bf16 operand path (the bf16 entries of K5 and K6): a problem's io
// bits say which of A, B (and C with the column sums) are bf16 arrays;
// a bf16 operand is widened as it loads and a bf16 output is rounded
// once, at its store, and the sums stay float32. The instance taken
// with `round_operands` (launch_atb) rounds every operand of the
// products to bf16 as it loads, as the JAX kernels round a product's
// operands (the identity on a bf16 array or on a float array that holds
// rounded values), while the column sums read B unrounded: K5's stash
// holds its dr, dcc and dws unrounded, whose bias sums JAX takes in
// float32. The float32 problems (io 0) of the instance without rounding
// compute what they did before the bf16 path existed, bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kAtbThreads = 256;
constexpr int kAtbTile = 64;
constexpr int kAtbRows = 32;
constexpr int kAtbMaxProblems = 8;

// A problem's io bits: which of its arrays are bf16 (else float).
constexpr int kAtbA16 = 1, kAtbB16 = 2, kAtbC16 = 4;  // kAtbC16: c and colsum

struct AtbProblem {
  const void* a;  // A(n, i) = a[(n + shift) * lda + i]; unused when c is null
  int lda, shift;
  const void* b;  // B(n, j) = b[n * ldb + j]
  int ldb;
  void* c;        // (M, N) row-major, or null: column sums only
  void* colsum;   // (N,), or null
  int M, N;
  int io = 0;     // kAtbA16 | kAtbB16 | kAtbC16
};

// Element i of a float or (bf16) bf16 array, as a float.
__device__ __forceinline__ float atb_load(const void* p, size_t i, bool bf16) {
  return bf16 ? ldg_f(static_cast<const __nv_bfloat16*>(p) + i)
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void atb_store(void* p, size_t i, float v, bool bf16) {
  if (bf16)
    st_f(static_cast<__nv_bfloat16*>(p) + i, v);
  else
    static_cast<float*>(p)[i] = v;
}

struct AtbBatch {
  AtbProblem p[kAtbMaxProblems];
  int first_tile[kAtbMaxProblems + 1];
  int count, rows, period;
};

template <bool kRound>
__global__ void __launch_bounds__(kAtbThreads) atb_kernel(const AtbBatch batch) {
  __shared__ float as[kAtbRows][kAtbTile + 4];
  __shared__ float bs[kAtbRows][kAtbTile + 4];
  __shared__ float braw[kRound ? kAtbRows : 1][kAtbTile + 4];  // B unrounded, for the sums
  int q = 0;
  while (q + 1 < batch.count && (int)blockIdx.x >= batch.first_tile[q + 1]) ++q;
  const AtbProblem& p = batch.p[q];
  const int tiles_n = (p.N + kAtbTile - 1) / kAtbTile;
  const int tile = blockIdx.x - batch.first_tile[q];
  const int i0 = (tile / tiles_n) * kAtbTile, j0 = (tile % tiles_n) * kAtbTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const bool with_c = p.c != nullptr, with_sum = p.colsum != nullptr && i0 == 0;
  const bool a16 = p.io & kAtbA16, b16 = p.io & kAtbB16, c16 = p.io & kAtbC16;

  float acc[4][4] = {};
  float csum = 0.f;
  for (int n0 = 0; n0 < batch.rows; n0 += kAtbRows) {
    for (int idx = tid; idx < kAtbRows * kAtbTile; idx += kAtbThreads) {
      const int k = idx / kAtbTile, x = idx % kAtbTile, n = n0 + k;
      float av = 0.f, bv = 0.f;
      if (n < batch.rows) {
        if (with_c && i0 + x < p.M) {
          const int t = n % batch.period + p.shift;
          if (t >= 0 && t < batch.period)
            av = atb_load(p.a, (size_t)(n + p.shift) * p.lda + i0 + x, a16);
        }
        if (j0 + x < p.N) bv = atb_load(p.b, (size_t)n * p.ldb + j0 + x, b16);
      }
      if constexpr (kRound) {
        as[k][x] = round_to<__nv_bfloat16>(av);
        bs[k][x] = round_to<__nv_bfloat16>(bv);
        braw[k][x] = bv;
      } else {
        as[k][x] = av;
        bs[k][x] = bv;
      }
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
      for (int k = 0; k < kAtbRows; ++k) csum += kRound ? braw[k][tid] : bs[k][tid];
    __syncthreads();
  }
  if (with_c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * tx + c;
        if (i < p.M && j < p.N) atb_store(p.c, (size_t)i * p.N + j, acc[r][c], c16);
      }
    }
  }
  if (with_sum && tid < kAtbTile && j0 + tid < p.N) atb_store(p.colsum, j0 + tid, csum, c16);
}

// Launch one atb_kernel over the batch's problems (count <= 8), with
// round_operands the instance that rounds the products' operands to bf16.
cudaError_t launch_atb(AtbBatch batch, cudaStream_t stream, bool round_operands = false) {
  int tiles = 0;
  for (int q = 0; q < batch.count; ++q) {
    const AtbProblem& p = batch.p[q];
    batch.first_tile[q] = tiles;
    const int tiles_m = p.c ? (p.M + kAtbTile - 1) / kAtbTile : 1;
    tiles += tiles_m * ((p.N + kAtbTile - 1) / kAtbTile);
  }
  batch.first_tile[batch.count] = tiles;
  if (round_operands)
    atb_kernel<true><<<tiles, kAtbThreads, 0, stream>>>(batch);
  else
    atb_kernel<false><<<tiles, kAtbThreads, 0, stream>>>(batch);
  return cudaGetLastError();
}

}  // namespace
