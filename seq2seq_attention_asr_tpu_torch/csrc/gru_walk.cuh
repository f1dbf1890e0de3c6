// The walk of one bias-free GRU direction over time for a block of R
// batch rows, forward and backward, shared by the flip-free BiGRU scan
// (K1 bigru_scan2.cu, K6 bigru_scan2_bwd.cu) and the one-direction and
// direction-stacked scans (K16/K18 gru_scan.cu, K17/K19 gru_scan_bwd.cu).
// Each kernel is a thin __global__ function that picks its direction's
// arrays by blockIdx.x and calls the walk; blockIdx.y picks the rows.
//
//   zr = sigmoid(h @ Wzr + x[:2H]);  c = tanh((r * h) @ Wh + x[2H:])
//   h' = (1 - z) * h + z * c
//
// What bounds a walk: the L steps form a dependency chain, and each step
// needs the direction's whole recurrent weight set (3H^2 floats, 768 KB
// at H = 256), which does not fit in one SM's shared memory and is read
// from L2 every step. The state lives in shared memory, so every weight
// is read once per step for all the rows of the block. What limits one
// block's weight stream is load latency, so the loads are 16 bytes wide
// and the input dimension of each product is split over thread groups,
// keeping many loads in flight; partial sums meet in shared memory.

#pragma once

#include "common.cuh"

namespace {

// part[p][r][j] = sum over i = p, p + parts, ... < H of v[r][i] * w[i][j],
// j < out, for the R rows of the block; VW consecutive columns per load.
// Returns the number of parts written.
template <int R, int VW>
__device__ int partial_products(const float* __restrict__ w, int H, int out, const float* v,
                                float* part) {
  const int q = out / VW;
  const int parts = q >= kThreads ? 1 : kThreads / q;
  const int p = threadIdx.x / q;
  if (p < parts) {
    for (int jq = threadIdx.x - p * q; jq < q; jq += kThreads) {
      float acc[R][VW];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < VW; ++c) acc[r][c] = 0.f;
#pragma unroll 8
      for (int i = p; i < H; i += parts) {
        const float* wp = w + (size_t)i * out + VW * jq;
        float wv[VW];
        if constexpr (VW == 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(wp));
          wv[0] = t.x, wv[1] = t.y, wv[2] = t.z, wv[3] = t.w;
        } else {
          wv[0] = __ldg(wp);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = v[r * H + i];
#pragma unroll
          for (int c = 0; c < VW; ++c) acc[r][c] = fmaf(hv, wv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < VW; ++c) part[(p * R + r) * out + VW * jq + c] = acc[r][c];
    }
  }
  return parts;
}

// Shared memory of the forward walk, in bytes: state, z, r * h, and the
// partial sums of the wider of the two products.
size_t gru_fwd_smem_bytes(int R, int VW, int H) {
  const int widest = kThreads * VW > 2 * H ? kThreads * VW : 2 * H;
  return (3 * (size_t)R * H + (size_t)R * widest) * sizeof(float);
}

// Forward walk of one direction for the rows b0 = blockIdx.y * R, ...:
// x (B, L, 3H) input projections, h0 (B, H) the initial state or null
// for zeros, wzr (H, 2H), wh (H, H), ys (B, L, H). Step s reads and
// writes time t = s, or t = L-1-s when `reverse`. `smem` holds
// gru_fwd_smem_bytes(R, VW, H).
template <int R, int VW>
__device__ void gru_walk_fwd(const float* __restrict__ x, const float* __restrict__ h0,
                             const float* __restrict__ wzr, const float* __restrict__ wh,
                             float* __restrict__ ys, int B, int L, int H, bool reverse,
                             float* smem) {
  float* hs = smem;           // [R][H] state
  float* z = hs + R * H;      // [R][H] update gate
  float* rh = z + R * H;      // [R][H] r * h
  float* part = rh + R * H;   // partial sums

  const int b0 = blockIdx.y * R;
  const int nrows = min(R, B - b0);
  const int H2 = 2 * H;
  const size_t H3 = 3 * (size_t)H;

  for (int i = threadIdx.x; i < R * H; i += kThreads)
    hs[i] = h0 != nullptr && i / H < nrows ? h0[(size_t)b0 * H + i] : 0.f;
  __syncthreads();

  for (int s = 0; s < L; ++s) {
    const int t = reverse ? L - 1 - s : s;
    // z and r gates: h @ Wzr + x[:2H].
    int parts = partial_products<R, VW>(wzr, H, H2, hs, part);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H2; idx += kThreads) {
      const int r = idx / H2, j = idx % H2;
      float a = r < nrows ? x[((size_t)(b0 + r) * L + t) * H3 + j] : 0.f;
      for (int q = 0; q < parts; ++q) a += part[(q * R + r) * H2 + j];
      const float g = activate<kSigmoid>(a);
      if (j < H)
        z[r * H + j] = g;
      else
        rh[r * H + j - H] = g * hs[r * H + j - H];
    }
    __syncthreads();
    // Candidate tanh((r * h) @ Wh + x[2H:]) and the update.
    parts = partial_products<R, VW>(wh, H, H, rh, part);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, u = idx % H;
      float a = r < nrows ? x[((size_t)(b0 + r) * L + t) * H3 + H2 + u] : 0.f;
      for (int q = 0; q < parts; ++q) a += part[(q * R + r) * H + u];
      const float zg = z[idx];
      const float hn = (1.f - zg) * hs[idx] + zg * tanhf(a);
      hs[idx] = hn;
      if (r < nrows) ys[((size_t)(b0 + r) * L + t) * H + u] = hn;
    }
    __syncthreads();
  }
}

// Shared memory of the backward walk, in bytes: 12 [R][H] vectors and
// matvec's scratch.
size_t gru_bwd_smem_bytes(int R, int H) {
  return ((size_t)12 * R * H + (size_t)kThreads * 4 * R) * sizeof(float);
}

// Rows per block of the backward walk on the current device: 4 where
// B > 1 and they fit the opt-in shared memory, else 1; an error when not
// even one row fits.
cudaError_t gru_bwd_rows(int B, int H, int* rows) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (gru_bwd_smem_bytes(1, H) > (size_t)limit) return cudaErrorInvalidValue;
  *rows = B > 1 && gru_bwd_smem_bytes(4, H) <= (size_t)limit ? 4 : 1;
  return cudaSuccess;
}

// Backward walk of one direction for the rows b0 = blockIdx.y * R, ...,
// over t = L-1..0 when `down` (the forward ran t = 0..L-1), else over
// t = 0..L-1. Each step's h_prev is hsrc[t + shift] (B, L, H), zero
// where that index leaves [0, L). Each step recomputes the gates from
// h_prev, then
//
//   dh = dys[t] + carry;  dz = dh (c - h_prev);  da_c = dh z (1 - c^2)
//   drh = da_c @ Wh^T;  da_z = dz z (1 - z);  da_r = drh h_prev r (1 - r)
//   carry = drh r + [da_z | da_r] @ Wzr^T + dh (1 - z)
//   dx[t] = [da_z | da_r | da_c];  rho[t] = r h_prev
//
// and dh0 (B, H), unless null, gets the carry after the last step. The
// weight gradients are not summed here (768 KB of accumulators per
// direction at H = 256 fit in no SM): reduce_atb.cuh forms them from dx,
// the h_prev sequence and rho. `smem` holds gru_bwd_smem_bytes(R, H).
template <int R>
__device__ void gru_walk_bwd(const float* __restrict__ x, const float* __restrict__ wzr,
                             const float* __restrict__ wh, const float* __restrict__ hsrc,
                             int shift, const float* __restrict__ dys, float* __restrict__ dx,
                             float* __restrict__ rho, float* __restrict__ dh0, int B, int L,
                             int H, bool down, float* smem) {
  const int H2 = 2 * H, H3 = 3 * H;
  float* hp = smem;            // [R][H]   h_prev
  float* zr = hp + R * H;      // [R][2H]  z | r
  float* rh = zr + R * H2;     // [R][H]   r * h_prev
  float* c = rh + R * H;       // [R][H]   candidate
  float* dh = c + R * H;       // [R][H]
  float* carry = dh + R * H;   // [R][H]   dh carried to the next step of the walk
  float* da = carry + R * H;   // [R][3H]  da_z | da_r | da_c
  float* drh = da + R * H3;    // [R][H]   da_c @ Wh^T
  float* dsr = drh + R * H;    // [R][H]   [da_z | da_r] @ Wzr^T
  float* scratch = dsr + R * H;

  const int b0 = blockIdx.y * R;
  const int nrows = min(R, B - b0);

  for (int i = threadIdx.x; i < R * H; i += kThreads) carry[i] = 0.f;

  for (int s = 0; s < L; ++s) {
    const int t = down ? L - 1 - s : s;
    const int tp = t + shift;
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, u = idx % H;
      hp[idx] = r < nrows && tp >= 0 && tp < L ? hsrc[((size_t)(b0 + r) * L + tp) * H + u] : 0.f;
    }
    __syncthreads();
    // Recompute the gates and the candidate.
    matvec<kNone>(wzr, nullptr, H, H2, hp, H, zr, H2, R, scratch);
    for (int idx = threadIdx.x; idx < R * H2; idx += kThreads) {
      const int r = idx / H2, j = idx % H2;
      const float xv = r < nrows ? x[((size_t)(b0 + r) * L + t) * H3 + j] : 0.f;
      const float g = activate<kSigmoid>(zr[idx] + xv);
      zr[idx] = g;
      if (j >= H) rh[r * H + j - H] = g * hp[r * H + j - H];
    }
    __syncthreads();
    matvec<kNone>(wh, nullptr, H, H, rh, H, c, H, R, scratch);
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, u = idx % H;
      const size_t row = (size_t)(b0 + r) * L + t;
      const float cv = tanhf(c[idx] + (r < nrows ? x[row * H3 + H2 + u] : 0.f));
      c[idx] = cv;
      const float dhv = (r < nrows ? dys[row * H + u] : 0.f) + carry[idx];
      dh[idx] = dhv;
      const float z = zr[r * H2 + u];
      da[r * H3 + H2 + u] = dhv * z * (1.f - cv * cv);
    }
    __syncthreads();
    // Backprop through the candidate product, then the gates.
    matvec_t<R>(wh, H, H, da + H2, H3, drh, H);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, u = idx % H;
      const float z = zr[r * H2 + u], rg = zr[r * H2 + H + u], h = hp[idx];
      const float dz = dh[idx] * (c[idx] - h);
      da[r * H3 + u] = dz * z * (1.f - z);
      da[r * H3 + H + u] = drh[idx] * h * rg * (1.f - rg);
    }
    __syncthreads();
    matvec_t<R>(wzr, H, H2, da, H3, dsr, H);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, u = idx % H;
      const float z = zr[r * H2 + u], rg = zr[r * H2 + H + u];
      carry[idx] = drh[idx] * rg + dsr[idx] + dh[idx] * (1.f - z);
      if (r < nrows) rho[((size_t)(b0 + r) * L + t) * H + u] = rh[idx];
    }
    for (int idx = threadIdx.x; idx < R * H3; idx += kThreads) {
      const int r = idx / H3, j = idx % H3;
      if (r < nrows) dx[((size_t)(b0 + r) * L + t) * H3 + j] = da[idx];
    }
    __syncthreads();
  }
  if (dh0 != nullptr)
    for (int i = threadIdx.x; i < nrows * H; i += kThreads) dh0[(size_t)b0 * H + i] = carry[i];
}

}  // namespace
