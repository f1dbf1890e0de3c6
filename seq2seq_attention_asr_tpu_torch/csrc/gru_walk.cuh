// The walks of one bias-free GRU direction over time, shared by the
// flip-free BiGRU scan (K1 bigru_scan2.cu, K6 bigru_scan2_bwd.cu) and the
// one-direction and direction-stacked scans (K16/K18 gru_scan.cu, K17/K19
// gru_scan_bwd.cu). Each kernel is a thin __global__ function that picks
// its direction's arrays and calls a walk.
//
//   zr = sigmoid(h @ Wzr + x[:2H]);  c = tanh((r * h) @ Wh + x[2H:])
//   h' = (1 - z) * h + z * c
//
// Forward (gru_walk_fwd): one block walks one direction for R batch rows.
// The L steps form a dependency chain, and each needs the direction's
// whole recurrent weight (3H^2 floats, 768 KB at H = 256), read from L2
// every step; the state lives in shared memory, so each weight is read
// once per step for all the block's rows. Load latency limits one block's
// weight stream, so the loads are 16 bytes wide and the input dimension
// of each product is split over thread groups; partial sums meet in
// shared memory.
//
// Backward (gru_gates_kernel, then gru_walk_bwd on a thread-block
// cluster; csrc/cluster_walk.cuh gives the scheme): every step's h_prev
// is an input, so the pre-pass forms z, r, c and r * h_prev for all B*L
// rows in parallel, and the walk keeps only its two transposed products
// on the chain. Block k of a cluster of C holds rows [k H / C, (k+1) H / C)
// of Wzr and Wh (96 KB at H = 256, C = 8) in shared memory, so no step
// reads a weight from L2. What bounds a step: its two cluster barriers,
// the distributed-shared-memory pushes before them, and the two
// transposed products, whose 4-byte shared-memory loads (one per two
// multiply-adds) grow with R. K6 at B = 16, L = 144, H = 256, R = 4:
// 5.0 us a step (4.2 at R = 1, 16.3 at R = 16; chip_smoke.py phase 8 on
// an NVIDIA H100 80GB HBM3 at 700.00 W). Where a slice does not fit (H
// above ~300 at C = 8), the same walk reads it from L2 each step, each
// block 1/C of the direction's weight.

#pragma once

#include "cluster_walk.cuh"
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

// One direction of a GRU backward.
struct GruBwdDir {
  const float* x;     // (B, L, 3H) input projections
  const float* wzr;   // (H, 2H)
  const float* wh;    // (H, H)
  const float* hsrc;  // (B, L, H): step t's h_prev is hsrc[t + shift], 0 outside [0, L)
  const float* dys;   // (B, L, H) the outputs' cotangent
  float* dx;          // (B, L, 3H): the pre-pass's z | r | c, then da_z | da_r | da_c
  float* rho;         // (B, L, H): r * h_prev, for the reduction of dWh
  float* dh0;         // (B, H), the carry after the last step, or null
  int shift, down;    // down: the walk runs t = L-1..0, else t = 0..L-1
};

struct GruBwd {
  GruBwdDir d[2];
  int B, L, H;
};

// Shared memory of the backward walk: the weight slices (3H floats a
// row), the gathered [da_z | da_r | da_c] (R x 3H), two buffers of five
// staged step inputs (z, r, c, h_prev, dys) and dh, drh, carry per unit.
size_t gru_walk_smem_bytes(const WalkPlan& p, int H) {
  return walk_smem_bytes(p, H, 3 * H, 1, 5, 3);
}

// The gate pre-pass over every (row, step) n of direction blockIdx.y, one
// 64 x 64 output tile a block. Stage 0: zr = sigmoid(h_prev @ Wzr +
// x[:2H]) into dx[:, :2H] and rho = r * h_prev; stage 1 (a second launch,
// after stage 0): c = tanh(rho @ Wh + x[2H:]) into dx[:, 2H:].
__global__ void __launch_bounds__(kTileThreads) gru_gates_kernel(const GruBwd g, int stage) {
  const GruBwdDir& a = g.d[blockIdx.y];
  const int H = g.H, L = g.L, H3 = 3 * H, rows = g.B * g.L;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.z * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  auto hprev = [&](int n, int k) -> float {
    const int tp = n % L + a.shift;
    return tp >= 0 && tp < L ? a.hsrc[(size_t)(n + a.shift) * H + k] : 0.f;
  };
  float acc[4][4];
  if (stage == 0) {
    tile_product(
        acc, [&](int n, int k) { return n < rows ? hprev(n, k) : 0.f; },
        [&](int k, int j) { return j < 2 * H ? a.wzr[(size_t)k * 2 * H + j] : 0.f; }, i0, j0, H);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = i0 + 4 * ty + r, j = j0 + 4 * tx + c;
        if (n >= rows || j >= 2 * H) continue;
        const float gv = activate<kSigmoid>(acc[r][c] + a.x[(size_t)n * H3 + j]);
        a.dx[(size_t)n * H3 + j] = gv;
        if (j >= H) a.rho[(size_t)n * H + j - H] = gv * hprev(n, j - H);
      }
  } else {
    tile_product(
        acc, [&](int n, int k) { return n < rows ? a.rho[(size_t)n * H + k] : 0.f; },
        [&](int k, int j) { return j < H ? a.wh[(size_t)k * H + j] : 0.f; }, i0, j0, H);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = i0 + 4 * ty + r, j = j0 + 4 * tx + c;
        if (n < rows && j < H)
          a.dx[(size_t)n * H3 + 2 * H + j] = tanhf(acc[r][c] + a.x[(size_t)n * H3 + 2 * H + j]);
      }
  }
}

// The backward walk of direction `a` for the R batch rows of this block's
// cluster (group blockIdx.x / C), after the pre-pass. Each step t, from
// the gates the pre-pass left in dx[t]:
//
//   dh = dys[t] + carry;  da_c = dh z (1 - c^2)          [push, barrier]
//   drh = da_c @ Wh^T;  da_z = dh (c - h_prev) z (1 - z);
//   da_r = drh h_prev r (1 - r)                          [push, barrier]
//   (the copies that stage step t+1's inputs start inside this barrier)
//   carry = drh r + [da_z | da_r] @ Wzr^T + dh (1 - z)
//   dx[t] = [da_z | da_r | da_c]
//
// for the block's units, and dh0 (unless null) gets the carry after the
// last step. A push is each thread storing its units' cotangents into
// every block's gathered rows, consecutive threads at consecutive
// addresses. A block overwrites a peer's da_c of step t+1 only after the second
// barrier of step t, which every peer reaches after reading da_c of step
// t; likewise for da_z | da_r and the first barrier of step t+1.
// The weight gradients are not summed here: reduce_atb.cuh forms them from
// dx, the h_prev sequence and rho. `smem` holds gru_walk_smem_bytes.
template <int R>
__device__ void gru_walk_bwd(const GruBwdDir& a, int B, int L, int H, bool resident,
                             float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int lo = k * H / C, hs = (k + 1) * H / C - lo, hm = (H + C - 1) / C;
  const int H2 = 2 * H, H3 = 3 * H, RM = R * hm;
  const int b0 = (blockIdx.x / C) * R, nrows = min(R, B - b0);
  const size_t lx = (size_t)L * H3, lh = (size_t)L * H;  // batch-row strides

  float* w_zr = smem;                            // [hm][2H]  resident rows of Wzr
  float* w_h = w_zr + (resident ? hm * H2 : 0);  // [hm][H]   resident rows of Wh
  float* gath = w_h + (resident ? hm * H : 0);   // [R][3H]   da_z | da_r | da_c, every unit
  float* stg = gath + R * H3;                    // [2][5][R][hm]  a step's staged inputs
  float* dh = stg + 10 * RM;                     // [R][hm]
  float* drh = dh + RM;                          // [R][hm]
  float* carry = drh + RM;                       // [R][hm]

  const float* wzr = a.wzr + (size_t)lo * H2;
  const float* wh = a.wh + (size_t)lo * H;
  if (resident) {
    for (int i = threadIdx.x; i < hs * H2; i += kThreads) w_zr[i] = __ldg(wzr + i);
    for (int i = threadIdx.x; i < hs * H; i += kThreads) w_h[i] = __ldg(wh + i);
    wzr = w_zr;
    wh = w_h;
  }
  for (int i = threadIdx.x; i < RM; i += kThreads) carry[i] = 0.f;

  // Stage step s's z, r, c, h_prev and dys of the block's units, 16 bytes
  // a copy where every slice is 4-float aligned.
  const bool vec = H % (4 * C) == 0 &&
                   ((reinterpret_cast<size_t>(a.dx) | reinterpret_cast<size_t>(a.hsrc) |
                     reinterpret_cast<size_t>(a.dys)) & 15) == 0;
  auto prefetch = [&](int s) {
    const int t = a.down ? L - 1 - s : s, tp = t + a.shift;
    float* q = stg + (s & 1) * 5 * RM;
    const float* x = a.dx + ((size_t)b0 * L + t) * H3 + lo;
    stage_async<R>(q, hm, x, lx, hs, nrows, vec);
    stage_async<R>(q + RM, hm, x + H, lx, hs, nrows, vec);
    stage_async<R>(q + 2 * RM, hm, x + H2, lx, hs, nrows, vec);
    stage_async<R>(q + 3 * RM, hm,
                   tp >= 0 && tp < L ? a.hsrc + ((size_t)b0 * L + tp) * H + lo : nullptr, lh, hs,
                   nrows, vec);
    stage_async<R>(q + 4 * RM, hm, a.dys + ((size_t)b0 * L + t) * H + lo, lh, hs, nrows, vec);
  };
  prefetch(0);
  cluster.sync();  // every block of the cluster runs before any push into its shared memory

  for (int s = 0; s < L; ++s) {
    const int t = a.down ? L - 1 - s : s;
    copy_async_wait();
    __syncthreads();
    const float* q = stg + (s & 1) * 5 * RM;
    const float *z = q, *rg = q + RM, *c = q + 2 * RM, *hp = q + 3 * RM, *dy = q + 4 * RM;
    float* dx = a.dx + ((size_t)b0 * L + t) * H3 + lo;  // batch row r at dx + r * lx
    for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
      const int r = idx / hs, i = idx - r * hs, o = r * hm + i;
      const float dhv = dy[o] + carry[o];
      dh[o] = dhv;
      const float dac = dhv * z[o] * (1.f - c[o] * c[o]);
      for (int p = 0; p < C; ++p) cluster.map_shared_rank(gath, p)[r * H3 + H2 + lo + i] = dac;
      if (r < nrows) dx[r * lx + H2 + i] = dac;
    }
    cluster.sync();
    rows_dot<R>(wh, H, hs, gath + H2, H3, H, [&](int i, int r, float v) { drh[r * hm + i] = v; });
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
      const int r = idx / hs, i = idx - r * hs, o = r * hm + i;
      const float zg = z[o], rv = rg[o], h = hp[o];
      const float daz = dh[o] * (c[o] - h) * zg * (1.f - zg);
      const float dar = drh[o] * h * rv * (1.f - rv);
      for (int p = 0; p < C; ++p) {
        float* gp = cluster.map_shared_rank(gath, p) + r * H3 + lo + i;
        gp[0] = daz;
        gp[H] = dar;
      }
      if (r < nrows) {
        dx[r * lx + i] = daz;
        dx[r * lx + H + i] = dar;
      }
    }
    cluster_arrive();
    if (s + 1 < L) prefetch(s + 1);  // the other staging buffer, read last in step s - 1
    cluster_wait();
    rows_dot<R>(wzr, H2, hs, gath, H3, H2, [&](int i, int r, float v) {
      const int o = r * hm + i;
      carry[o] = drh[o] * rg[o] + v + dh[o] * (1.f - z[o]);
    });
  }
  __syncthreads();
  if (a.dh0 != nullptr)
    for (int idx = threadIdx.x; idx < nrows * hs; idx += kThreads) {
      const int r = idx / hs, i = idx - r * hs;
      a.dh0[(size_t)(b0 + r) * H + lo + i] = carry[r * hm + i];
    }
  cluster.sync();  // no block leaves while its shared memory may still be a peer's target
}

// The walk instance for R batch rows per cluster, from a source's
// __global__ template (a function of (GruBwd, int resident)).
#define GRU_WALK_INSTANCE(kernel, R)                                              \
  ((R) == 1    ? kernel<1>                                                        \
   : (R) == 2  ? kernel<2>                                                        \
   : (R) == 4  ? kernel<4>                                                        \
   : (R) == 8  ? kernel<8>                                                        \
   : (R) == 16 ? kernel<16>                                                       \
               : nullptr)

// Run a GRU backward of D directions without the weight gradients: the
// two pre-pass launches, then `walk` on clusters of p.cluster blocks,
// ceil(B / p.rows) clusters per direction.
cudaError_t run_gru_bwd(const GruBwd& g, int D, const WalkPlan& p,
                        void (*walk)(const GruBwd, int), cudaStream_t stream) {
  const size_t smem = gru_walk_smem_bytes(p, g.H);
  cudaError_t err = check_plan(p, g.H, smem);
  if (err != cudaSuccess) return err;
  if (walk == nullptr) return cudaErrorInvalidValue;
  const int tiles = (g.B * g.L + kTile - 1) / kTile;
  const dim3 zr_tiles(tiles, D, (2 * g.H + kTile - 1) / kTile);
  const dim3 c_tiles(tiles, D, (g.H + kTile - 1) / kTile);
  gru_gates_kernel<<<zr_tiles, kTileThreads, 0, stream>>>(g, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gru_gates_kernel<<<c_tiles, kTileThreads, 0, stream>>>(g, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int groups = (g.B + p.rows - 1) / p.rows;
  return launch_cluster(walk, dim3(p.cluster * groups, D), p.cluster, smem, stream, g,
                        p.resident);
}

}  // namespace
