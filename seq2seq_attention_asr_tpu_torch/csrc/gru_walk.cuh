// The walks of one bias-free GRU direction over time, shared by the
// flip-free BiGRU scan (K1 bigru_scan2.cu, K6 bigru_scan2_bwd.cu) and the
// one-direction and direction-stacked scans (K16/K18 gru_scan.cu, K17/K19
// gru_scan_bwd.cu). Each kernel is a thin __global__ function that picks
// its direction's arrays and calls a walk. Both walks run a direction for
// R batch rows on a thread-block cluster of C blocks (csrc/cluster_walk.cuh
// gives the scheme); block k owns the state units [k H / C, (k+1) H / C)
// and holds, in shared memory, the slice of Wzr and Wh that touches them
// (96 KB at H = 256, C = 8), so no step reads a weight from L2. Where a
// slice does not fit (at C = 8 and R = 4, H above 376 for the forward and
// 368 for the backward), the same walk reads it from L2 each step, each
// block 1/C of the direction's weight. The plan (C, R, resident) comes
// from the caller (ops/cuda/walk.py).
//
//   zr = sigmoid(h @ Wzr + x[:2H]);  c = tanh((r * h) @ Wh + x[2H:])
//   h' = (1 - z) * h + z * c
//
// Forward (gru_walk_fwd): block k holds its units' columns of Wzr (z and
// r) and of Wh, transposed as it loads them, one row of H floats per
// output, so that rows_dot forms each output as a dot product over
// contiguous floats. A step is two exchanges: z, r and r * h of the units
// from the gathered h, r * h pushed into every block; then c and h' of the
// units from the gathered r * h, h' pushed into every block. A push is
// st.async stores counted on the receiving block's mbarrier, and a block
// waits on its own mbarrier for the bytes its peers push, not at a cluster
// barrier, whose release fence (MEMBAR.ALL.GPU) made a step 9-12% slower.
// What bounds it: the L steps form a chain, each of two pushes and waits,
// and the products per block and step are R x (H/C) x 3H multiply-adds
// from shared memory, 58-66% of a step (tools/scan_phases.py --gru-fwd).
// K1 at B = 1, L = 132, H = 256: 3.4 us a step, 0.45 ms; at B = 16,
// L = 144 (R = 4) 4.9 us, 0.70 ms (chip_smoke.py phase 8 on an NVIDIA
// H100 80GB HBM3 at 700.00 W).
//
// Backward (gru_gates_kernel, then gru_walk_bwd): every step's h_prev is
// an input, so the pre-pass forms z, r, c and r * h_prev for all B*L rows
// in parallel, and the walk keeps only its two transposed products on the
// chain, from its rows of Wzr and Wh. What bounds a step: its two cluster
// barriers, the distributed-shared-memory pushes before them, and the two
// transposed products, whose 4-byte shared-memory loads (one per two
// multiply-adds) grow with R. K6 at B = 16, L = 144, H = 256, R = 4:
// 5.0 us a step (4.2 at R = 1, 16.3 at R = 16; chip_smoke.py phase 8 on
// an NVIDIA H100 80GB HBM3 at 700.00 W).

#pragma once

#include "cluster_walk.cuh"
#include "common.cuh"

namespace {

// One direction of a GRU forward, its arrays of IO type T (float, or
// bf16 for K1's bf16 entry).
template <class T>
struct GruFwdDirT {
  const T* x;    // (B, L, 3H) input projections
  const T* h0;   // (B, H) the initial state, or null for zeros
  const T* wzr;  // (H, 2H)
  const T* wh;   // (H, H)
  T* ys;         // (B, L, H)
  int reverse;   // step s reads and writes t = L-1-s, else t = s
};
using GruFwdDir = GruFwdDirT<float>;

template <class T>
struct GruFwdT {
  GruFwdDirT<T> d[2];
  int B, L, H;
};
using GruFwd = GruFwdT<float>;

// Shared memory of the forward walk: the weight slices (3H floats a
// unit), the gathered h and r * h (R x 2H), two buffers of three staged
// step inputs (x_z, x_r, x_c) and z per unit. Its two mbarriers are
// static shared memory, which the limits helper takes off the budget.
size_t gru_fwd_smem_bytes(const WalkPlan& p, int H) {
  return walk_smem_bytes(p, H, 3 * H, 2 * H, 3, 1);
}

// The forward walk of direction `a` for the R batch rows of this block's
// cluster (group blockIdx.x / C). Each step s, at t = s (or L-1-s):
//
//   z, r = sigmoid(h @ Wzr + x[t, :2H]);  r * h            [push, wait]
//   c = tanh((r * h) @ Wh + x[t, 2H:]);  h = (1 - z) h + z c;  ys[t] = h
//                                                          [push, wait]
//   (the copies that stage step s+1's x start before the second wait)
//
// for the block's units. A push is the block's threads storing its units'
// values into every other block's gathered rows with st.async,
// consecutive threads at consecutive addresses, after a block barrier
// that makes the block's own values visible to all its threads. The
// waits are on this block's mbarriers, one for each exchange, whose phase
// s completes when the peers' R x (H - hs) floats of step s have landed. Single buffers
// suffice, by causality: a peer pushes r * h of step s+1 only after it
// has every block's h of step s, which this block pushes only after a
// block barrier behind its candidate product's reads of r * h of step s;
// a peer pushes h of step s only after it has this block's r * h of step
// s, pushed behind the gate products' reads of h. For the same reason
// thread 0 arms an mbarrier's next phase as soon as it has seen one
// complete: no push of that phase can have started. Rows past B keep
// h = 0, as their staged x is 0. A zero x row and h = 0 give h' = 0
// exactly, so a zero-padded tail holds h at 0. `smem` holds
// gru_fwd_smem_bytes.
//
// With bf16 IO (T), as the JAX kernel with bf16 inputs: x, h0 and the
// weights load widened to float (the slices stay float in shared memory,
// so the plan is the float walk's), the products read their operands h
// and r * h rounded to bf16 while h and r * h stay float (h is the
// carry), and ys stores rounded.
template <int R, class T = float>
__device__ void gru_walk_fwd(const GruFwdDirT<T>& a, int B, int L, int H, bool resident,
                             float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int lo = k * H / C, hs = (k + 1) * H / C - lo, hm = (H + C - 1) / C;
  const int H2 = 2 * H, H3 = 3 * H, RM = R * hm;
  const int b0 = (blockIdx.x / C) * R, nrows = min(R, B - b0);
  const size_t lx = (size_t)L * H3, lh = (size_t)L * H;  // batch-row strides

  float* w_z = smem;                           // [hm][H] resident: unit i's column of Wzr[:, :H]
  float* w_r = w_z + (resident ? hm * H : 0);  // [hm][H]   ... of Wzr[:, H:]
  float* w_c = w_r + (resident ? hm * H : 0);  // [hm][H]   ... of Wh
  float* gh = w_c + (resident ? hm * H : 0);   // [R][H]    h, every unit
  float* grh = gh + R * H;                     // [R][H]    r * h, every unit
  float* stg = grh + R * H;                    // [2][3][R][hm]  a step's staged x
  float* z = stg + 6 * RM;                     // [R][hm]

  if (resident)
    for (int j = threadIdx.x; j < H; j += kThreads) {
      const T* wzr = a.wzr + (size_t)j * H2 + lo;
      const T* wh = a.wh + (size_t)j * H + lo;
#pragma unroll 4
      for (int i = 0; i < hs; ++i) {
        w_z[i * H + j] = ldg_f(wzr + i);
        w_r[i * H + j] = ldg_f(wzr + H + i);
        w_c[i * H + j] = ldg_f(wh + i);
      }
    }
  for (int i = threadIdx.x; i < R * H; i += kThreads)
    gh[i] = a.h0 != nullptr && i / H < nrows ? to_f(a.h0[(size_t)b0 * H + i]) : 0.f;

  // The block's units of the product v @ W (v: R x H, gathered), as
  // rows_dot's rows: the transposed slice in shared memory, or the
  // columns of W from L2 (`wg`, row stride ldg).
  auto product = [&](const float* ws, const T* wg, int ldg, const float* v, auto emit) {
    if (resident)
      rows_dot<R, false, false, kIsBf16<T>>(ws, H, hs, v, H, H, emit);
    else
      rows_dot<R, true, false, kIsBf16<T>>(wg, ldg, hs, v, H, H, emit);
  };
  // Stage step s's x of the block's units, 16 bytes a copy where every
  // slice is 4-float aligned.
  const bool vec = H % (4 * C) == 0 && (reinterpret_cast<size_t>(a.x) & 15) == 0;
  auto prefetch = [&](int s) {
    const int t = a.reverse ? L - 1 - s : s;
    float* q = stg + (s & 1) * 3 * RM;
    const T* x = a.x + ((size_t)b0 * L + t) * H3 + lo;
    stage_async<R>(q, hm, x, lx, hs, nrows, vec);
    stage_async<R>(q + RM, hm, x + H, lx, hs, nrows, vec);
    stage_async<R>(q + 2 * RM, hm, x + H2, lx, hs, nrows, vec);
  };
  // bars[0] counts the r * h the peers push in a step, bars[1] their h:
  // R x (H - hs) floats each. Thread 0 arms a phase as soon as the one
  // before it has completed, before this block pushes anything that lets
  // a peer start the pushes of the next.
  __shared__ unsigned long long bars[2];
  const unsigned tx = 4u * R * (H - hs);
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_init_fence();
    mbar_expect(&bars[0], tx);
    mbar_expect(&bars[1], tx);
  }
  prefetch(0);
  cluster.sync();  // every block's mbarriers are armed before any push into it

  for (int s = 0; s < L; ++s) {
    const int t = a.reverse ? L - 1 - s : s;
    copy_async_wait();
    __syncthreads();
    // [phase] staging wait
    const float* q = stg + (s & 1) * 3 * RM;
    const float *xz = q, *xr = q + RM, *xc = q + 2 * RM;
    product(w_z, a.wzr + lo, H2, gh, [&](int i, int r, float v) {
      z[r * hm + i] = activate<kSigmoid>(v + xz[r * hm + i]);
    });
    product(w_r, a.wzr + H + lo, H2, gh, [&](int i, int r, float v) {
      const int o = r * H + lo + i;
      grh[o] = activate<kSigmoid>(v + xr[r * hm + i]) * gh[o];
    });
    __syncthreads();
    // [phase] zr product
    push_units<R>(grh, &bars[0], H, lo, hs, C, k);
    mbar_wait(&bars[0], s & 1);
    // [phase] rh push
    if (threadIdx.x == 0 && s + 1 < L) mbar_expect(&bars[0], tx);
    T* ys = a.ys + ((size_t)b0 * L + t) * H + lo;  // batch row r at ys + r * lh
    product(w_c, a.wh + lo, H, grh, [&](int i, int r, float v) {
      const int o = r * H + lo + i;
      const float zg = z[r * hm + i];
      const float hn = (1.f - zg) * gh[o] + zg * tanhf(v + xc[r * hm + i]);
      gh[o] = hn;
      if (r < nrows) st_f(ys + r * lh + i, hn);
    });
    __syncthreads();
    // [phase] candidate product
    push_units<R>(gh, &bars[1], H, lo, hs, C, k);
    if (s + 1 < L) prefetch(s + 1);  // the other staging buffer, read last in step s - 1
    mbar_wait(&bars[1], s & 1);
    // [phase] h push
    if (threadIdx.x == 0 && s + 1 < L) mbar_expect(&bars[1], tx);
  }
  cluster.sync();  // no block leaves before the cluster's last pushes have landed
}

// Run a GRU forward of D directions: `walk` on clusters of p.cluster
// blocks, ceil(B / p.rows) clusters per direction.
template <class T>
cudaError_t run_gru_fwd(const GruFwdT<T>& g, int D, const WalkPlan& p,
                        void (*walk)(const GruFwdT<T>, int), cudaStream_t stream) {
  const size_t smem = gru_fwd_smem_bytes(p, g.H);
  cudaError_t err = check_plan(p, g.H, smem);
  if (err != cudaSuccess) return err;
  if (walk == nullptr) return cudaErrorInvalidValue;
  const int groups = (g.B + p.rows - 1) / p.rows;
  return launch_cluster(walk, dim3(p.cluster * groups, D), p.cluster, smem, stream, g,
                        p.resident);
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
  return walk_smem_bytes(p, H, 3 * H, 3 * H, 5, 3);
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
// __global__ template (a function of (GruFwd or GruBwd, int resident)).
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
