// Backward of the bidirectional LSTM scan, without peepholes (kernel K9).
//
// Replaces the Pallas kernel bilstm_scan backward
// (seq2seq_attention_asr_tpu/ops/pallas/lstm_scan.py: _run_bwd :139,
// pallas_call :145, _bwd_kernel :58, VJP _vjp_bwd :194). Plain PyTorch
// twin: ops/cuda/lstm_scan.py::bilstm_scan_bwd_plain.
//
// Both directions walk t = L-1..0 over the direction-stacked arrays
// (direction 1 in its own scan order, as the forward ran it), from the
// previous hidden and cell states (the saved sequences shifted by one
// step, the initial state in front):
//
//   dh = dys[t] + dh_carry;  dc = dc_carry + dh o (1 - tanh(c)^2)
//   da = [dc g i(1-i) | dc c_prev f(1-f) | dc i (1-g^2) | dh tanh(c) o(1-o)]
//   dxproj[t] = da;  dh_carry = da @ W_h^T;  dc_carry = dc f
//
// and dh0, dc0 are the carries after step 0.
//
// Three stages (csrc/cluster_walk.cuh gives the scheme):
//   1. lstm_gates_kernel: i, f, g, o = act(h_prev @ W_h + xproj) and
//      tanh(c), c = f c_prev + i g, for all B*L rows of both directions,
//      as tiled products, off the step chain; the gates go where dxproj
//      goes, tanh(c) to scratch;
//   2. bilstm_scan_bwd_kernel: per direction and group of R rows, one
//      thread-block cluster walks the steps, block k holding rows
//      [k H / C, (k+1) H / C) of W_h (H x 4H; 32 KB at H = 128, C = 8) in
//      shared memory and owning those units. What bounds it: the L steps
//      form a chain, and each costs one cluster barrier after a push of
//      the step's da (R x 4H) into every block; the gathered da is double
//      buffered, so a push of step t+1 never overwrites what a peer still
//      reads for step t. The product per block and step is R x (H/C) x 4H
//      multiply-adds from shared memory. At B = 16, L' = 16, H = 128
//      (R = 4): pre-pass 0.024 ms, walk 0.058 ms (3.6 us a step),
//      reduction 0.040 ms, 0.122 ms in all against cuDNN's bidirectional
//      LSTM backward's 0.168 ms (chip_smoke.py phase 8 on an NVIDIA H100
//      80GB HBM3 at 700.00 W);
//   3. reduce_atb.cuh: dW_h = sum h_prev^T da over the B*L rows, tiled and
//      deterministic (no atomics).
// The plan (C, R, resident) comes from the caller (ops/cuda/walk.py).
// The bf16 entry (bilstm_scan_bwd_bf16: lstm_gates_bf16_kernel,
// bilstm_scan_bwd_bf16_kernel<R>) is the same three stages with bf16
// xproj2 and W_h widened as they load, on the same plan: the JAX kernel
// with bf16 inputs rounds nothing, and its outputs are float32. At B = 16,
// L' = 16: 0.1225 ms against the float32 kernel's 0.1216 on the upcast
// inputs (chip_smoke.py phase 12 (d), NVIDIA H100 80GB HBM3, 700.00 W).

#include "cluster_walk.cuh"
#include "reduce_atb.cuh"

namespace {

// T is the IO type of xproj2 and wh2: float, or bf16 for the bf16 entry
// (bilstm_scan_bwd_bf16), which widens them as it loads them; the states,
// the cotangents and every output are float32 either way.
template <class T>
struct LstmBwdT {
  const T* xproj2;      // (2, B, L, 4H)
  const float* hprev2;  // (2, B, L, H)
  const float* cprev2;  // (2, B, L, H)
  const float* dys2;    // (2, B, L, H)
  const T* wh2;         // (2, H, 4H)
  float* dx2;           // (2, B, L, 4H): the pre-pass's i | f | g | o, then da
  float* tc2;           // (2, B, L, H): tanh(c)
  float* dh02;          // (2, B, H)
  float* dc02;          // (2, B, H)
  int B, L, H;
};

// Shared memory of the walk: the weight slices (4H floats a row), two
// buffers of the gathered da (R x 4H), two buffers of seven staged step
// inputs (i, f, g, o, tanh(c), c_prev, dys) and the two carries per unit.
size_t lstm_walk_smem_bytes(const WalkPlan& p, int H) {
  return walk_smem_bytes(p, H, 4 * H, 8 * H, 7, 2);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The gate pre-pass over the rows n of direction blockIdx.y, one tile of
// 64 rows by 16 units (all four gates of each) a block; thread (ty, tx)
// holds the four gates of unit u0 + tx for rows i0 + 4 ty + r.
template <class T>
__device__ __forceinline__ void lstm_gates(const LstmBwdT<T>& a) {
  const int H = a.H, H4 = 4 * H, rows = a.B * a.L;
  const size_t off = (size_t)blockIdx.y * rows;
  const float* hp = a.hprev2 + off * H;
  const T* w = a.wh2 + (size_t)blockIdx.y * H * H4;
  const int i0 = blockIdx.x * kTile, u0 = blockIdx.z * (kTile / 4);
  float acc[4][4];
  tile_product(
      acc, [&](int n, int k) { return n < rows ? hp[(size_t)n * H + k] : 0.f; },
      [&](int k, int j) {
        const int u = u0 + j / 4;
        return u < H ? to_f(w[(size_t)k * H4 + (j % 4) * H + u]) : 0.f;
      },
      i0, 0, H);
  const int ty = threadIdx.x / 16, u = u0 + threadIdx.x % 16;
  if (u >= H) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = i0 + 4 * ty + r;
    if (n >= rows) continue;
    const size_t at = off + n;
    const T* x = a.xproj2 + at * H4;
    float* g = a.dx2 + at * H4;
    const float ig = sigmoid(acc[r][0] + to_f(x[u]));
    const float fg = sigmoid(acc[r][1] + to_f(x[H + u]));
    const float gg = tanhf(acc[r][2] + to_f(x[2 * H + u]));
    const float og = sigmoid(acc[r][3] + to_f(x[3 * H + u]));
    g[u] = ig, g[H + u] = fg, g[2 * H + u] = gg, g[3 * H + u] = og;
    a.tc2[at * H + u] = tanhf(fg * a.cprev2[at * H + u] + ig * gg);
  }
}

__global__ void __launch_bounds__(kTileThreads) lstm_gates_kernel(const LstmBwdT<float> a) {
  lstm_gates(a);
}

// The bf16 entry's pre-pass.
__global__ void __launch_bounds__(kTileThreads) lstm_gates_bf16_kernel(const LstmBwdT<bf16> a) {
  lstm_gates(a);
}

// The walk of direction blockIdx.y for the R batch rows of this block's
// cluster (group blockIdx.x / C), after the pre-pass.
template <int R, class T>
__device__ __forceinline__ void bilstm_bwd_walk(const LstmBwdT<T>& a, int resident, float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int H = a.H, L = a.L, H4 = 4 * H;
  const int lo = k * H / C, hs = (k + 1) * H / C - lo, hm = (H + C - 1) / C, RM = R * hm;
  const int b0 = (blockIdx.x / C) * R, nrows = min(R, a.B - b0);
  const size_t row0 = (size_t)blockIdx.y * a.B + b0;  // first (direction, batch) row
  const size_t l4 = (size_t)L * H4, lh = (size_t)L * H;  // batch-row strides

  float* w_s = smem;                             // [hm][4H]  resident rows of W_h
  float* gath = w_s + (resident ? hm * H4 : 0);  // [2][R][4H]  da of every unit
  float* stg = gath + 2 * R * H4;                // [2][7][R][hm]  a step's staged inputs
  float* dhc = stg + 14 * RM;                    // [R][hm]  dh carried to the previous step
  float* dcc = dhc + RM;                         // [R][hm]  dc carried to the previous step

  const T* w = a.wh2 + ((size_t)blockIdx.y * H + lo) * H4;  // widened where it is read
  if (resident)
    for (int i = threadIdx.x; i < hs * H4; i += kThreads) w_s[i] = ldg_f(w + i);
  for (int i = threadIdx.x; i < RM; i += kThreads) dhc[i] = dcc[i] = 0.f;

  // Stage step s's i, f, g, o, tanh(c), c_prev and dys of the block's
  // units, 16 bytes a copy where every slice is 4-float aligned.
  const bool vec = H % (4 * C) == 0 &&
                   ((reinterpret_cast<size_t>(a.dx2) | reinterpret_cast<size_t>(a.tc2) |
                     reinterpret_cast<size_t>(a.cprev2) | reinterpret_cast<size_t>(a.dys2)) &
                    15) == 0;
  auto prefetch = [&](int s) {
    const int t = L - 1 - s;
    float* q = stg + (s & 1) * 7 * RM;
    const float* g = a.dx2 + (row0 * L + t) * H4 + lo;
    for (int gate = 0; gate < 4; ++gate)
      stage_async<R>(q + gate * RM, hm, g + gate * H, l4, hs, nrows, vec);
    const size_t at = (row0 * L + t) * H + lo;
    stage_async<R>(q + 4 * RM, hm, a.tc2 + at, lh, hs, nrows, vec);
    stage_async<R>(q + 5 * RM, hm, a.cprev2 + at, lh, hs, nrows, vec);
    stage_async<R>(q + 6 * RM, hm, a.dys2 + at, lh, hs, nrows, vec);
  };
  prefetch(0);
  cluster.sync();  // every block of the cluster runs before any push into its shared memory

  for (int s = 0; s < L; ++s) {
    const int t = L - 1 - s;
    copy_async_wait();
    __syncthreads();
    const float* q = stg + (s & 1) * 7 * RM;
    const float *ig = q, *fg = q + RM, *gg = q + 2 * RM, *og = q + 3 * RM, *tc = q + 4 * RM,
                *cp = q + 5 * RM, *dy = q + 6 * RM;
    float* buf = gath + (s & 1) * R * H4;
    float* dx = a.dx2 + (row0 * L + t) * H4 + lo;  // batch row r at dx + r * l4
    for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
      const int r = idx / hs, i = idx - r * hs, o = r * hm + i;
      const float dhv = dy[o] + dhc[o];
      const float dcv = dcc[o] + dhv * og[o] * (1.f - tc[o] * tc[o]);
      const float da0 = dcv * gg[o] * ig[o] * (1.f - ig[o]);
      const float da1 = dcv * cp[o] * fg[o] * (1.f - fg[o]);
      const float da2 = dcv * ig[o] * (1.f - gg[o] * gg[o]);
      const float da3 = dhv * tc[o] * og[o] * (1.f - og[o]);
      dcc[o] = dcv * fg[o];
      for (int p = 0; p < C; ++p) {
        float* gp = cluster.map_shared_rank(buf, p) + r * H4 + lo + i;
        gp[0] = da0, gp[H] = da1, gp[2 * H] = da2, gp[3 * H] = da3;
      }
      if (r < nrows) {
        float* dxr = dx + r * l4 + i;
        dxr[0] = da0, dxr[H] = da1, dxr[2 * H] = da2, dxr[3 * H] = da3;
      }
    }
    cluster_arrive();
    if (s + 1 < L) prefetch(s + 1);  // the other staging buffer, read last in step s - 1
    cluster_wait();
    const auto carry = [&](int i, int r, float v) { dhc[r * hm + i] = v; };
    if (resident)
      rows_dot<R>(w_s, H4, hs, buf, H4, H4, carry);
    else
      rows_dot<R>(w, H4, hs, buf, H4, H4, carry);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * hs; idx += kThreads) {
    const int r = idx / hs, i = idx - r * hs;
    a.dh02[(row0 + r) * H + lo + i] = dhc[r * hm + i];
    a.dc02[(row0 + r) * H + lo + i] = dcc[r * hm + i];
  }
  cluster.sync();  // no block leaves while its shared memory may still be a peer's target
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bilstm_scan_bwd_kernel(const LstmBwdT<float> a, int resident) {
  extern __shared__ float smem[];
  bilstm_bwd_walk<R>(a, resident, smem);
}

// The bf16 entry's walk.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bilstm_scan_bwd_bf16_kernel(const LstmBwdT<bf16> a, int resident) {
  extern __shared__ float smem[];
  bilstm_bwd_walk<R>(a, resident, smem);
}

template <class T>
using LstmBwdWalk = void (*)(const LstmBwdT<T>, int);

// The walk's instance for `rows` batch rows a cluster (R = 16 where rows
// is none of 1, 2, 4 and 8).
template <class T>
LstmBwdWalk<T> lstm_bwd_walk_instance(int rows) {
  if constexpr (kIsBf16<T>)
    return rows == 1   ? bilstm_scan_bwd_bf16_kernel<1>
           : rows == 2 ? bilstm_scan_bwd_bf16_kernel<2>
           : rows == 4 ? bilstm_scan_bwd_bf16_kernel<4>
           : rows == 8 ? bilstm_scan_bwd_bf16_kernel<8>
                       : bilstm_scan_bwd_bf16_kernel<16>;
  else
    return rows == 1   ? bilstm_scan_bwd_kernel<1>
           : rows == 2 ? bilstm_scan_bwd_kernel<2>
           : rows == 4 ? bilstm_scan_bwd_kernel<4>
           : rows == 8 ? bilstm_scan_bwd_kernel<8>
                       : bilstm_scan_bwd_kernel<16>;
}

template <class T>
int bilstm_scan_bwd_run(const LstmBwdT<T>& a, float* dwh2, int cluster, int rows, int resident,
                        cudaStream_t stream) {
  const int B = a.B, L = a.L, H = a.H;
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const WalkPlan plan{cluster, rows, resident};
  const size_t smem = lstm_walk_smem_bytes(plan, H);
  cudaError_t err = check_plan(plan, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles((B * L + kTile - 1) / kTile, 2, (H + kTile / 4 - 1) / (kTile / 4));
  if constexpr (kIsBf16<T>)
    lstm_gates_bf16_kernel<<<tiles, kTileThreads, 0, stream>>>(a);
  else
    lstm_gates_kernel<<<tiles, kTileThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int groups = (B + rows - 1) / rows;
  err = launch_cluster(lstm_bwd_walk_instance<T>(rows), dim3(cluster * groups, 2), cluster, smem,
                       stream, a, resident);
  if (err != cudaSuccess) return (int)err;

  // dW_h[d] = sum over (b, t) of h_prev^T da, da being dxproj (both float).
  const size_t n = (size_t)B * L;
  AtbBatch batch{};
  batch.count = 2;
  batch.rows = (int)n;
  batch.period = L;
  for (int d = 0; d < 2; ++d)
    batch.p[d] = AtbProblem{a.hprev2 + d * n * H, H, 0, a.dx2 + d * n * 4 * H, 4 * H,
                            dwh2 + (size_t)d * H * 4 * H, nullptr, H, 4 * H};
  return (int)launch_atb(batch, stream);
}

}  // namespace

// The device's opt-in shared memory per block and the clusters of
// `cluster` blocks of the walk that can be resident at that size.
extern "C" int bilstm_scan_bwd_limits(int cluster, int* smem_limit, int* clusters) {
  return (int)cluster_limits(bilstm_scan_bwd_kernel<16>, cluster, smem_limit, clusters);
}

// xproj2 (2, B, L, 4H), h_prev2, c_prev2, dys2 (2, B, L, H), wh2 (2, H, 4H)
// -> dxproj2 (2, B, L, 4H), dh02, dc02 (2, B, H), dwh2 (2, H, 4H); tc2
// (2, B, L, H) is scratch; (cluster, rows, resident) the walk's plan.
extern "C" int bilstm_scan_bwd(const float* xproj2, const float* hprev2, const float* cprev2,
                               const float* dys2, const float* wh2, float* dxproj2, float* dh02,
                               float* dc02, float* dwh2, float* tc2, int B, int L, int H,
                               int cluster, int rows, int resident, cudaStream_t stream) {
  return bilstm_scan_bwd_run(
      LstmBwdT<float>{xproj2, hprev2, cprev2, dys2, wh2, dxproj2, tc2, dh02, dc02, B, L, H}, dwh2,
      cluster, rows, resident, stream);
}

extern "C" int bilstm_scan_bwd_bf16_limits(int cluster, int* smem_limit, int* clusters) {
  return (int)cluster_limits(bilstm_scan_bwd_bf16_kernel<16>, cluster, smem_limit, clusters);
}

// K9's bf16 entry: bilstm_scan_bwd with bf16 xproj2 and wh2, widened as
// they load (the states, dys2 and every output float32), on
// bilstm_scan_bwd_limits' plan (the walk's shared memory is the same).
// The JAX kernel with bf16 inputs (_bwd_kernel with bf16 xproj and w_h,
// float32 states from its forward) rounds nothing: h_prev @ w_h and
// da @ w_h^T multiply float32 values by the widened weights, and its
// outputs are float32 (lstm_scan.py:161-166 of the JAX package).
extern "C" int bilstm_scan_bwd_bf16(const bf16* xproj2, const float* hprev2, const float* cprev2,
                                    const float* dys2, const bf16* wh2, float* dxproj2,
                                    float* dh02, float* dc02, float* dwh2, float* tc2, int B,
                                    int L, int H, int cluster, int rows, int resident,
                                    cudaStream_t stream) {
  return bilstm_scan_bwd_run(
      LstmBwdT<bf16>{xproj2, hprev2, cprev2, dys2, wh2, dxproj2, tc2, dh02, dc02, B, L, H}, dwh2,
      cluster, rows, resident, stream);
}
