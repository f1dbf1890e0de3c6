// Bidirectional LSTM scan, forward only, without peepholes (kernel K7).
//
// Replaces the forward of the Pallas kernel bilstm_scan
// (seq2seq_attention_asr_tpu/ops/pallas/lstm_scan.py:178, _run_fwd :103,
// pallas_call :107, _fwd_kernel :36). Plain PyTorch twin:
// ops/cuda/lstm_scan.py::bilstm_scan_plain.
//
//   gates = xproj[t] + h @ W_h          (order in, forget, cell, out)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//
// Both directions read the direction-stacked (2, B, L, 4H) projections;
// direction 1 arrives in its own scan order, so both walk t = 0..L-1.
// The LSTM has biases, so h = 0 is not a fixed point under zero input:
// the caller flips the backward direction about each row's length, and
// the forward direction runs on into the padding.
//
// Per direction and group of R rows, one thread-block cluster of C blocks
// walks the steps (csrc/cluster_walk.cuh gives the scheme): block k owns
// the units [k H / C, (k+1) H / C) and holds its units' four gate columns
// of W_h in shared memory, transposed into rows of H floats (32 KB at
// H = 128, C = 8), so no step reads a weight from L2; where a slice does
// not fit (H above ~340 at C = 8), the same walk reads its columns from L2
// each step. A step is one exchange: the block's units' gates from the
// gathered h, then c and h of its units, h pushed into every block with
// st.async counted on the receiving block's mbarrier. The block's units'
// c stays in its shared memory. The plan (C, R, resident) comes from the
// caller (ops/cuda/walk.py, cell "lstm_fwd").
//
// What bounds it: the L steps form a chain, and a step of block 0 at
// R = 1 is ~1.7k cycles of gate products and cell (4 x 16 rows of 128
// floats, then four shuffle reductions) and ~2.0k of exchange (the push
// and the wait for the slowest peer's), after ~8k cycles before the walk,
// most of them the slice's load (tools/scan_phases.py --lstm-enc-fwd).
// At B = 1, L' = 14, H = 128: 2.25 us a step, 0.0315 ms; B = 16, L' = 16
// (R = 4): 2.83 us, 0.0453 ms; B = 128 (R = 8, 32 clusters in 3 waves):
// 0.158 ms (chip_smoke.py phase 8 on an NVIDIA H100 80GB HBM3 at 700.00 W).
//
// bilstm_scan_fwd_bf16 is K7's bf16 entry (bilstm_scan_bf16_kernel): the
// same walk with bf16 projections and weights, as _fwd_kernel runs with
// bf16 xproj and w_h and float32 h0 and c0: it widens each value as it
// loads it (the slices stay float in shared memory, so the plan is the
// float walk's), carries h and c in float and stores both outputs in
// float, as the JAX kernel's scratch and outputs are (lstm_scan.py:
// 119-126): h @ W_h multiplies the unrounded h by the widened weights, so
// the entry rounds nothing. Plain PyTorch twin: ops/cuda/lstm_scan.py::
// bilstm_scan_plain on the widened inputs.

#include "cluster_walk.cuh"

namespace {

// The walk's arrays; T is the IO type of the projections and the weights
// (float, or bf16 for the bf16 entry), the states float either way.
template <class T>
struct LstmFwdT {
  const T* xproj2;      // (2, B, L, 4H)
  const float* h02;     // (2, B, H)
  const float* c02;     // (2, B, H)
  const T* wh2;         // (2, H, 4H)
  float* hs2;           // (2, B, L, H)
  float* cs2;           // (2, B, L, H)
  int B, L, H;
};
using LstmFwd = LstmFwdT<float>;

// Shared memory of the walk: the weight slices (4H floats a unit), two
// buffers of the gathered h (R x H each), two buffers of the four staged
// gate inputs per unit and c per unit. Its two mbarriers are static shared
// memory, which the limits helper takes off the budget.
size_t lstm_fwd_smem_bytes(const WalkPlan& p, int H) {
  return walk_smem_bytes(p, H, 4 * H, 2 * H, 4, 1);
}

// For each of the block's units i < hs (a warp each, in turn) and each
// batch row r < R: the four gate sums sum_j W_h[j][q H + i] h[r][j], then
// cell(i, r, sums) on lane r' < R for its row r. The warp reads unit i's
// four gate rows of the transposed slice (`w`, [4][hs][H]) where
// kResident, else its four columns of W_h from L2 (`w` at the unit's
// gate-0 column, row stride 4H; a bf16 w, TW, widened as it is read); the
// gathered h `v` is R x H. Reading the four gates of a unit in one pass
// leaves each unit's cell on one lane, with no block barrier between the
// products and the cell.
template <int R, bool kResident, class TW, class Cell>
__device__ __forceinline__ void unit_gates(const TW* w, int H, int hs, const float* v,
                                           Cell cell) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < hs; i += kWarps) {
    float sum[4][R];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r) sum[q][r] = 0.f;
#pragma unroll 2
    for (int j = lane; j < H; j += 32) {
      float x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kResident)
          x[q] = w[(q * hs + i) * H + j];
        else
          x[q] = ldg_f(w + (size_t)j * 4 * H + q * H + i);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float y = v[r * H + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[q][r] = fmaf(x[q], y, sum[q][r]);
      }
    }
    int row = 0;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = reduce_rows<R>(sum[q], row);
    if (lane < R) cell(i, row, g);
  }
}

// The walk of direction blockIdx.y for the R batch rows of this block's
// cluster (group blockIdx.x / C). Each step s, at t = s:
//
//   i, f, g, o = act(h(s-1) @ W_h + xproj[t]);  c = f c + i g;
//   h(s) = o tanh(c);  hs2[t], cs2[t] = h(s), c                  [push, wait]
//   (the copies that stage step s+2's xproj start before the push)
//
// for the block's units, a unit's four gate products and its cell on one
// warp (unit_gates). One exchange a step, so the gathered h is double
// buffered: step s reads h(s-1) from buffer s & 1 and writes and pushes
// h(s) into buffer (s + 1) & 1, each push counted on that buffer's
// mbarrier. By causality a peer pushes h(s+1) into buffer s & 1 only
// after it has this block's h(s), which this block pushes behind a block
// barrier after its gate products' reads of h(s-1) there. Each mbarrier
// completes every other step, so step s waits on parity (s >> 1) & 1, and
// thread 0 arms the mbarrier's next phase as soon as it has seen one
// complete: no push of that phase can have started. The last step pushes
// nothing. The step's one block barrier also makes step s+1's staged
// xproj (copies started in step s-1) visible. Rows past B stage x = 0
// from h = c = 0, which gives gates 1/2, 1/2, 0, 1/2 and c = h = 0
// exactly, so nothing leaks into a valid row. With bf16 IO (T) the
// projections and the weights load widened; the rest is the float walk.
template <int R, class T>
__device__ __forceinline__ void bilstm_walk(const LstmFwdT<T>& a, int resident, float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int H = a.H, L = a.L, H4 = 4 * H;
  const int lo = k * H / C, hs = (k + 1) * H / C - lo, hm = (H + C - 1) / C, RM = R * hm;
  const int b0 = (blockIdx.x / C) * R, nrows = min(R, a.B - b0);
  const size_t row0 = (size_t)blockIdx.y * a.B + b0;  // first (direction, batch) row
  const size_t l4 = (size_t)L * H4, lh = (size_t)L * H;  // batch-row strides

  float* w_s = smem;                                // [4][hs][H]  resident: gate q of unit i
  float* gath = w_s + (resident ? 4 * hm * H : 0);  // [2][R][H]   h, every unit
  float* stg = gath + 2 * R * H;                    // [2][4][R][hm]  a step's staged xproj
  float* cst = stg + 8 * RM;                        // [R][hm]     c of the block's units

  // bars[b] counts the h the peers push into gathered buffer b: R x
  // (H - hs) floats a phase. The cluster barrier's arrive releases their
  // inits; its wait, before the first push, comes after step 0's products.
  __shared__ unsigned long long bars[2];
  const unsigned tx = 4u * R * (H - hs);
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_init_fence();
    mbar_expect(&bars[0], tx);
    mbar_expect(&bars[1], tx);
  }
  cluster_arrive();
  // Stage step s's xproj of the block's units, gate by gate, 16 bytes a
  // copy where every slice is 4-float aligned; h0 and the units' c0 too.
  const bool vec =
      H % (4 * C) == 0 &&
      ((reinterpret_cast<size_t>(a.xproj2) | reinterpret_cast<size_t>(a.wh2) |
        reinterpret_cast<size_t>(a.h02) | reinterpret_cast<size_t>(a.c02)) & 15) == 0;
  auto prefetch = [&](int s) {
    float* q = stg + (s & 1) * 4 * RM;
    const T* x = a.xproj2 + (row0 * L + s) * H4 + lo;
    for (int gate = 0; gate < 4; ++gate)
      stage_async<R>(q + gate * RM, hm, x + gate * H, l4, hs, nrows, vec);
  };
  prefetch(0);
  stage_async<R>(gath, H, a.h02 + row0 * H, H, H, nrows, vec);
  stage_async<R>(cst, hm, a.c02 + row0 * H + lo, H, hs, nrows, vec);
  const T* w = a.wh2 + (size_t)blockIdx.y * H * H4 + lo;  // the units' columns of gate 0
  if (resident) {
    if constexpr (kIsBf16<T>) {
      // bf16: a value a load, widened, kWide loads of a thread in flight
      // at once; consecutive threads take consecutive input rows j, as
      // below (past the end, a slot repeats the last value).
      constexpr int kWide = 8;
      const int n = H * 4 * hs;
      for (int base = threadIdx.x; base < n; base += kWide * kThreads) {
        float v[kWide];
        int dst[kWide];
#pragma unroll
        for (int u = 0; u < kWide; ++u) {
          const int idx = min(base + u * kThreads, n - 1), j = idx % H, qi = idx / H;
          const int gate = qi / hs, i = qi - gate * hs;
          dst[u] = (gate * hs + i) * H + j;
          v[u] = ldg_f(w + (size_t)j * H4 + gate * H + i);
        }
#pragma unroll
        for (int u = 0; u < kWide; ++u) w_s[dst[u]] = v[u];
      }
    } else {
      // Consecutive threads take consecutive input rows j, each wu units
      // of a gate (two 16-byte loads, a whole 32-byte sector, where it
      // can), so the stores into the transposed slice fall on consecutive
      // banks; a thread's loads are in flight at once (past the end, a
      // slot repeats the last one).
      const int wu = !vec ? 1 : hs % 8 == 0 ? 8 : 4, nq = hs / wu, n = H * 4 * nq;
      for (int base = threadIdx.x; base < n; base += 2 * kThreads) {
        float4 x[2][2];
        float* dst[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = min(base + u * kThreads, n - 1), j = idx % H, qi = idx / H;
          const int gate = qi / nq, i = (qi - gate * nq) * wu;
          const float* src = w + (size_t)j * H4 + gate * H + i;
          dst[u] = w_s + (gate * hs + i) * H + j;
          x[u][0] = vec ? __ldg(reinterpret_cast<const float4*>(src))
                        : make_float4(__ldg(src), 0.f, 0.f, 0.f);
          if (wu == 8) x[u][1] = __ldg(reinterpret_cast<const float4*>(src + 4));
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float* d = dst[u];
          d[0] = x[u][0].x;
          if (wu >= 4) d[H] = x[u][0].y, d[2 * H] = x[u][0].z, d[3 * H] = x[u][0].w;
          if (wu == 8)
            d[4 * H] = x[u][1].x, d[5 * H] = x[u][1].y, d[6 * H] = x[u][1].z, d[7 * H] = x[u][1].w;
        }
      }
    }
  }
  copy_async_wait();
  if (L > 1) prefetch(1);
  __syncthreads();
  // [phase] before the walk

  for (int s = 0; s < L; ++s) {
    const float* q = stg + (s & 1) * 4 * RM;   // step s's staged xproj
    float* hn = gath + ((s + 1) & 1) * R * H;  // h(s), every unit
    auto cell = [&](int i, int r, const float (&g)[4]) {
      const int o = r * hm + i;
      auto sig = [](float v) { return __fdividef(1.f, 1.f + __expf(-v)); };
      const float ig = sig(g[0] + q[o]);
      const float fg = sig(g[1] + q[RM + o]);
      const float gg = fast_tanh(g[2] + q[2 * RM + o]);
      const float og = sig(g[3] + q[3 * RM + o]);
      const float c = fg * cst[o] + ig * gg;
      const float h = og * fast_tanh(c);
      cst[o] = c;
      hn[r * H + lo + i] = h;
      if (r < nrows) {
        const size_t at = (row0 + r) * lh + (size_t)s * H + lo + i;
        a.cs2[at] = c;
        a.hs2[at] = h;
      }
    };
    const float* hv = gath + (s & 1) * R * H;  // h(s-1), every unit
    if (resident)
      unit_gates<R, true>(w_s, H, hs, hv, cell);
    else
      unit_gates<R, false>(w, H, hs, hv, cell);
    copy_async_wait();  // step s+1's xproj
    __syncthreads();
    // [phase] gates and cell
    if (s == 0) cluster_wait();  // every block's mbarriers are armed before any push into it
    if (s + 1 < L) {
      // Step s+2's xproj into step s's staging buffer, read last above:
      // the copies start before the push; bf16's plain loads (which wait
      // for their data) after it, so that they wait beside the peers' h.
      if (!kIsBf16<T> && s + 2 < L) prefetch(s + 2);
      unsigned long long* bar = &bars[(s + 1) & 1];
      push_units<R>(hn, bar, H, lo, hs, C, k);
      if (kIsBf16<T> && s + 2 < L) prefetch(s + 2);
      mbar_wait(bar, (s >> 1) & 1);
      if (threadIdx.x == 0 && s + 3 < L) mbar_expect(bar, tx);
    }
    // [phase] push and wait
  }
  cluster.sync();  // no block leaves before the cluster's last pushes have landed
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) bilstm_scan_kernel(const LstmFwd a, int resident) {
  extern __shared__ float smem[];
  bilstm_walk<R>(a, resident, smem);
}

// K7's bf16 entry.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    bilstm_scan_bf16_kernel(const LstmFwdT<bf16> a, int resident) {
  extern __shared__ float smem[];
  bilstm_walk<R>(a, resident, smem);
}

template <class T>
using LstmWalk = void (*)(const LstmFwdT<T>, int);

// The walk's instance for `rows` batch rows a cluster (R = 16 where rows
// is none of 1, 2, 4 and 8).
template <class T>
LstmWalk<T> lstm_walk_instance(int rows) {
  if constexpr (kIsBf16<T>)
    return rows == 1   ? bilstm_scan_bf16_kernel<1>
           : rows == 2 ? bilstm_scan_bf16_kernel<2>
           : rows == 4 ? bilstm_scan_bf16_kernel<4>
           : rows == 8 ? bilstm_scan_bf16_kernel<8>
                       : bilstm_scan_bf16_kernel<16>;
  else
    return rows == 1   ? bilstm_scan_kernel<1>
           : rows == 2 ? bilstm_scan_kernel<2>
           : rows == 4 ? bilstm_scan_kernel<4>
           : rows == 8 ? bilstm_scan_kernel<8>
                       : bilstm_scan_kernel<16>;
}

template <class T>
int bilstm_scan_run(const LstmFwdT<T>& a, int cluster, int rows, int resident,
                    cudaStream_t stream) {
  if (a.B < 1 || a.L < 1 || a.H < 1 || a.H > 1024) return (int)cudaErrorInvalidValue;
  const WalkPlan plan{cluster, rows, resident};
  const size_t smem = lstm_fwd_smem_bytes(plan, a.H);
  cudaError_t err = check_plan(plan, a.H, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (a.B + rows - 1) / rows;
  return (int)launch_cluster(lstm_walk_instance<T>(rows), dim3(cluster * groups, 2), cluster,
                             smem, stream, a, resident);
}

}  // namespace

// The device's opt-in shared memory per block and the clusters of
// `cluster` blocks of the walk that can be resident at that size.
extern "C" int bilstm_scan_fwd_limits(int cluster, int* smem_limit, int* clusters) {
  return (int)cluster_limits(bilstm_scan_kernel<16>, cluster, smem_limit, clusters);
}

// xproj2 (2, B, L, 4H), h02, c02 (2, B, H), wh2 (2, H, 4H) -> hs2, cs2
// (2, B, L, H); (cluster, rows, resident) the walk's plan.
extern "C" int bilstm_scan_fwd(const float* xproj2, const float* h02, const float* c02,
                               const float* wh2, float* hs2, float* cs2, int B, int L, int H,
                               int cluster, int rows, int resident, cudaStream_t stream) {
  return bilstm_scan_run(LstmFwd{xproj2, h02, c02, wh2, hs2, cs2, B, L, H}, cluster, rows,
                         resident, stream);
}

// K7's bf16 entry: bilstm_scan_fwd with bf16 xproj2 and wh2 (h02, c02 and
// the outputs float), on bilstm_scan_fwd_limits' plan (the walk's shared
// memory is the same).
extern "C" int bilstm_scan_fwd_bf16(const bf16* xproj2, const float* h02, const float* c02,
                                    const bf16* wh2, float* hs2, float* cs2, int B, int L, int H,
                                    int cluster, int rows, int resident, cudaStream_t stream) {
  return bilstm_scan_run(LstmFwdT<bf16>{xproj2, h02, c02, wh2, hs2, cs2, B, L, H}, cluster, rows,
                         resident, stream);
}
