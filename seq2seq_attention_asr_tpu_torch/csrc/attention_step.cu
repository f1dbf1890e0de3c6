// One beam-search decoder step for all K hypotheses of a batch row:
// content attention, masked softmax, context, GRU cell, maxout -> linear
// readout and an f32 log_softmax, in one launch.
//
// K2 replaces the Pallas kernel fused_attention_step
// (seq2seq_attention_asr_tpu/ops/pallas/attention_step.py:371, _kernel
// :85, _apply_readout_fused :40; the step math is attention_scan.py
// _step_core :91) for the content-only GRU decoder. Plain PyTorch twin:
// ops/cuda/attention_step.py::fused_attention_step_plain.
//
// What bounds it: a step is a chain of dependent matrix-vector products
// (s -> Ws, alpha -> c -> c_in -> dec_in -> GRU gates -> candidate ->
// maxout -> linear) whose weights, about 4.5 MB at flagship width, are
// read from L2 for every step, and the K*L*S tanh of the energies. One
// block streams them through one SM at a few tens of GB/s; so each
// batch row runs on a cluster of C blocks (16 or 8, from the wrapper's
// plan), and block r of the cluster
//   - reads columns [r out / C, (r + 1) out / C) of each weight (maxout's
//     columns in whole groups of its window), for all K hypotheses at
//     once, and pushes its outputs into every block's shared memory
//     through distributed shared memory (DSMEM);
//   - takes encoder positions [r L / C, (r + 1) L / C): their energies
//     (the tanh work is split C ways), the softmax's max and exp-sum over
//     them, and the context's partial sums over them; every block gets
//     each block's max and sum, and block r sums the C partials of its
//     context columns in rank order. Only vh's and h's rows of those
//     positions are read, and no shared buffer grows with the full L.
// A product is warps over input rows and lanes over the slice's columns
// (16-byte loads where aligned), its warps' partials summed in a fixed
// order: no atomics, two calls give the same bits. Eight cluster
// barriers a step. The elementwise GRU math runs on each block's own
// state units; block 0 alone takes the linear layer and the log_softmax.

#include <math.h>

#include <algorithm>

#include "attention_common.cuh"
#include "cluster_walk.cuh"

namespace {

constexpr int kMaxStepCluster = 16;  // a non-portable cluster size on Hopper
// Weight rows a lane of a product loads before it uses any of them.
constexpr int kBatch = 4;

template <class T>
__host__ __device__ constexpr T cdiv(T n, T d) {
  return (n + d - 1) / d;
}

// Shared memory of one block of K2's step, in floats; the plan in
// ops/cuda/attention_step.py (step_smem_bytes) computes the same.
long long step_smem_floats(long long K, long long L, long long S, long long A, long long St,
                           long long M, long long W, long long V, long long C) {
  return K * (7 * St + S + A + M + V) + S + cdiv(L, C) * (K + 1) + C * K * (cdiv(A, C) + 3) +
         K + K * std::max(2 * cdiv(St, C), cdiv(M, C) * W) + cdiv(S, C) + 2 * cdiv(St, C) +
         cdiv(M, C) * W + V +
         kWarps * K * std::min(128LL, std::max(std::max(cdiv(S, C), 2 * cdiv(St, C)),
                                               std::max(cdiv(M, C) * W, V)));
}

struct Args {
  const float *vh, *h, *mask, *yin, *sprev;
  const float *ws_w, *ws_b, *w_e, *c_w, *c_b, *dec_w, *dec_b, *w_zr, *w_h;
  const float *mo_w, *mo_b, *lin_w, *lin_b;
  float *alpha, *c, *s, *logp;
  int B, K, L, S, A, St, M, W, V;
};

// Block r's share [lo, lo + n) of n_all items over C blocks.
struct Span {
  int lo, n;
  __device__ Span(int n_all, int C, int r) : lo(n_all * r / C), n(n_all * (r + 1) / C - lo) {}
};

// Columns [lo0, lo0 + n0), then [lo1, lo1 + n1), of an input-major weight.
struct Cols {
  int lo0, n0, lo1, n1;
};

// The partial sums of one chunk of slice_product: columns [VW q0, VW (q0 +
// qc)) of cs, qc <= 32 column groups of VW. Lanes take VW consecutive
// columns each, G lanes (a power of two) the same columns on other input
// rows, each lane kBatch rows at a time (their weights, then for each
// hypothesis their inputs, loaded before any is used); the G partials of a
// warp meet in a fixed shuffle order, over all KM rows of acc (zeros past
// K, KM >= K: a shuffle under a K guard costs a divergence-safe
// sequence), and go to scratch[(warp K + k) VW qc + j]. KM = 5 (the
// beam's K) spares the K = 8 instance's idle rows. Not inlined: one copy
// serves all seven products of the step.
template <int VW, int KM>
__device__ __noinline__ void slice_partials(const float* __restrict__ w, int ldw, int in,
                                            const float* x, int xs, int K, const Cols cs,
                                            int q0, int qc, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nc = qc * VW;
  int G = 1;
  while (2 * G * qc <= 32) G *= 2;  // the largest power of two with G * qc <= 32
  const int quad = lane / G, g = lane - quad * G;
  float acc[KM][VW];
#pragma unroll
  for (int k = 0; k < KM; ++k)
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[k][v] = 0.f;
  if (quad < qc) {
    const int jj = VW * (q0 + quad), step = kWarps * G;
    const float* wc = w + (jj < cs.n0 ? cs.lo0 + jj : cs.lo1 + jj - cs.n0);
#pragma unroll 1
    for (int i0 = warp * G + g; i0 < in; i0 += kBatch * step) {
      float wv[kBatch][VW];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int i = i0 + t * step;
        if constexpr (VW == 4) {
          const float4 u = i < in ? __ldg(reinterpret_cast<const float4*>(wc + (size_t)i * ldw))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          wv[t][0] = u.x, wv[t][1] = u.y, wv[t][2] = u.z, wv[t][3] = u.w;
        } else {
          wv[t][0] = i < in ? __ldg(wc + (size_t)i * ldw) : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k < K) {
          float xv[kBatch];
#pragma unroll
          for (int t = 0; t < kBatch; ++t) {
            const int i = i0 + t * step;
            xv[t] = i < in ? x[k * xs + i] : 0.f;
          }
#pragma unroll
          for (int t = 0; t < kBatch; ++t)
#pragma unroll
            for (int v = 0; v < VW; ++v) acc[k][v] = fmaf(xv[t], wv[t][v], acc[k][v]);
        }
      }
    }
  }
  for (int o = 1; o < G; o *= 2) {
#pragma unroll
    for (int k = 0; k < KM; ++k)
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[k][v] += __shfl_xor_sync(0xffffffffu, acc[k][v], o);
  }
  if (g == 0 && quad < qc) {
#pragma unroll
    for (int k = 0; k < KM; ++k)
      if (k < K)
#pragma unroll
        for (int v = 0; v < VW; ++v) scratch[(warp * K + k) * nc + quad * VW + v] = acc[k][v];
  }
}

// For k < K and the columns of cs: emit(k, jj, col, sum_i x[k*xs + i] *
// w[i*ldw + col]) where jj counts the columns of cs in order, up to 32 VW
// columns at a time: slice_partials, then the kWarps warps' partials
// (`scratch`: kWarps * K * min(n0 + n1, 32 VW) floats) summed in warp
// order. Starts after the caller's barrier; ends with a block barrier.
template <int VW, class Emit>
__device__ void slice_product_vw(const float* __restrict__ w, int ldw, int in, const float* x,
                                 int xs, int K, const Cols& cs, float* scratch, Emit emit) {
  const int q = (cs.n0 + cs.n1) / VW;
  for (int q0 = 0; q0 < q; q0 += 32) {
    const int qc = min(32, q - q0), nc = qc * VW;
    if (K <= 5)
      slice_partials<VW, 5>(w, ldw, in, x, xs, K, cs, q0, qc, scratch);
    else
      slice_partials<VW, kMaxK>(w, ldw, in, x, xs, K, cs, q0, qc, scratch);
    __syncthreads();
    for (int idx = threadIdx.x; idx < K * nc; idx += kThreads) {
      const int k = idx / nc, j = idx - k * nc;
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < kWarps; ++p) sum += scratch[(p * K + k) * nc + j];
      const int jj = VW * q0 + j;
      emit(k, jj, jj < cs.n0 ? cs.lo0 + jj : cs.lo1 + jj - cs.n0, sum);
    }
    __syncthreads();
  }
}

template <class Emit>
__device__ void slice_product(const float* w, int ldw, int in, const float* x, int xs, int K,
                              const Cols& cs, float* scratch, Emit emit) {
  const bool vec = ((ldw | cs.lo0 | cs.n0 | cs.lo1 | cs.n1) & 3) == 0 &&
                   (reinterpret_cast<size_t>(w) & 15) == 0;
  if (vec)
    slice_product_vw<4>(w, ldw, in, x, xs, K, cs, scratch, emit);
  else
    slice_product_vw<1>(w, ldw, in, x, xs, K, cs, scratch, emit);
}

// VW floats of x from i (16 bytes when VW = 4), zeros from n on.
template <int VW>
__device__ __forceinline__ void load_vw(float (&v)[VW], const float* x, int i, int n) {
  if constexpr (VW == 4) {
    const float4 u = i < n ? __ldg(reinterpret_cast<const float4*>(x + i))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = i < n ? __ldg(x + i) : 0.f;
  }
}

// VW floats of shared memory from x (one 16-byte load when VW = 4).
template <int VW>
__device__ __forceinline__ void lds_vw(float (&v)[VW], const float* x) {
  if constexpr (VW == 4) {
    const float4 u = *reinterpret_cast<const float4*>(x);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = x[0];
  }
}

// e[k * Lc + p] = w_e . tanh(vh[p] + ws[k]) for this block's n positions,
// a warp a position, lanes over VW consecutive scores (16-byte loads of
// vh, ws and w_e when VW = 4: all S of them aligned), vh's row read once
// for all K hypotheses. Ends with a block barrier.
template <int VW>
__device__ void energies(const float* vhb, const float* ws, const float* we, float* e, int n,
                         int Lc, int K, int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < n; p += kWarps) {
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
    const float* vr = vhb + (size_t)p * S;
    // One iteration's vh loads are in flight while the previous one's
    // tanh run: a short loop body that the instruction cache keeps.
    float cur[VW], nxt[VW];
    load_vw<VW>(cur, vr, VW * lane, S);
#pragma unroll 1
    for (int s = VW * lane; s < S; s += 32 * VW) {
      load_vw<VW>(nxt, vr, s + 32 * VW, S);
      float wv[VW];
      lds_vw<VW>(wv, we + s);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          float x[VW];
          lds_vw<VW>(x, ws + k * S + s);
#pragma unroll
          for (int q = 0; q < VW; ++q) acc[k] = fmaf(fast_tanh(cur[q] + x[q]), wv[q], acc[k]);
        }
      }
#pragma unroll
      for (int q = 0; q < VW; ++q) cur[q] = nxt[q];
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const float v = warp_sum(acc[k]);  // unguarded, as in slice_partials
      if (lane == 0 && k < K) e[k * Lc + p] = v;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) attention_step_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int K = a.K, L = a.L, S = a.S, A = a.A, St = a.St, M = a.M, W = a.W, V = a.V;
  const int St2 = 2 * St, XO = St + A, Lc = cdiv(L, C), Ac = cdiv(A, C);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Span pos(L, C, r), sc(S, C, r), un(St, C, r), ac(A, C, r), gr(M, C, r);
  const int Stc = cdiv(St, C);

  // Gathered: every block holds the whole of these, each block writing its
  // slice. ws and w_e first: 16-byte aligned where S is a multiple of 4.
  float* ws = sm;                // [K][S]     s_prev @ Ws + b
  float* we = ws + K * S;        // [S]
  float* sr = we + S;            // [K][2St]   s_prev | r
  float* rin = sr + K * St2;     // [K][2St]   c_in(c) | yin
  float* rhr = rin + K * St2;    // [K][2St]   reset gate * s_prev | r
  float* xo = rhr + K * St2;     // [K][St+A]  s_new | c
  float* mo = xo + K * XO;       // [K][M]     maxout (block 0's)
  float* lg = mo + K * M;        // [K][V]     logits (block 0's)
  // This block's positions, and what the cluster exchanges about them.
  float* msk = lg + K * V;       // [Lc]
  float* e = msk + Lc;           // [K][Lc]       energies, then exp(e - local max)
  float* part = e + K * Lc;      // [C][K][Ac]    context partials of this block's columns
  float* stat = part + C * K * Ac;  // [C][K][2]  each block's (max, exp-sum)
  float* scale = stat + C * K * 2;  // [C][K]     exp(block max - max)
  float* zsum = scale + C * K;      // [K]        the clamped exp-sum
  float* gz = zsum + K;             // [K][max(2 Stc, Mc W)] update gate, then maxout pre-activations
  const int Mc = cdiv(M, C);
  float* bws = gz + K * max(2 * Stc, Mc * W);  // this block's bias columns: ws
  float* bc = bws + cdiv(S, C);                 // c_in
  float* bdec = bc + Stc;                       // dec_in
  float* bmo = bdec + Stc;                      // maxout
  float* blin = bmo + Mc * W;                   // linear (block 0)
  float* scratch = blin + V;

  cluster_arrive();  // no block writes into another before every block has started
  // The step's inputs and this block's bias columns, by asynchronous
  // copies: one round trip.
  const size_t row = (size_t)b * K;
  for (int i = tid; i < K * St; i += kThreads) {
    const int k = i / St, j = i % St;
    copy_async(sr + k * St2 + j, a.sprev + (row + k) * St + j);
    copy_async(rin + k * St2 + St + j, a.yin + (row + k) * St + j);
  }
  for (int i = tid; i < S; i += kThreads) copy_async(we + i, a.w_e + i);
  for (int i = tid; i < pos.n; i += kThreads)
    copy_async(msk + i, a.mask + (size_t)b * L + pos.lo + i);
  for (int i = tid; i < sc.n; i += kThreads) copy_async(bws + i, a.ws_b + sc.lo + i);
  for (int i = tid; i < un.n; i += kThreads) {
    copy_async(bc + i, a.c_b + un.lo + i);
    copy_async(bdec + i, a.dec_b + un.lo + i);
  }
  for (int i = tid; i < gr.n * W; i += kThreads) copy_async(bmo + i, a.mo_b + gr.lo * W + i);
  for (int i = tid; i < (r == 0 ? V : 0); i += kThreads) copy_async(blin + i, a.lin_b + i);
  copy_async_wait();
  __syncthreads();
  cluster_wait();
  // [phase] load

  // ws = s_prev @ Ws + b, this block's S / C columns, into every block.
  slice_product(a.ws_w, S, St, sr, St2, K, Cols{sc.lo, sc.n, 0, 0}, scratch,
                [&](int k, int jj, int col, float v) {
                  v += bws[jj];
                  for (int p = 0; p < C; ++p) cluster.map_shared_rank(ws, p)[k * S + col] = v;
                });
  cluster.sync();
  // [phase] ws

  const float* vhb = a.vh + ((size_t)b * L + pos.lo) * S;
  if ((S & 3) == 0 && (reinterpret_cast<size_t>(a.vh) & 15) == 0)
    energies<4>(vhb, ws, we, e, pos.n, Lc, K, S);
  else
    energies<1>(vhb, ws, we, e, pos.n, Lc, K, S);
  // [phase] energies

  // The masked softmax over this block's positions (ops/masking.py:
  // NEG_INF on padding, the exponentials times the mask), a warp per
  // hypothesis: its max and exp-sum go to every block.
  if (warp < K) {
    float* ek = e + warp * Lc;
    float mx = kNegInf;
    for (int p = lane; p < pos.n; p += 32) mx = fmaxf(mx, msk[p] > 0.f ? ek[p] : kNegInf);
    mx = warp_max(mx);
    float z = 0.f;
    for (int p = lane; p < pos.n; p += 32) {
      const float v = msk[p] > 0.f ? expf(ek[p] - mx) : 0.f;
      ek[p] = v;
      z += v;
    }
    z = warp_sum(z);
    if (lane < C) {
      float* st = cluster.map_shared_rank(stat, lane) + (r * K + warp) * 2;
      st[0] = mx;
      st[1] = z;
    }
  }
  __syncthreads();
  // The context's partial sums over this block's positions, each column
  // into the block that owns it.
  const float* hb = a.h + ((size_t)b * L + pos.lo) * A;
  for (int j = tid; j < A; j += kThreads) {
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
    float hv = pos.n > 0 ? __ldg(hb + j) : 0.f;
#pragma unroll 1
    for (int p = 0; p < pos.n; ++p) {
      const float hn = p + 1 < pos.n ? __ldg(hb + (size_t)(p + 1) * A + j) : 0.f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k] = fmaf(e[k * Lc + p], hv, acc[k]);
      hv = hn;
    }
    const int owner = ((j + 1) * C - 1) / A;
    float* dst = cluster.map_shared_rank(part, owner) + r * K * Ac + (j - A * owner / C);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) dst[k * Ac] = acc[k];
  }
  cluster.sync();
  // [phase] softmax, context partials

  // Every block: the max over blocks, each block's exp(max_r - max), and
  // the clamped exp-sum (a row with no valid position gets alpha 0).
  if (tid < K) {
    float mx = kNegInf;
    for (int p = 0; p < C; ++p) mx = fmaxf(mx, stat[(p * K + tid) * 2]);
    float z = 0.f;
    for (int p = 0; p < C; ++p) {
      const float f = expf(stat[(p * K + tid) * 2] - mx);
      scale[p * K + tid] = f;
      z += f * stat[(p * K + tid) * 2 + 1];
    }
    zsum[tid] = fmaxf(z, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < K * pos.n; i += kThreads) {
    const int k = i / pos.n, p = i % pos.n;
    a.alpha[(row + k) * L + pos.lo + p] = e[k * Lc + p] * scale[r * K + k] / zsum[k];
  }
  // This block's context columns: the C partials in rank order, into every block.
  for (int i = tid; i < K * ac.n; i += kThreads) {
    const int k = i / ac.n, jl = i % ac.n;
    float sum = 0.f;
    for (int p = 0; p < C; ++p) sum = fmaf(scale[p * K + k], part[(p * K + k) * Ac + jl], sum);
    const float v = sum / zsum[k];
    const int j = St + ac.lo + jl;
    for (int p = 0; p < C; ++p) cluster.map_shared_rank(xo, p)[k * XO + j] = v;
    a.c[(row + k) * A + ac.lo + jl] = v;
  }
  cluster.sync();
  // [phase] context

  // r = dec_in(concat(c_in(c), yin)): this block's state units of each.
  slice_product(a.c_w, St, A, xo + St, XO, K, Cols{un.lo, un.n, 0, 0}, scratch,
                [&](int k, int jj, int col, float v) {
                  v += bc[jj];
                  for (int p = 0; p < C; ++p) cluster.map_shared_rank(rin, p)[k * St2 + col] = v;
                });
  cluster.sync();
  // [phase] c_in
  slice_product(a.dec_w, St, St2, rin, St2, K, Cols{un.lo, un.n, 0, 0}, scratch,
                [&](int k, int jj, int col, float v) {
                  v += bdec[jj];
                  for (int p = 0; p < C; ++p) {
                    cluster.map_shared_rank(sr, p)[k * St2 + St + col] = v;
                    cluster.map_shared_rank(rhr, p)[k * St2 + St + col] = v;
                  }
                });
  cluster.sync();
  // [phase] dec_in

  // The GRU's gates on concat(s_prev, r) for this block's units: the
  // update gate stays here, reset gate * s_prev goes to every block.
  slice_product(a.w_zr, St2, St2, sr, St2, K, Cols{un.lo, un.n, St + un.lo, un.n}, scratch,
                [&](int k, int jj, int col, float v) {
                  const float g = activate<kSigmoid>(v);
                  if (jj < un.n) {
                    gz[k * un.n + jj] = g;
                  } else {
                    const int u = col - St;
                    const float rs = g * sr[k * St2 + u];
                    for (int p = 0; p < C; ++p) cluster.map_shared_rank(rhr, p)[k * St2 + u] = rs;
                  }
                });
  cluster.sync();
  // [phase] gates
  // The candidate and s_new for this block's units, into every block.
  slice_product(a.w_h, St, St2, rhr, St2, K, Cols{un.lo, un.n, 0, 0}, scratch,
                [&](int k, int jj, int col, float v) {
                  const float zg = gz[k * un.n + jj], sp = sr[k * St2 + col];
                  const float sn = (1.f - zg) * sp + zg * activate<kTanh>(v);
                  for (int p = 0; p < C; ++p) cluster.map_shared_rank(xo, p)[k * XO + col] = sn;
                  a.s[(row + k) * St + col] = sn;
                });
  cluster.sync();
  // [phase] candidate

  // Readout: this block's maxout groups (whole windows of W columns),
  // their maxima into block 0.
  const int nmo = gr.n * W;
  slice_product(a.mo_w, M * W, XO, xo, XO, K, Cols{gr.lo * W, nmo, 0, 0}, scratch,
                [&](int k, int jj, int, float v) { gz[k * nmo + jj] = v + bmo[jj]; });
  for (int i = tid; i < K * gr.n; i += kThreads) {
    const int k = i / gr.n, g = i % gr.n;
    const float* grp = gz + k * nmo + g * W;
    float m = grp[0];
    for (int t = 1; t < W; ++t) m = fmaxf(m, grp[t]);
    cluster.map_shared_rank(mo, 0)[k * M + gr.lo + g] = m;
  }
  cluster.sync();
  // [phase] maxout
  if (r != 0) return;

  // Block 0: linear and the f32 log_softmax, a warp per hypothesis.
  slice_product(a.lin_w, V, M, mo, M, K, Cols{0, V, 0, 0}, scratch,
                [&](int k, int, int col, float v) { lg[k * V + col] = v + blin[col]; });
  if (warp < K) {
    const float* x = lg + warp * V;
    float m = -INFINITY;
    for (int j = lane; j < V; j += 32) m = fmaxf(m, x[j]);
    m = warp_max(m);
    float z = 0.f;
    for (int j = lane; j < V; j += 32) z += expf(x[j] - m);
    const float lse = logf(warp_sum(z));
    for (int j = lane; j < V; j += 32) a.logp[(row + warp) * V + j] = x[j] - m - lse;
  }
  // [phase] linear, log_softmax
}

}  // namespace

// Device limits of K2's cluster launch: the opt-in shared memory of a
// block and how many clusters of `cluster` blocks (8, or 16: a
// non-portable size) can be resident at once. The plan in
// ops/cuda/attention_step.py takes C from them.
extern "C" int fused_attention_step_limits(int cluster, int* smem_limit, int* clusters) {
  if (cluster < 1 || cluster > kMaxStepCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_step_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  return (int)cluster_limits(attention_step_kernel, cluster, smem_limit, clusters);
}

// `cluster`: C, the blocks of a batch row's cluster (the wrapper's plan).
extern "C" int fused_attention_step(
    const float* vh, const float* h, const float* mask, const float* yin, const float* sprev,
    const float* ws_w, const float* ws_b, const float* w_e, const float* c_w, const float* c_b,
    const float* dec_w, const float* dec_b, const float* w_zr, const float* w_h,
    const float* mo_w, const float* mo_b, const float* lin_w, const float* lin_b,
    float* alpha, float* c, float* s, float* logp, int B, int K, int L, int S, int A, int St,
    int M, int W, int V, int cluster, cudaStream_t stream) {
  if (B < 1 || K < 1 || K > kMaxK || L < 1 || W < 1 || cluster < 1 ||
      cluster > kMaxStepCluster)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = step_smem_floats(K, L, S, A, St, M, W, V, cluster) * sizeof(float);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_step_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  const Args a{vh,    h,     mask,  yin,   sprev, ws_w, ws_b, w_e, c_w, c_b, dec_w,
               dec_b, w_zr,  w_h,   mo_w,  mo_b,  lin_w, lin_b, alpha, c, s, logp,
               B,     K,     L,     S,     A,     St,   M,    W,   V};
  return (int)launch_cluster(attention_step_kernel, dim3(B * cluster), cluster, bytes, stream, a);
}

// ---------------------------------------------------------------------------
// K8: the beam step of the location-aware and/or LSTM decoders, with the
// readout given as a layer list.
//
// Replaces the location-aware and LSTM branches of the Pallas kernel
// fused_attention_step (attention_step.py:371: _kernel_loc :116, the
// LSTM branch of _kernel :85, _apply_readout_fused :40; step math
// attention_scan.py _step_core :91-154, _location_term :62-88). Plain
// PyTorch twin: ops/cuda/attention_step.py::fused_attention_step_plain.
// Templated on the cell (GRU or LSTM) and on the location term.
//
// What bounds it: as K2, a chain of dependent matrix-vector products
// whose weights come from L2 every step (about 7.4 MB at the conv+BiLSTM
// recipe: dec_in 800x400, the LSTM's gates 2 x 400x1600), read once per
// block for all K hypotheses. The location term adds K*L*S*FM
// multiply-adds; UF is never stored: each warp forms the K x FM
// features of its encoder position and adds them through U (in shared
// memory) inside the energy loop. Intermediates live in shared memory;
// the cell's and the readout's buffers share one region.

namespace {

constexpr int kMaxLayers = 4;  // readout layers after dropout is dropped
enum LayerKind { kLinear = 0, kMaxout = 1, kRelu = 2 };

struct Readout {
  int n;
  int kind[kMaxLayers];
  int out[kMaxLayers];  // output width (maxout: groups)
  int win[kMaxLayers];  // maxout window
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
};

struct Args2 {
  const float *vh, *h, *mask, *yin, *sprev;
  const float *ws_w, *ws_b, *w_e, *c_w, *c_b, *dec_w, *dec_b, *cw1, *cw2, *cw3;
  const float *memprev, *aprev, *conv_w, *conv_b, *u;
  float *alpha, *c, *s, *mem, *logp;
  int B, K, L, S, A, St, V, FM, F, PL;
  int region, maxw;  // floats per row of the cell/readout region; widest readout layer
  Readout ro;
};

template <bool kLstm, bool kLoc>
__global__ void __launch_bounds__(kThreads, 1) attention_step_loc_lstm_kernel(const Args2 a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int K = a.K, L = a.L, S = a.S, A = a.A, St = a.St, V = a.V, FM = a.FM, F = a.F;
  const int St2 = 2 * St, XO = St + A, LP = L + F - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* sp = sm;                            // [K][St]    s_prev
  float* sr = sp + K * St;                   // [K][2St]   s_prev | r
  float* ws = sr + K * St2;                  // [K][S]     s_prev @ Ws + b
  float* al = ws + K * S;                    // [K][L]     energies, then alpha
  float* xo = al + K * L;                    // [K][St+A]  s_new | c
  float* reg = xo + K * XO;                  // K * region: rin/zr, rhr, cand or rin/gates; then the readout
  float* mem = reg + K * a.region;           // [K][St]    LSTM cell state
  float* ap = mem + (kLstm ? K * St : 0);    // [K][L+F-1] alpha_prev, zero-padded
  float* we = ap + (kLoc ? K * LP : 0);      // [S]
  float* msk = we + S;                       // [L]
  float* u = msk + L;                        // [FM][S]
  float* cw = u + (kLoc ? FM * S : 0);       // [F][FM]
  float* cb = cw + (kLoc ? F * FM : 0);      // [FM]
  float* feat = cb + (kLoc ? FM : 0);        // [kWarps][K][FM]
  float* scratch = feat + (kLoc ? kWarps * K * FM : 0);  // [kThreads * 4 * K]

  const size_t row = (size_t)b * K;
  for (int i = tid; i < K * St; i += kThreads) {
    const int k = i / St, j = i % St;
    const float v = a.sprev[(row + k) * St + j];
    sp[i] = v;
    sr[k * St2 + j] = v;
    reg[k * St2 + St + j] = a.yin[(row + k) * St + j];  // rin[:, St:]
    if (kLstm) mem[i] = a.memprev[(row + k) * St + j];
  }
  for (int i = tid; i < S; i += kThreads) we[i] = a.w_e[i];
  for (int i = tid; i < L; i += kThreads) msk[i] = a.mask[(size_t)b * L + i];
  if (kLoc) {
    for (int i = tid; i < K * LP; i += kThreads) {
      const int k = i / LP, p = i % LP - a.PL;
      ap[i] = p >= 0 && p < L ? a.aprev[(row + k) * L + p] : 0.f;
    }
    for (int i = tid; i < FM * S; i += kThreads) u[i] = a.u[i];
    for (int i = tid; i < F * FM; i += kThreads) cw[i] = a.conv_w[i];
    for (int i = tid; i < FM; i += kThreads) cb[i] = a.conv_b[i];
  }
  __syncthreads();

  const StepWeights w{a.ws_w, a.ws_b, a.c_w, a.c_b, a.dec_w, a.dec_b, a.cw1, a.cw2};
  // GRU: rin and zr share [K][2St], then rhr [K][2St], cand [K][St].
  const StepBufs bufs{sp, ws, al, reg, sr, reg, reg + K * St2, xo, reg + 2 * K * St2,
                      we, msk, scratch};
  const float* vhb = a.vh + (size_t)b * L * S;
  if constexpr (kLoc)
    attend_loc(w, bufs, LocBufs{ap, u, cw, cb, feat, F, FM}, vhb, K, L, S, St);
  else
    attend(w, bufs, vhb, K, L, S, St);
  context(bufs, a.h + (size_t)b * L * A, K, L, A, St);
  if constexpr (kLstm)
    lstm_cell(w, bufs, a.cw1, a.cw2, a.cw3, reg, mem, K, A, St);
  else
    decoder_cell(w, bufs, K, A, St);

  for (int i = tid; i < K * St; i += kThreads) {
    const int k = i / St, j = i % St;
    a.s[(row + k) * St + j] = xo[k * XO + j];
    if (kLstm) a.mem[(row + k) * St + j] = mem[i];
  }
  for (int i = tid; i < K * A; i += kThreads) {
    const int k = i / A, j = i % A;
    a.c[(row + k) * A + j] = xo[k * XO + St + j];
  }
  for (int i = tid; i < K * L; i += kThreads) a.alpha[row * L + i] = al[i];

  // Readout on concat(s_new, c): two ping-pong buffers, and the maxout
  // pre-activations after them.
  float* buf[2] = {reg, reg + K * a.maxw};
  float* pre = reg + 2 * K * a.maxw;
  const float* x = xo;
  int xs = XO, width = XO, next = 0;
  for (int li = 0; li < a.ro.n; ++li) {
    float* y = buf[next];
    const int out = a.ro.out[li];
    if (a.ro.kind[li] == kLinear) {
      matvec<kNone>(a.ro.w[li], a.ro.b[li], width, out, x, xs, y, out, K, scratch);
    } else if (a.ro.kind[li] == kMaxout) {
      const int win = a.ro.win[li];
      matvec<kNone>(a.ro.w[li], a.ro.b[li], width, out * win, x, xs, pre, out * win, K, scratch);
      for (int i = tid; i < K * out; i += kThreads) {
        const int k = i / out, g = i % out;
        const float* grp = pre + (k * out + g) * win;
        float mx = grp[0];
        for (int q = 1; q < win; ++q) mx = fmaxf(mx, grp[q]);
        y[i] = mx;
      }
      __syncthreads();
    } else {  // relu, out == width
      for (int i = tid; i < K * width; i += kThreads) {
        const int k = i / width, j = i % width;
        y[i] = fmaxf(x[k * xs + j], 0.f);
      }
      __syncthreads();
    }
    x = y;
    xs = width = out;
    next ^= 1;
  }
  if (warp < K) {  // f32 log_softmax, a warp per row
    const float* z = x + warp * xs;
    float m = -INFINITY;
    for (int j = lane; j < V; j += 32) m = fmaxf(m, z[j]);
    m = warp_max(m);
    float t = 0.f;
    for (int j = lane; j < V; j += 32) t += expf(z[j] - m);
    const float lse = logf(warp_sum(t));
    for (int j = lane; j < V; j += 32) a.logp[(row + warp) * V + j] = z[j] - m - lse;
  }
}

template <bool kLstm, bool kLoc>
cudaError_t launch2(const Args2& a, cudaStream_t stream) {
  const int LP = a.L + a.F - 1;
  const size_t floats =
      (size_t)a.K * (3 * a.St + a.S + a.L + a.St + a.A + a.region + 4 * kThreads) + a.S + a.L +
      (kLstm ? (size_t)a.K * a.St : 0) +
      (kLoc ? (size_t)a.K * LP + (size_t)a.FM * a.S + a.F * a.FM + a.FM + kWarps * a.K * a.FM : 0);
  const size_t bytes = floats * sizeof(float);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(attention_step_loc_lstm_kernel<kLstm, kLoc>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  attention_step_loc_lstm_kernel<kLstm, kLoc><<<a.B, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// cw1, cw2, cw3: the GRU's w_zr and w_h (cw3 NULL), or the LSTM's w_h,
// w_x and gate bias. memprev (LSTM) and aprev, conv_w, conv_b, u
// (location term) are NULL where the instance has no use for them; so
// are ro_w[i] and ro_b[i] of a relu layer.
extern "C" int fused_attention_step_loc_lstm(
    const float* vh, const float* h, const float* mask, const float* yin, const float* sprev,
    const float* ws_w, const float* ws_b, const float* w_e, const float* c_w, const float* c_b,
    const float* dec_w, const float* dec_b, const float* cw1, const float* cw2,
    const float* cw3, const float* memprev, const float* aprev, const float* conv_w, const float* conv_b,
    const float* u,
    float* alpha, float* c, float* s, float* mem, float* logp, int n_layers, const int* kinds,
    const int* outs, const int* wins, const float* const* ro_w, const float* const* ro_b,
    int lstm, int loc, int B, int K, int L, int S, int A, int St, int V, int FM, int F,
    cudaStream_t stream) {
  if (B < 1 || K < 1 || K > kMaxK || L < 1 || n_layers < 1 || n_layers > kMaxLayers ||
      (loc && (FM < 1 || F < 1)))
    return (int)cudaErrorInvalidValue;
  // The reference's padding (Attention.lua:77-85): (f-1)/2 on the left
  // for an odd filter, f/2 for an even one; both equal f / 2.
  Args2 a{vh,      h,     mask,   yin,    sprev, ws_w,  ws_b, w_e, c_w, c_b, dec_w, dec_b,
          cw1,     cw2,   cw3,    memprev, aprev, conv_w, conv_b, u, alpha, c, s, mem, logp,
          B,       K,     L,      S,      A,     St,    V,    loc ? FM : 0, loc ? F : 1,
          loc ? F / 2 : 0, 0, 0, {}};
  int width = St + A, maxw = 0, max_pre = 0;
  a.ro.n = n_layers;
  for (int i = 0; i < n_layers; ++i) {
    a.ro.kind[i] = kinds[i];
    a.ro.out[i] = kinds[i] == kRelu ? width : outs[i];
    a.ro.win[i] = kinds[i] == kMaxout ? wins[i] : 1;
    a.ro.w[i] = ro_w[i];
    a.ro.b[i] = ro_b[i];
    if (kinds[i] == kMaxout) max_pre = std::max(max_pre, a.ro.out[i] * a.ro.win[i]);
    width = a.ro.out[i];
    maxw = std::max(maxw, width);
  }
  if (width != V) return (int)cudaErrorInvalidValue;
  a.maxw = maxw;
  a.region = std::max(lstm ? 4 * St : 5 * St, 2 * maxw + max_pre);
  cudaError_t err;
  if (lstm)
    err = loc ? launch2<true, true>(a, stream) : launch2<true, false>(a, stream);
  else
    err = loc ? launch2<false, true>(a, stream) : launch2<false, false>(a, stream);
  return (int)err;
}
