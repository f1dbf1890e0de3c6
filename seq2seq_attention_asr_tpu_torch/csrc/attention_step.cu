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
// order: no atomics, two calls give the same bits. Nine cluster
// barriers a step. A beam wider than kMaxK hypotheses is cut into
// hyp_groups(K) balanced groups, each (batch row, group) on a cluster of
// its own that reads the row's vh and h. The elementwise GRU math runs on each block's own
// state units. Every block holds the maxout layer's outputs and takes
// its V / C columns of the linear layer (a word vocabulary of tens of
// thousands fits no one block): the log_softmax's max and exp-sum meet
// across the cluster, two floats a hypothesis a block, and each block
// writes its columns of logp. The block's logits take the place of the
// step's gathered vectors, dead by then.
//
// fused_attention_step_bf16 is K2's bf16 entry, for a bf16 model's beam:
// the same kernel with bf16 inputs and alpha, c and s in bf16, logp
// float, rounding where the JAX kernel rounds with bf16 inputs
// (attention_step_kernel says where). Plain PyTorch twin:
// ops/cuda/attention_step.py::_k2_plain_bf16.

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "cluster_walk.cuh"

namespace {

constexpr int kMaxStepCluster = 16;  // a non-portable cluster size on Hopper
// Weight rows a lane of a product loads before it uses any of them.
constexpr int kBatch = 4;

template <class T>
__host__ __device__ constexpr T cdiv(T n, T d) {
  return (n + d - 1) / d;
}

// The group a share of n items is cut in: 4 where 4 divides n, else 1.
__host__ __device__ constexpr int quad(int n) { return n % 4 ? 1 : 4; }

// The largest share of n items over C blocks, in groups of quad(n).
__host__ __device__ constexpr long long cspan(long long n, long long C) {
  return n % 4 ? cdiv(n, C) : 4 * cdiv(n / 4, C);
}

// Shared memory of one block of K2's step, in floats; the plan in
// ops/cuda/attention_step.py (step_smem_bytes) computes the same. The
// block's logits, K cspan(V, C), take the place of the step's gathered
// vectors, which are dead by the readout's last layer.
long long step_smem_floats(long long K, long long L, long long S, long long A, long long St,
                           long long M, long long W, long long V, long long C) {
  return std::max(K * (7 * St + S + A) + S, K * cspan(V, C)) + K * M + cdiv(L, C) * (K + 1) +
         C * K * (cdiv(A, C) + 3) + K + K * std::max(2 * cdiv(St, C), cdiv(M, C) * W) +
         cdiv(S, C) + 2 * cdiv(St, C) + cdiv(M, C) * W +
         kWarps * K * std::min(128LL, std::max(std::max(cdiv(S, C), 2 * cdiv(St, C)),
                                               std::max(cdiv(M, C) * W, cspan(V, C))));
}

// K2's arguments; T is the IO type of every array but logp: float, or bf16
// for the bf16 entry.
template <class T>
struct ArgsT {
  using Io = T;
  const T *vh, *h, *mask, *yin, *sprev;
  const T *ws_w, *ws_b, *w_e, *c_w, *c_b, *dec_w, *dec_b, *w_zr, *w_h;
  const T *mo_w, *mo_b, *lin_w, *lin_b;
  T *alpha, *c, *s;
  float* logp;
  int B, K, L, S, A, St, M, W, V;
  int G;  // hypothesis groups (hyp_groups), set by launch_step
};
using Args = ArgsT<float>;

// A beam of K hypotheses in G = cdiv(K, kMaxK) balanced groups of at most
// kMaxK (K = 10: two of 5); ops/cuda/attention_step.py::hyp_groups.
__host__ __device__ constexpr int hyp_groups(int K) { return cdiv(K, kMaxK); }

// The batch row and hypotheses of the cluster that runs this block, on
// clusters of C blocks, one cluster a (row, group): group g of row b takes
// hypotheses [k0, k0 + K), k0 = g Ktot / G, of the row's Ktot.
struct HypGroup {
  int b, k0, K;
  __device__ HypGroup(int C, int Ktot, int G) {
    const int cl = blockIdx.x / C, g = cl % G;
    b = cl / G;
    k0 = g * Ktot / G;
    K = (g + 1) * Ktot / G - k0;
  }
};

// Block r's share [lo, lo + n) of n_all items over C blocks, in whole
// groups of g items (g divides n_all).
struct Span {
  int lo, n;
  __device__ Span(int n_all, int C, int r, int g = 1)
      : lo(g * (n_all / g * r / C)), n(g * (n_all / g * (r + 1) / C) - lo) {}
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
// serves all seven products of the step. A bf16 w (TW) is widened as it
// is read.
template <int VW, int KM, class TW>
__device__ __noinline__ void slice_partials(const TW* __restrict__ w, int ldw, int in,
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
    const TW* wc = w + (jj < cs.n0 ? cs.lo0 + jj : cs.lo1 + jj - cs.n0);
#pragma unroll 1
    for (int i0 = warp * G + g; i0 < in; i0 += kBatch * step) {
      float wv[kBatch][VW];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int i = i0 + t * step;
        if constexpr (VW == 4) {
          const float4 u = i < in ? ldg_f4(wc + (size_t)i * ldw) : make_float4(0.f, 0.f, 0.f, 0.f);
          wv[t][0] = u.x, wv[t][1] = u.y, wv[t][2] = u.z, wv[t][3] = u.w;
        } else {
          wv[t][0] = i < in ? ldg_f(wc + (size_t)i * ldw) : 0.f;
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
template <int VW, class TW, class Emit>
__device__ void slice_product_vw(const TW* __restrict__ w, int ldw, int in, const float* x,
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

template <class TW, class Emit>
__device__ void slice_product(const TW* w, int ldw, int in, const float* x, int xs, int K,
                              const Cols& cs, float* scratch, Emit emit) {
  const bool vec = ((ldw | cs.lo0 | cs.n0 | cs.lo1 | cs.n1) & 3) == 0 &&
                   (reinterpret_cast<size_t>(w) & (4 * sizeof(TW) - 1)) == 0;
  if (vec)
    slice_product_vw<4>(w, ldw, in, x, xs, K, cs, scratch, emit);
  else
    slice_product_vw<1>(w, ldw, in, x, xs, K, cs, scratch, emit);
}

// VW values of x from i, widened (one 16-byte load of float, or 8-byte
// of bf16, when VW = 4), zeros from n on.
template <int VW, class TX>
__device__ __forceinline__ void load_vw(float (&v)[VW], const TX* x, int i, int n) {
  if constexpr (VW == 4) {
    const float4 u = i < n ? ldg_f4(x + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = i < n ? ldg_f(x + i) : 0.f;
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
// for all K hypotheses (bf16 vh, TV, widened as it is read). Ends with a
// block barrier.
template <int VW, class TV>
__device__ void energies(const TV* vhb, const float* ws, const float* we, float* e, int n,
                         int Lc, int K, int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < n; p += kWarps) {
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
    const TV* vr = vhb + (size_t)p * S;
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

// K2's step. With bf16 IO (T), as the JAX kernel with bf16 inputs: the
// inputs load widened and alpha, c and s store rounded; the energies, the
// softmax, c and the cell's math are float; each product's operand is
// rounded to bf16 where it is formed: c (in s_new | c, which the readout
// reads too) before c_in, c_in(c) + b before dec_in, r before the gates
// and the candidate, reset gate * s_prev before the candidate, s_new (in
// s_new | c) before maxout (s_prev arrives in bf16). Each readout layer
// rounds its product, then its bias add; the log-softmax is float.
// The kernel is a template on its arguments' type (Args is ArgsT<float> or
// ArgsT<bf16>), so that both entries run this one body; a profiler names
// both attention_step_kernel.
template <class Args>
__global__ void __launch_bounds__(kThreads, 1) attention_step_kernel(const Args a) {
  using T = typename Args::Io;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const HypGroup hg(C, a.K, a.G);
  const int b = hg.b, K = hg.K;
  const int L = a.L, S = a.S, A = a.A, St = a.St, M = a.M, W = a.W, V = a.V;
  const int St2 = 2 * St, XO = St + A, Lc = cdiv(L, C), Ac = cdiv(A, C);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Span pos(L, C, r), sc(S, C, r), un(St, C, r), ac(A, C, r), gr(M, C, r);
  const Span vs(V, C, r, quad(V));
  const int Stc = cdiv(St, C), Vc = (int)cspan(V, C);

  // Gathered: every block holds the whole of these, each block writing its
  // slice. ws and w_e first: 16-byte aligned where S is a multiple of 4.
  float* ws = sm;                // [K][S]     s_prev @ Ws + b
  float* we = ws + K * S;        // [S]
  float* sr = we + S;            // [K][2St]   s_prev | r
  float* rin = sr + K * St2;     // [K][2St]   c_in(c) | yin
  float* rhr = rin + K * St2;    // [K][2St]   reset gate * s_prev | r
  float* xo = rhr + K * St2;     // [K][St+A]  s_new | c
  // The block's logits, its Vc columns of the linear layer, over the
  // buffers above: none is read after the maxout layer.
  float* lg = sm;                // [K][Vc]
  float* mo = sm + max(K * (St2 * 3 + XO + S) + S, K * Vc);  // [K][M] maxout
  // This block's positions, and what the cluster exchanges about them.
  float* msk = mo + K * M;       // [Lc]
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
  float* scratch = bmo + Mc * W;

  cluster_arrive();  // no block writes into another before every block has started
  // The step's inputs and this block's bias columns, by asynchronous
  // copies: one round trip (bf16 IO: loads widened).
  const auto load = [](float* dst, const T* src) {
    if constexpr (kIsBf16<T>)
      *dst = to_f(*src);
    else
      copy_async(dst, src);
  };
  const size_t row = (size_t)b * a.K + hg.k0;
  for (int i = tid; i < K * St; i += kThreads) {
    const int k = i / St, j = i % St;
    load(sr + k * St2 + j, a.sprev + (row + k) * St + j);
    load(rin + k * St2 + St + j, a.yin + (row + k) * St + j);
  }
  for (int i = tid; i < S; i += kThreads) load(we + i, a.w_e + i);
  for (int i = tid; i < pos.n; i += kThreads) load(msk + i, a.mask + (size_t)b * L + pos.lo + i);
  for (int i = tid; i < sc.n; i += kThreads) load(bws + i, a.ws_b + sc.lo + i);
  for (int i = tid; i < un.n; i += kThreads) {
    load(bc + i, a.c_b + un.lo + i);
    load(bdec + i, a.dec_b + un.lo + i);
  }
  for (int i = tid; i < gr.n * W; i += kThreads) load(bmo + i, a.mo_b + gr.lo * W + i);
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

  const T* vhb = a.vh + ((size_t)b * L + pos.lo) * S;
  if ((S & 3) == 0 && (reinterpret_cast<size_t>(a.vh) & (4 * sizeof(T) - 1)) == 0)
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
  const T* hb = a.h + ((size_t)b * L + pos.lo) * A;
  for (int j = tid; j < A; j += kThreads) {
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
    float hv = pos.n > 0 ? ldg_f(hb + j) : 0.f;
#pragma unroll 1
    for (int p = 0; p < pos.n; ++p) {
      const float hn = p + 1 < pos.n ? ldg_f(hb + (size_t)(p + 1) * A + j) : 0.f;
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
    st_f(a.alpha + (row + k) * L + pos.lo + p, e[k * Lc + p] * scale[r * K + k] / zsum[k]);
  }
  // This block's context columns: the C partials in rank order, into every block.
  for (int i = tid; i < K * ac.n; i += kThreads) {
    const int k = i / ac.n, jl = i % ac.n;
    float sum = 0.f;
    for (int p = 0; p < C; ++p) sum = fmaf(scale[p * K + k], part[(p * K + k) * Ac + jl], sum);
    const float v = sum / zsum[k], vr = round_to<T>(v);
    const int j = St + ac.lo + jl;
    for (int p = 0; p < C; ++p) cluster.map_shared_rank(xo, p)[k * XO + j] = vr;
    st_f(a.c + (row + k) * A + ac.lo + jl, v);
  }
  cluster.sync();
  // [phase] context

  // r = dec_in(concat(c_in(c), yin)): this block's state units of each.
  slice_product(a.c_w, St, A, xo + St, XO, K, Cols{un.lo, un.n, 0, 0}, scratch,
                [&](int k, int jj, int col, float v) {
                  v = round_to<T>(v + bc[jj]);
                  for (int p = 0; p < C; ++p) cluster.map_shared_rank(rin, p)[k * St2 + col] = v;
                });
  cluster.sync();
  // [phase] c_in
  slice_product(a.dec_w, St, St2, rin, St2, K, Cols{un.lo, un.n, 0, 0}, scratch,
                [&](int k, int jj, int col, float v) {
                  v = round_to<T>(v + bdec[jj]);
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
                    const float rs = round_to<T>(g * sr[k * St2 + u]);
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
                  const float snr = round_to<T>(sn);
                  for (int p = 0; p < C; ++p) cluster.map_shared_rank(xo, p)[k * XO + col] = snr;
                  st_f(a.s + (row + k) * St + col, sn);
                });
  cluster.sync();
  // [phase] candidate

  // Readout: this block's maxout groups (whole windows of W columns),
  // their maxima into every block.
  const int nmo = gr.n * W;
  slice_product(a.mo_w, M * W, XO, xo, XO, K, Cols{gr.lo * W, nmo, 0, 0}, scratch,
                [&](int k, int jj, int, float v) {
                  gz[k * nmo + jj] = round_to<T>(round_to<T>(v) + bmo[jj]);
                });
  for (int i = tid; i < K * gr.n; i += kThreads) {
    const int k = i / gr.n, g = i % gr.n;
    const float* grp = gz + k * nmo + g * W;
    float m = grp[0];
    for (int t = 1; t < W; ++t) m = fmaxf(m, grp[t]);
    for (int p = 0; p < C; ++p) cluster.map_shared_rank(mo, p)[k * M + gr.lo + g] = m;
  }
  cluster.sync();
  // [phase] maxout

  // The linear layer's columns vs of this block (whole groups of 4 where
  // 4 divides V), then the f32 log_softmax, a warp per hypothesis: the
  // block's max and exp-sum over its columns go to every block, and each
  // block writes its columns of logp against the row's max and sum.
  slice_product(a.lin_w, V, M, mo, M, K, Cols{vs.lo, vs.n, 0, 0}, scratch,
                [&](int k, int jj, int col, float v) {
                  lg[k * Vc + jj] = round_to<T>(round_to<T>(v) + ldg_f(a.lin_b + col));
                });
  const float* x = lg + warp * Vc;
  float m = -INFINITY;
  if (warp < K) {
    for (int j = lane; j < vs.n; j += 32) m = fmaxf(m, x[j]);
    m = warp_max(m);
    float z = 0.f;
    for (int j = lane; j < vs.n; j += 32) z += expf(x[j] - m);
    z = warp_sum(z);
    if (lane < C) {
      float* st = cluster.map_shared_rank(stat, lane) + (r * K + warp) * 2;
      st[0] = m;
      st[1] = z;
    }
  }
  cluster.sync();
  // [phase] linear
  if (warp < K) {
    m = -INFINITY;
    for (int p = 0; p < C; ++p) m = fmaxf(m, stat[(p * K + warp) * 2]);
    float z = 0.f;
    for (int p = 0; p < C; ++p) {
      const float* st = stat + (p * K + warp) * 2;
      if (st[1] > 0.f) z = fmaf(expf(st[0] - m), st[1], z);
    }
    const float lse = logf(z);
    float* out = a.logp + (row + warp) * V + vs.lo;
    for (int j = lane; j < vs.n; j += 32) out[j] = x[j] - m - lse;
  }
  // [phase] log_softmax
}

// K2 on clusters of `cluster` blocks, a cluster a batch row and hypothesis
// group, each block sized for the largest group.
template <class T>
int launch_step(ArgsT<T> a, int cluster, cudaStream_t stream) {
  if (a.B < 1 || a.K < 1 || a.L < 1 || a.W < 1 || cluster < 1 || cluster > kMaxStepCluster)
    return (int)cudaErrorInvalidValue;
  a.G = hyp_groups(a.K);
  const size_t bytes =
      step_smem_floats(cdiv(a.K, a.G), a.L, a.S, a.A, a.St, a.M, a.W, a.V, cluster) *
      sizeof(float);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_step_kernel<ArgsT<T>>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(attention_step_kernel<ArgsT<T>>, dim3(a.B * a.G * cluster), cluster,
                             bytes, stream, a);
}

}  // namespace

// Device limits of K2's cluster launch: the opt-in shared memory of a
// block and how many clusters of `cluster` blocks (8, or 16: a
// non-portable size) can be resident at once. The plan in
// ops/cuda/attention_step.py takes C from them.
extern "C" int fused_attention_step_limits(int cluster, int* smem_limit, int* clusters) {
  if (cluster < 1 || cluster > kMaxStepCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_step_kernel<Args>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  return (int)cluster_limits(attention_step_kernel<Args>, cluster, smem_limit, clusters);
}

// `cluster`: C, the blocks of a batch row's cluster (the wrapper's plan).
extern "C" int fused_attention_step(
    const float* vh, const float* h, const float* mask, const float* yin, const float* sprev,
    const float* ws_w, const float* ws_b, const float* w_e, const float* c_w, const float* c_b,
    const float* dec_w, const float* dec_b, const float* w_zr, const float* w_h,
    const float* mo_w, const float* mo_b, const float* lin_w, const float* lin_b,
    float* alpha, float* c, float* s, float* logp, int B, int K, int L, int S, int A, int St,
    int M, int W, int V, int cluster, cudaStream_t stream) {
  const Args a{vh,    h,     mask,  yin,   sprev, ws_w, ws_b, w_e, c_w, c_b, dec_w,
               dec_b, w_zr,  w_h,   mo_w,  mo_b,  lin_w, lin_b, alpha, c, s, logp,
               B,     K,     L,     S,     A,     St,   M,    W,   V};
  return launch_step(a, cluster, stream);
}

// K2's bf16 entry: fused_attention_step with every array bf16 but logp,
// on fused_attention_step_limits' plan (the same block and shared memory).
extern "C" int fused_attention_step_bf16(
    const bf16* vh, const bf16* h, const bf16* mask, const bf16* yin, const bf16* sprev,
    const bf16* ws_w, const bf16* ws_b, const bf16* w_e, const bf16* c_w, const bf16* c_b,
    const bf16* dec_w, const bf16* dec_b, const bf16* w_zr, const bf16* w_h,
    const bf16* mo_w, const bf16* mo_b, const bf16* lin_w, const bf16* lin_b,
    bf16* alpha, bf16* c, bf16* s, float* logp, int B, int K, int L, int S, int A, int St,
    int M, int W, int V, int cluster, cudaStream_t stream) {
  const ArgsT<bf16> a{vh,    h,     mask,  yin,   sprev, ws_w, ws_b, w_e, c_w, c_b, dec_w,
                      dec_b, w_zr,  w_h,   mo_w,  mo_b,  lin_w, lin_b, alpha, c, s, logp,
                      B,     K,     L,     S,     A,     St,   M,    W,   V};
  return launch_step(a, cluster, stream);
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
// whose weights come from L2 every step, about 7.4 MB at the conv+BiLSTM
// recipe (dec_in 800x400, the LSTM's w_h and w_x 400x1600 each). So it
// takes K2's split: each batch row (and group of at most kMaxK of its
// hypotheses, as K2's) runs on a cluster of C blocks (16 or 8, from the
// wrapper's plan), and block r
//   - reads its share of every weight's columns, for all the group's
//     hypotheses at once: S / C of ws, its St / C state units' columns of
//     c_in, dec_in and the cell (the LSTM's four gates, the GRU's update
//     and reset gates and candidate), and its share of each readout layer
//     (maxout in whole groups of its window); shares of a width that 4
//     divides are whole groups of 4, so that 16-byte loads stay aligned;
//   - pushes what it forms into every block's shared memory through
//     distributed shared memory (DSMEM), and the cluster meets at a
//     barrier before the values are read (six barriers a step for the
//     LSTM and seven for the GRU, one for each readout layer but the
//     last, and one for the log_softmax);
//   - takes encoder positions [r L / C, (r + 1) L / C): their energies,
//     with the location term formed from alpha_prev's window around them
//     (the F - 1 halo comes from global memory: alpha_prev is an input),
//     the softmax's local max and exp-sum, and the context's partial sums
//     over them, combined in every block as K2 combines them.
// The products on s_prev and yin, which need no exchange (s_prev @ w_h or
// @ w_zr[:St], yin @ dec_w[St:]), and the GRU's r @ w_h[St:], run while a
// cluster barrier completes. The readout's last layer stays split: each
// block keeps its logits (a word vocabulary of tens of thousands fits no
// one block), the log_softmax's max and exp-sum meet across the cluster,
// two floats a hypothesis a block, and each block writes its outputs of
// logp. Fixed-order sums, no atomics: two calls give the same bits. No
// shared buffer grows with the full L or the full V.
//
// fused_attention_step_loc_lstm_bf16 is K8's bf16 entry, for a bf16
// model's beam (each of its four instances): the same kernel with bf16
// inputs, alpha, c, s and mem in bf16 and logp float, on the float
// instance's plan, rounding where the JAX kernel rounds with bf16 inputs
// (cluster_step_loc_lstm_kernel says where). Plain PyTorch twin:
// ops/cuda/attention_step.py::_plain_bf16.

namespace {

constexpr int kMaxLayers = 4;  // readout layers after dropout is dropped
enum LayerKind { kLinear = 0, kMaxout = 1, kRelu = 2 };
// Score units a lane of the location term's energies takes at once: their
// sums over the feature maps are independent chains.
constexpr int kLocCols = 4;

// The readout as its dense layers (linear or maxout), each followed by a
// relu or not; relu_in: a relu on concat(s_new, c) before the first. T is
// the weights' IO type.
template <class T>
struct ReadoutT {
  int n, relu_in;
  int kind[kMaxLayers];
  int out[kMaxLayers];   // output width (maxout: groups)
  int win[kMaxLayers];   // maxout window (linear: 1)
  int relu[kMaxLayers];  // a relu follows
  const T* w[kMaxLayers];
  const T* b[kMaxLayers];
};

// n rounded up to whole 16-byte groups of floats.
__host__ __device__ constexpr long long r4(long long n) { return (n + 3) / 4 * 4; }

// Shared memory of one block of K8's step, in floats, on clusters of C
// blocks for a group of K hypotheses (lstm 1 for the LSTM cell, loc 1
// with the location term, else 0 and FM = F = 0); maxw, maxpre, cols and
// lastw are readout_dims'. Each buffer is 16-byte aligned; the block's
// logits of the readout's last layer (K lastw) lie over the first
// gathered buffers, dead by then. The plan in ops/cuda/attention_step.py
// (step_loc_lstm_smem_bytes) computes the same.
long long step_loc_lstm_smem_floats(long long K, long long L, long long S, long long A,
                                    long long St, long long FM, long long F, long long C,
                                    long long lstm, long long loc, long long maxw,
                                    long long maxpre, long long cols, long long lastw) {
  return std::max(r4(K * S) + r4(S) + 2 * r4(2 * K * St) + (1 - lstm) * r4(K * St),
                  r4(K * lastw)) +
         r4(K * (St + A)) + 2 * r4(K * maxw) + r4(cdiv(L, C)) + r4(K * cdiv(L, C)) +
         r4(C * K * cdiv(A, C)) +
         r4(2 * C * K) + r4(C * K) + r4(K) +
         r4(K * std::max((2 + 2 * lstm) * cspan(St, C), maxpre)) +
         (1 + lstm) * r4(K * cspan(St, C)) + r4(cspan(S, C)) + 2 * r4(cspan(St, C)) +
         lstm * r4(4 * cspan(St, C)) +
         loc * (r4(K * (cdiv(L, C) + F - 1)) + r4(FM * S) + r4(F * FM) + r4(FM) +
                r4(kWarps * FM)) +
         r4(kWarps * K * std::min(128LL, std::max(std::max(cspan(S, C), 2 * cspan(St, C)), cols)));
}

// The readout's sizes on clusters of C blocks: the widest output of a
// layer but the last (maxw, 0 for one layer), the most maxout
// pre-activations a block holds (maxpre), the most columns a block's
// share of a layer's product takes (cols) and the most outputs a block
// takes of the last layer (lastw). Every layer is split over the blocks
// (maxout in whole groups, linear in groups of quad(out)); a layer but the
// last is gathered into every block, the last stays where it is formed.
struct ReadoutDims {
  long long maxw, maxpre, cols, lastw;
};

template <class T>
ReadoutDims readout_dims(const ReadoutT<T>& ro, long long C) {
  ReadoutDims d{0, 0, 0, 0};
  for (int i = 0; i < ro.n; ++i) {
    const long long out = ro.out[i], win = ro.win[i];
    const long long share = ro.kind[i] == kMaxout ? cdiv(out, C) : cspan(out, C);
    d.cols = std::max(d.cols, share * win);
    if (ro.kind[i] == kMaxout) d.maxpre = std::max(d.maxpre, share * win);
    if (i == ro.n - 1)
      d.lastw = share;
    else
      d.maxw = std::max(d.maxw, out);
  }
  return d;
}

// K8's arguments; T is the IO type of every array but logp: float, or bf16
// for the bf16 entry.
template <class T>
struct Args8T {
  using Io = T;
  const T *vh, *h, *mask, *yin, *sprev;
  const T *ws_w, *ws_b, *w_e, *c_w, *c_b, *dec_w, *dec_b, *cw1, *cw2, *cw3;
  const T *memprev, *aprev, *conv_w, *conv_b, *u;
  T *alpha, *c, *s, *mem;
  float* logp;
  int B, K, L, S, A, St, V, FM, F, PL;
  int G, maxw, maxpre, lastw;  // hypothesis groups; readout_dims'
  ReadoutT<T> ro;
};

// e[k * Lc + p] = w_e . tanh(vh[p] + ws[k] + feat_k(p) @ U) for this
// block's n positions: a warp per (position, hypothesis) pair, and P =
// kWarps / (n K) warps (at least 1) to a pair, each taking every P-th
// group of 32 score units, kLocCols groups a lane at once. A warp forms
// its hypothesis's FM features of its position from alpha_prev's window
// (ap: [K][Pw], the block's position p reading ap[k][p + j] for the F
// taps j) and adds them through U inside the energy loop; UF is never
// stored. The P warps' sums meet in `part` ([kWarps]) and are added in
// their order. Ends with a block barrier. A bf16 vh (TV) is widened as it
// is read, and the features are rounded to bf16 where they are formed
// (the JAX kernel's rounding of the features before U).
template <class TV>
__device__ void energies_loc(const TV* vhb, const float* ws, const float* we, const float* ap,
                             int Pw, const float* u, const float* cw, const float* cb,
                             float* feat, float* part, float* e, int n, int Lc, int K, int S,
                             int FM, int F) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pairs = n * K, P = pairs > 0 ? max(1, kWarps / pairs) : 1;
  float* f = feat + warp * FM;
  for (int task = warp; task < pairs * P; task += kWarps) {
    const int pk = task / P, q0 = task - pk * P, p = pk / K, k = pk - p * K;
    for (int q = lane; q < FM; q += 32) {
      const float* x = ap + k * Pw + p;
      float v = 0.f;
      for (int j = 0; j < F; ++j) v = fmaf(x[j], cw[j * FM + q], v);
      f[q] = round_to<TV>(v + cb[q]);
    }
    __syncwarp();
    const TV* vr = vhb + (size_t)p * S;
    const float* wk = ws + k * S;
    float acc = 0.f;
#pragma unroll 1
    for (int g0 = q0; 32 * g0 < S; g0 += P * kLocCols) {
      float z[kLocCols], uf[kLocCols];
      int sx[kLocCols];  // the lane's score unit in each group, S past the end
#pragma unroll
      for (int x = 0; x < kLocCols; ++x) {
        const int s = 32 * (g0 + P * x) + lane;
        sx[x] = min(s, S);
        z[x] = s < S ? ldg_f(vr + s) + wk[s] : 0.f;
        uf[x] = 0.f;
      }
#pragma unroll 4
      for (int q = 0; q < FM; ++q) {
        const float fq = f[q];
#pragma unroll
        for (int x = 0; x < kLocCols; ++x)
          if (sx[x] < S) uf[x] = fmaf(fq, u[q * S + sx[x]], uf[x]);
      }
#pragma unroll
      for (int x = 0; x < kLocCols; ++x)
        if (sx[x] < S) acc = fmaf(fast_tanh(z[x] + uf[x]), we[sx[x]], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      if (P == 1)
        e[k * Lc + p] = acc;
      else
        part[task] = acc;
    }
    __syncwarp();  // f is rewritten for the warp's next pair
  }
  __syncthreads();
  if (P > 1) {
    for (int i = threadIdx.x; i < pairs; i += kThreads) {
      const int p = i / K, k = i - p * K;
      float v = 0.f;
      for (int q = 0; q < P; ++q) v += part[i * P + q];
      e[k * Lc + p] = v;
    }
    __syncthreads();
  }
}

// K8's step. With bf16 IO (T), as the JAX kernel with bf16 inputs: the
// inputs and the state (s_prev, mem_prev, alpha_prev) load widened, and
// alpha, c, s and mem store rounded; the energies, the softmax, c and the
// cell's math are float; each product's operand is rounded to bf16 where
// it is formed: the location term's features before U (energies_loc), c
// (in s_new | c, which the readout reads too) before c_in, c_in(c) + b
// before dec_in (yin arrives in bf16), r before the gates (and the GRU's
// candidate), reset gate * s_prev before the candidate, s_new (in s_new |
// c) before the readout. Each readout layer rounds its product, then its
// bias add; the log-softmax is float. The kernel is a template on the IO
// type, so that both entries run this one body; a profiler names both
// cluster_step_loc_lstm_kernel.
template <bool kLstm, bool kLoc, class T>
__global__ void __launch_bounds__(kThreads, 1) cluster_step_loc_lstm_kernel(const Args8T<T> a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const HypGroup hg(C, a.K, a.G);
  const int b = hg.b, K = hg.K;
  const int L = a.L, S = a.S, A = a.A, St = a.St, FM = a.FM, F = a.F;
  const int St2 = 2 * St, XO = St + A, Lc = cdiv(L, C), Ac = cdiv(A, C);
  // Gate pre-activations a unit: the LSTM's four, the GRU's update and reset.
  constexpr int G = kLstm ? 4 : 2;
  const int Stc = (int)cspan(St, C), Pw = Lc + F - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Span pos(L, C, r), sc(S, C, r, quad(S)), un(St, C, r, quad(St)), ac(A, C, r);

  // As step_loc_lstm_smem_floats counts, each buffer 16-byte aligned.
  float* next = sm;
  const auto take = [&](long long n) {
    float* p = next;
    next += r4(n);
    return p;
  };
  // Gathered: every block holds the whole of these, each block writing its share.
  float* ws = take(K * S);        // [K][S]     s_prev @ Ws + b
  float* we = take(S);            // [S]
  float* sr = take(K * St2);      // [K][2St]   s_prev | r
  float* rin = take(K * St2);     // [K][2St]   c_in(c) | yin
  float* rs = kLstm ? nullptr : take(K * St);  // [K][St] reset gate * s_prev
  // The block's logits, its share of the readout's last layer, over the
  // buffers above: none is read (or written by another block) after the
  // cell.
  float* lg = sm;                 // [K][lastw]
  if (next - sm < r4((long long)K * a.lastw)) next = sm + r4((long long)K * a.lastw);
  float* xo = take(K * XO);       // [K][St+A]  s_new | c
  float* y0 = take(K * a.maxw);   // [K][maxw]  readout layer outputs, by turns
  float* y1 = take(K * a.maxw);
  // This block's positions, and what the cluster exchanges about them.
  float* msk = take(Lc);           // [Lc]
  float* e = take(K * Lc);         // [K][Lc]       energies, then exp(e - local max)
  float* part = take(C * K * Ac);  // [C][K][Ac]    context partials of this block's columns
  float* stat = take(2 * C * K);   // [C][K][2]     each block's (max, exp-sum)
  float* scale = take(C * K);      // [C][K]        exp(block max - max)
  float* zsum = take(K);           // [K]           the clamped exp-sum
  // This block's units: gate pre-activations [K][G][Stc] (then the maxout
  // pre-activations), the LSTM's cell state, a product's half formed early
  // (yin @ dec_w[St:], then the GRU's r @ w_h[St:]), and bias columns.
  float* gl = take(K * max(G * Stc, a.maxpre));
  float* mem = kLstm ? take(K * Stc) : nullptr;
  float* pre = take(K * Stc);
  float* bws = take(cspan(S, C));
  float* bc = take(Stc);
  float* bdec = take(Stc);
  float* bg = kLstm ? take(4 * Stc) : nullptr;
  float *ap = nullptr, *u = nullptr, *cw = nullptr, *cb = nullptr, *feat = nullptr;
  if (kLoc) {
    ap = take(K * Pw);           // [K][Pw]      alpha_prev on the positions' window, 0 off [0, L)
    u = take(FM * S);            // [FM][S]
    cw = take(F * FM);           // [F][FM]      conv taps
    cb = take(FM);               // [FM]         conv bias
    feat = take(kWarps * FM);    // [kWarps][FM]  a (position, hypothesis)'s features, per warp
  }
  float* scratch = next;
  const auto gi = [&](int k, int g, int j) { return (k * G + g) * Stc + j; };

  cluster_arrive();  // no block writes into another before every block has started
  // The step's inputs and this block's columns of biases, by asynchronous
  // copies: one round trip (bf16 IO: loads widened).
  const auto load = [](float* dst, const T* src) {
    if constexpr (kIsBf16<T>)
      *dst = to_f(*src);
    else
      copy_async(dst, src);
  };
  const size_t row = (size_t)b * a.K + hg.k0;
  for (int i = tid; i < K * St; i += kThreads) {
    const int k = i / St, j = i - k * St;
    load(sr + k * St2 + j, a.sprev + (row + k) * St + j);
    load(rin + k * St2 + St + j, a.yin + (row + k) * St + j);
  }
  for (int i = tid; i < S; i += kThreads) load(we + i, a.w_e + i);
  for (int i = tid; i < pos.n; i += kThreads) load(msk + i, a.mask + (size_t)b * L + pos.lo + i);
  for (int i = tid; i < sc.n; i += kThreads) load(bws + i, a.ws_b + sc.lo + i);
  for (int i = tid; i < un.n; i += kThreads) {
    load(bc + i, a.c_b + un.lo + i);
    load(bdec + i, a.dec_b + un.lo + i);
  }
  if (kLstm) {
    for (int i = tid; i < 4 * un.n; i += kThreads) {
      const int g = i / un.n, j = i - g * un.n;
      load(bg + g * Stc + j, a.cw3 + g * St + un.lo + j);
    }
    for (int i = tid; i < K * un.n; i += kThreads) {
      const int k = i / un.n, j = i - k * un.n;
      load(mem + k * Stc + j, a.memprev + (row + k) * St + un.lo + j);
    }
  }
  if (kLoc) {
    // The positions' window of alpha_prev: the reference pads F / 2 on
    // the left (a.PL), so position l's features read l - PL .. l - PL + F - 1.
    const int nwin = pos.n > 0 ? pos.n + F - 1 : 0;
    for (int i = tid; i < K * nwin; i += kThreads) {
      const int k = i / nwin, x = i - k * nwin, l = pos.lo - a.PL + x;
      if (l >= 0 && l < L)
        load(ap + k * Pw + x, a.aprev + (row + k) * L + l);
      else
        ap[k * Pw + x] = 0.f;
    }
    for (int i = tid; i < FM * S; i += kThreads) load(u + i, a.u + i);
    for (int i = tid; i < F * FM; i += kThreads) load(cw + i, a.conv_w + i);
    for (int i = tid; i < FM; i += kThreads) load(cb + i, a.conv_b + i);
  }
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
  cluster_arrive();
  // While the exchange completes: s_prev's products on the block's gate
  // columns, the LSTM's s_prev @ w_h + b on its four gates (in two passes
  // of two), the GRU's s_prev @ w_zr[:St] on its update and reset gates.
  if constexpr (kLstm) {
    for (int g0 = 0; g0 < 4; g0 += 2)
      slice_product(a.cw1, 4 * St, St, sr, St2, K,
                    Cols{g0 * St + un.lo, un.n, (g0 + 1) * St + un.lo, un.n}, scratch,
                    [&](int k, int jj, int, float v) {
                      const int g = g0 + (jj >= un.n), j = jj - (jj >= un.n) * un.n;
                      gl[gi(k, g, j)] = v + bg[g * Stc + j];
                    });
  } else {
    slice_product(a.cw1, St2, St, sr, St2, K, Cols{un.lo, un.n, St + un.lo, un.n}, scratch,
                  [&](int k, int jj, int, float v) {
                    const int g = jj >= un.n;
                    gl[gi(k, g, jj - g * un.n)] = v;
                  });
  }
  cluster_wait();
  // [phase] ws, s_prev product

  const T* vhb = a.vh + ((size_t)b * L + pos.lo) * S;
  if constexpr (kLoc)
    energies_loc(vhb, ws, we, ap, Pw, u, cw, cb, feat, scratch, e, pos.n, Lc, K, S, FM, F);
  else if ((S & 3) == 0 && (reinterpret_cast<size_t>(a.vh) & (4 * sizeof(T) - 1)) == 0)
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
  const T* hb = a.h + ((size_t)b * L + pos.lo) * A;
  for (int j = tid; j < A; j += kThreads) {
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
    float hv = pos.n > 0 ? ldg_f(hb + j) : 0.f;
#pragma unroll 1
    for (int p = 0; p < pos.n; ++p) {
      const float hn = p + 1 < pos.n ? ldg_f(hb + (size_t)(p + 1) * A + j) : 0.f;
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
  cluster_arrive();
  // While the exchange completes: yin's half of dec_in on the block's units.
  slice_product(a.dec_w + (size_t)St * St, St, St, rin + St, St2, K, Cols{un.lo, un.n, 0, 0},
                scratch, [&](int k, int jj, int, float v) { pre[k * Stc + jj] = v; });
  cluster_wait();
  // [phase] softmax, context partials, yin product

  // Every block, a warp per hypothesis and a lane per block: the max over
  // blocks, each block's exp(max_r - max), and the clamped exp-sum (a row
  // with no valid position gets alpha 0).
  if (warp < K) {
    const float m = lane < C ? stat[(lane * K + warp) * 2] : kNegInf, mx = warp_max(m);
    const float f = lane < C ? expf(m - mx) : 0.f;
    if (lane < C) scale[lane * K + warp] = f;
    const float z = warp_sum(lane < C ? f * stat[(lane * K + warp) * 2 + 1] : 0.f);
    if (lane == 0) zsum[warp] = fmaxf(z, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < K * pos.n; i += kThreads) {
    const int k = i / pos.n, p = i % pos.n;
    st_f(a.alpha + (row + k) * L + pos.lo + p, e[k * Lc + p] * scale[r * K + k] / zsum[k]);
  }
  // This block's context columns: the C partials in rank order, into every block.
  for (int i = tid; i < K * ac.n; i += kThreads) {
    const int k = i / ac.n, jl = i % ac.n;
    float sum = 0.f;
    for (int p = 0; p < C; ++p) sum = fmaf(scale[p * K + k], part[(p * K + k) * Ac + jl], sum);
    const float v = sum / zsum[k], vr = round_to<T>(v);
    const int j = St + ac.lo + jl;
    for (int p = 0; p < C; ++p) cluster.map_shared_rank(xo, p)[k * XO + j] = vr;
    st_f(a.c + (row + k) * A + ac.lo + jl, v);
  }
  cluster.sync();
  // [phase] context

  // r = dec_in(concat(c_in(c), yin)): this block's state units of c_in,
  // into every block; then of dec_in, c_in's half added to yin's.
  slice_product(a.c_w, St, A, xo + St, XO, K, Cols{un.lo, un.n, 0, 0}, scratch,
                [&](int k, int jj, int col, float v) {
                  v = round_to<T>(v + bc[jj]);
                  for (int p = 0; p < C; ++p) cluster.map_shared_rank(rin, p)[k * St2 + col] = v;
                });
  cluster.sync();
  // [phase] c_in
  slice_product(a.dec_w, St, St, rin, St2, K, Cols{un.lo, un.n, 0, 0}, scratch,
                [&](int k, int jj, int col, float v) {
                  v = round_to<T>(v + pre[k * Stc + jj] + bdec[jj]);
                  for (int p = 0; p < C; ++p)
                    cluster.map_shared_rank(sr, p)[k * St2 + St + col] = v;
                });
  cluster.sync();
  // [phase] dec_in

  if constexpr (kLstm) {
    // The gates: + r @ w_x on the block's gate columns; then the LSTM
    // cell on its units (gate order in, forget, cell, out), s_new into
    // every block.
    for (int g0 = 0; g0 < 4; g0 += 2)
      slice_product(a.cw2, 4 * St, St, sr + St, St2, K,
                    Cols{g0 * St + un.lo, un.n, (g0 + 1) * St + un.lo, un.n}, scratch,
                    [&](int k, int jj, int, float v) {
                      const int g = g0 + (jj >= un.n);
                      gl[gi(k, g, jj - (jj >= un.n) * un.n)] += v;
                    });
    for (int i = tid; i < K * un.n; i += kThreads) {
      const int k = i / un.n, j = i - k * un.n;
      const float ig = activate<kSigmoid>(gl[gi(k, 0, j)]);
      const float fg = activate<kSigmoid>(gl[gi(k, 1, j)]);
      const float gg = tanhf(gl[gi(k, 2, j)]);
      const float og = activate<kSigmoid>(gl[gi(k, 3, j)]);
      const float cv = fg * mem[k * Stc + j] + ig * gg;
      const float sn = og * tanhf(cv);
      const size_t o = (row + k) * St + un.lo + j;
      st_f(a.mem + o, cv);
      st_f(a.s + o, sn);
      const float snr = round_to<T>(sn);
      for (int p = 0; p < C; ++p) cluster.map_shared_rank(xo, p)[k * XO + un.lo + j] = snr;
    }
    cluster.sync();
    // [phase] cell
  } else {
    // The gates: + r @ w_zr[St:] on the block's update and reset columns;
    // the update gate stays here, reset gate * s_prev goes to every block.
    slice_product(a.cw1 + (size_t)St * St2, St2, St, sr + St, St2, K,
                  Cols{un.lo, un.n, St + un.lo, un.n}, scratch,
                  [&](int k, int jj, int col, float v) {
                    const int g = jj >= un.n, j = jj - g * un.n;
                    const float gv = activate<kSigmoid>(gl[gi(k, g, j)] + v);
                    if (g == 0) {
                      gl[gi(k, 0, j)] = gv;
                    } else {
                      const int uu = col - St;
                      const float x = round_to<T>(gv * sr[k * St2 + uu]);
                      for (int p = 0; p < C; ++p) cluster.map_shared_rank(rs, p)[k * St + uu] = x;
                    }
                  });
    cluster_arrive();
    // While the exchange completes: r's half of the candidate, r @ w_h[St:].
    slice_product(a.cw2 + (size_t)St * St, St, St, sr + St, St2, K, Cols{un.lo, un.n, 0, 0},
                  scratch, [&](int k, int jj, int, float v) { pre[k * Stc + jj] = v; });
    cluster_wait();
    // [phase] gates, r candidate product
    // The candidate and s_new for this block's units, into every block.
    slice_product(a.cw2, St, St, rs, St, K, Cols{un.lo, un.n, 0, 0}, scratch,
                  [&](int k, int jj, int col, float v) {
                    const float zg = gl[gi(k, 0, jj)], sp = sr[k * St2 + col];
                    const float sn = (1.f - zg) * sp + zg * activate<kTanh>(v + pre[k * Stc + jj]);
                    const float snr = round_to<T>(sn);
                    for (int p = 0; p < C; ++p) cluster.map_shared_rank(xo, p)[k * XO + col] = snr;
                    st_f(a.s + (row + k) * St + col, sn);
                  });
    cluster.sync();
    // [phase] candidate
  }

  // Readout on concat(s_new, c). Each dense layer: this block's share of
  // its columns (maxout: whole groups of its window, their maxima), relu
  // applied; a layer but the last pushes its share into every block, the
  // last keeps its logits here (lg), and its f32 log_softmax meets across
  // the cluster as K2's does.
  const ReadoutT<T>& ro = a.ro;
  if (ro.relu_in) {
    for (int i = tid; i < K * XO; i += kThreads) xo[i] = fmaxf(xo[i], 0.f);
    __syncthreads();
  }
  const float* x = xo;
  int width = XO;
  for (int li = 0; li < ro.n; ++li) {
    const bool last = li + 1 == ro.n;
    float* y = last ? lg : li & 1 ? y1 : y0;
    const int out = ro.out[li], win = ro.win[li], ldw = out * win;
    const bool relu = ro.relu[li];
    const T* bias = ro.b[li];
    // Output j of this block's share: into lg, or into every block's y.
    const auto put = [&](int k, int jj, int col, float v) {
      if (last)
        y[k * a.lastw + jj] = v;
      else
        for (int p = 0; p < C; ++p) cluster.map_shared_rank(y, p)[k * out + col] = v;
    };
    if (ro.kind[li] == kLinear) {
      const Span oc(out, C, r, quad(out));
      slice_product(ro.w[li], ldw, width, x, width, K, Cols{oc.lo, oc.n, 0, 0}, scratch,
                    [&](int k, int jj, int col, float v) {
                      v = round_to<T>(round_to<T>(v) + ldg_f(bias + col));
                      put(k, jj, col, relu ? fmaxf(v, 0.f) : v);
                    });
    } else {
      const Span gr(out, C, r);
      const int n = gr.n * win;
      slice_product(ro.w[li], ldw, width, x, width, K, Cols{gr.lo * win, n, 0, 0}, scratch,
                    [&](int k, int jj, int col, float v) {
                      gl[k * n + jj] = round_to<T>(round_to<T>(v) + ldg_f(bias + col));
                    });
      for (int i = tid; i < K * gr.n; i += kThreads) {
        const int k = i / gr.n, g = i % gr.n;
        const float* grp = gl + k * n + g * win;
        float m = grp[0];
        for (int t = 1; t < win; ++t) m = fmaxf(m, grp[t]);
        put(k, g, gr.lo + g, relu ? fmaxf(m, 0.f) : m);
      }
    }
    if (last) break;
    cluster.sync();
    // [phase] readout layer
    x = y;
    width = out;
  }
  __syncthreads();

  // The f32 log_softmax, a warp per hypothesis: the block's max and
  // exp-sum over its outputs go to every block, and each block writes its
  // outputs of logp against the row's max and sum.
  const Span vs = ro.kind[ro.n - 1] == kLinear ? Span(a.V, C, r, quad(a.V)) : Span(a.V, C, r);
  const float* z = lg + warp * a.lastw;
  if (warp < K) {
    float m = -INFINITY;
    for (int j = lane; j < vs.n; j += 32) m = fmaxf(m, z[j]);
    m = warp_max(m);
    float t = 0.f;
    for (int j = lane; j < vs.n; j += 32) t += expf(z[j] - m);
    t = warp_sum(t);
    if (lane < C) {
      float* st = cluster.map_shared_rank(stat, lane) + (r * K + warp) * 2;
      st[0] = m;
      st[1] = t;
    }
  }
  cluster.sync();
  // [phase] last layer
  if (warp < K) {
    float m = -INFINITY;
    for (int p = 0; p < C; ++p) m = fmaxf(m, stat[(p * K + warp) * 2]);
    float t = 0.f;
    for (int p = 0; p < C; ++p) {
      const float* st = stat + (p * K + warp) * 2;
      if (st[1] > 0.f) t = fmaf(expf(st[0] - m), st[1], t);
    }
    const float lse = logf(t);
    float* o = a.logp + (row + warp) * a.V + vs.lo;
    for (int j = lane; j < vs.n; j += 32) o[j] = z[j] - m - lse;
  }
  // [phase] log_softmax
}

template <bool kLstm, bool kLoc>
cudaError_t step_loc_lstm_limits(int cluster, int* smem_limit, int* clusters) {
  const auto kernel = cluster_step_loc_lstm_kernel<kLstm, kLoc, float>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cluster_limits(kernel, cluster, smem_limit, clusters);
}

template <bool kLstm, bool kLoc, class T>
cudaError_t launch_step_loc_lstm(const Args8T<T>& a, int cluster, size_t bytes,
                                 cudaStream_t stream) {
  const auto kernel = cluster_step_loc_lstm_kernel<kLstm, kLoc, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return launch_cluster(kernel, dim3(a.B * a.G * cluster), cluster, bytes, stream, a);
}

// K8 on clusters of `cluster` blocks, a cluster a batch row and hypothesis
// group, each block sized for the largest group; the readout's n_layers
// layers (kinds, outs, wins; ro_w and ro_b their weights).
template <class T>
int step_loc_lstm_run(Args8T<T> a, int n_layers, const int* kinds, const int* outs,
                      const int* wins, const T* const* ro_w, const T* const* ro_b, int lstm,
                      int loc, int cluster, cudaStream_t stream) {
  if (a.B < 1 || a.K < 1 || a.L < 1 || n_layers < 1 || n_layers > kMaxLayers ||
      cluster < 1 || cluster > kMaxStepCluster || (loc && (a.FM < 1 || a.F < 1)))
    return (int)cudaErrorInvalidValue;
  // The dense layers, each relu folded into the layer before it.
  int width = a.St + a.A;
  for (int i = 0; i < n_layers; ++i) {
    if (kinds[i] == kRelu) {
      if (a.ro.n == 0)
        a.ro.relu_in = 1;
      else
        a.ro.relu[a.ro.n - 1] = 1;
      continue;
    }
    const int d = a.ro.n++, win = kinds[i] == kMaxout ? wins[i] : 1;
    if ((kinds[i] != kLinear && kinds[i] != kMaxout) || outs[i] < 1 || win < 1)
      return (int)cudaErrorInvalidValue;
    a.ro.kind[d] = kinds[i];
    a.ro.out[d] = width = outs[i];
    a.ro.win[d] = win;
    a.ro.w[d] = ro_w[i];
    a.ro.b[d] = ro_b[i];
  }
  if (a.ro.n == 0 || width != a.V) return (int)cudaErrorInvalidValue;
  const ReadoutDims d = readout_dims(a.ro, cluster);
  a.maxw = (int)d.maxw;
  a.maxpre = (int)d.maxpre;
  a.lastw = (int)d.lastw;
  a.G = hyp_groups(a.K);
  const size_t bytes = step_loc_lstm_smem_floats(cdiv(a.K, a.G), a.L, a.S, a.A, a.St, a.FM, a.F,
                                                 cluster, lstm ? 1 : 0, loc ? 1 : 0, d.maxw,
                                                 d.maxpre, d.cols, d.lastw) *
                       sizeof(float);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (lstm) {
    err = loc ? launch_step_loc_lstm<true, true>(a, cluster, bytes, stream)
              : launch_step_loc_lstm<true, false>(a, cluster, bytes, stream);
  } else {
    err = loc ? launch_step_loc_lstm<false, true>(a, cluster, bytes, stream)
              : launch_step_loc_lstm<false, false>(a, cluster, bytes, stream);
  }
  return (int)err;
}

}  // namespace

// Device limits of K8's cluster launch for the instance (lstm, loc): the
// opt-in shared memory of a block and how many clusters of `cluster`
// blocks (8, or 16: a non-portable size) can be resident at once. The
// plan in ops/cuda/attention_step.py takes C from them.
extern "C" int fused_attention_step_loc_lstm_limits(int lstm, int loc, int cluster,
                                                    int* smem_limit, int* clusters) {
  if (cluster < 1 || cluster > kMaxStepCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (lstm)
    err = loc ? step_loc_lstm_limits<true, true>(cluster, smem_limit, clusters)
              : step_loc_lstm_limits<true, false>(cluster, smem_limit, clusters);
  else
    err = loc ? step_loc_lstm_limits<false, true>(cluster, smem_limit, clusters)
              : step_loc_lstm_limits<false, false>(cluster, smem_limit, clusters);
  return (int)err;
}

// cw1, cw2, cw3: the GRU's w_zr and w_h (cw3 NULL), or the LSTM's w_h,
// w_x and gate bias. memprev (LSTM) and aprev, conv_w, conv_b, u
// (location term) are NULL where the instance has no use for them; so
// are ro_w[i] and ro_b[i] of a relu layer. `cluster`: C, the blocks of a
// batch row's cluster (the wrapper's plan).
extern "C" int fused_attention_step_loc_lstm(
    const float* vh, const float* h, const float* mask, const float* yin, const float* sprev,
    const float* ws_w, const float* ws_b, const float* w_e, const float* c_w, const float* c_b,
    const float* dec_w, const float* dec_b, const float* cw1, const float* cw2,
    const float* cw3, const float* memprev, const float* aprev, const float* conv_w, const float* conv_b,
    const float* u,
    float* alpha, float* c, float* s, float* mem, float* logp, int n_layers, const int* kinds,
    const int* outs, const int* wins, const float* const* ro_w, const float* const* ro_b,
    int lstm, int loc, int B, int K, int L, int S, int A, int St, int V, int FM, int F,
    int cluster, cudaStream_t stream) {
  // The reference's padding (Attention.lua:77-85): (f-1)/2 on the left
  // for an odd filter, f/2 for an even one; both equal f / 2.
  const Args8T<float> a{vh,      h,     mask,   yin,    sprev, ws_w,  ws_b, w_e, c_w, c_b,
                        dec_w,   dec_b, cw1,    cw2,    cw3,   memprev, aprev, conv_w, conv_b,
                        u,       alpha, c,      s,      mem,   logp,  B,    K,   L,   S,   A,
                        St,      V,     loc ? FM : 0,   loc ? F : 0,   loc ? F / 2 : 0, 0, 0, 0, 0, {}};
  return step_loc_lstm_run(a, n_layers, kinds, outs, wins, ro_w, ro_b, lstm, loc, cluster,
                           stream);
}

// K8's bf16 entry: fused_attention_step_loc_lstm with every array bf16 but
// logp, on fused_attention_step_loc_lstm_limits' plan (the same block and
// shared memory).
extern "C" int fused_attention_step_loc_lstm_bf16(
    const bf16* vh, const bf16* h, const bf16* mask, const bf16* yin, const bf16* sprev,
    const bf16* ws_w, const bf16* ws_b, const bf16* w_e, const bf16* c_w, const bf16* c_b,
    const bf16* dec_w, const bf16* dec_b, const bf16* cw1, const bf16* cw2, const bf16* cw3,
    const bf16* memprev, const bf16* aprev, const bf16* conv_w, const bf16* conv_b,
    const bf16* u, bf16* alpha, bf16* c, bf16* s, bf16* mem, float* logp, int n_layers,
    const int* kinds, const int* outs, const int* wins, const bf16* const* ro_w,
    const bf16* const* ro_b, int lstm, int loc, int B, int K, int L, int S, int A, int St, int V,
    int FM, int F, int cluster, cudaStream_t stream) {
  const Args8T<bf16> a{vh,      h,     mask,   yin,    sprev, ws_w,  ws_b, w_e, c_w, c_b,
                       dec_w,   dec_b, cw1,    cw2,    cw3,   memprev, aprev, conv_w, conv_b,
                       u,       alpha, c,      s,      mem,   logp,  B,    K,   L,   S,   A,
                       St,      V,     loc ? FM : 0,   loc ? F : 0,   loc ? F / 2 : 0, 0, 0, 0, 0, {}};
  return step_loc_lstm_run(a, n_layers, kinds, outs, wins, ro_w, ro_b, lstm, loc, cluster,
                           stream);
}
