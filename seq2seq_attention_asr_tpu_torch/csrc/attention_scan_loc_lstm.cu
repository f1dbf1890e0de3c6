// Teacher-forced attention decoder scans, each a forward and a backward
// kernel:
//
//   <LSTM, location>  K10 loc_lstm_fwd_kernel<R>, K11 loc_lstm_bwd_kernel<R>;
//                     entry points attention_decode_scan_loc_lstm_{fwd,bwd}
//   <GRU, location>   K12 loc_gru_fwd_kernel<R>, K13 scan_loc_gru_bwd_kernel;
//                     entry points attention_decode_scan_loc_{fwd,bwd}
//   <LSTM, content>   K14 scan_lstm_fwd_kernel<R>, K15 scan_lstm_bwd_kernel<R>;
//                     entry points attention_decode_scan_lstm_{fwd,bwd}
//   <GRU, content>    K4 content_gru_fwd_kernel<R>, K5 content_gru_walk_kernel<R>;
//                     entry points attention_decode_scan_{fwd,bwd}; K4's bf16
//                     entry attention_decode_scan_fwd_bf16 (gru_fwd_prepass_bf16_kernel,
//                     content_gru_fwd_bf16_kernel<R>: decoder_fwd_walk says where
//                     it rounds)
//
// The four forwards share a pre-pass (fwd_prepass<kLstm, kStage>) and a
// forward walk on a thread-block cluster (decoder_fwd_walk<R, kLstm,
// kLoc>); K11, K15 and K5 share a pre-pass and a backward walk on one
// (decoder_walk<R, kLstm, kLoc>); K13 has a one-block body of its own
// (scan_bwd). Each instance's kernels are thin __global__ functions of
// their own, so that a profiler trace names which instance ran.
//
// They replace the Pallas kernels of
// seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py, whose forwards
// share pallas_call :355 (_run_fwd :290) and whose backwards are
// pallas_call :945 (_run_bwd_loc :891) for the location-aware ones and
// :851 (_run_bwd :800) for the content-only ones:
//   K10/K11  attention_decode_scan_loc_lstm :1292, _fwd_kernel_loc_lstm
//            :254, _bwd_kernel_loc_lstm :624;
//   K12/K13  attention_decode_scan_loc :984, _fwd_kernel_loc :219,
//            _bwd_kernel_loc :710;
//   K14/K15  attention_decode_scan_lstm :1226, _fwd_kernel_lstm :189,
//            _bwd_kernel_lstm :577;
//   K4/K5    attention_decode_scan :1156, _fwd_kernel :165, _bwd_kernel :376;
// with _location_term :62, _step_core :91 and _bwd_core :419. Plain
// PyTorch twins: ops/cuda/attention_scan.py attention_decode_scan_{loc_lstm,
// loc,lstm}_plain and their _bwd_plain, and attention_decode_scan_plain
// and attention_decode_scan_bwd_plain.
//
// The forwards (K10, K12, K14, K4) run in two stages (launch_fwd_walk
// below):
//   1. a pre-pass off the chain (lstm_fwd_prepass_kernel<0, 1> or
//      gru_fwd_prepass_kernel<0, 1>: tiled products, cluster_walk.cuh
//      tile_product). Teacher forcing gives every step's yin in advance,
//      and the decoder input r = [c @ c_w + c_b | yin] @ dec_w + dec_b is
//      linear in c, so each gate's input part r @ W_x is
//        P[n] + c @ W_cx,
//        P    = ([c_b | yin] @ dec_w + dec_b) @ W_x (+ b)   (B*T, G St)
//        W_cx = c_w @ dec_w[:St] @ W_x                      (A, G St)
//      with the LSTM's W_x = w_x (G = 4 gates: i, f, g, o) or the GRU's
//      W_x = [w_zr[St:] | w_h[St:]] (G = 3: the update and reset gates
//      and the candidate), which takes c_w, dec_w and W_x off the chain
//      (the products are reassociated: the rounding differs from the
//      plain version's by about 1e-7 of a gate). Stage 0 forms [c_b |
//      yin] @ dec_w + dec_b and c_w @ dec_w[:St], and the s_prev
//      products' weights transposed; stage 1 multiplies them by W_x;
//   2. the walk on thread-block clusters of C blocks (16 or 8), each
//      cluster taking R batch rows (plan: ops/cuda/attention_scan.py
//      fwd_plan). Block k owns state units [k St / C, (k+1) St / C) with
//      their G gate columns of the s_prev products and of W_cx and their
//      rows of ws_w, annotation columns [k A / C, ...) of the output c,
//      and encoder positions [k L / C, ...). A step:
//        ws = ws_b + the blocks' partials s_prev[own] @ ws_w[own, :]  [E1]
//        the energies on its positions (with the location term, the
//        features from alpha_prev over the filter's window); their
//        local max m_k, sum and context partial sum_l exp(e_l - m_k) h_l,
//        pushed with (location term) the energies in a peer's window  [E2]
//        while E2 flies: s_prev @ w_h + P on the LSTM's gate columns of
//        its units, or s_prev @ w_zr[:St] + P on the GRU's update and
//        reset columns; then M = max m_k, z = sum_k exp(m_k - M) sum_k,
//        c and alpha on its positions (and window) in rank order, the
//        masked softmax of ops/masking.py (NEG_INF on padding, exp times
//        the mask, z clamped at 1e-30: a row with every position masked
//        gets alpha = 0 and c = 0; an empty or all-masked block adds
//        nothing); + c @ W_cx on every gate column of its units;
//        the LSTM: the cell on its units (mem never leaves the block);
//        the GRU: the update gate z and the reset gate rg on its units,
//        rg s_prev pushed                                             [E3]
//        (the candidate's product reads every unit of it), then the
//        candidate tanh(P + c @ W_cx + (rg s_prev) @ w_h[:St]) and s =
//        (1 - z) s_prev + z cand on its units;
//        s (and mem), its columns of c and alpha written out;
//        s[own] and its partial s[own] @ ws_w[own, :] pushed          [E1]
//      At each [E] the block copies what it formed into every peer's
//      shared memory (a bulk copy of a row's share where St is a
//      multiple of 4, else st.async a value; always bulk for the S- and
//      A-long partials, whose slots are whole 16-byte groups), counted on
//      the peer's mbarrier, and waits on its own. Two exchanges a step
//      for the LSTM, three for the GRU, whose reset gate acts on s_prev
//      before the candidate's product (a gather of St / C floats a block,
//      where partial products would move St); sums over blocks in rank
//      order, no atomics: two calls give the same bits. The W_cx slice
//      stays in shared memory where the plan's block holds it
//      ("resident"), else the products stream their rows from L2 (the
//      s_prev products' weights transposed and W_cx^T, made in the
//      pre-pass in unit order: a block's gate columns are one run of
//      rows). Nothing in a block's shared memory grows with L beyond
//      ceil(L / C) positions and the filter's window. What bounds a step:
//      the exchanges' round trips and the products on the chain after the
//      softmax, c @ W_cx (and the GRU's candidate product after E3).
//
// K13 walks t = T-1..0 in one block per row. It recomputes the step from
// s_prev and alpha_prev, the saved sequences shifted by one and zero at
// step 0, and the saved c, and takes alpha itself from the saved alpha
// sequence, so it runs no softmax; then it backprops the GRU cell
// (gru_cell_bwd), the decoder-input MLP, the context, the masked softmax,
// the energies and the location term, whose input alpha_prev is the
// previous step's output: that cotangent is carried
// into step t-1. ds is carried in shared memory. dvh and dh are summed
// over the steps in global memory, each row's slice by its own block.
// The weight gradients of the step's products are sums of outer products
// over the B*T steps: the walk writes each step's operands and cotangents
// to a stash, and reduce_atb.cuh forms the products and the bias sums
// afterwards, deterministically, in one launch. The location term's
// weight gradients, dU, dwconv and dbconv, are sums over the B*T*L (step,
// encoder position) pairs; as the TPU kernel does (_bwd_kernel_loc
// :779-791), each block sums its own row's T*L pairs in the walk: dU in
// the energies pass by the thread that forms dz(l, sc), in registers over
// the step's L positions, where FM is at most kLocQ and a multiple of 4,
// else in a pass of its own; dwconv and dbconv from the step's dfeat. A
// second reduce_atb.cuh launch sums the B rows' partials in a fixed
// order. What bounds K13's walk: about half of a step is the recompute
// and the cell's transposed products, which read the step's weights from
// L2; most of the rest is the energies and dfeat passes.
//
// K11, K15 and K5 run in three stages (launch_walk_bwd below):
//   1. a recompute pre-pass off the chain (lstm_decoder_prepass_kernel,
//      gru_decoder_prepass_kernel): every step's s_prev, c and alpha_prev
//      are saved sequences, so ws, cc, r = [cc | yin] @ dec_w + dec_b and
//      the cell's inputs of all B*T (row, step) pairs come from tiled
//      products (cluster_walk.cuh tile_product): the LSTM's gate
//      pre-activations s_prev @ w_h + r @ w_x + b; the GRU's gates
//      zr = sigmoid([s_prev | r] @ w_zr), then its candidate
//      tanh([rg s_prev | r] @ w_h), a stage each (the candidate reads the
//      reset gate). ws and the cell's values go into the stash rows that
//      the walk overwrites with their cotangents;
//   2. the walk on thread-block clusters of C blocks (16 or 8), each
//      cluster taking R batch rows (plan: ops/cuda/attention_scan.py
//      scan_plan). Block k owns state units [k St / C, (k+1) St / C),
//      annotation columns [k A / C, ...) and encoder positions
//      [k L / C, ...). A step's chain is, for the LSTM,
//        dg (the LSTM cell's backward, elementwise on its units)   [E1]
//        dsp = dg w_h^T, dr = dg w_x^T on its units' rows          [E2]
//      and for the GRU (reset gate before the candidate product),
//        da_cand = ds z (1 - cand^2) on its units                  [E1]
//        dcin = da_cand w_h^T on its units' rows; da_zr on its units:
//        the update gate's from ds (cand - s_prev), the reset gate's
//        from dcin[:St] s_prev                                      [E2]
//        dsr = da_zr w_zr^T on its units' rows; dsp = dsr[:St] +
//        dcin[:St] rg + ds (1 - z), dr = dcin[St:] + dsr[St:]       [E3]
//      then, for both cells,
//        dcc | dyin = dr dec_w^T on its units' rows                 [E]
//        dc = dcc c_w^T + dc_seq on its columns' rows              [E]
//        dalpha, de (the softmax), dh, the energies (dvh, dz), the
//        location term (feat, dfeat) on its positions               [E]
//        dws = the cluster's sum of the blocks' partials, then
//        ds_prev = dsp + dws ws_w^T on its units' rows;
//      at each [E] the block copies what it formed into every peer's
//      shared memory, counted on the peer's mbarrier, and waits on its
//      own for the peers' bytes (cluster_walk.cuh; no cluster barrier,
//      whose release is a GPU-wide fence): a bulk copy (cp.async.bulk)
//      of each row's share where St and A are multiples of 4, so that
//      the shares are whole 16-byte groups, else st.async of each
//      value. The dc exchange also carries each block's share of the
//      softmax's sum sum_l alpha dalpha = c . dc + sum_l alpha
//      (dalpha_seq + carry), c being the saved context; the last the
//      blocks' S-long dws partials and the dfeat rows within F - 1
//      positions of a peer's, whose alpha_prev cotangent reads them.
//      Sums over blocks are in rank order, no atomics: two calls give
//      the same bits. The location term's dU, dwconv and dbconv and dw_e
//      are summed over the block's rows, positions and steps in its
//      shared memory and written once, a row of partials per block;
//   3. reduce_atb.cuh over the B*T stash rows, then over the partials.
// Nothing in a block's shared memory grows with L beyond ceil(L / C)
// positions and the dfeat halo. What bounds a step: the chain's
// transposed products read 1/C of the step's weights from L2 (about 7 MB
// for the LSTM, w_h and w_x 73% of it; about 3 MB for the flagship's
// GRU), and each exchange costs a round trip through distributed shared
// memory: five a step for the LSTM, six for the GRU, whose reset gate's
// cotangent needs w_h^T's output before w_zr^T can start.
//
// The source builds four libraries (ops/cuda/attention_scan.py), so that
// nvcc compiles the walks' instances in processes of their own, side by
// side: K10's and K14's with LSTM_FWD_ONLY defined, K12's and K4's with
// GRU_FWD_ONLY, K5's alone with CONTENT_GRU_BWD_ONLY, and K11's, K13's and
// K15's.

#include "attention_common.cuh"
#include "cluster_walk.cuh"
#include "reduce_atb.cuh"

#if defined(LSTM_FWD_ONLY) || defined(GRU_FWD_ONLY)
#define FWD_WALK_BUILD  // one of the forward walk's two libraries
#endif

namespace {

// The cell's weights are the GRU's w_zr (2St, 2St) and w_h (2St, St), or
// the LSTM's w_h, w_x (St, 4St) and b (4St); the location term's are null
// without it. T is their IO type: float, or bf16 for K4's bf16 entry.
template <class T>
struct WeightsT {
  const T *ws_w, *ws_b, *w_e, *c_w, *c_b, *dec_w, *dec_b;
  const T *w_zr, *w_h, *w_x, *b;
  const T *wconv, *bconv, *u;
  __host__ __device__ StepWeights step() const {
    return StepWeights{ws_w, ws_b, c_w, c_b, dec_w, dec_b, w_zr, w_h};
  }
};
using Weights = WeightsT<float>;

struct Dims {
  int B, T, L, S, A, St, FM, F;  // FM = F = 0 without the location term
};

// Hands out consecutive buffers; with a null base it only counts, which
// is how the host sizes the launch.
struct Carver {
  float* base;
  size_t off;
  __host__ __device__ float* take(size_t n) {
    float* p = base ? base + off : nullptr;
    off += n;
    return p;
  }
};

// Feature maps whose location-term sums one thread keeps in registers.
constexpr int kLocQ = 16;

// The location term's constants and buffers (kLoc only).
struct LocShared {
  float *ap, *u, *cw, *cb;  // alpha_prev zero-padded [L+F-1]; U [FM][S]; taps [F][FM]; bias [FM]
};

template <bool kLoc>
__host__ __device__ LocShared carve_loc(Carver& c, const Dims& d) {
  LocShared s{};
  if (kLoc) {
    s.ap = c.take(d.L + d.F - 1);
    s.u = c.take((size_t)d.FM * d.S);
    s.cw = c.take((size_t)d.F * d.FM);
    s.cb = c.take(d.FM);
  }
  return s;
}

// The buffers of one step of K13's GRU.
__host__ __device__ StepBufs carve_step(Carver& c, const Dims& d) {
  const int St = d.St;
  StepBufs m{};
  m.sp = c.take(St);
  m.ws = c.take(d.S);
  m.al = c.take(d.L);
  m.rin = c.take(2 * St);
  m.sr = c.take(2 * St);
  m.xo = c.take(St + d.A);
  m.we = c.take(d.S);
  m.msk = c.take(d.L);
  m.zr = c.take(2 * St);
  m.rhr = c.take(2 * St);
  m.cand = c.take(St);
  return m;
}

template <bool kLoc>
__device__ void load_constants(const Weights& w, const float* mask, const StepBufs& m,
                               const LocShared& loc, const Dims& d, int b) {
  for (int i = threadIdx.x; i < d.S; i += kThreads) m.we[i] = w.w_e[i];
  for (int i = threadIdx.x; i < d.L; i += kThreads) m.msk[i] = mask[(size_t)b * d.L + i];
  if (kLoc) {
    for (int i = threadIdx.x; i < d.L + d.F - 1; i += kThreads) loc.ap[i] = 0.f;
    for (int i = threadIdx.x; i < d.FM * d.S; i += kThreads) loc.u[i] = w.u[i];
    for (int i = threadIdx.x; i < d.F * d.FM; i += kThreads) loc.cw[i] = w.wconv[i];
    for (int i = threadIdx.x; i < d.FM; i += kThreads) loc.cb[i] = w.bconv[i];
  }
}

// ---------------------------------------------------------------------------
// K11, K13, K15: the backward.

// Per-step operands and cotangents the weight-gradient reductions read,
// carved from the caller's scratch in this order: (B*T) rows of rr (2St);
// for the LSTM r (St); for the GRU sr and cand_in (2St each); then dws
// (S; for the walks the pre-pass's ws until the walk writes dws over it),
// dcc (St), dr (St); for the LSTM dgates (4St; the pre-pass's gate
// pre-activations until the walk writes dgates over them), for the GRU
// da_zr (2St) and da_cand (St) (for K5 the pre-pass's gates and
// candidate until the walk writes their cotangents over them), and for
// K13 the step's w_e partial (S); then, with the location term, B rows
// of the step's dz (L*S, rewritten every step). Then the partial sums:
// for K13, per batch row, of dU (FM*S) and of dwconv and dbconv ((F + 1)
// * FM); for the walks (K11, K15, K5), per block of the walk (`partials`
// rows), of dw_e (S) and, with the location term, of dU and of dwconv
// and dbconv.
struct Stash {
  float *rr, *r, *sr, *cand_in, *dws, *dcc, *dr, *dg, *da_zr, *da_cand, *dwe;
  float *dz, *pwe, *pu, *pconv;
};

template <bool kLstm, bool kLoc>
Stash carve_stash(float* p, const Dims& d, int partials) {
  const size_t rows = (size_t)d.B * d.T, St = d.St, S = d.S;
  const bool walk = kLstm || !kLoc;  // every instance but K13 runs the cluster walk
  Carver c{p, 0};
  Stash s{};
  s.rr = c.take(rows * 2 * St);
  if (kLstm) {
    s.r = c.take(rows * St);
  } else {
    s.sr = c.take(rows * 2 * St);
    s.cand_in = c.take(rows * 2 * St);
  }
  s.dws = c.take(rows * S);
  s.dcc = c.take(rows * St);
  s.dr = c.take(rows * St);
  if (kLstm) {
    s.dg = c.take(rows * 4 * St);
  } else {
    s.da_zr = c.take(rows * 2 * St);
    s.da_cand = c.take(rows * St);
  }
  if (!walk) s.dwe = c.take(rows * S);
  if (kLoc) s.dz = c.take((size_t)d.B * d.L * S);
  const size_t n = walk ? (size_t)partials : (size_t)d.B;
  if (walk) s.pwe = c.take(n * S);
  if (kLoc) {
    s.pu = c.take(n * d.FM * S);
    s.pconv = c.take(n * (d.F + 1) * d.FM);
  }
  return s;
}

struct BwdArgs {
  const float *vh, *h, *mask, *yin;
  Weights w;
  const float *s_seq, *c_seq, *alpha_seq, *mem_seq;       // mem_seq: LSTM only
  const float *ds_seq, *dc_seq, *dalpha_seq, *dmem_seq;  // each may be null: zeros
  float *dvh, *dh, *dyin;
  Stash st;
  Dims d;
};

// p[i], or 0 where the cotangent p is absent.
__device__ __forceinline__ float cot(const float* p, size_t i) { return p ? p[i] : 0.f; }

// Positions (the context's dh and the energies pass) and score units (the
// dfeat pass) whose global loads a thread issues together, ahead of the
// arithmetic that uses them.
constexpr int kLocRows = 4, kLocCols = 8;

// One stage of warp_sum16: v[0..2W) becomes v[0..W), the half that the
// lane's bit W << 1 selects plus the partner lane's copy of that half.
// W is a constant, so v stays in registers.
template <int W>
__device__ __forceinline__ void fold_half(float (&v)[kLocQ], int lane) {
  const bool up = lane & (2 * W);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float keep = up ? v[k + W] : v[k], give = up ? v[k] : v[k + W];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, give, 2 * W);
  }
}

// Each of v[0..kLocQ) summed over the warp, in 16 shuffles: the lane
// gets the sum of v[lane >> 1].
__device__ __forceinline__ float warp_sum16(float (&v)[kLocQ], int lane) {
  static_assert(kLocQ == 16, "four halving stages over lane bits 4..1");
  fold_half<8>(v, lane);
  fold_half<4>(v, lane);
  fold_half<2>(v, lane);
  fold_half<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// dfeat[q] = sum_sc dz[sc] U[q][sc] for one encoder position, by one warp:
// its lanes along sc (the reads of dz coalesced, kLocCols of them issued
// together; those of U, in shared memory, conflict-free), kLocQ maps at a
// time; lane 2q' writes map q0 + q'.
__device__ __forceinline__ void dfeat_of(const float* dz, const float* u, int S, int FM,
                                         float* dfeat, int lane) {
  for (int q0 = 0; q0 < FM; q0 += kLocQ) {
    float acc[kLocQ] = {};
    for (int sc0 = lane; sc0 < S; sc0 += 32 * kLocCols) {
      float z[kLocCols];
#pragma unroll
      for (int g = 0; g < kLocCols; ++g) z[g] = sc0 + 32 * g < S ? dz[sc0 + 32 * g] : 0.f;
#pragma unroll
      for (int g = 0; g < kLocCols; ++g) {
        const int sc = sc0 + 32 * g;
        if (sc >= S) break;
#pragma unroll
        for (int k = 0; k < kLocQ; ++k)
          if (q0 + k < FM) acc[k] = fmaf(z[g], u[(q0 + k) * S + sc], acc[k]);
      }
    }
    const float v = warp_sum16(acc, lane);
    const int q = q0 + (lane >> 1);
    if (!(lane & 1) && q < FM) dfeat[q] = v;
  }
}

// ---------------------------------------------------------------------------
// K13: the location-aware GRU decoder's backward, one block per batch row.

struct BwdShared {
  StepBufs m;  // sp, ws, al (alpha), rin (cc | yin), sr (s_prev | r), xo (c at [St:]), we, msk,
               // zr, rhr, cand
  LocShared loc;
  GruGrads g;
  float *dsp, *dr;              // [St]   the cell's part of ds_prev; dr
  float *drr, *tmp;             // [2St]  dr @ dec_w^T; [St] dws @ ws_w^T
  float *carry_s;               // [St]   ds carried to the previous step
  float *dc;                    // [A]
  float *dal, *de;              // [L]
  float *dws;                   // [S]
  float *feat, *dfeat;          // [L][FM]
  float *dal_carry;             // [L]    the cotangent of this step's alpha from step t+1
  float *red;                   // [kWarps]
};

__host__ __device__ BwdShared carve_bwd(float* sm, const Dims& d, size_t* floats) {
  Carver c{sm, 0};
  const int St = d.St;
  BwdShared s{};
  // feat first, 16-byte aligned: with FM a multiple of 4 the energies
  // pass reads a position's maps as float4s.
  s.feat = c.take((size_t)d.L * d.FM);
  s.m = carve_step(c, d);
  s.g.ds = c.take(St);
  s.g.da_cand = c.take(St);
  s.g.dcin = c.take(2 * St);
  s.g.da_zr = c.take(2 * St);
  s.g.dsr = c.take(2 * St);
  s.dsp = c.take(St);
  s.dr = c.take(St);
  s.drr = c.take(2 * St);
  s.tmp = c.take(St);
  s.carry_s = c.take(St);
  s.dc = c.take(d.A);
  s.dal = c.take(d.L);
  s.de = c.take(d.L);
  s.dws = c.take(d.S);
  s.loc = carve_loc<true>(c, d);
  s.dfeat = c.take((size_t)d.L * d.FM);
  s.dal_carry = c.take(d.L);
  s.red = c.take(kWarps);
  s.m.scratch = c.take(kThreads * 4);
  *floats = c.off;
  return s;
}

// Where the walk sums dU, from the shapes alone: with FM <= kLocQ and a
// multiple of 4, in the energies pass, in the registers of the thread
// that forms dz(l, sc) over the step's L positions; else in a pass of
// its own, kLocQ maps at a time; either way into the row's partial, read
// and written once a step.
__device__ __forceinline__ bool du_inline(const Dims& d) {
  return d.FM <= kLocQ && d.FM % 4 == 0;
}

__device__ __forceinline__ void scan_bwd(float* sm, const BwdArgs& a) {
  const Dims& d = a.d;
  const int b = blockIdx.x, St = d.St, St2 = 2 * St, A = d.A, L = d.L, S = d.S;
  const int FM = d.FM, F = d.F, pad = F / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  size_t floats;
  const BwdShared s = carve_bwd(sm, d, &floats);
  const StepBufs& m = s.m;
  const StepWeights w = a.w.step();
  const float* vhb = a.vh + (size_t)b * L * S;
  const float* hb = a.h + (size_t)b * L * A;
  float* dvhb = a.dvh + (size_t)b * L * S;
  float* dhb = a.dh + (size_t)b * L * A;

  load_constants<true>(a.w, a.mask, m, s.loc, d, b);
  for (int j = tid; j < St; j += kThreads) s.carry_s[j] = 0.f;
  // The location term's weight gradients over this row's pairs, in the
  // row's partials pu (dU) and pconv (dwconv, dbconv).
  const bool du_in = du_inline(d);
  const int n_conv = (F + 1) * FM;
  float* dzb = a.st.dz + (size_t)b * L * S;
  float* pub = a.st.pu + (size_t)b * FM * S;
  float* pcb = a.st.pconv + (size_t)b * n_conv;
  for (int l = tid; l < L; l += kThreads) s.dal_carry[l] = 0.f;
  for (int t = d.T - 1; t >= 0; --t) {
    const size_t n = (size_t)b * d.T + t;
    const bool last = t == d.T - 1;  // the first step of the walk writes dvh and dh
    // The step's saved state: s_prev and alpha_prev (zero at step 0), c
    // and alpha.
    for (int j = tid; j < St; j += kThreads) {
      const float v = t > 0 ? a.s_seq[(n - 1) * St + j] : 0.f;
      m.sp[j] = m.sr[j] = v;
      m.rin[St + j] = a.yin[n * St + j];
    }
    for (int j = tid; j < A; j += kThreads) m.xo[St + j] = a.c_seq[n * A + j];
    for (int l = tid; l < L; l += kThreads) {
      m.al[l] = a.alpha_seq[n * L + l];
      s.loc.ap[pad + l] = t > 0 ? a.alpha_seq[(n - 1) * L + l] : 0.f;
    }
    __syncthreads();
    // [phase] load
    // Recompute ws, r and the cell (the GRU's gates, candidate and rhr);
    // and the location features, as the forward forms them.
    matvec<kNone>(w.ws_w, w.ws_b, St, S, m.sp, St, m.ws, S, 1, m.scratch);
    decoder_cell(w, m, 1, A, St);
    // [phase] recompute
    for (int i = tid; i < L * FM; i += kThreads) {
      const int l = i / FM, q = i % FM;
      float f = 0.f;
      for (int j = 0; j < F; ++j) f = fmaf(s.loc.ap[l + j], s.loc.cw[j * FM + q], f);
      s.feat[i] = f + s.loc.cb[q];
    }
    gru_cell_bwd(a.w.w_zr, a.w.w_h, m, a.ds_seq ? a.ds_seq + n * St : nullptr, s.carry_s, s.g,
                 s.dsp, s.dr, St);
    // [phase] cell
    // The decoder-input MLP.
    matvec_t<1>(w.dec_w, St2, St, s.dr, 0, s.drr, 0);
    __syncthreads();
    // [phase] dec_w^T
    for (int j = tid; j < St; j += kThreads) a.dyin[n * St + j] = s.drr[St + j];
    matvec_t<1>(w.c_w, A, St, s.drr, 0, s.dc, 0);
    __syncthreads();
    for (int j = tid; j < A; j += kThreads) s.dc[j] += cot(a.dc_seq, n * A + j);
    __syncthreads();
    // [phase] c_w^T

    // The context: dalpha = h dc + dalpha_seq + the carry from step t+1,
    // dh += alpha dc^T.
    for (int l = warp; l < L; l += kWarps) {
      const float* hr = hb + (size_t)l * A;
      float acc = 0.f;
      for (int j = lane; j < A; j += 32) acc = fmaf(s.dc[j], hr[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) s.dal[l] = acc + cot(a.dalpha_seq, n * L + l) + s.dal_carry[l];
    }
    // dh, the loads of kLocRows positions issued together.
    for (int j = tid; j < A; j += kThreads) {
      const float dcj = s.dc[j];
      for (int l0 = 0; l0 < L; l0 += kLocRows) {
        float o[kLocRows];
#pragma unroll
        for (int r = 0; r < kLocRows; ++r)
          o[r] = l0 + r < L && !last ? dhb[(size_t)(l0 + r) * A + j] : 0.f;
#pragma unroll
        for (int r = 0; r < kLocRows; ++r) {
          const int l = l0 + r;
          if (l >= L) break;
          const float v = m.al[l] * dcj;
          dhb[(size_t)l * A + j] = last ? v : o[r] + v;
        }
      }
    }
    __syncthreads();
    // [phase] context
    // The masked softmax.
    float part = 0.f;
    for (int l = tid; l < L; l += kThreads) part += s.dal[l] * m.al[l];
    const float dot = block_sum(part, s.red);
    for (int l = tid; l < L; l += kThreads) s.de[l] = m.al[l] * (s.dal[l] - dot);
    __syncthreads();
    // [phase] softmax
    // The energies: dz = de w_e (1 - tanh(z)^2), a thread per score unit,
    // z recomputed as the forward forms it, the loads of kLocRows
    // positions issued together. The step's dz also goes to the row's
    // scratch, and dU += feat^T dz.
    for (int sc = tid; sc < S; sc += kThreads) {
      const float wsv = m.ws[sc], wev = m.we[sc];
      float ur[kLocQ], du[kLocQ];  // U[:, sc] and dU[:, sc], where dU is summed here
      if (du_in)
#pragma unroll
        for (int q = 0; q < kLocQ; ++q) {
          ur[q] = q < FM ? s.loc.u[q * S + sc] : 0.f;
          du[q] = q < FM && !last ? pub[(size_t)q * S + sc] : 0.f;
        }
      float gws = 0.f, gwe = 0.f;
      for (int l0 = 0; l0 < L; l0 += kLocRows) {
        float vv[kLocRows], dv[kLocRows];
#pragma unroll
        for (int r = 0; r < kLocRows; ++r) {
          const size_t i = (size_t)(l0 + r) * S + sc;
          vv[r] = l0 + r < L ? vhb[i] : 0.f;
          dv[r] = l0 + r < L && !last ? dvhb[i] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kLocRows; ++r) {
          const int l = l0 + r;
          if (l >= L) break;
          float z = vv[r] + wsv;
          const float4* f4 = reinterpret_cast<const float4*>(s.feat + l * FM);
          float uf = 0.f;
          if (du_in) {
#pragma unroll
            for (int q = 0; q < kLocQ; q += 4) {
              if (q >= FM) break;
              const float4 f = f4[q / 4];
              uf = fmaf(f.x, ur[q], uf);
              uf = fmaf(f.y, ur[q + 1], uf);
              uf = fmaf(f.z, ur[q + 2], uf);
              uf = fmaf(f.w, ur[q + 3], uf);
            }
          } else {
            for (int q = 0; q < FM; ++q) uf = fmaf(s.feat[l * FM + q], s.loc.u[q * S + sc], uf);
          }
          z += uf;
          const float av = fast_tanh(z);
          const float dz = s.de[l] * wev * (1.f - av * av);
          const size_t i = (size_t)l * S + sc;
          dvhb[i] = last ? dz : dv[r] + dz;
          dzb[i] = dz;
          if (du_in)
#pragma unroll
            for (int q = 0; q < kLocQ; q += 4) {
              if (q >= FM) break;
              const float4 f = f4[q / 4];
              du[q] = fmaf(f.x, dz, du[q]);
              du[q + 1] = fmaf(f.y, dz, du[q + 1]);
              du[q + 2] = fmaf(f.z, dz, du[q + 2]);
              du[q + 3] = fmaf(f.w, dz, du[q + 3]);
            }
          gws += dz;
          gwe = fmaf(av, s.de[l], gwe);
        }
      }
      s.dws[sc] = gws;
      a.st.dwe[n * S + sc] = gwe;
      if (du_in) {
#pragma unroll
        for (int q = 0; q < kLocQ; ++q)
          if (q < FM) pub[(size_t)q * S + sc] = du[q];
      } else {
        // dU[:, sc], kLocQ maps at a time, from the dz this thread has
        // just written.
        for (int q0 = 0; q0 < FM; q0 += kLocQ) {
          float acc[kLocQ];
#pragma unroll
          for (int k = 0; k < kLocQ; ++k)
            acc[k] = last || q0 + k >= FM ? 0.f : pub[(size_t)(q0 + k) * S + sc];
          for (int l = 0; l < L; ++l) {
            const float z = dzb[(size_t)l * S + sc];
#pragma unroll
            for (int k = 0; k < kLocQ; ++k)
              if (q0 + k < FM) acc[k] = fmaf(s.feat[l * FM + q0 + k], z, acc[k]);
          }
#pragma unroll
          for (int k = 0; k < kLocQ; ++k)
            if (q0 + k < FM) pub[(size_t)(q0 + k) * S + sc] = acc[k];
        }
      }
    }
    __syncthreads();
    // [phase] energies
    // dfeat = dz @ U^T: a warp per position.
    for (int l = warp; l < L; l += kWarps) dfeat_of(dzb + (size_t)l * S, s.loc.u, S, FM,
                                                    s.dfeat + l * FM, lane);
    __syncthreads();
    // [phase] dfeat
    // The cotangent of alpha_prev, for step t-1: alpha_prev[k] enters
    // feat[l] through tap j = k + pad - l. A warp per k, its lanes along
    // the taps' (j, q): the rows of dfeat it reads are adjacent.
    for (int k = warp; k < L; k += kWarps) {
      float acc = 0.f;
      for (int i = lane; i < F * FM; i += 32) {
        const int j = i / FM, l = k + pad - j;
        if (l >= 0 && l < L) acc = fmaf(s.dfeat[l * FM + i - j * FM], s.loc.cw[i], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) s.dal_carry[k] = acc;
    }
    // dwconv[j][q] += sum_l ap[l + j] dfeat[l][q] and dbconv[q] +=
    // sum_l dfeat[l][q]: a thread per entry.
    for (int i = tid; i < n_conv; i += kThreads) {
      float v = 0.f;
      if (i < F * FM) {
        const int j = i / FM, q = i - j * FM;
        for (int l = 0; l < L; ++l) v = fmaf(s.loc.ap[l + j], s.dfeat[l * FM + q], v);
      } else {
        for (int l = 0; l < L; ++l) v += s.dfeat[l * FM + i - F * FM];
      }
      pcb[i] = last ? v : pcb[i] + v;
    }
    matvec_t<1>(w.ws_w, St, S, s.dws, 0, s.tmp, 0);
    __syncthreads();
    // [phase] carry, conv, ws_w^T
    for (int j = tid; j < St; j += kThreads) {
      s.carry_s[j] = s.dsp[j] + s.tmp[j];
      a.st.dcc[n * St + j] = s.drr[j];
      a.st.dr[n * St + j] = s.dr[j];
      a.st.da_cand[n * St + j] = s.g.da_cand[j];
    }
    for (int j = tid; j < St2; j += kThreads) {
      a.st.rr[n * St2 + j] = m.rin[j];
      a.st.sr[n * St2 + j] = m.sr[j];
      a.st.cand_in[n * St2 + j] = m.rhr[j];
      a.st.da_zr[n * St2 + j] = s.g.da_zr[j];
    }
    for (int sc = tid; sc < S; sc += kThreads) a.st.dws[n * S + sc] = s.dws[sc];
    __syncthreads();
    // [phase] stash
  }
}

#if !defined(CONTENT_GRU_BWD_ONLY) && !defined(FWD_WALK_BUILD)
__global__ void __launch_bounds__(kThreads, 1) scan_loc_gru_bwd_kernel(const BwdArgs a) {
  extern __shared__ float sm[];
  scan_bwd(sm, a);
}
#endif

// ---------------------------------------------------------------------------
// K11, K15, K5: the decoder backwards on thread-block clusters.

constexpr int kMaxWalkCluster = 16;  // a non-portable cluster size on Hopper
// The exchanges of a step, an mbarrier each: the LSTM's five, the GRU's six.
constexpr int kBarsLstm = 5, kBarsGru = 6;
template <bool kLstm>
constexpr int kBars = kLstm ? kBarsLstm : kBarsGru;
// The cell's gate columns a unit: the LSTM's 4 (i, f, g, o), the GRU's 3
// (update, reset, candidate). The backward walk gathers their cotangents
// (the LSTM's dgates, the GRU's da_cand and da_zr), the forward walk's
// products form them.
template <bool kLstm>
constexpr int kGates = kLstm ? 4 : 3;

// Annotation columns of a row of h and dh whose loads a lane of the
// walk's context pass issues together.
constexpr int kWalkCols = 8;

__host__ __device__ constexpr long long cdiv(long long n, long long d) { return (n + d - 1) / d; }

// n rounded up to whole 16-byte groups of floats.
__host__ __device__ constexpr long long r4(long long n) { return (n + 3) / 4 * 4; }

// Block k's share [lo, lo + n) of n_all items over C blocks, in whole
// groups of g items (g divides n_all).
struct Span {
  int lo, n;
  __host__ __device__ Span(int n_all, int C, int k, int g = 1)
      : lo(g * (n_all / g * k / C)), n(g * (n_all / g * (k + 1) / C) - lo) {}
};

// The largest share of n items over C blocks: in whole groups of 4 items
// where 4 divides n (the walk's unit and column shares then start and end
// on 16-byte boundaries), else of single items.
__host__ __device__ constexpr long long cspan(long long n, long long C) {
  return n % 4 ? cdiv(n, C) : 4 * cdiv(n / 4, C);
}

// Shared memory of one block of the walk, in floats, for R batch rows on
// clusters of C blocks, lstm 1 for the LSTM cell (else 0: the GRU), loc 1
// with the location term (else 0 and FM = F = 0). carve_walk lays it out,
// each buffer 16-byte aligned; the plan in ops/cuda/attention_scan.py
// (walk_smem_bytes) computes the same.
long long walk_smem_floats(long long R, long long C, long long L, long long S, long long A,
                           long long St, long long FM, long long F, long long loc,
                           long long lstm) {
  return r4(2 * (lstm * kBarsLstm + (1 - lstm) * kBarsGru)) + r4((3 + lstm) * R * St) +
         2 * r4(R * St) + r4(R * A) + r4(C * R) + r4(C * R * r4(S)) + r4(R * r4(S)) +
         2 * (r4((3 + lstm) * R * cspan(St, C)) + (2 + lstm) * r4(R * cspan(St, C)) +
              r4(R * r4(S)) + 2 * r4(R * cdiv(L, C)) + loc * r4(R * (cdiv(L, C) + F - 1)) +
              2 * r4(R * cspan(A, C))) +
         (4 - lstm) * r4(R * cspan(St, C)) + 2 * r4(R * cdiv(L, C)) + 2 * r4(S) +
         loc * (r4(R * cdiv(L, C) * FM) + r4(R * (cdiv(L, C) + F - 1) * FM) + 2 * r4(FM * S) +
                r4(F * FM) + r4(FM) + r4((F + 1) * FM));
}

// A step's inputs of the block's units, positions and columns, staged by
// asynchronous copies one step ahead, each [R][width].
struct Staged {
  float* g;     // [kGates][R][Stc]  the LSTM's gate pre-activations (i, f, g, o), or the
                //                   GRU's update and reset gates and its candidate
  float *mp, *dsq, *dmq;  // [R][Stc]  the LSTM's mem_prev or the GRU's s_prev, the
                          //           cotangents of s and (LSTM only) mem
  float* ws;    // [R][Sp]      s_prev @ ws_w + ws_b, every score unit
  float *al, *dalq;       // [R][Pc]   alpha and its cotangent
  float* ap;    // [R][Pw]      alpha_prev at [lo - pad, lo + Pc + F - 1 - pad), 0 off [0, L)
  float *dcq, *cq;        // [R][Ac]   the cotangent of c, and c
};

struct WalkShared {
  unsigned long long* bars;  // [kBars]: the step's exchanges
  // Gathered: every block holds all of them, each block writing its share.
  float *gdg;   // [R][kGates St]  dgates, or da_cand | da_zr
  float *gdr;   // [R][St]      dr
  float *gdcc;  // [R][St]      dcc = drr[:St]
  float *gdc;   // [R][A]       dc
  float *dotp;  // [C][R]       the blocks' shares of sum_l alpha dalpha
  float *dwsp;  // [C][R][Sp]   the blocks' partials of dws
  float *dws;   // [R][Sp]      dws, their sum
  Staged stg;      // the first of two staging buffers,
  long long stage;  // the second `stage` floats on
  float *carry_s, *carry_m, *dsp;  // [R][Stc]  (carry_m: LSTM only)
  float *dcs, *dcr;                // [R][Stc]  the GRU's dcin = da_cand w_h^T, [:St] and [St:]
  float *dalc, *de;                // [R][Pc]  alpha's cotangent from step t+1; de
  float *we, *we_acc;              // [S]      w_e; dw_e over the block's rows, steps, positions
  // The location term.
  float *feat;   // [R][Pc][FM]
  float *dfh;    // [R][Pw][FM]  dfeat at [lo + pad - F + 1, lo + Pc - 1 + pad]: the halo's
  float *u, *pu; // [FM][S]      U; dU over the block's rows, steps and positions
  float *cw, *cb, *pconv;  // [F][FM], [FM]; dwconv | dbconv likewise, [(F + 1) FM]
};

__host__ __device__ inline float* take4(Carver& c, long long n) { return c.take((size_t)r4(n)); }

template <bool kLstm, bool kLoc>
__host__ __device__ WalkShared carve_walk(float* sm, const Dims& d, int C, int R, size_t* floats) {
  Carver c{sm, 0};
  const long long Stc = cspan(d.St, C), Ac = cspan(d.A, C), Pc = cdiv(d.L, C), Sp = r4(d.S);
  const long long Pw = Pc + d.F - 1;
  WalkShared s{};
  s.bars = reinterpret_cast<unsigned long long*>(take4(c, 2 * kBars<kLstm>));
  s.gdg = take4(c, (long long)kGates<kLstm> * R * d.St);
  s.gdr = take4(c, (long long)R * d.St);
  s.gdcc = take4(c, (long long)R * d.St);
  s.gdc = take4(c, (long long)R * d.A);
  s.dotp = take4(c, (long long)C * R);
  s.dwsp = take4(c, C * R * Sp);
  s.dws = take4(c, R * Sp);
  Staged& q = s.stg;
  const size_t first = c.off;
  q.g = take4(c, kGates<kLstm> * R * Stc);
  q.mp = take4(c, R * Stc);
  q.dsq = take4(c, R * Stc);
  if (kLstm) q.dmq = take4(c, R * Stc);
  q.ws = take4(c, R * Sp);
  q.al = take4(c, R * Pc);
  q.dalq = take4(c, R * Pc);
  if (kLoc) q.ap = take4(c, R * Pw);
  q.dcq = take4(c, R * Ac);
  q.cq = take4(c, R * Ac);
  s.stage = (long long)(c.off - first);
  c.take((size_t)s.stage);
  s.carry_s = take4(c, R * Stc);
  if (kLstm) {
    s.carry_m = take4(c, R * Stc);
  } else {
    s.dcs = take4(c, R * Stc);
    s.dcr = take4(c, R * Stc);
  }
  s.dsp = take4(c, R * Stc);
  s.dalc = take4(c, R * Pc);
  s.de = take4(c, R * Pc);
  s.we = take4(c, d.S);
  s.we_acc = take4(c, d.S);
  if (kLoc) {
    s.feat = take4(c, R * Pc * d.FM);
    s.dfh = take4(c, R * Pw * d.FM);
    s.u = take4(c, (long long)d.FM * d.S);
    s.pu = take4(c, (long long)d.FM * d.S);
    s.cw = take4(c, (long long)d.F * d.FM);
    s.cb = take4(c, d.FM);
    s.pconv = take4(c, (long long)(d.F + 1) * d.FM);
  }
  *floats = c.off;
  return s;
}

// Staging buffer i of the walk: the first's arrays, i * stage floats on
// (pointer arithmetic, so that no array of them is indexed at run time).
__device__ __forceinline__ Staged staged(const WalkShared& sh, int i) {
  const long long o = i * sh.stage;
  const Staged& q = sh.stg;
  return Staged{q.g + o, q.mp + o, q.dsq + o, q.dmq ? q.dmq + o : nullptr, q.ws + o,
                q.al + o, q.dalq + o, q.ap ? q.ap + o : nullptr, q.dcq + o, q.cq + o};
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// mbar_wait, except that a wait past 2^28 tries (seconds) traps: an
// exchange whose bytes never all arrive faults the launch instead of
// hanging the card.
__device__ __forceinline__ void walk_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (tries == (1u << 28)) __trap();
  }
}

// Makes this thread's earlier writes to shared memory visible to the
// bulk copies (the async proxy) that a thread starts after a barrier.
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16) of this block's shared memory at `src`
// to `dst` (where this block's `dst` is) in block `rank` of the cluster,
// both 16-byte aligned, counted on that block's mbarrier `bar`; bulk_copy
// copies to the same place.
__device__ __forceinline__ void bulk_copy_to(const float* src, const float* dst, unsigned bytes,
                                             unsigned rank, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(cluster_map(dst, rank)),
      "r"(smem_addr(src)), "r"(bytes), "r"(cluster_map(bar, rank))
      : "memory");
}

__device__ __forceinline__ void bulk_copy(const float* src, unsigned bytes, unsigned rank,
                                          unsigned long long* bar) {
  bulk_copy_to(src, src, bytes, rank, bar);
}

// Put this block's values buf[r * ld + off + j * seg + i] (r < R, j <
// nseg, i < n) at the same place of every other block of the cluster,
// counted on that block's mbarrier `bar`: with `bulk` (every run of n
// floats 16-byte aligned, n a multiple of 4) a bulk copy a run and peer,
// else a store a value and peer; either way dealt out over the threads.
// Reads buf after a block barrier, behind async_fence where bulk.
template <int R>
__device__ void push(const float* buf, int ld, int off, int nseg, int seg, int n,
                     unsigned long long* bar, int C, int k, bool bulk) {
  const int nv = R * nseg * n;
  if (nv == 0 || C == 1) return;
  if (bulk) {
    for (int idx = threadIdx.x; idx < R * nseg * (C - 1); idx += kThreads) {
      const int rj = idx / (C - 1), q = idx - rj * (C - 1);
      bulk_copy(buf + (rj / nseg) * ld + off + (rj % nseg) * seg, 4u * n, q < k ? q : q + 1, bar);
    }
    return;
  }
  const int groups = max(1, min(C - 1, kThreads / nv));
  for (int idx = threadIdx.x; idx < nv * groups; idx += kThreads) {
    const int gq = idx / nv, e = idx - gq * nv, rj = e / n, i = e - rj * n;
    const float* p = buf + (rj / nseg) * ld + off + (rj % nseg) * seg + i;
    const float v = *p;
    for (int q = gq; q < C - 1; q += groups) {
      const int peer = q < k ? q : q + 1;
      st_async(cluster_map(p, peer), v, cluster_map(bar, peer));
    }
  }
}

// What a block of the walk works on: its rank in the cluster, its batch
// rows, its shares of the state units, annotation columns, score units
// and encoder positions, and the widths of its staged arrays. With St and
// A multiples of 4 (`bulk`) the unit and column shares are whole 16-byte
// groups, and the exchanges copy each row's share to a peer in one bulk
// copy; else a thread stores each value.
struct WalkCtx {
  int C, k, b0, nrows, Stc, Ac, Pc, Sp, Pw, pad;
  bool bulk;
  Span un, ac, sp, pos;
  int hlo;  // the first position of the block's dfeat halo
  __device__ WalkCtx(const Dims& d, int C_, int k_, int R)
      : C(C_), k(k_), b0(blockIdx.x / C_ * R), nrows(min(R, d.B - b0)),
        Stc((int)cspan(d.St, C_)), Ac((int)cspan(d.A, C_)), Pc((int)cdiv(d.L, C_)),
        Sp((int)r4(d.S)), Pw(Pc + d.F - 1), pad(d.F / 2), bulk(d.St % 4 == 0 && d.A % 4 == 0),
        un(d.St, C_, k_, bulk ? 4 : 1), ac(d.A, C_, k_, bulk ? 4 : 1), sp(d.S, C_, k_),
        pos(d.L, C_, k_), hlo(pos.lo + pad - d.F + 1) {}
};

// Stage step t's inputs of the block's units, positions and columns into
// q by asynchronous copies (zeros for absent cotangents, rows past B and
// alpha_prev outside [0, L) or at t = 0). The cell's: the LSTM's gate
// pre-activations and mem_prev, or the GRU's gates, candidate and s_prev.
template <int R, bool kLstm, bool kLoc>
__device__ __forceinline__ void stage_step(const BwdArgs& a, const WalkCtx& c, const Staged& q,
                                           int t) {
  const Dims& d = a.d;
  const int T = d.T, L = d.L, S = d.S, A = d.A, St = d.St, St2 = 2 * St, St4 = 4 * St;
  const size_t n0 = (size_t)c.b0 * T + t;  // (row b0, step t)
  const Span &un = c.un, &ac = c.ac, &pos = c.pos;
  const size_t rs = (size_t)T * St;
  if constexpr (kLstm) {
    for (int gi = 0; gi < 4; ++gi)
      stage_async<R>(q.g + gi * R * c.Stc, c.Stc, a.st.dg + n0 * St4 + gi * St + un.lo,
                     (size_t)T * St4, un.n, c.nrows, false);
  } else {
    for (int gi = 0; gi < 2; ++gi)
      stage_async<R>(q.g + gi * R * c.Stc, c.Stc, a.st.da_zr + n0 * St2 + gi * St + un.lo,
                     (size_t)T * St2, un.n, c.nrows, false);
    stage_async<R>(q.g + 2 * R * c.Stc, c.Stc, a.st.da_cand + n0 * St + un.lo, rs, un.n,
                   c.nrows, false);
  }
  const float* prev = kLstm ? a.mem_seq : a.s_seq;
  stage_async<R>(q.mp, c.Stc, t > 0 ? prev + (n0 - 1) * St + un.lo : nullptr, rs, un.n,
                 c.nrows, false);
  stage_async<R>(q.dsq, c.Stc, a.ds_seq ? a.ds_seq + n0 * St + un.lo : nullptr, rs, un.n,
                 c.nrows, false);
  if (kLstm)
    stage_async<R>(q.dmq, c.Stc, a.dmem_seq ? a.dmem_seq + n0 * St + un.lo : nullptr, rs, un.n,
                   c.nrows, false);
  stage_async<R>(q.ws, c.Sp, a.st.dws + n0 * S, (size_t)T * S, S, c.nrows, false);
  stage_async<R>(q.al, c.Pc, a.alpha_seq + n0 * L + pos.lo, (size_t)T * L, pos.n, c.nrows, false);
  stage_async<R>(q.dalq, c.Pc, a.dalpha_seq ? a.dalpha_seq + n0 * L + pos.lo : nullptr,
                 (size_t)T * L, pos.n, c.nrows, false);
  stage_async<R>(q.dcq, c.Ac, a.dc_seq ? a.dc_seq + n0 * A + ac.lo : nullptr, (size_t)T * A,
                 ac.n, c.nrows, false);
  stage_async<R>(q.cq, c.Ac, a.c_seq + n0 * A + ac.lo, (size_t)T * A, ac.n, c.nrows, false);
  if (kLoc)
    for (int idx = threadIdx.x; idx < R * c.Pw; idx += kThreads) {
      const int r = idx / c.Pw, i = idx - r * c.Pw, p = pos.lo - c.pad + i;
      if (t > 0 && r < c.nrows && i < pos.n + d.F - 1 && p >= 0 && p < L)
        copy_async(q.ap + idx, a.alpha_seq + (n0 + (size_t)r * T - 1) * L + p);
      else
        q.ap[idx] = 0.f;
    }
}

// The energies on the block's positions: dz = de w_e (1 - tanh(z)^2), a
// thread per score unit, z = vh + ws (+ feat U), the loads of kLocRows
// positions issued together; dvh (`last`: the walk's first step writes
// it), the block's partial of dws, dw_e's sum, and with the location term
// dU's sum and dz into the scratch, which the dfeat pass reads.
template <int R, bool kLoc>
__device__ __forceinline__ void walk_energies(const BwdArgs& a, const WalkCtx& c,
                                           const WalkShared& sh, const Staged& q, bool last) {
  const int L = a.d.L, S = a.d.S, FM = a.d.FM, Pc = c.Pc, Sp = c.Sp;
  const Span& pos = c.pos;
  for (int sc = threadIdx.x; sc < S; sc += kThreads) {
    const float wev = sh.we[sc];
    float gwe = 0.f;
    for (int r = 0; r < c.nrows; ++r) {
      const float wsv = q.ws[r * Sp + sc];
      const size_t base = ((size_t)(c.b0 + r) * L + pos.lo) * S + sc;
      float gws = 0.f;
      for (int p0 = 0; p0 < pos.n; p0 += kLocRows) {
        float vv[kLocRows], dv[kLocRows];
#pragma unroll
        for (int x = 0; x < kLocRows; ++x) {
          const size_t i = base + (size_t)(p0 + x) * S;
          vv[x] = p0 + x < pos.n ? a.vh[i] : 0.f;
          dv[x] = p0 + x < pos.n && !last ? a.dvh[i] : 0.f;
        }
#pragma unroll
        for (int x = 0; x < kLocRows; ++x) {
          const int p = p0 + x;
          if (p >= pos.n) break;
          float z = vv[x] + wsv;
          const float* f = sh.feat + (r * Pc + p) * FM;
          if (kLoc) {
            float uf = 0.f;
            for (int qq = 0; qq < FM; ++qq) uf = fmaf(f[qq], sh.u[qq * S + sc], uf);
            z += uf;
          }
          const float av = fast_tanh(z), de = sh.de[r * Pc + p];
          const float dz = de * wev * (1.f - av * av);
          const size_t i = base + (size_t)p * S;
          a.dvh[i] = last ? dz : dv[x] + dz;
          if (kLoc) {
            a.st.dz[i] = dz;
            for (int qq = 0; qq < FM; ++qq)
              sh.pu[qq * S + sc] = fmaf(f[qq], dz, sh.pu[qq * S + sc]);
          }
          gws += dz;
          gwe = fmaf(av, de, gwe);
        }
      }
      sh.dwsp[(c.k * R + r) * Sp + sc] = gws;
    }
    sh.we_acc[sc] += gwe;
  }
}

// dfeat = dz U^T on the block's positions, a warp each, into the halo
// buffer's rows of the block's own positions.
template <int R>
__device__ __forceinline__ void walk_dfeat(const BwdArgs& a, const WalkCtx& c,
                                           const WalkShared& sh) {
  const int L = a.d.L, S = a.d.S, FM = a.d.FM, n = c.pos.n;
  for (int pr = threadIdx.x >> 5; pr < c.nrows * n; pr += kWarps) {
    const int r = pr / n, p = pr - r * n;
    dfeat_of(a.st.dz + ((size_t)(c.b0 + r) * L + c.pos.lo + p) * S, sh.u, S, FM,
             sh.dfh + (r * c.Pw + p + a.d.F - 1 - c.pad) * FM, threadIdx.x & 31);
  }
}

// The walk of K11 (kLstm, kLoc), K15 (kLstm) or K5 (the GRU) for the R
// batch rows of this block's cluster (group blockIdx.x / C), after the
// pre-pass; the file's head gives the step. Single buffers suffice for
// what the exchanges carry, by causality: a peer pushes a step's first
// exchange only after it has passed that step's last (the dws partials)
// wait before, which needs this block's last push, which this block makes
// after reading everything the earlier exchanges brought; and a peer
// pushes the last only after its wait for the one before (dc), which
// needs this block's next push of dc, made after this block has read
// what the last brought. For the same reason thread 0 arms an mbarrier's
// next phase as soon as it has seen one complete, and a bulk copy's
// source is read before the block writes it again. Rows past B have zero
// inputs, stay zero and write nothing.
template <int R, bool kLstm, bool kLoc>
__device__ __forceinline__ void decoder_walk(float* sm, const BwdArgs& a) {
  static_assert(kLstm || !kLoc, "the location-aware GRU's backward is K13's scan_bwd");
  // The exchanges after the cell's: dr, dcc, dc (with the softmax's
  // shares), the dws partials (with the dfeat halo).
  constexpr int eDr = kLstm ? 1 : 2, eDcc = eDr + 1, eDc = eDr + 2, eDws = eDr + 3;
  static_assert(eDws + 1 == kBars<kLstm>, "an mbarrier an exchange");
  constexpr int kG = kGates<kLstm>;
  cg::cluster_group cluster = cg::this_cluster();
  const Dims& d = a.d;
  const WalkCtx c(d, (int)cluster.num_blocks(), (int)cluster.block_rank(), R);
  const int C = c.C, k = c.k, b0 = c.b0, nrows = c.nrows, Stc = c.Stc, Ac = c.Ac, Pc = c.Pc;
  const int Sp = c.Sp, Pw = c.Pw, pad = c.pad;
  const Span &un = c.un, &ac = c.ac, &sp = c.sp, &pos = c.pos;
  const int T = d.T, L = d.L, S = d.S, A = d.A, St = d.St, St2 = 2 * St, St4 = 4 * St;
  const int FM = d.FM, F = d.F, Stg = kG * St;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_conv = (F + 1) * FM;
  size_t floats;
  const WalkShared sh = carve_walk<kLstm, kLoc>(sm, d, C, R, &floats);

  for (int i = tid; i < S; i += kThreads) {
    sh.we[i] = a.w.w_e[i];
    sh.we_acc[i] = 0.f;
  }
  for (int i = tid; i < C * R * Sp; i += kThreads) sh.dwsp[i] = 0.f;
  for (int i = tid; i < R * Stc; i += kThreads) {
    sh.carry_s[i] = 0.f;
    if (kLstm) sh.carry_m[i] = 0.f;
  }
  for (int i = tid; i < R * Pc; i += kThreads) sh.dalc[i] = 0.f;
  if (kLoc) {
    for (int i = tid; i < FM * S; i += kThreads) {
      sh.u[i] = a.w.u[i];
      sh.pu[i] = 0.f;
    }
    for (int i = tid; i < F * FM; i += kThreads) sh.cw[i] = a.w.wconv[i];
    for (int i = tid; i < FM; i += kThreads) sh.cb[i] = a.w.bconv[i];
    for (int i = tid; i < n_conv; i += kThreads) sh.pconv[i] = 0.f;
    // The halo's positions outside [0, L) stay 0.
    for (int i = tid; i < R * Pw * FM; i += kThreads) sh.dfh[i] = 0.f;
  }
  // The bytes the peers push into this block a step, by exchange.
  int halo = 0;  // positions of other blocks whose dfeat this block reads
  if (kLoc && pos.n > 0) halo = min(pos.lo + pos.n - 1 + pad, L - 1) - max(c.hlo, 0) + 1 - pos.n;
  unsigned tx[kBars<kLstm>];
  if constexpr (kLstm) {
    tx[0] = 16u * R * (St - un.n);  // dgates
  } else {
    tx[0] = 4u * R * (St - un.n);  // da_cand
    tx[1] = 8u * R * (St - un.n);  // da_zr
  }
  tx[eDr] = 4u * R * (St - un.n);
  tx[eDcc] = 4u * R * (St - un.n);
  tx[eDc] = 4u * R * (A - ac.n) + 4u * R * (C - 1);
  tx[eDws] = 4u * R * Sp * (C - 1) + 4u * R * FM * halo;
  if (tid == 0) {
    for (int i = 0; i < kBars<kLstm>; ++i) mbar_init(&sh.bars[i]);
    mbar_init_fence();
    for (int i = 0; i < kBars<kLstm>; ++i) mbar_expect(&sh.bars[i], tx[i]);
  }
  const bool vec_g = ((reinterpret_cast<size_t>(a.w.w_h) | reinterpret_cast<size_t>(a.w.w_x)) &
                      15) == 0;
  // The GRU's products read rows of St (w_h) and 2 St (w_zr) floats.
  const bool vec_h = St % 4 == 0 && (reinterpret_cast<size_t>(a.w.w_h) & 15) == 0;
  const bool vec_zr = St % 4 == 0 && (reinterpret_cast<size_t>(a.w.w_zr) & 15) == 0;
  const bool vec_dec = St % 4 == 0 && (reinterpret_cast<size_t>(a.w.dec_w) & 15) == 0;
  const bool vec_c = St % 4 == 0 && (reinterpret_cast<size_t>(a.w.c_w) & 15) == 0;
  const bool vec_ws = S % 4 == 0 && (reinterpret_cast<size_t>(a.w.ws_w) & 15) == 0;
  stage_step<R, kLstm, kLoc>(a, c, staged(sh, 0), T - 1);
  cluster.sync();  // every block's mbarriers are armed before any push into it

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const bool last = s == 0;  // the first step of the walk writes dvh and dh
    const size_t n0 = (size_t)b0 * T + t, rs = (size_t)T * St;  // (row b0, step t); a row's stride
    const Staged q = staged(sh, s & 1);
    copy_async_wait();
    __syncthreads();
    // The other buffer, last read in step s - 1.
    if (s + 1 < T) stage_step<R, kLstm, kLoc>(a, c, staged(sh, (s + 1) & 1), t - 1);
    // [phase] staging wait
    if constexpr (kLstm) {
      // The LSTM cell of the block's units: the gates' cotangents and the
      // dmem chain.
      for (int idx = tid; idx < R * un.n; idx += kThreads) {
        const int r = idx / un.n, i = idx - r * un.n, o = r * Stc + i;
        const float ig = sigmoid(q.g[o]), fg = sigmoid(q.g[R * Stc + o]);
        const float gg = tanhf(q.g[2 * R * Stc + o]), og = sigmoid(q.g[3 * R * Stc + o]);
        const float mprev = q.mp[o];
        const float tm = tanhf(fg * mprev + ig * gg);
        const float ds = q.dsq[o] + sh.carry_s[o];
        const float dm = ds * og * (1.f - tm * tm) + q.dmq[o] + sh.carry_m[o];
        const float dg[4] = {dm * gg * ig * (1.f - ig), dm * mprev * fg * (1.f - fg),
                             dm * ig * (1.f - gg * gg), ds * tm * og * (1.f - og)};
        sh.carry_m[o] = dm * fg;
        float* gd = sh.gdg + r * St4 + un.lo + i;
        float* stash = a.st.dg + (n0 + (size_t)r * T) * St4 + un.lo + i;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          gd[gi * St] = dg[gi];
          if (r < nrows) stash[gi * St] = dg[gi];
        }
      }
    } else {
      // The GRU's candidate of the block's units: da_cand = ds z (1 -
      // cand^2), ds the step's cotangent of s plus the carry.
      for (int idx = tid; idx < R * un.n; idx += kThreads) {
        const int r = idx / un.n, i = idx - r * un.n, o = r * Stc + i;
        const float zg = q.g[o], cv = q.g[2 * R * Stc + o];
        const float dac = (q.dsq[o] + sh.carry_s[o]) * zg * (1.f - cv * cv);
        sh.gdg[r * Stg + un.lo + i] = dac;
        if (r < nrows) a.st.da_cand[(n0 + (size_t)r * T) * St + un.lo + i] = dac;
      }
    }
    async_fence();
    __syncthreads();
    push<R>(sh.gdg, Stg, un.lo, kLstm ? 4 : 1, St, un.n, &sh.bars[0], C, k, c.bulk);
    if (kLoc)  // the location features of the block's positions, off the chain
      for (int idx = tid; idx < nrows * pos.n * FM; idx += kThreads) {
        const int qq = idx % FM, rp = idx / FM, p = rp % pos.n, r = rp / pos.n;
        float f = 0.f;
        for (int j = 0; j < F; ++j) f = fmaf(q.ap[r * Pw + p + j], sh.cw[j * FM + qq], f);
        sh.feat[(r * Pc + p) * FM + qq] = f + sh.cb[qq];
      }
    walk_wait(&sh.bars[0], s & 1);
    if (tid == 0 && s + 1 < T) mbar_expect(&sh.bars[0], tx[0]);
    // [phase] cell, E1 exchange
    // Each product's emit takes its outputs' bases by value, formed before
    // its loop (fewer values live through it than capturing the walk's
    // state).
    if constexpr (kLstm) {
      // dr = dg w_x^T on the block's units, pushed; then, while it is on
      // its way, dsp = dg w_h^T, which only the step's carry reads.
      rows_dot<R, false, true>(a.w.w_x + (size_t)un.lo * St4, St4, un.n, sh.gdg, St4, St4,
                               [y = sh.gdr + un.lo, z = a.st.dr + n0 * St + un.lo, St, rs,
                                nrows](int i, int r, float v) {
                                 y[r * St + i] = v;
                                 if (r < nrows) z[r * rs + i] = v;
                               }, vec_g);
      async_fence();
      __syncthreads();
      push<R>(sh.gdr, St, un.lo, 1, 0, un.n, &sh.bars[eDr], C, k, c.bulk);
      rows_dot<R, false, true>(a.w.w_h + (size_t)un.lo * St4, St4, un.n, sh.gdg, St4, St4,
                               [y = sh.dsp, Stc](int i, int r, float v) { y[r * Stc + i] = v; },
                               vec_g);
    } else {
      // dcin[:St] = da_cand w_h^T on the block's units' rows; then the
      // gates' cotangents of its units, pushed: the update gate's from
      // ds (cand - s_prev), the reset gate's from dcin[:St] s_prev (the
      // gate acts before the candidate product).
      rows_dot<R, false, true>(a.w.w_h + (size_t)un.lo * St, St, un.n, sh.gdg, Stg, St,
                               [y = sh.dcs, Stc](int i, int r, float v) { y[r * Stc + i] = v; },
                               vec_h);
      __syncthreads();
      for (int idx = tid; idx < R * un.n; idx += kThreads) {
        const int r = idx / un.n, i = idx - r * un.n, o = r * Stc + i;
        const float zg = q.g[o], rg = q.g[R * Stc + o], cv = q.g[2 * R * Stc + o];
        const float sv = q.mp[o], ds = q.dsq[o] + sh.carry_s[o];
        const float dz = ds * (cv - sv) * zg * (1.f - zg);
        const float drg = sh.dcs[o] * sv * rg * (1.f - rg);
        float* gd = sh.gdg + r * Stg + St + un.lo + i;
        gd[0] = dz;
        gd[St] = drg;
        if (r < nrows) {
          float* stash = a.st.da_zr + (n0 + (size_t)r * T) * St2 + un.lo + i;
          stash[0] = dz;
          stash[St] = drg;
        }
      }
      async_fence();
      __syncthreads();
      push<R>(sh.gdg, Stg, St + un.lo, 2, St, un.n, &sh.bars[1], C, k, c.bulk);
      // While da_zr is on its way: dcin[St:] on the block's units' rows,
      // which only dr reads.
      rows_dot<R, false, true>(a.w.w_h + (size_t)(St + un.lo) * St, St, un.n, sh.gdg, Stg, St,
                               [y = sh.dcr, Stc](int i, int r, float v) { y[r * Stc + i] = v; },
                               vec_h);
      walk_wait(&sh.bars[1], s & 1);
      if (tid == 0 && s + 1 < T) mbar_expect(&sh.bars[1], tx[1]);
      __syncthreads();  // dcin[St:], formed by other warps
      // [phase] w_h^T, da_zr exchange
      // dr = dcin[St:] + dsr[St:] on the block's units, dsr = da_zr
      // w_zr^T, pushed; then, while it is on its way, the cell's part of
      // ds_prev, dsr[:St] + dcin[:St] rg + ds (1 - z), which only the
      // step's carry reads.
      rows_dot<R, false, true>(a.w.w_zr + (size_t)(St + un.lo) * St2, St2, un.n, sh.gdg + St, Stg,
                               St2,
                               [y = sh.gdr + un.lo, z = a.st.dr + n0 * St + un.lo, add = sh.dcr,
                                St, Stc, rs, nrows](int i, int r, float v) {
                                 const float dr = add[r * Stc + i] + v;
                                 y[r * St + i] = dr;
                                 if (r < nrows) z[r * rs + i] = dr;
                               }, vec_zr);
      async_fence();
      __syncthreads();
      push<R>(sh.gdr, St, un.lo, 1, 0, un.n, &sh.bars[eDr], C, k, c.bulk);
      rows_dot<R, false, true>(a.w.w_zr + (size_t)un.lo * St2, St2, un.n, sh.gdg + St, Stg, St2,
                               [y = sh.dsp, Stc](int i, int r, float v) { y[r * Stc + i] = v; },
                               vec_zr);
      __syncthreads();
      for (int idx = tid; idx < R * un.n; idx += kThreads) {
        const int r = idx / un.n, i = idx - r * un.n, o = r * Stc + i;
        const float zg = q.g[o], rg = q.g[R * Stc + o], ds = q.dsq[o] + sh.carry_s[o];
        sh.dsp[o] = sh.dsp[o] + sh.dcs[o] * rg + ds * (1.f - zg);
      }
    }
    walk_wait(&sh.bars[eDr], s & 1);
    if (tid == 0 && s + 1 < T) mbar_expect(&sh.bars[eDr], tx[eDr]);
    // [phase] cell products, dr exchange
    // drr = dr dec_w^T on the block's units: dcc, pushed; then dyin.
    rows_dot<R, false, true>(a.w.dec_w + (size_t)un.lo * St, St, un.n, sh.gdr, St, St,
                             [y = sh.gdcc + un.lo, z = a.st.dcc + n0 * St + un.lo, St, rs,
                              nrows](int i, int r, float v) {
                               y[r * St + i] = v;
                               if (r < nrows) z[r * rs + i] = v;
                             }, vec_dec);
    async_fence();
    __syncthreads();
    push<R>(sh.gdcc, St, un.lo, 1, 0, un.n, &sh.bars[eDcc], C, k, c.bulk);
    rows_dot<R, false, true>(a.w.dec_w + (size_t)(St + un.lo) * St, St, un.n, sh.gdr, St, St,
                             [z = a.dyin + n0 * St + un.lo, rs, nrows](int i, int r, float v) {
                               if (r < nrows) z[r * rs + i] = v;
                             }, vec_dec);
    walk_wait(&sh.bars[eDcc], s & 1);
    if (tid == 0 && s + 1 < T) mbar_expect(&sh.bars[eDcc], tx[eDcc]);
    // [phase] dec_w^T, dcc exchange
    // dc = dcc c_w^T + dc_seq on the block's columns, pushed with the
    // block's share of sum_l alpha dalpha, a warp a row.
    rows_dot<R, false, true>(a.w.c_w + (size_t)ac.lo * St, St, ac.n, sh.gdcc, St, St,
                             [y = sh.gdc + ac.lo, add = q.dcq, A, Ac](int i, int r, float v) {
                               y[r * A + i] = v + add[r * Ac + i];
                             }, vec_c);
    async_fence();
    __syncthreads();
    push<R>(sh.gdc, A, ac.lo, 1, 0, ac.n, &sh.bars[eDc], C, k, c.bulk);
    if (warp < R) {
      const int r = warp;
      float part = 0.f;
      for (int i = lane; i < ac.n; i += 32)
        part = fmaf(q.cq[r * Ac + i], sh.gdc[r * A + ac.lo + i], part);
      for (int p = lane; p < pos.n; p += 32)
        part = fmaf(q.al[r * Pc + p], q.dalq[r * Pc + p] + (kLoc ? sh.dalc[r * Pc + p] : 0.f),
                    part);
      part = warp_sum(part);
      if (lane == 0) sh.dotp[k * R + r] = part;
      if (lane < C && lane != k)
        st_async(cluster_map(sh.dotp + k * R + r, lane), part, cluster_map(&sh.bars[eDc], lane));
    }
    walk_wait(&sh.bars[eDc], s & 1);
    if (tid == 0 && s + 1 < T) mbar_expect(&sh.bars[eDc], tx[eDc]);
    __syncthreads();  // this block's own share of the sum
    // [phase] c_w^T, dc exchange
    // The context on the block's positions, a warp per (row, position):
    // dalpha = h dc + dalpha_seq + the carry from step t+1, de = alpha
    // (dalpha - sum_l alpha dalpha), and dh += alpha dc^T in the same
    // pass over the row of h and dh, kWalkCols of each a lane in flight.
    for (int pr = warp; pr < nrows * pos.n; pr += kWarps) {
      const int r = pr / pos.n, p = pr - r * pos.n;
      const size_t row = ((size_t)(b0 + r) * L + pos.lo + p) * A;
      const float* hr = a.h + row;
      float* dhr = a.dh + row;
      const float* dc = sh.gdc + r * A;
      const float al = q.al[r * Pc + p];
      float acc = 0.f;
      for (int j0 = lane; j0 < A; j0 += 32 * kWalkCols) {
        float hv[kWalkCols], o[kWalkCols];
#pragma unroll
        for (int x = 0; x < kWalkCols; ++x) {
          const int j = j0 + 32 * x;
          hv[x] = j < A ? hr[j] : 0.f;
          o[x] = j < A && !last ? dhr[j] : 0.f;
        }
#pragma unroll
        for (int x = 0; x < kWalkCols; ++x) {
          const int j = j0 + 32 * x;
          if (j >= A) break;
          const float dcj = dc[j];
          acc = fmaf(dcj, hv[x], acc);
          const float v = al * dcj;
          dhr[j] = last ? v : o[x] + v;
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        float dot = 0.f;
        for (int j = 0; j < C; ++j) dot += sh.dotp[j * R + r];
        const float dal = acc + q.dalq[r * Pc + p] + (kLoc ? sh.dalc[r * Pc + p] : 0.f);
        sh.de[r * Pc + p] = al * (dal - dot);
      }
    }
    __syncthreads();
    // [phase] context
    walk_energies<R, kLoc>(a, c, sh, q, last);
    async_fence();
    __syncthreads();
    // [phase] energies
    if (kLoc) {
      walk_dfeat<R>(a, c, sh);
      async_fence();
      __syncthreads();
    }
    // [phase] dfeat
    // The last exchange: the block's dws partial into every peer, a bulk
    // copy each; with
    // the location term, its dfeat rows into each peer whose alpha_prev
    // cotangent reads them: a row's positions x0..x0+nx are nx FM
    // consecutive floats in both blocks' halo buffers, one bulk copy a
    // row and peer where FM is a multiple of 4, else a store a value.
    for (int e = tid; e < C - 1; e += kThreads)
      bulk_copy(sh.dwsp + k * R * Sp, 4u * R * Sp, e < k ? e : e + 1, &sh.bars[eDws]);
    if (kLoc)
      for (int j = 0; j < C; ++j) {
        const Span pj(L, C, j);
        if (j == k || pj.n == 0) continue;
        const int hj = pj.lo + pad - F + 1;
        const int x0 = max(pos.lo, hj), nx = min(pos.lo + pos.n, pj.lo + pj.n + pad) - x0;
        if (nx <= 0) continue;
        if (FM % 4 == 0) {
          for (int r = tid; r < R; r += kThreads)
            bulk_copy_to(sh.dfh + (r * Pw + x0 - c.hlo) * FM, sh.dfh + (r * Pw + x0 - hj) * FM,
                         4u * nx * FM, j, &sh.bars[eDws]);
          continue;
        }
        const unsigned bar = cluster_map(&sh.bars[eDws], j);
        for (int idx = tid; idx < R * nx * FM; idx += kThreads) {
          const int qq = idx % FM, rx = idx / FM, x = x0 + rx % nx, r = rx / nx;
          st_async(cluster_map(sh.dfh + (r * Pw + x - hj) * FM + qq, j),
                   sh.dfh[(r * Pw + x - c.hlo) * FM + qq], bar);
        }
      }
    if (kLoc) {
      // Off the chain: dwconv[j][q] += sum ap[p + j] dfeat[p][q] and
      // dbconv[q] += sum dfeat[p][q] over the block's rows and positions,
      // a thread per entry.
      for (int idx = tid; idx < n_conv; idx += kThreads) {
        float v = 0.f;
        for (int r = 0; r < nrows; ++r) {
          const float* df = sh.dfh + (r * Pw + F - 1 - pad) * FM;  // the block's first position
          if (idx < F * FM) {
            const int j = idx / FM, qq = idx - j * FM;
            for (int p = 0; p < pos.n; ++p) v = fmaf(q.ap[r * Pw + p + j], df[p * FM + qq], v);
          } else {
            for (int p = 0; p < pos.n; ++p) v += df[p * FM + idx - F * FM];
          }
        }
        sh.pconv[idx] += v;
      }
    }
    walk_wait(&sh.bars[eDws], s & 1);
    if (tid == 0 && s + 1 < T) mbar_expect(&sh.bars[eDws], tx[eDws]);
    // [phase] dws exchange
    // dws, the blocks' partials in rank order (the same sums in every
    // block; the owner of a score unit stashes it). With the location
    // term, the cotangent of alpha_prev for step t-1 on the block's
    // positions: alpha_prev[x] enters feat[l] through tap j = x + pad - l,
    // a warp per (row, position), its lanes along the taps' (j, q).
    for (int idx = tid; idx < R * S; idx += kThreads) {
      const int r = idx / S, sc = idx - r * S;
      float v = 0.f;
      for (int j = 0; j < C; ++j) v += sh.dwsp[(j * R + r) * Sp + sc];
      sh.dws[r * Sp + sc] = v;
      if (r < nrows && sc >= sp.lo && sc < sp.lo + sp.n)
        a.st.dws[(n0 + (size_t)r * T) * S + sc] = v;
    }
    if (kLoc)
      for (int pr = warp; pr < nrows * pos.n; pr += kWarps) {
        const int r = pr / pos.n, p = pr - r * pos.n;
        float acc = 0.f;
        for (int i = lane; i < F * FM; i += 32) {
          const int j = i / FM;
          acc = fmaf(sh.dfh[(r * Pw + p + F - 1 - j) * FM + i - j * FM], sh.cw[i], acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) sh.dalc[r * Pc + p] = acc;
      }
    __syncthreads();
    // ds carried to step t-1: dsp + dws ws_w^T on the block's units.
    rows_dot<R, false, true>(a.w.ws_w + (size_t)un.lo * S, S, un.n, sh.dws, Sp, S,
                             [y = sh.carry_s, add = sh.dsp, Stc](int i, int r, float v) {
                               y[r * Stc + i] = v + add[r * Stc + i];
                             }, vec_ws);
    __syncthreads();
    // [phase] ws_w^T
  }
  // This block's rows of the partial sums: the cluster's rank k block of
  // group g is block g C + k.
  const size_t part = blockIdx.x;
  for (int i = tid; i < S; i += kThreads) a.st.pwe[part * S + i] = sh.we_acc[i];
  if (kLoc) {
    for (int i = tid; i < FM * S; i += kThreads) a.st.pu[part * FM * S + i] = sh.pu[i];
    for (int i = tid; i < n_conv; i += kThreads) a.st.pconv[part * n_conv + i] = sh.pconv[i];
  }
  cluster.sync();  // no block leaves while its shared memory may still be a peer's target
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) loc_lstm_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  decoder_walk<R, true, true>(sm, a);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) scan_lstm_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  decoder_walk<R, true, false>(sm, a);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) content_gru_walk_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  decoder_walk<R, false, false>(sm, a);
}

// The recompute pre-pass over every (row, step) n, one 64 x 64 output
// tile a block. Stage 0: cc = c @ c_w + c_b into rr[:, :St], yin into
// rr[:, St:] (blockIdx.y below ceil(St / 64)), and ws = s_prev @ ws_w +
// ws_b into the stash's dws rows (the rest); stage 1: r = rr @ dec_w +
// dec_b, for the LSTM into r, for the GRU into sr[:, St:] and
// cand_in[:, St:], with s_prev into sr[:, :St]. Then the LSTM's stage 2:
// the gates' pre-activations s_prev @ w_h + r @ w_x + b into the stash's
// dgates rows; or the GRU's stage 2: its gates sigmoid(sr @ w_zr) into
// the da_zr rows, and stage 3: rg s_prev into cand_in[:, :St] and the
// candidate tanh(cand_in @ w_h) into the da_cand rows. Each stage is a
// launch of its own, after the one it reads, and an instance of its own
// (tile_product's static shared memory, 17 KB a call site, stays under
// 48 KB).
template <bool kLstm, int kStage>
__device__ __forceinline__ void decoder_prepass(const BwdArgs& a) {
  const Dims& d = a.d;
  const Weights& w = a.w;
  const Stash& st = a.st;
  const int St = d.St, St2 = 2 * St, St4 = 4 * St, S = d.S, A = d.A, T = d.T;
  const int rows = d.B * T, i0 = blockIdx.x * kTile, ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  auto sprev = [&](int n, int kk) -> float {
    return n < rows && n % T > 0 ? a.s_seq[(size_t)(n - 1) * St + kk] : 0.f;
  };
  // out(n, j) for the tile's rows n < rows and columns j < N.
  auto store = [&](const float (&acc)[4][4], int j0, int N, auto out) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = i0 + 4 * ty + r, j = j0 + 4 * tx + c;
        if (n < rows && j < N) out(n, j, acc[r][c]);
      }
  };
  float acc[4][4];
  const int j0 = blockIdx.y * kTile, cc_tiles = (St + kTile - 1) / kTile;
  if constexpr (kStage == 0) {
    if ((int)blockIdx.y < cc_tiles) {
      tile_product(
          acc, [&](int n, int kk) { return n < rows ? a.c_seq[(size_t)n * A + kk] : 0.f; },
          [&](int kk, int j) { return j < St ? w.c_w[(size_t)kk * St + j] : 0.f; }, i0, j0, A);
      store(acc, j0, St, [&](int n, int j, float v) {
        st.rr[(size_t)n * St2 + j] = v + w.c_b[j];
        st.rr[(size_t)n * St2 + St + j] = a.yin[(size_t)n * St + j];
      });
    } else {
      const int js = j0 - cc_tiles * kTile;
      tile_product(acc, sprev,
                   [&](int kk, int j) { return j < S ? w.ws_w[(size_t)kk * S + j] : 0.f; }, i0,
                   js, St);
      store(acc, js, S, [&](int n, int j, float v) { st.dws[(size_t)n * S + j] = v + w.ws_b[j]; });
    }
  } else if constexpr (kStage == 1) {
    tile_product(
        acc, [&](int n, int kk) { return n < rows ? st.rr[(size_t)n * St2 + kk] : 0.f; },
        [&](int kk, int j) { return j < St ? w.dec_w[(size_t)kk * St + j] : 0.f; }, i0, j0, St2);
    if constexpr (kLstm) {
      store(acc, j0, St,
            [&](int n, int j, float v) { st.r[(size_t)n * St + j] = v + w.dec_b[j]; });
    } else {
      store(acc, j0, St, [&](int n, int j, float v) {
        const size_t o = (size_t)n * St2 + j;
        st.sr[o] = sprev(n, j);
        st.sr[o + St] = st.cand_in[o + St] = v + w.dec_b[j];
      });
    }
  } else if constexpr (kLstm) {
    tile_product(
        acc,
        [&](int n, int kk) {
          return kk < St ? sprev(n, kk) : n < rows ? st.r[(size_t)n * St + kk - St] : 0.f;
        },
        [&](int kk, int j) {
          return j >= St4 ? 0.f : kk < St ? w.w_h[(size_t)kk * St4 + j]
                                          : w.w_x[(size_t)(kk - St) * St4 + j];
        },
        i0, j0, St2);
    store(acc, j0, St4, [&](int n, int j, float v) { st.dg[(size_t)n * St4 + j] = v + w.b[j]; });
  } else if constexpr (kStage == 2) {
    tile_product(
        acc, [&](int n, int kk) { return n < rows ? st.sr[(size_t)n * St2 + kk] : 0.f; },
        [&](int kk, int j) { return j < St2 ? w.w_zr[(size_t)kk * St2 + j] : 0.f; }, i0, j0,
        St2);
    store(acc, j0, St2,
          [&](int n, int j, float v) { st.da_zr[(size_t)n * St2 + j] = activate<kSigmoid>(v); });
  } else {
    // The candidate's input: the reset gate times s_prev, then r.
    auto cand_in = [&](int n, int kk) -> float {
      if (n >= rows) return 0.f;
      const size_t o = (size_t)n * St2;
      return kk < St ? st.da_zr[o + St + kk] * sprev(n, kk) : st.sr[o + kk];
    };
    tile_product(acc, cand_in,
                 [&](int kk, int j) { return j < St ? w.w_h[(size_t)kk * St + j] : 0.f; }, i0,
                 j0, St2);
    store(acc, j0, St, [&](int n, int j, float v) {
      st.cand_in[(size_t)n * St2 + j] = cand_in(n, j);
      st.da_cand[(size_t)n * St + j] = activate<kTanh>(v);
    });
  }
}

template <int kStage>
__global__ void __launch_bounds__(kTileThreads) lstm_decoder_prepass_kernel(const BwdArgs a) {
  decoder_prepass<true, kStage>(a);
}

template <int kStage>
__global__ void __launch_bounds__(kTileThreads) gru_decoder_prepass_kernel(const BwdArgs a) {
  decoder_prepass<false, kStage>(a);
}

#ifdef FWD_WALK_BUILD
// ---------------------------------------------------------------------------
// K10, K14 (the LSTM) and K12, K4 (the GRU): the decoder forwards, a
// pre-pass and a walk on thread-block clusters (the file's head gives the
// step).

// T is the IO type of every input and output: float, or bf16 for K4's
// bf16 entry (the content-only GRU only). The pre-pass's tables and the
// walk's shared buffers are float either way.
template <class T>
struct FwdArgsT {
  const T *vh, *h, *mask, *yin;
  WeightsT<T> w;
  T *s_seq, *c_seq, *alpha_seq, *mem_seq;  // mem_seq: LSTM only
  Dims d;
};
using FwdArgs = FwdArgsT<float>;

// The pre-pass's outputs, carved from the caller's scratch in this order,
// each 16-byte aligned, G = kGates<kLstm>: Z, (B*T + A) rows of St ([c_b |
// yin] @ dec_w + dec_b for the B*T steps, then c_w @ dec_w[:St]); P, B*T
// rows of G St (Z's first B*T rows @ W_x, + b for the LSTM); W_cx^T, G St
// rows of A (Z's last A rows @ W_x, transposed); the s_prev products'
// weights transposed, G St rows of St: the LSTM's w_h^T, or the GRU's
// w_zr[:St]^T (2 St rows) then w_h[:St]^T (St rows). P's columns and the
// rows of W_cx^T are in unit order, the G gates of unit u at G u..G u + G
// - 1, and so are the LSTM's w_h^T and the GRU's w_zr[:St]^T (the update
// and reset gates of unit u at rows 2u, 2u + 1), so that a block's units
// are one run of each.
struct FwdScratch {
  float *z, *p, *wcx, *wh;
};

template <bool kLstm>
__host__ __device__ FwdScratch carve_fwd_scratch(float* base, const Dims& d, size_t* floats) {
  Carver c{base, 0};
  const long long rows = (long long)d.B * d.T, St = d.St, G = kGates<kLstm>;
  FwdScratch x{};
  x.z = take4(c, (rows + d.A) * St);
  x.p = take4(c, rows * G * St);
  x.wcx = take4(c, G * St * d.A);
  x.wh = take4(c, G * St * St);
  *floats = c.off;
  return x;
}

// The scratch's floats, as carve_fwd_scratch lays it out for `gates`
// gate columns a unit (4: the LSTM, 3: the GRU);
// ops/cuda/attention_scan.py (fwd_scratch_floats) computes the same.
long long fwd_scratch_floats(long long B, long long T, long long A, long long St,
                             long long gates) {
  return r4((B * T + A) * St) + r4(gates * B * T * St) + r4(gates * St * A) +
         r4(gates * St * St);
}

// The exchanges of a forward step, an mbarrier each: s_prev with the
// blocks' ws partials (E1), the softmax's shares (E2), and the GRU's
// reset gate times s_prev (E3).
constexpr int kBarsFwdLstm = 2, kBarsFwdGru = 3;
template <bool kLstm>
constexpr int kBarsFwd = kLstm ? kBarsFwdLstm : kBarsFwdGru;

// n or m, whichever is larger.
__host__ __device__ constexpr long long lmax(long long n, long long m) { return n > m ? n : m; }

// Shared memory of one block of the forward walk, in floats, for R batch
// rows on clusters of C blocks, loc 1 with the location term (else 0 and
// FM = F = 0), resident 1 where the block holds its rows of W_cx^T, lstm 1
// for the LSTM cell (else 0: the GRU). carve_fwd_walk lays it out, each
// buffer 16-byte aligned; the plan in ops/cuda/attention_scan.py
// (fwd_smem_bytes) computes the same.
long long fwd_smem_floats(long long R, long long C, long long L, long long S, long long A,
                          long long St, long long FM, long long F, long long loc,
                          long long resident, long long lstm) {
  return r4(2 * (lstm * kBarsFwdLstm + (1 - lstm) * kBarsFwdGru)) + 2 * r4(R * St) +
         r4(C * R * r4(S)) + r4(R * lmax(r4(S), (1 - lstm) * St)) + r4(C * R * r4(A + 2)) +
         r4(R * r4(A)) + r4(R * (C + 2)) + 3 * r4((3 + lstm) * R * cspan(St, C)) +
         lstm * r4(R * cspan(St, C)) + 2 * r4(R * cdiv(L, C)) + r4(S) + r4(cspan(St, C) * S) +
         resident * r4((3 + lstm) * cspan(St, C) * A) + (1 - loc) * r4(R * cdiv(L, C)) +
         loc * (3 * r4(R * (cdiv(L, C) + F - 1)) + r4(FM * S) + r4(F * FM) + r4(FM) +
                r4(kWarps * FM));
}

struct FwdWalkShared {
  unsigned long long* bars;  // [kBarsFwd]: E1 (s and the ws partials), E2 (the softmax's
                             // shares), E3 (the GRU's rg s_prev)
  float* sg;     // two [R][St]: s gathered from every block, step t's in buffer t & 1
  float* wsp;    // [C][R][Sp]  the blocks' partials of s_prev @ ws_w
  float* ws;     // [R][Sp]     s_prev @ ws_w + ws_b (the GRU's rs shares its floats)
  float* st;     // [C][R][Ap]  the blocks' shares: context partial [A], local max, local sum
  float* c;      // [R][Aq]     the context
  float* fz;     // [R][C + 2]  the blocks' scales exp(m_k - M), then max(z, 1e-30), then M
  float* g;      // [R][G Stc]  the gate pre-activations of the block's units, in unit order
                 //             (the GRU's update gate z in place of its first, once formed)
  float* pq;     // two [R][G Stc]: P of the block's units, staged a step ahead
  float* mem;    // [R][Stc]    the LSTM's cell state of the block's units
  float* rs;     // [R][St]     the GRU's rg s_prev gathered from every block (E3), in ws's
                 //             floats: ws is last read in the energies, before the block's
                 //             E2 push, which every peer's E3 push follows; and written
                 //             again after the block's E3 wait
  float *e, *p;  // [R][Pc]     the energies (NEG_INF where masked), exp(e - m_k)
  float* mw;     // [R][Pw]     the mask on the window (location term), or [R][Pc] on the positions
  float *ap, *eh;  // [R][Pw]   alpha_prev on the window, 0 off [0, L); the peers' energies there
  float* we;     // [S]         w_e
  float* wsw;    // [Stc][S]    the block's units' rows of ws_w
  float* wcx;    // [G Stc][A]  the block's rows of W_cx^T (resident plans only)
  float *u, *cw, *cb, *feat;  // U [FM][S], taps [F][FM], bias [FM], a warp's features [kWarps][FM]
  long long sgs, pqs;         // the second buffer of sg, of pq, is this many floats on
};

template <bool kLstm, bool kLoc>
__host__ __device__ FwdWalkShared carve_fwd_walk(float* sm, const Dims& d, int C, int R,
                                                 int resident, size_t* floats) {
  Carver c{sm, 0};
  const long long Stc = cspan(d.St, C), Pc = cdiv(d.L, C), Sp = r4(d.S), Pw = Pc + d.F - 1;
  const long long G = kGates<kLstm>;
  FwdWalkShared s{};
  s.bars = reinterpret_cast<unsigned long long*>(take4(c, 2 * kBarsFwd<kLstm>));
  s.sgs = r4((long long)R * d.St);
  s.sg = take4(c, 2 * s.sgs);
  s.wsp = take4(c, C * R * Sp);
  s.ws = take4(c, R * (kLstm ? Sp : lmax(Sp, d.St)));
  s.st = take4(c, C * R * r4(d.A + 2));
  s.c = take4(c, R * r4(d.A));
  s.fz = take4(c, (long long)R * (C + 2));
  s.g = take4(c, G * R * Stc);
  s.pqs = r4(G * R * Stc);
  s.pq = take4(c, 2 * s.pqs);
  if (kLstm)
    s.mem = take4(c, R * Stc);
  else
    s.rs = s.ws;
  s.e = take4(c, R * Pc);
  s.p = take4(c, R * Pc);
  s.we = take4(c, d.S);
  s.wsw = take4(c, Stc * d.S);
  if (resident) s.wcx = take4(c, G * Stc * d.A);
  if (kLoc) {
    s.mw = take4(c, R * Pw);
    s.ap = take4(c, R * Pw);
    s.eh = take4(c, R * Pw);
    s.u = take4(c, (long long)d.FM * d.S);
    s.cw = take4(c, (long long)d.F * d.FM);
    s.cb = take4(c, d.FM);
    s.feat = take4(c, (long long)kWarps * d.FM);
  } else {
    s.mw = take4(c, R * Pc);
  }
  *floats = c.off;
  return s;
}

// rows_dot<R, false, true> with kRows rows of w a warp at once (rows i,
// i + kWarps, ..., i + (kRows - 1) kWarps), every load of them issued
// before any is used. The forward walk streams its slices of the s_prev
// products' weights and W_cx^T from L2 every step, and a pass over a
// warp's rows costs about one round trip to L2: more rows a pass, fewer
// passes. The sums are rows_dot's, in the same order. A row past n reads
// row n - 1 again and is not emitted.
template <int R>
constexpr int kL2Rows = R <= 4 ? 4 : 2;

// Score units a lane of the forward walk's energies pass takes at once:
// their vh loads issued together, and with the location term their sums
// over the feature maps as independent chains. The sums are in the order
// of one unit at a time.
constexpr int kEnergyCols = 8;

template <int R, bool kRoundV = false, class Emit>
__device__ __forceinline__ void rows_dot_l2(const float* w, int ldw, int n, const float* v,
                                            int ldv, int m, Emit emit, bool vec) {
  constexpr int kRows = kL2Rows<R>;
  const auto vin = [](float y) { return kRoundV ? round_to<bf16>(y) : y; };
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += kRows * kWarps) {
    const float* wr[kRows];
    float s[kRows][R];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      wr[q] = w + (size_t)min(i + q * kWarps, n - 1) * ldw;
#pragma unroll
      for (int r = 0; r < R; ++r) s[q][r] = 0.f;
    }
    if (vec) {
#pragma unroll 2
      for (int j = 4 * lane; j < m; j += 128) {
        float4 x[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) x[q] = __ldg(reinterpret_cast<const float4*>(wr[q] + j));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float4 y = *reinterpret_cast<const float4*>(v + r * ldv + j);
          y = make_float4(vin(y.x), vin(y.y), vin(y.z), vin(y.w));
#pragma unroll
          for (int q = 0; q < kRows; ++q)
            s[q][r] = fmaf(x[q].w, y.w, fmaf(x[q].z, y.z, fmaf(x[q].y, y.y, fmaf(x[q].x, y.x,
                                                                                s[q][r]))));
        }
      }
    } else {
#pragma unroll 2
      for (int j = lane; j < m; j += 32) {
        float x[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) x[q] = __ldg(wr[q] + j);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float y = vin(v[r * ldv + j]);
#pragma unroll
          for (int q = 0; q < kRows; ++q) s[q][r] = fmaf(x[q], y, s[q][r]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      int rr;
      const float sum = reduce_rows<R>(s[q], rr);
      if (lane < R && i + q * kWarps < n) emit(i + q * kWarps, rr, sum);
    }
  }
}

// The forward walk of K10 (kLstm, kLoc), K14 (kLstm), K12 (kLoc) or K4
// for the R batch rows of this block's cluster (group blockIdx.x / C),
// after the pre-pass; x holds the pre-pass's outputs. Single buffers
// suffice for what E1's partials, E2 and E3 carry, and two for the
// gathered s, by causality. A block pushes step t + 1's E2 only after its
// E1 wait of step t + 1, which needs every peer's E1 push of step t, each
// made after that peer had read E2's shares (and E3's rg s_prev) of step t
// and summed E1's partials of step t. It pushes E1 of step t + 1 only
// after its E2 wait of step t + 1, which needs every peer's E2 push of
// step t + 1, made after that peer's ws sum of step t + 1; s_prev of step
// t + 1, which the peer reads until its update of step t + 1, is in the
// other buffer. It pushes E3 of step t + 1 only after its E2 wait of step
// t + 1, which needs every peer's E2 push of step t + 1, made after that
// peer had read E3's rg s_prev of step t in its candidate product. For the
// same reasons thread 0 arms an mbarrier's next phase as soon as it has
// seen one complete (no byte of the next phase can arrive before), and a
// bulk copy's source is read before the block writes it again (the peers'
// waits for those bytes precede the pushes that let the block go on).
// Rows past B have zero inputs, stay zero and write nothing.
//
// With bf16 IO (IO, K4's bf16 entry), as the JAX kernel with bf16 inputs:
// every input loads widened to float, every output stores rounded; the
// energies, the softmax, c and the s carry are float; each product reads
// its operand rounded to bf16: s_prev in E1's ws partials and the s_prev
// products, c (rounded where it is formed) in c @ W_cx, and rg s_prev
// (rounded where it is formed) in the candidate's product. The pre-pass's
// fold never forms cc or r, so they are not rounded (ops/cuda/
// attention_scan.py).
template <int R, bool kLstm, bool kLoc, class IO = float>
__device__ __forceinline__ void decoder_fwd_walk(float* sm, const FwdArgsT<IO>& a,
                                                 const FwdScratch& x, int resident) {
  constexpr int kG = kGates<kLstm>;
  cg::cluster_group cluster = cg::this_cluster();
  const Dims& d = a.d;
  const WalkCtx c(d, (int)cluster.num_blocks(), (int)cluster.block_rank(), R);
  const int C = c.C, k = c.k, b0 = c.b0, nrows = c.nrows, Stc = c.Stc, Pc = c.Pc, Sp = c.Sp;
  const Span &un = c.un, &ac = c.ac, &pos = c.pos;
  const int T = d.T, L = d.L, S = d.S, A = d.A, St = d.St, Sg = kG * St, FM = d.FM, F = d.F;
  // The block's gate rows (kG a unit) and their stride; the stride of a
  // row's softmax shares and of c.
  const int G = kG * un.n, Gc = kG * Stc, Ap = (int)r4(A + 2), Aq = (int)r4(A);
  // The window: alpha_prev's positions that the block's features read
  // (its own, [pad, pad + pos.n) in it), or without the location term its
  // own positions; nwin of them are needed.
  const int pad = kLoc ? c.pad : 0, Pw = kLoc ? c.Pw : Pc, wlo = pos.lo - pad;
  const int nwin = kLoc ? (pos.n > 0 ? pos.n + F - 1 : 0) : pos.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  size_t floats;
  const FwdWalkShared sh = carve_fwd_walk<kLstm, kLoc>(sm, d, C, R, resident, &floats);

  for (int i = tid; i < S; i += kThreads) sh.we[i] = to_f(a.w.w_e[i]);
  for (int i = tid; i < un.n * S; i += kThreads) sh.wsw[i] = to_f(a.w.ws_w[(size_t)un.lo * S + i]);
  if (resident)
    for (int i = tid; i < G * A; i += kThreads) sh.wcx[i] = x.wcx[(size_t)kG * un.lo * A + i];
  for (int i = tid; i < R * St; i += kThreads) sh.sg[sh.sgs + i] = 0.f;  // s_prev of step 0
  for (int i = tid; i < C * R * Sp; i += kThreads) sh.wsp[i] = 0.f;   // its ws partials
  if (kLstm)
    for (int i = tid; i < R * Stc; i += kThreads) sh.mem[i] = 0.f;
  for (int i = tid; i < R * Pc; i += kThreads) sh.e[i] = kNegInf;
  for (int idx = tid; idx < R * Pw; idx += kThreads) {
    const int r = idx / Pw, i = idx - r * Pw, l = wlo + i;
    const bool in = r < nrows && l >= 0 && l < L && (kLoc || i < pos.n);
    sh.mw[idx] = in ? to_f(a.mask[(size_t)(b0 + r) * L + l]) : 0.f;
    if (kLoc) sh.ap[idx] = 0.f;  // alpha_prev of step 0
  }
  if (kLoc) {
    for (int i = tid; i < FM * S; i += kThreads) sh.u[i] = to_f(a.w.u[i]);
    for (int i = tid; i < F * FM; i += kThreads) sh.cw[i] = to_f(a.w.wconv[i]);
    for (int i = tid; i < FM; i += kThreads) sh.cb[i] = to_f(a.w.bconv[i]);
  }
  // The bytes the peers push into this block a step, by exchange: with
  // the location term, the energies of the window's other positions.
  int halo = 0;
  if (kLoc && pos.n > 0) halo = min(wlo + nwin, L) - max(wlo, 0) - pos.n;
  const unsigned tx1 = 4u * R * (St - un.n) + 4u * R * Sp * (C - 1);
  const unsigned tx2 = 4u * R * Ap * (C - 1) + 4u * R * halo;
  const unsigned tx3 = 4u * R * (St - un.n);
  if (tid == 0) {
    for (int i = 0; i < kBarsFwd<kLstm>; ++i) mbar_init(&sh.bars[i]);
    mbar_init_fence();
    if (T > 1) mbar_expect(&sh.bars[0], tx1);
    mbar_expect(&sh.bars[1], tx2);
    if (!kLstm) mbar_expect(&sh.bars[2], tx3);
  }
  // P of the block's units of step t into staging buffer i, 16 bytes a
  // copy where every run is whole 16-byte groups (always for the LSTM's
  // four gates a unit; for the GRU's three where the units come in groups
  // of 4).
  const bool vec_p = kLstm || c.bulk;
  const auto stage = [&](int t, int i) {
    stage_async<R>(sh.pq + i * sh.pqs, Gc, x.p + ((size_t)b0 * T + t) * Sg + kG * un.lo,
                   (size_t)T * Sg, G, nrows, vec_p);
  };
  stage(0, 0);
  // The products' rows: St floats (the s_prev products) and A floats
  // (W_cx^T), carved 16-byte aligned.
  const bool vec_h = St % 4 == 0, vec_c = A % 4 == 0;
  cluster.sync();  // every block's mbarriers are armed before any push into it

  for (int t = 0; t < T; ++t) {
    const size_t n0 = (size_t)b0 * T + t;  // (row b0, step t)
    const float* sp = sh.sg + ((t + 1) & 1) * sh.sgs;  // s_prev
    float* sn = sh.sg + (t & 1) * sh.sgs;              // s of this step
    const float* q = sh.pq + (t & 1) * sh.pqs;
    copy_async_wait();
    __syncthreads();
    // The other buffer, last read in step t - 1.
    if (t + 1 < T) stage(t + 1, (t + 1) & 1);
    // [phase] staging wait
    if (t > 0) {
      walk_wait(&sh.bars[0], (t - 1) & 1);
      if (tid == 0 && t + 1 < T) mbar_expect(&sh.bars[0], tx1);
    }
    // [phase] E1 exchange
    // ws: the blocks' partials in rank order, then ws_b.
    for (int idx = tid; idx < R * S; idx += kThreads) {
      const int r = idx / S, sc = idx - r * S;
      float v = 0.f;
      for (int j = 0; j < C; ++j) v += sh.wsp[(j * R + r) * Sp + sc];
      sh.ws[r * Sp + sc] = v + to_f(a.w.ws_b[sc]);
    }
    __syncthreads();
    // The energies on the block's positions, a warp per (row, position):
    // e = w_e . tanh(vh + ws [+ feat U]), the features from alpha_prev
    // over the filter's window; NEG_INF where masked.
    for (int pr = warp; pr < nrows * pos.n; pr += kWarps) {
      const int r = pr / pos.n, pp = pr - r * pos.n;
      const IO* vr = a.vh + ((size_t)(b0 + r) * L + pos.lo + pp) * S;
      const float* wsr = sh.ws + r * Sp;
      const float* f = sh.feat + warp * FM;
      if constexpr (kLoc) {
        for (int qq = lane; qq < FM; qq += 32) {
          float v = 0.f;
          for (int j = 0; j < F; ++j) v = fmaf(sh.ap[r * Pw + pp + j], sh.cw[j * FM + qq], v);
          sh.feat[warp * FM + qq] = v + sh.cb[qq];
        }
        __syncwarp();
      }
      float acc = 0.f;
      for (int sc0 = lane; sc0 < S; sc0 += 32 * kEnergyCols) {
        float z[kEnergyCols], uf[kEnergyCols];
#pragma unroll
        for (int x = 0; x < kEnergyCols; ++x) {
          const int sc = sc0 + 32 * x;
          z[x] = sc < S ? ldg_f(vr + sc) + wsr[sc] : 0.f;
          uf[x] = 0.f;
        }
        if constexpr (kLoc) {
          for (int qq = 0; qq < FM; ++qq) {
            const float fq = f[qq], *uq = sh.u + qq * S + sc0;
#pragma unroll
            for (int x = 0; x < kEnergyCols; ++x)
              if (sc0 + 32 * x < S) uf[x] = fmaf(fq, uq[32 * x], uf[x]);
          }
        }
#pragma unroll
        for (int x = 0; x < kEnergyCols; ++x) {
          const int sc = sc0 + 32 * x;
          if (sc < S) acc = fmaf(fast_tanh(kLoc ? z[x] + uf[x] : z[x]), sh.we[sc], acc);
        }
      }
      if (kLoc) __syncwarp();  // f is rewritten for the warp's next position
      acc = warp_sum(acc);
      if (lane == 0) sh.e[r * Pc + pp] = sh.mw[r * Pw + pad + pp] > 0.f ? acc : kNegInf;
    }
    __syncthreads();
    // [phase] ws, energies
    // The block's softmax shares, a warp a row: the local max m_k (NEG_INF
    // where the block has no unmasked position), exp(e - m_k) times the
    // mask and its sum, then the context partial sum_l exp(e_l - m_k) h_l.
    if (warp < R) {
      const int r = warp;
      float m = kNegInf;
      for (int pp = lane; pp < pos.n; pp += 32) m = fmaxf(m, sh.e[r * Pc + pp]);
      m = warp_max(m);
      float z = 0.f;
      for (int pp = lane; pp < pos.n; pp += 32) {
        const float v = sh.mw[r * Pw + pad + pp] > 0.f ? expf(sh.e[r * Pc + pp] - m) : 0.f;
        sh.p[r * Pc + pp] = v;
        z += v;
      }
      z = warp_sum(z);
      if (lane == 0) {
        sh.st[(k * R + r) * Ap + A] = m;
        sh.st[(k * R + r) * Ap + A + 1] = z;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < R * A; idx += kThreads) {
      const int r = idx / A, j = idx - r * A;
      float v = 0.f;
      if (r < nrows) {
        const IO* hr = a.h + ((size_t)(b0 + r) * L + pos.lo) * A + j;
        for (int pp = 0; pp < pos.n; ++pp)
          v = fmaf(sh.p[r * Pc + pp], ldg_f(hr + (size_t)pp * A), v);
      }
      sh.st[(k * R + r) * Ap + j] = v;
    }
    async_fence();
    __syncthreads();
    // [phase] softmax shares
    // E2: the shares into every peer, a bulk copy each; with the location
    // term, the block's energies into each peer whose window holds them.
    for (int e = tid; e < C - 1; e += kThreads)
      bulk_copy(sh.st + k * R * Ap, 4u * R * Ap, e < k ? e : e + 1, &sh.bars[1]);
    if (kLoc && pos.n > 0)
      for (int j = 0; j < C; ++j) {
        const Span pj(L, C, j);
        if (j == k || pj.n == 0) continue;
        const int wj = pj.lo - pad;
        const int x0 = max(pos.lo, wj), nx = min(pos.lo + pos.n, wj + pj.n + F - 1) - x0;
        if (nx <= 0) continue;
        const unsigned bar = cluster_map(&sh.bars[1], j);
        for (int idx = tid; idx < R * nx; idx += kThreads) {
          const int r = idx / nx, xx = x0 + idx - r * nx;
          st_async(cluster_map(sh.eh + r * Pw + xx - wj, j), sh.e[r * Pc + xx - pos.lo], bar);
        }
      }
    // While E2 is on its way: s_prev's product + P on the block's gate
    // columns: the LSTM's s_prev @ w_h on every one; the GRU's s_prev @
    // w_zr[:St] on its update and reset columns (row i of the block's
    // w_zr^T is unit i / 2's gate i % 2, column 3 (i / 2) + i % 2), and P
    // alone on its candidate column.
    if constexpr (kLstm) {
      rows_dot_l2<R, kIsBf16<IO>>(x.wh + (size_t)4 * un.lo * St, St, G, sp, St, St,
                     [y = sh.g, add = q, Gc](int i, int r, float v) {
                       y[r * Gc + i] = v + add[r * Gc + i];
                     }, vec_h);
    } else {
      rows_dot_l2<R, kIsBf16<IO>>(x.wh + (size_t)2 * un.lo * St, St, 2 * un.n, sp, St, St,
                     [y = sh.g, add = q, Gc](int i, int r, float v) {
                       const int j = i + (i >> 1);
                       y[r * Gc + j] = v + add[r * Gc + j];
                     }, vec_h);
      for (int idx = tid; idx < R * un.n; idx += kThreads) {
        const int r = idx / un.n, j = r * Gc + 3 * (idx - r * un.n) + 2;
        sh.g[j] = q[j];
      }
    }
    walk_wait(&sh.bars[1], t & 1);
    if (tid == 0 && t + 1 < T) mbar_expect(&sh.bars[1], tx2);
    // [phase] s_prev product, E2 exchange
    // The softmax of the row, a warp a row: M = max m_k, each block's
    // scale exp(m_k - M), z = sum_k z_k exp(m_k - M) in rank order.
    if (warp < R) {
      const int r = warp;
      float* f = sh.fz + r * (C + 2);
      float m = kNegInf;
      for (int j = 0; j < C; ++j) m = fmaxf(m, sh.st[(j * R + r) * Ap + A]);
      if (lane < C) f[lane] = expf(sh.st[(lane * R + r) * Ap + A] - m);
      __syncwarp();
      if (lane == 0) {
        float z = 0.f;
        for (int j = 0; j < C; ++j) z = fmaf(sh.st[(j * R + r) * Ap + A + 1], f[j], z);
        f[C] = fmaxf(z, 1e-30f);
        f[C + 1] = m;
      }
    }
    __syncthreads();
    // c = sum_k exp(m_k - M) ctx_k / z in rank order; alpha on the block's
    // positions, and with the location term on its window, the next
    // step's alpha_prev.
    for (int idx = tid; idx < R * A; idx += kThreads) {
      const int r = idx / A, j = idx - r * A;
      const float* f = sh.fz + r * (C + 2);
      float v = 0.f;
      for (int kk = 0; kk < C; ++kk) v = fmaf(f[kk], sh.st[(kk * R + r) * Ap + j], v);
      v /= f[C];
      sh.c[r * Aq + j] = round_to<IO>(v);
      if (r < nrows && j >= ac.lo && j < ac.lo + ac.n)
        st_f(a.c_seq + (n0 + (size_t)r * T) * A + j, v);
    }
    for (int idx = tid; idx < R * Pw; idx += kThreads) {
      const int r = idx / Pw, i = idx - r * Pw, pp = i - pad;
      const bool own = pp >= 0 && pp < pos.n;
      float al = 0.f;
      if (i < nwin && sh.mw[idx] > 0.f) {  // mw: 0 off [0, L) and past the group's rows
        const float* f = sh.fz + r * (C + 2);
        al = expf((own ? sh.e[r * Pc + pp] : sh.eh[idx]) - f[C + 1]) / f[C];
      }
      if (own && r < nrows) st_f(a.alpha_seq + (n0 + (size_t)r * T) * L + pos.lo + pp, al);
      if (kLoc) sh.ap[idx] = al;
    }
    __syncthreads();
    // [phase] combine
    // The gates: + c @ W_cx on the block's gate columns.
    const auto add_cx = [y = sh.g, Gc](int i, int r, float v) { y[r * Gc + i] += v; };
    if (resident)
      rows_dot<R>(sh.wcx, A, G, sh.c, Aq, A, add_cx);
    else
      rows_dot_l2<R>(x.wcx + (size_t)kG * un.lo * A, A, G, sh.c, Aq, A, add_cx, vec_c);
    __syncthreads();
    // [phase] c W_cx
    if constexpr (kLstm) {
      // The LSTM cell on the block's units (gate order i, f, g, o).
      for (int idx = tid; idx < R * un.n; idx += kThreads) {
        const int r = idx / un.n, u = idx - r * un.n;
        const float* gr = sh.g + r * Gc + 4 * u;
        const float ig = sigmoid(gr[0]), fg = sigmoid(gr[1]), gg = tanhf(gr[2]);
        const float og = sigmoid(gr[3]);
        const float mv = fg * sh.mem[r * Stc + u] + ig * gg;
        const float sv = og * tanhf(mv);
        sh.mem[r * Stc + u] = mv;
        sn[r * St + un.lo + u] = sv;
        if (r < nrows) {
          const size_t o = (n0 + (size_t)r * T) * St + un.lo + u;
          st_f(a.s_seq + o, sv);
          st_f(a.mem_seq + o, mv);
        }
      }
      __syncthreads();
      // [phase] cell
    } else {
      // The GRU's gates on the block's units: z in place of its
      // pre-activation, and rg s_prev into the E3 buffer.
      for (int idx = tid; idx < R * un.n; idx += kThreads) {
        const int r = idx / un.n, u = idx - r * un.n, o = r * St + un.lo + u;
        float* gr = sh.g + r * Gc + 3 * u;
        gr[0] = sigmoid(gr[0]);
        sh.rs[o] = round_to<IO>(sigmoid(gr[1]) * sp[o]);
      }
      async_fence();
      __syncthreads();
      // [phase] gates
      // E3: the block's rg s_prev into every peer.
      push<R>(sh.rs, St, un.lo, 1, 0, un.n, &sh.bars[2], C, k, c.bulk);
      walk_wait(&sh.bars[2], t & 1);
      if (tid == 0 && t + 1 < T) mbar_expect(&sh.bars[2], tx3);
      // [phase] E3 exchange
      // The candidate's pre-activation: + (rg s_prev) @ w_h[:St] on the
      // block's candidate columns.
      rows_dot_l2<R>(x.wh + (size_t)(2 * St + un.lo) * St, St, un.n, sh.rs, St, St,
                     [y = sh.g, Gc](int i, int r, float v) { y[r * Gc + 3 * i + 2] += v; },
                     vec_h);
      __syncthreads();
      // [phase] candidate
      // s = (1 - z) s_prev + z tanh(the candidate's pre-activation).
      for (int idx = tid; idx < R * un.n; idx += kThreads) {
        const int r = idx / un.n, u = idx - r * un.n, o = r * St + un.lo + u;
        const float* gr = sh.g + r * Gc + 3 * u;
        const float z = gr[0], sv = (1.f - z) * sp[o] + z * tanhf(gr[2]);
        sn[o] = sv;
        if (r < nrows) st_f(a.s_seq + (n0 + (size_t)r * T) * St + un.lo + u, sv);
      }
      __syncthreads();
      // [phase] update
    }
    if (t + 1 < T) {
      // E1: the block's s and its partial s[own] @ ws_w[own, :], a thread
      // per (row, score unit), into every peer.
      for (int idx = tid; idx < R * S; idx += kThreads) {
        const int r = idx / S, sc = idx - r * S;
        const float* sr = sn + r * St + un.lo;
        float v = 0.f;
        for (int u = 0; u < un.n; ++u) v = fmaf(round_to<IO>(sr[u]), sh.wsw[u * S + sc], v);
        sh.wsp[(k * R + r) * Sp + sc] = v;
      }
      async_fence();
      __syncthreads();
      push<R>(sn, St, un.lo, 1, 0, un.n, &sh.bars[0], C, k, c.bulk);
      for (int e = tid; e < C - 1; e += kThreads)
        bulk_copy(sh.wsp + k * R * Sp, 4u * R * Sp, e < k ? e : e + 1, &sh.bars[0]);
    }
    // [phase] ws_w, E1 push
  }
  cluster.sync();  // no block leaves while its shared memory may still be a peer's target
}

#ifdef LSTM_FWD_ONLY
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    loc_lstm_fwd_kernel(const FwdArgs a, const FwdScratch x, int resident) {
  extern __shared__ __align__(16) float sm[];
  decoder_fwd_walk<R, true, true>(sm, a, x, resident);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    scan_lstm_fwd_kernel(const FwdArgs a, const FwdScratch x, int resident) {
  extern __shared__ __align__(16) float sm[];
  decoder_fwd_walk<R, true, false>(sm, a, x, resident);
}
#else
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    loc_gru_fwd_kernel(const FwdArgs a, const FwdScratch x, int resident) {
  extern __shared__ __align__(16) float sm[];
  decoder_fwd_walk<R, false, true>(sm, a, x, resident);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    content_gru_fwd_kernel(const FwdArgs a, const FwdScratch x, int resident) {
  extern __shared__ __align__(16) float sm[];
  decoder_fwd_walk<R, false, false>(sm, a, x, resident);
}

// K4's bf16 entry.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    content_gru_fwd_bf16_kernel(const FwdArgsT<bf16> a, const FwdScratch x, int resident) {
  extern __shared__ __align__(16) float sm[];
  decoder_fwd_walk<R, false, false, bf16>(sm, a, x, resident);
}
#endif

// The pre-pass over the B*T (row, step) pairs and the A rows of c_w, one
// 64 x 64 output tile a block, Sg = G St. Stage 0: Z = [c_b | yin] @ dec_w
// + dec_b for the pairs and c_w @ dec_w[:St] for c_w's rows; the extra row
// of blocks (blockIdx.y past Z's tiles) writes the s_prev products'
// weights transposed (FwdScratch gives their order), from Ws = w_h (the
// LSTM) or [w_zr[:St] | w_h[:St]] (the GRU), St x Sg. Stage 1: P = Z @ W_x
// (+ b for the LSTM) for the pairs, W_cx^T = (Z @ W_x)^T for c_w's rows,
// in unit order, W_x = w_x (the LSTM) or [w_zr[St:] | w_h[St:]] (the
// GRU), St x Sg. Each stage is a launch of its own, after the one it
// reads. With bf16 IO (T) the inputs load widened and the tables are
// float, as with float IO.
template <bool kLstm, int kStage, class T = float>
__device__ __forceinline__ void fwd_prepass(const FwdArgsT<T>& a, const FwdScratch& x) {
  constexpr int kG = kGates<kLstm>;
  const Dims& d = a.d;
  const WeightsT<T>& w = a.w;
  const int St = d.St, St2 = 2 * St, Sg = kG * St, A = d.A, rows = d.B * d.T, all = rows + A;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
  if constexpr (kStage == 0) {
    if ((int)blockIdx.y == (St + kTile - 1) / kTile) {
      const size_t n = (size_t)St * Sg;
      for (size_t e = (size_t)blockIdx.x * kTileThreads + threadIdx.x; e < n;
           e += (size_t)gridDim.x * kTileThreads) {
        const int kk = (int)(e / Sg), j = (int)(e - (size_t)kk * Sg), gi = j / St;
        const int u = j - gi * St;
        if constexpr (kLstm)
          x.wh[(size_t)(4 * u + gi) * St + kk] = to_f(w.w_h[e]);
        else if (gi < 2)
          x.wh[(size_t)(2 * u + gi) * St + kk] = to_f(w.w_zr[(size_t)kk * St2 + j]);
        else
          x.wh[(size_t)(St2 + u) * St + kk] = to_f(w.w_h[(size_t)kk * St + u]);
      }
      return;
    }
    tile_product(
        acc,
        [&](int n, int kk) -> float {
          if (n < rows) return to_f(kk < St ? w.c_b[kk] : a.yin[(size_t)n * St + kk - St]);
          return n < all && kk < St ? to_f(w.c_w[(size_t)(n - rows) * St + kk]) : 0.f;
        },
        [&](int kk, int j) { return j < St ? to_f(w.dec_w[(size_t)kk * St + j]) : 0.f; }, i0,
        j0, 2 * St);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = i0 + 4 * ty + r, j = j0 + 4 * tx + cc;
        if (n < all && j < St)
          x.z[(size_t)n * St + j] = acc[r][cc] + (n < rows ? to_f(w.dec_b[j]) : 0.f);
      }
  } else {
    tile_product(
        acc, [&](int n, int kk) { return n < all ? x.z[(size_t)n * St + kk] : 0.f; },
        [&](int kk, int j) -> float {
          if (j >= Sg) return 0.f;
          if constexpr (kLstm) return to_f(w.w_x[(size_t)kk * Sg + j]);
          return to_f(j < St2 ? w.w_zr[(size_t)(St + kk) * St2 + j]
                              : w.w_h[(size_t)(St + kk) * St + j - St2]);
        },
        i0, j0, St);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = i0 + 4 * ty + r, j = j0 + 4 * tx + cc, gi = j / St;
        const int col = kG * (j - gi * St) + gi;
        if (n >= all || j >= Sg) continue;
        if (n < rows)
          x.p[(size_t)n * Sg + col] = acc[r][cc] + (kLstm ? to_f(w.b[j]) : 0.f);
        else
          x.wcx[(size_t)col * A + n - rows] = acc[r][cc];
      }
  }
}

template <int kStage>
__global__ void __launch_bounds__(kTileThreads)
    lstm_fwd_prepass_kernel(const FwdArgs a, const FwdScratch x) {
  fwd_prepass<true, kStage>(a, x);
}

template <int kStage>
__global__ void __launch_bounds__(kTileThreads)
    gru_fwd_prepass_kernel(const FwdArgs a, const FwdScratch x) {
  fwd_prepass<false, kStage>(a, x);
}

template <int kStage>
__global__ void __launch_bounds__(kTileThreads)
    gru_fwd_prepass_bf16_kernel(const FwdArgsT<bf16> a, const FwdScratch x) {
  fwd_prepass<false, kStage, bf16>(a, x);
}

#endif

// ---------------------------------------------------------------------------
// Host side.

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool kLoc>
bool valid(const Dims& d) {
  return d.B >= 1 && d.T >= 1 && d.L >= 1 && d.S >= 1 && d.A >= 1 && d.St >= 1 &&
         (!kLoc || (d.FM >= 1 && d.F >= 1));
}

#ifdef FWD_WALK_BUILD
template <class T>
using FwdKernel = void (*)(const FwdArgsT<T>, const FwdScratch, int);

// The forward walk instance for R batch rows a cluster: K10's (kLstm,
// kLoc), K14's (kLstm), K12's (kLoc) or K4's, and with bf16 IO K4's bf16
// entry's.
template <bool kLstm, bool kLoc, class T = float>
FwdKernel<T> fwd_walk_kernel(int R) {
  static_assert(!kIsBf16<T> || (!kLstm && !kLoc), "bf16 IO: the content-only GRU only");
#ifdef LSTM_FWD_ONLY
  static_assert(kLstm, "this build holds the LSTM's forwards");
  if constexpr (kLoc)
    return R == 1 ? loc_lstm_fwd_kernel<1> : R == 2 ? loc_lstm_fwd_kernel<2>
         : R == 4 ? loc_lstm_fwd_kernel<4> : R == 8 ? loc_lstm_fwd_kernel<8> : nullptr;
  else
    return R == 1 ? scan_lstm_fwd_kernel<1> : R == 2 ? scan_lstm_fwd_kernel<2>
         : R == 4 ? scan_lstm_fwd_kernel<4> : R == 8 ? scan_lstm_fwd_kernel<8> : nullptr;
#else
  static_assert(!kLstm, "this build holds the GRU's forwards");
  if constexpr (kIsBf16<T>)
    return R == 1 ? content_gru_fwd_bf16_kernel<1> : R == 2 ? content_gru_fwd_bf16_kernel<2>
         : R == 4 ? content_gru_fwd_bf16_kernel<4> : R == 8 ? content_gru_fwd_bf16_kernel<8>
         : nullptr;
  else if constexpr (kLoc)
    return R == 1 ? loc_gru_fwd_kernel<1> : R == 2 ? loc_gru_fwd_kernel<2>
         : R == 4 ? loc_gru_fwd_kernel<4> : R == 8 ? loc_gru_fwd_kernel<8> : nullptr;
  else
    return R == 1 ? content_gru_fwd_kernel<1> : R == 2 ? content_gru_fwd_kernel<2>
         : R == 4 ? content_gru_fwd_kernel<4> : R == 8 ? content_gru_fwd_kernel<8> : nullptr;
#endif
}

// K10, K14, K12 and K4: the pre-pass (two launches: Z and the s_prev
// products' weights transposed, then P and W_cx^T), then the walk on
// clusters of `cluster` blocks, `rows` batch rows a cluster, holding W_cx's
// slice in shared memory where `resident`.
template <bool kLstm, bool kLoc, class T = float>
int launch_fwd_walk(const FwdArgsT<T>& a, float* scratch, int cluster, int rows, int resident,
                    cudaStream_t stream) {
  const Dims& d = a.d;
  const auto walk = fwd_walk_kernel<kLstm, kLoc, T>(rows);
  if (!valid<kLoc>(d) || walk == nullptr || cluster < 1 || cluster > kMaxWalkCluster ||
      (resident != 0 && resident != 1))
    return (int)cudaErrorInvalidValue;
  size_t floats, xfloats;
  carve_fwd_walk<kLstm, kLoc>(nullptr, d, cluster, rows, resident, &floats);
  if ((long long)floats !=
      fwd_smem_floats(rows, cluster, d.L, d.S, d.A, d.St, d.FM, d.F, kLoc, resident, kLstm))
    return (int)cudaErrorInvalidValue;  // layout and count disagree
  const FwdScratch x = carve_fwd_scratch<kLstm>(scratch, d, &xfloats);
  if ((long long)xfloats != fwd_scratch_floats(d.B, d.T, d.A, d.St, kGates<kLstm>))
    return (int)cudaErrorInvalidValue;
  const int tiles = (d.B * d.T + d.A + kTile - 1) / kTile;
  const dim3 grid[] = {dim3(tiles, (d.St + kTile - 1) / kTile + 1),
                       dim3(tiles, (kGates<kLstm> * d.St + kTile - 1) / kTile)};
  void (*stages[2])(const FwdArgsT<T>, const FwdScratch);
  if constexpr (kIsBf16<T>)
    stages[0] = gru_fwd_prepass_bf16_kernel<0>, stages[1] = gru_fwd_prepass_bf16_kernel<1>;
  else if constexpr (kLstm)
    stages[0] = lstm_fwd_prepass_kernel<0>, stages[1] = lstm_fwd_prepass_kernel<1>;
  else
    stages[0] = gru_fwd_prepass_kernel<0>, stages[1] = gru_fwd_prepass_kernel<1>;
  for (int i = 0; i < 2; ++i) {
    stages[i]<<<grid[i], kTileThreads, 0, stream>>>(a, x);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(walk, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int groups = (d.B + rows - 1) / rows;
  return (int)launch_cluster(walk, dim3(cluster * groups), cluster, floats * sizeof(float),
                             stream, a, x, resident);
}

// As walk_limits, for the forward walk.
template <bool kLstm, bool kLoc, class T = float>
int fwd_limits(int cluster, int* smem_limit, int* clusters) {
  if (cluster < 1 || cluster > kMaxWalkCluster) return (int)cudaErrorInvalidValue;
  const auto walk = fwd_walk_kernel<kLstm, kLoc, T>(8);
  cudaError_t err = cudaFuncSetAttribute(walk, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  return (int)cluster_limits(walk, cluster, smem_limit, clusters);
}
#endif

// The weight gradients; the cell's are the GRU's dw_zr and dw_h, or the
// LSTM's dw_h, dw_x and db.
struct Grads {
  float *dws_w, *dws_b, *dw_e, *dc_w, *dc_b, *ddec_w, *ddec_b;
  float *dw_zr, *dw_h, *dw_x, *db;
  float *dwconv, *dbconv, *du;
};

// The location term's weight gradients as column sums of `rows` rows of
// partials, in a fixed order: dU from pu, dwconv and dbconv from pconv;
// and first, where pwe is given, dw_e.
cudaError_t reduce_partials(const Stash& st, const Grads& g, const Dims& d, int rows, bool loc,
                            cudaStream_t stream) {
  const int FM = d.FM, F = d.F, n_conv = (F + 1) * FM, S = d.S;
  AtbBatch batch{};
  batch.rows = rows;
  batch.period = 1;
  if (st.pwe) batch.p[batch.count++] = AtbProblem{nullptr, 0, 0, st.pwe, S, nullptr, g.dw_e, 0, S};
  if (loc) {
    batch.p[batch.count++] =
        AtbProblem{nullptr, 0, 0, st.pu, FM * S, nullptr, g.du, 0, FM * S};
    batch.p[batch.count++] =
        AtbProblem{nullptr, 0, 0, st.pconv, n_conv, nullptr, g.dwconv, 0, F * FM};
    batch.p[batch.count++] =
        AtbProblem{nullptr, 0, 0, st.pconv + F * FM, n_conv, nullptr, g.dbconv, 0, FM};
  }
  return launch_atb(batch, stream);
}

#if !defined(CONTENT_GRU_BWD_ONLY) && !defined(FWD_WALK_BUILD)
// K13: the backward kernel, then the weight gradients over the B*T steps
// (s_prev = s_seq shifted by one) and dU, dwconv and dbconv as the sums
// of the B rows' partials.
int launch_gru_bwd(BwdArgs a, const Grads& g, float* scratch, cudaStream_t stream) {
  const Dims& d = a.d;
  if (!valid<true>(d)) return (int)cudaErrorInvalidValue;
  size_t floats;
  carve_bwd(nullptr, d, &floats);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = set_smem(scan_loc_gru_bwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  a.st = carve_stash<false, true>(scratch, d, 0);
  scan_loc_gru_bwd_kernel<<<d.B, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const Stash& st = a.st;
  const int St = d.St, St2 = 2 * St, S = d.S, A = d.A;
  AtbBatch steps{};
  steps.count = 6;
  steps.rows = d.B * d.T;
  steps.period = d.T;
  steps.p[0] = AtbProblem{a.s_seq, St, -1, st.dws, S, g.dws_w, g.dws_b, St, S};
  steps.p[1] = AtbProblem{a.c_seq, A, 0, st.dcc, St, g.dc_w, g.dc_b, A, St};
  steps.p[2] = AtbProblem{st.rr, St2, 0, st.dr, St, g.ddec_w, g.ddec_b, St2, St};
  steps.p[3] = AtbProblem{st.sr, St2, 0, st.da_zr, St2, g.dw_zr, nullptr, St2, St2};
  steps.p[4] = AtbProblem{st.cand_in, St2, 0, st.da_cand, St, g.dw_h, nullptr, St2, St};
  steps.p[5] = AtbProblem{nullptr, 0, 0, st.dwe, S, nullptr, g.dw_e, 0, S};
  err = launch_atb(steps, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(st, g, d, d.B, true, stream);
}
#endif

using BwdKernel = void (*)(const BwdArgs);

// The walk instance for R batch rows a cluster: K11's (kLstm, kLoc),
// K15's (kLstm) or K5's.
template <bool kLstm, bool kLoc>
BwdKernel walk_kernel(int R) {
  if constexpr (kLstm && kLoc)
    return R == 1 ? loc_lstm_bwd_kernel<1> : R == 2 ? loc_lstm_bwd_kernel<2>
         : R == 4 ? loc_lstm_bwd_kernel<4> : R == 8 ? loc_lstm_bwd_kernel<8> : nullptr;
  else if constexpr (kLstm)
    return R == 1 ? scan_lstm_bwd_kernel<1> : R == 2 ? scan_lstm_bwd_kernel<2>
         : R == 4 ? scan_lstm_bwd_kernel<4> : R == 8 ? scan_lstm_bwd_kernel<8> : nullptr;
  else
    return R == 1 ? content_gru_walk_kernel<1> : R == 2 ? content_gru_walk_kernel<2>
         : R == 4 ? content_gru_walk_kernel<4> : R == 8 ? content_gru_walk_kernel<8> : nullptr;
}

// The pre-pass: 64-row tiles of the B*T rows by 64-column tiles of
// [cc | ws], of r, then of the LSTM's gates, or of the GRU's gates and
// of its candidate.
template <bool kLstm>
cudaError_t launch_prepass(const BwdArgs& a, cudaStream_t stream) {
  const Dims& d = a.d;
  const int tiles = (d.B * d.T + kTile - 1) / kTile, cc_tiles = (d.St + kTile - 1) / kTile;
  const dim3 cc_ws(tiles, cc_tiles + (d.S + kTile - 1) / kTile), r(tiles, cc_tiles);
  const dim3 gates(tiles, ((kLstm ? 4 : 2) * d.St + kTile - 1) / kTile);
  BwdKernel stages[4];
  if constexpr (kLstm) {
    stages[0] = lstm_decoder_prepass_kernel<0>, stages[1] = lstm_decoder_prepass_kernel<1>;
    stages[2] = lstm_decoder_prepass_kernel<2>;
  } else {
    stages[0] = gru_decoder_prepass_kernel<0>, stages[1] = gru_decoder_prepass_kernel<1>;
    stages[2] = gru_decoder_prepass_kernel<2>, stages[3] = gru_decoder_prepass_kernel<3>;
  }
  const dim3 grid[] = {cc_ws, r, gates, r};
  for (int i = 0; i < (kLstm ? 3 : 4); ++i) {
    stages[i]<<<grid[i], kTileThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K11, K15 and K5: the pre-pass, the walk on clusters of `cluster`
// blocks, `rows` batch rows a cluster, then the weight gradients over the
// B*T steps and over the blocks' partials.
template <bool kLstm, bool kLoc>
int launch_walk_bwd(BwdArgs a, const Grads& g, float* scratch, int cluster, int rows,
                    cudaStream_t stream) {
  const Dims& d = a.d;
  const auto walk = walk_kernel<kLstm, kLoc>(rows);
  if (!valid<kLoc>(d) || walk == nullptr || cluster < 1 || cluster > kMaxWalkCluster)
    return (int)cudaErrorInvalidValue;
  size_t floats;
  carve_walk<kLstm, kLoc>(nullptr, d, cluster, rows, &floats);
  const long long counted = walk_smem_floats(rows, cluster, d.L, d.S, d.A, d.St, d.FM, d.F, kLoc,
                                             kLstm);
  if ((long long)floats != counted) return (int)cudaErrorInvalidValue;  // layout and count disagree
  const int groups = (d.B + rows - 1) / rows;
  a.st = carve_stash<kLstm, kLoc>(scratch, d, groups * cluster);
  cudaError_t err = launch_prepass<kLstm>(a, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(walk, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  err = launch_cluster(walk, dim3(cluster * groups), cluster, floats * sizeof(float), stream, a);
  if (err != cudaSuccess) return (int)err;

  const Stash& st = a.st;
  const int St = d.St, St2 = 2 * St, St4 = 4 * St, S = d.S, A = d.A;
  AtbBatch steps{};
  steps.count = 5;
  steps.rows = d.B * d.T;
  steps.period = d.T;
  steps.p[0] = AtbProblem{a.s_seq, St, -1, st.dws, S, g.dws_w, g.dws_b, St, S};
  steps.p[1] = AtbProblem{a.c_seq, A, 0, st.dcc, St, g.dc_w, g.dc_b, A, St};
  steps.p[2] = AtbProblem{st.rr, St2, 0, st.dr, St, g.ddec_w, g.ddec_b, St2, St};
  if (kLstm) {
    steps.p[3] = AtbProblem{a.s_seq, St, -1, st.dg, St4, g.dw_h, g.db, St, St4};
    steps.p[4] = AtbProblem{st.r, St, 0, st.dg, St4, g.dw_x, nullptr, St, St4};
  } else {
    steps.p[3] = AtbProblem{st.sr, St2, 0, st.da_zr, St2, g.dw_zr, nullptr, St2, St2};
    steps.p[4] = AtbProblem{st.cand_in, St2, 0, st.da_cand, St, g.dw_h, nullptr, St2, St};
  }
  err = launch_atb(steps, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(st, g, d, groups * cluster, kLoc, stream);
}

// The opt-in shared memory of a block of the walk and the clusters of
// `cluster` blocks (8, or 16: a non-portable size) of it that can be
// resident at once when each block takes that much.
template <bool kLstm, bool kLoc>
int walk_limits(int cluster, int* smem_limit, int* clusters) {
  if (cluster < 1 || cluster > kMaxWalkCluster) return (int)cudaErrorInvalidValue;
  const auto walk = walk_kernel<kLstm, kLoc>(8);
  cudaError_t err = cudaFuncSetAttribute(walk, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  return (int)cluster_limits(walk, cluster, smem_limit, clusters);
}

}  // namespace

// ---------------------------------------------------------------------------
// Entry points. The backward ones take ds_seq, dc_seq, dalpha_seq (and
// dmem_seq) as NULL where there is no cotangent; those of K11, K15 and K5
// take the walk's plan, `cluster` blocks a cluster and `rows` batch rows
// a cluster (1, 2, 4 or 8), from ops/cuda/attention_scan.py scan_plan,
// and the forwards (K10, K14, K12, K4) the forward walk's, with
// `resident` (W_cx's slice in shared memory), from fwd_plan, and a
// scratch of fwd_scratch_floats floats.

#if defined(LSTM_FWD_ONLY)
extern "C" int attention_decode_scan_loc_lstm_fwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_h, const float* w_x, const float* b, const float* wconv,
    const float* bconv, const float* u, float* s_seq, float* c_seq, float* alpha_seq,
    float* mem_seq, float* scratch, int B, int T, int L, int S, int A, int St, int FM, int F,
    int cluster, int rows, int resident, cudaStream_t stream) {
  const FwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, nullptr, w_h, w_x, b, wconv,
                          bconv, u},
                  s_seq, c_seq, alpha_seq, mem_seq, Dims{B, T, L, S, A, St, FM, F}};
  return launch_fwd_walk<true, true>(a, scratch, cluster, rows, resident, stream);
}

extern "C" int attention_decode_scan_loc_lstm_fwd_limits(int cluster, int* smem_limit,
                                                         int* clusters) {
  return fwd_limits<true, true>(cluster, smem_limit, clusters);
}

extern "C" int attention_decode_scan_lstm_fwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_h, const float* w_x, const float* b, float* s_seq,
    float* c_seq, float* alpha_seq, float* mem_seq, float* scratch, int B, int T, int L, int S,
    int A, int St, int cluster, int rows, int resident, cudaStream_t stream) {
  const FwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, nullptr, w_h, w_x, b, nullptr,
                          nullptr, nullptr},
                  s_seq, c_seq, alpha_seq, mem_seq, Dims{B, T, L, S, A, St, 0, 0}};
  return launch_fwd_walk<true, false>(a, scratch, cluster, rows, resident, stream);
}

extern "C" int attention_decode_scan_lstm_fwd_limits(int cluster, int* smem_limit, int* clusters) {
  return fwd_limits<true, false>(cluster, smem_limit, clusters);
}

#elif defined(GRU_FWD_ONLY)
extern "C" int attention_decode_scan_loc_fwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_zr, const float* w_h, const float* wconv,
    const float* bconv, const float* u, float* s_seq, float* c_seq, float* alpha_seq,
    float* scratch, int B, int T, int L, int S, int A, int St, int FM, int F, int cluster,
    int rows, int resident, cudaStream_t stream) {
  const FwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_zr, w_h, nullptr, nullptr,
                          wconv, bconv, u},
                  s_seq, c_seq, alpha_seq, nullptr, Dims{B, T, L, S, A, St, FM, F}};
  return launch_fwd_walk<false, true>(a, scratch, cluster, rows, resident, stream);
}

extern "C" int attention_decode_scan_loc_fwd_limits(int cluster, int* smem_limit, int* clusters) {
  return fwd_limits<false, true>(cluster, smem_limit, clusters);
}

extern "C" int attention_decode_scan_fwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_zr, const float* w_h, float* s_seq, float* c_seq,
    float* alpha_seq, float* scratch, int B, int T, int L, int S, int A, int St, int cluster,
    int rows, int resident, cudaStream_t stream) {
  const FwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_zr, w_h, nullptr, nullptr,
                          nullptr, nullptr, nullptr},
                  s_seq, c_seq, alpha_seq, nullptr, Dims{B, T, L, S, A, St, 0, 0}};
  return launch_fwd_walk<false, false>(a, scratch, cluster, rows, resident, stream);
}

extern "C" int attention_decode_scan_fwd_limits(int cluster, int* smem_limit, int* clusters) {
  return fwd_limits<false, false>(cluster, smem_limit, clusters);
}

// K4's bf16 entry: attention_decode_scan_fwd with every input and output
// bf16 (the scratch float).
extern "C" int attention_decode_scan_fwd_bf16(
    const bf16* vh, const bf16* h, const bf16* mask, const bf16* yin, const bf16* ws_w,
    const bf16* ws_b, const bf16* w_e, const bf16* c_w, const bf16* c_b, const bf16* dec_w,
    const bf16* dec_b, const bf16* w_zr, const bf16* w_h, bf16* s_seq, bf16* c_seq,
    bf16* alpha_seq, float* scratch, int B, int T, int L, int S, int A, int St, int cluster,
    int rows, int resident, cudaStream_t stream) {
  const FwdArgsT<bf16> a{vh, h, mask, yin,
                         WeightsT<bf16>{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_zr, w_h,
                                        nullptr, nullptr, nullptr, nullptr, nullptr},
                         s_seq, c_seq, alpha_seq, nullptr, Dims{B, T, L, S, A, St, 0, 0}};
  return launch_fwd_walk<false, false, bf16>(a, scratch, cluster, rows, resident, stream);
}

extern "C" int attention_decode_scan_fwd_bf16_limits(int cluster, int* smem_limit,
                                                     int* clusters) {
  return fwd_limits<false, false, bf16>(cluster, smem_limit, clusters);
}

#elif !defined(CONTENT_GRU_BWD_ONLY)
extern "C" int attention_decode_scan_loc_lstm_bwd_limits(int cluster, int* smem_limit,
                                                         int* clusters) {
  return walk_limits<true, true>(cluster, smem_limit, clusters);
}

extern "C" int attention_decode_scan_loc_lstm_bwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_h, const float* w_x, const float* b, const float* wconv,
    const float* bconv, const float* u, const float* s_seq, const float* c_seq,
    const float* alpha_seq, const float* mem_seq, const float* ds_seq, const float* dc_seq,
    const float* dalpha_seq, const float* dmem_seq, float* dvh, float* dh, float* dyin,
    float* dws_w, float* dws_b, float* dw_e, float* dc_w, float* dc_b, float* ddec_w,
    float* ddec_b, float* dw_h, float* dw_x, float* db, float* dwconv, float* dbconv, float* du,
    float* scratch, int B, int T, int L, int S, int A, int St, int FM, int F, int cluster,
    int rows, cudaStream_t stream) {
  const BwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, nullptr, w_h, w_x, b, wconv,
                          bconv, u},
                  s_seq, c_seq, alpha_seq, mem_seq, ds_seq, dc_seq, dalpha_seq, dmem_seq,
                  dvh, dh, dyin, Stash{}, Dims{B, T, L, S, A, St, FM, F}};
  const Grads g{dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, nullptr, dw_h, dw_x, db,
                dwconv, dbconv, du};
  return launch_walk_bwd<true, true>(a, g, scratch, cluster, rows, stream);
}

extern "C" int attention_decode_scan_loc_bwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_zr, const float* w_h, const float* wconv,
    const float* bconv, const float* u, const float* s_seq, const float* c_seq,
    const float* alpha_seq, const float* ds_seq, const float* dc_seq, const float* dalpha_seq,
    float* dvh, float* dh, float* dyin, float* dws_w, float* dws_b, float* dw_e, float* dc_w,
    float* dc_b, float* ddec_w, float* ddec_b, float* dw_zr, float* dw_h, float* dwconv,
    float* dbconv, float* du, float* scratch, int B, int T, int L, int S, int A, int St, int FM,
    int F, cudaStream_t stream) {
  const BwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_zr, w_h, nullptr, nullptr,
                          wconv, bconv, u},
                  s_seq, c_seq, alpha_seq, nullptr, ds_seq, dc_seq, dalpha_seq, nullptr,
                  dvh, dh, dyin, Stash{}, Dims{B, T, L, S, A, St, FM, F}};
  const Grads g{dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, dw_zr, dw_h, nullptr, nullptr,
                dwconv, dbconv, du};
  return launch_gru_bwd(a, g, scratch, stream);
}

extern "C" int attention_decode_scan_lstm_bwd_limits(int cluster, int* smem_limit, int* clusters) {
  return walk_limits<true, false>(cluster, smem_limit, clusters);
}

extern "C" int attention_decode_scan_lstm_bwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_h, const float* w_x, const float* b, const float* s_seq,
    const float* c_seq, const float* alpha_seq, const float* mem_seq, const float* ds_seq,
    const float* dc_seq, const float* dalpha_seq, const float* dmem_seq, float* dvh, float* dh,
    float* dyin, float* dws_w, float* dws_b, float* dw_e, float* dc_w, float* dc_b,
    float* ddec_w, float* ddec_b, float* dw_h, float* dw_x, float* db, float* scratch, int B,
    int T, int L, int S, int A, int St, int cluster, int rows, cudaStream_t stream) {
  const BwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, nullptr, w_h, w_x, b, nullptr,
                          nullptr, nullptr},
                  s_seq, c_seq, alpha_seq, mem_seq, ds_seq, dc_seq, dalpha_seq, dmem_seq,
                  dvh, dh, dyin, Stash{}, Dims{B, T, L, S, A, St, 0, 0}};
  const Grads g{dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, nullptr, dw_h, dw_x, db,
                nullptr, nullptr, nullptr};
  return launch_walk_bwd<true, false>(a, g, scratch, cluster, rows, stream);
}

#else
extern "C" int attention_decode_scan_bwd_limits(int cluster, int* smem_limit, int* clusters) {
  return walk_limits<false, false>(cluster, smem_limit, clusters);
}

extern "C" int attention_decode_scan_bwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_zr, const float* w_h, const float* s_seq,
    const float* c_seq, const float* alpha_seq, const float* ds_seq, const float* dc_seq,
    const float* dalpha_seq, float* dvh, float* dh, float* dyin, float* dws_w, float* dws_b,
    float* dw_e, float* dc_w, float* dc_b, float* ddec_w, float* ddec_b, float* dw_zr,
    float* dw_h, float* scratch, int B, int T, int L, int S, int A, int St, int cluster, int rows,
    cudaStream_t stream) {
  const BwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_zr, w_h, nullptr, nullptr,
                          nullptr, nullptr, nullptr},
                  s_seq, c_seq, alpha_seq, nullptr, ds_seq, dc_seq, dalpha_seq, nullptr,
                  dvh, dh, dyin, Stash{}, Dims{B, T, L, S, A, St, 0, 0}};
  const Grads g{dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, dw_zr, dw_h, nullptr, nullptr,
                nullptr, nullptr, nullptr};
  return launch_walk_bwd<false, false>(a, g, scratch, cluster, rows, stream);
}
#endif
