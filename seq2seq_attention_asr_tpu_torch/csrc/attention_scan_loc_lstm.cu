// Teacher-forced attention decoder scans with the location term or the
// LSTM cell, each a forward and a backward kernel over one templated
// body (scan_fwd<kLstm, kLoc>, scan_bwd<kLstm, kLoc>):
//
//   <LSTM, location>  K10 loc_lstm_fwd_kernel, K11 loc_lstm_bwd_kernel;
//                     entry points attention_decode_scan_loc_lstm_{fwd,bwd}
//   <GRU, location>   K12 scan_loc_gru_fwd_kernel, K13 scan_loc_gru_bwd_kernel;
//                     entry points attention_decode_scan_loc_{fwd,bwd}
//   <LSTM, content>   K14 scan_lstm_fwd_kernel, K15 scan_lstm_bwd_kernel;
//                     entry points attention_decode_scan_lstm_{fwd,bwd}
//
// Each instance's kernels are thin __global__ functions of their own, so
// that a profiler trace names which instance ran. The content-only GRU
// decoder's scan is K4/K5 (attention_scan.cu).
//
// They replace the Pallas kernels of
// seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py, whose forwards
// share pallas_call :355 (_run_fwd :290) and whose backwards are
// pallas_call :945 (_run_bwd_loc :891) for the location-aware ones and
// :851 (_run_bwd :800) for the content-only LSTM:
//   K10/K11  attention_decode_scan_loc_lstm :1292, _fwd_kernel_loc_lstm
//            :254, _bwd_kernel_loc_lstm :624;
//   K12/K13  attention_decode_scan_loc :984, _fwd_kernel_loc :219,
//            _bwd_kernel_loc :710;
//   K14/K15  attention_decode_scan_lstm :1226, _fwd_kernel_lstm :189,
//            _bwd_kernel_lstm :577;
// with _location_term :62, _step_core :91 and _bwd_core :419. Plain
// PyTorch twins: ops/cuda/attention_scan.py attention_decode_scan_{loc_lstm,
// loc,lstm}_plain and their _bwd_plain.
//
// What bounds them: the T steps are a chain, and every step reads the
// step's weights from L2: at the conv+BiLSTM recipe the LSTM's gates
// (w_h and w_x, 2 x 400 x 1600 floats), dec_in, c_in and Ws, about 7 MB;
// at the flagship's widths the GRU's w_zr and w_h, dec_in, c_in and Ws,
// about 2.6 MB. No SM holds them; the backward reads them twice (the
// recompute and the transposed products). One block per batch row keeps
// the state and every intermediate of a step in shared memory and runs
// the step from the pieces the beam step K8 uses (attention_common.cuh:
// attend or attend_loc, which forms the location features per encoder
// position and never stores UF; context; decoder_cell for the GRU;
// lstm_preacts, whose gates are s_prev @ w_h plus r @ w_x accumulated in
// place). With one block per row, a step's time is one SM's L2 read rate
// over those bytes; batching rows per block cuts the bytes but not that
// time, and splitting a step's products over a cluster of blocks is the
// way past it.
//
// The backward walks t = T-1..0. It recomputes the step from s_prev,
// mem_prev (LSTM) and alpha_prev (location term), the saved sequences
// shifted by one and zero at step 0, and the saved c, and takes alpha
// itself from the saved alpha sequence, so it runs no softmax; then it
// backprops the cell (the LSTM with the dmem chain carried in shared
// memory; the GRU through gru_cell_bwd, which K5 shares), the
// decoder-input MLP, the context, the masked softmax, the energies and
// the location term, whose input alpha_prev is the previous step's
// output: that cotangent is carried into step t-1. ds is carried in
// shared memory. dvh and dh are summed over the steps in global memory,
// each row's slice by its own block. The weight gradients of the step's
// products are sums of outer products over the B*T steps: the walk
// writes each step's operands and cotangents to a stash, and
// reduce_atb.cuh forms the products and the bias sums afterwards,
// deterministically, in one launch.
//
// The location term's weight gradients, dU, dwconv and dbconv, are sums
// over the B*T*L (step, encoder position) pairs. As the TPU kernel does
// (_bwd_kernel_loc :779-791, _bwd_kernel_loc_lstm :692-702), each block
// sums its own row's T*L pairs in the walk, so nothing of length T*L is
// stored. dU[:, sc] is summed in the energies pass by the thread that
// forms dz(l, sc), in registers over the step's L positions (FM more
// FMAs per (l, sc), as many as the UF recompute), and added to the row's
// partial once a step; where FM is above kLocQ or not a multiple of 4,
// in a pass of its own, kLocQ maps at a time. dwconv and dbconv are
// summed once the step's dfeat is in shared memory, a thread per entry,
// into the row's partial once a step. A second reduce_atb.cuh launch sums the B rows'
// partials in a fixed order. The step's dz goes to a per-row scratch of
// L*S floats (L2-resident) for the dfeat pass, whose warps run their
// lanes along sc. No shared-memory access of the walk is more than 2-way
// bank-conflicted (matvec_t's reads in common.cuh included), except
// matvec's stores of the recompute's products, 4 consecutive outputs a
// lane: 4-way, on about 10,000 floats a step.
//
// What bounds the walk now: about half of a step is the recompute and
// the cell's transposed products, which read the step's weights from L2
// as K5 does; most of the rest is the energies and dfeat passes, each
// L*S*FM multiply-adds in float32 on one SM, and the context's dh
// update, L*A loads and stores to L2.

#include "attention_common.cuh"
#include "reduce_atb.cuh"

namespace {

// The cell's weights are the GRU's w_zr (2St, 2St) and w_h (2St, St), or
// the LSTM's w_h, w_x (St, 4St) and b (4St); the location term's are null
// without it.
struct Weights {
  const float *ws_w, *ws_b, *w_e, *c_w, *c_b, *dec_w, *dec_b;
  const float *w_zr, *w_h, *w_x, *b;
  const float *wconv, *bconv, *u;
  __host__ __device__ StepWeights step() const {
    return StepWeights{ws_w, ws_b, c_w, c_b, dec_w, dec_b, w_zr, w_h};
  }
};

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

// The buffers of one step that the forward and the backward share (the
// GRU's zr, rhr and cand too).
template <bool kLstm>
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
  if (!kLstm) {
    m.zr = c.take(2 * St);
    m.rhr = c.take(2 * St);
    m.cand = c.take(St);
  }
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
// K10, K12, K14: the forward.

struct FwdArgs {
  const float *vh, *h, *mask, *yin;
  Weights w;
  float *s_seq, *c_seq, *alpha_seq, *mem_seq;  // mem_seq: LSTM only
  Dims d;
};

struct FwdShared {
  StepBufs m;
  LocShared loc;
  float *gates, *mem, *feat;
};

template <bool kLstm, bool kLoc>
__host__ __device__ FwdShared carve_fwd(float* sm, const Dims& d, size_t* floats) {
  Carver c{sm, 0};
  FwdShared s{};
  s.m = carve_step<kLstm>(c, d);
  if (kLstm) {
    s.gates = c.take(4 * d.St);
    s.mem = c.take(d.St);
  }
  s.loc = carve_loc<kLoc>(c, d);
  s.feat = kLoc ? c.take((size_t)kWarps * d.FM) : nullptr;
  s.m.scratch = c.take(kThreads * 4);
  *floats = c.off;
  return s;
}

template <bool kLstm, bool kLoc>
__device__ __forceinline__ void scan_fwd(float* sm, const FwdArgs& a) {
  const Dims& d = a.d;
  const int b = blockIdx.x, St = d.St, A = d.A, L = d.L, pad = d.F / 2;
  size_t floats;
  const FwdShared s = carve_fwd<kLstm, kLoc>(sm, d, &floats);
  const StepBufs& m = s.m;
  const StepWeights w = a.w.step();
  const float* vhb = a.vh + (size_t)b * L * d.S;
  const float* hb = a.h + (size_t)b * L * A;

  load_constants<kLoc>(a.w, a.mask, m, s.loc, d, b);
  for (int j = threadIdx.x; j < St; j += kThreads) {
    m.sp[j] = m.sr[j] = 0.f;
    if (kLstm) s.mem[j] = 0.f;
  }
  for (int t = 0; t < d.T; ++t) {
    const size_t n = (size_t)b * d.T + t;
    for (int j = threadIdx.x; j < St; j += kThreads) m.rin[St + j] = a.yin[n * St + j];
    __syncthreads();
    if constexpr (kLoc)
      attend_loc(w, m, LocBufs{s.loc.ap, s.loc.u, s.loc.cw, s.loc.cb, s.feat, d.F, d.FM}, vhb,
                 1, L, d.S, St);
    else
      attend(w, m, vhb, 1, L, d.S, St);
    context(m, hb, 1, L, A, St);
    if constexpr (kLstm)
      lstm_cell(w, m, a.w.w_h, a.w.w_x, a.w.b, s.gates, s.mem, 1, A, St);
    else
      decoder_cell(w, m, 1, A, St);
    for (int j = threadIdx.x; j < St; j += kThreads) {
      const float v = m.xo[j];
      a.s_seq[n * St + j] = v;
      if (kLstm) a.mem_seq[n * St + j] = s.mem[j];
      m.sp[j] = m.sr[j] = v;
    }
    for (int j = threadIdx.x; j < A; j += kThreads) a.c_seq[n * A + j] = m.xo[St + j];
    for (int l = threadIdx.x; l < L; l += kThreads) {
      a.alpha_seq[n * L + l] = m.al[l];
      if (kLoc) s.loc.ap[pad + l] = m.al[l];  // the next step's alpha_prev
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) loc_lstm_fwd_kernel(const FwdArgs a) {
  extern __shared__ float sm[];
  scan_fwd<true, true>(sm, a);
}

__global__ void __launch_bounds__(kThreads, 1) scan_loc_gru_fwd_kernel(const FwdArgs a) {
  extern __shared__ float sm[];
  scan_fwd<false, true>(sm, a);
}

__global__ void __launch_bounds__(kThreads, 1) scan_lstm_fwd_kernel(const FwdArgs a) {
  extern __shared__ float sm[];
  scan_fwd<true, false>(sm, a);
}

// ---------------------------------------------------------------------------
// K11, K13, K15: the backward.

// Per-step operands and cotangents the weight-gradient reductions read,
// carved from the caller's scratch in this order: (B*T) rows of rr (2St);
// for the LSTM r (St); for the GRU sr and cand_in (2St each); then dws
// (S), dcc (St), dr (St); for the LSTM dgates (4St), for the GRU da_zr
// (2St) and da_cand (St); the step's w_e partial (S); then, with the
// location term, per batch row: the step's dz (L*S, rewritten every
// step), and the row's partial sums of dU (FM*S) and of dwconv and dbconv
// ((F + 1) * FM).
struct Stash {
  float *rr, *r, *sr, *cand_in, *dws, *dcc, *dr, *dg, *da_zr, *da_cand, *dwe;
  float *dz, *pu, *pconv;
};

template <bool kLstm, bool kLoc>
Stash carve_stash(float* p, const Dims& d) {
  const size_t rows = (size_t)d.B * d.T, St = d.St, S = d.S;
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
  s.dwe = c.take(rows * S);
  if (kLoc) {
    s.dz = c.take((size_t)d.B * d.L * S);
    s.pu = c.take((size_t)d.B * d.FM * S);
    s.pconv = c.take((size_t)d.B * (d.F + 1) * d.FM);
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

struct BwdShared {
  StepBufs m;  // sp, ws, al (alpha), rin (cc | yin), sr (s_prev | r), xo (c at [St:]), we, msk;
               // the GRU's zr, rhr and cand
  LocShared loc;
  float *mp;                    // LSTM [St]   mem_prev
  float *gates, *dg;            // LSTM [4St]  gate pre-activations; their cotangents
  float *carry_m;               // LSTM [St]   dmem carried to the previous step
  GruGrads g;                   // GRU
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

template <bool kLstm, bool kLoc>
__host__ __device__ BwdShared carve_bwd(float* sm, const Dims& d, size_t* floats) {
  Carver c{sm, 0};
  const int St = d.St;
  BwdShared s{};
  // feat first, 16-byte aligned: with FM a multiple of 4 the energies
  // pass reads a position's maps as float4s.
  if (kLoc) s.feat = c.take((size_t)d.L * d.FM);
  s.m = carve_step<kLstm>(c, d);
  if (kLstm) {
    s.mp = c.take(St);
    s.gates = c.take(4 * St);
    s.dg = c.take(4 * St);
    s.carry_m = c.take(St);
  } else {
    s.g.ds = c.take(St);
    s.g.da_cand = c.take(St);
    s.g.dcin = c.take(2 * St);
    s.g.da_zr = c.take(2 * St);
    s.g.dsr = c.take(2 * St);
  }
  s.dsp = c.take(St);
  s.dr = c.take(St);
  s.drr = c.take(2 * St);
  s.tmp = c.take(St);
  s.carry_s = c.take(St);
  s.dc = c.take(d.A);
  s.dal = c.take(d.L);
  s.de = c.take(d.L);
  s.dws = c.take(d.S);
  s.loc = carve_loc<kLoc>(c, d);
  if (kLoc) {
    s.dfeat = c.take((size_t)d.L * d.FM);
    s.dal_carry = c.take(d.L);
  }
  s.red = c.take(kWarps);
  s.m.scratch = c.take(kThreads * 4);
  *floats = c.off;
  return s;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Positions (the context's dh and the energies pass) and score units (the
// dfeat pass) whose global loads a thread issues together, ahead of the
// arithmetic that uses them.
constexpr int kLocRows = 4, kLocCols = 8;

// Where the walk sums dU, from the shapes alone: with FM <= kLocQ and a
// multiple of 4, in the energies pass, in the registers of the thread
// that forms dz(l, sc) over the step's L positions; else in a pass of
// its own, kLocQ maps at a time; either way into the row's partial, read
// and written once a step.
__device__ __forceinline__ bool du_inline(const Dims& d) {
  return d.FM <= kLocQ && d.FM % 4 == 0;
}

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

// p[i], or 0 where the cotangent p is absent.
__device__ __forceinline__ float cot(const float* p, size_t i) { return p ? p[i] : 0.f; }

template <bool kLstm, bool kLoc>
__device__ __forceinline__ void scan_bwd(float* sm, const BwdArgs& a) {
  const Dims& d = a.d;
  const int b = blockIdx.x, St = d.St, St2 = 2 * St, St4 = 4 * St, A = d.A, L = d.L, S = d.S;
  const int FM = d.FM, F = d.F, pad = F / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  size_t floats;
  const BwdShared s = carve_bwd<kLstm, kLoc>(sm, d, &floats);
  const StepBufs& m = s.m;
  const StepWeights w = a.w.step();
  const float* vhb = a.vh + (size_t)b * L * S;
  const float* hb = a.h + (size_t)b * L * A;
  float* dvhb = a.dvh + (size_t)b * L * S;
  float* dhb = a.dh + (size_t)b * L * A;

  load_constants<kLoc>(a.w, a.mask, m, s.loc, d, b);
  for (int j = tid; j < St; j += kThreads) {
    s.carry_s[j] = 0.f;
    if (kLstm) s.carry_m[j] = 0.f;
  }
  // The location term's weight gradients over this row's pairs, in the
  // row's partials pu (dU) and pconv (dwconv, dbconv).
  const bool du_in = kLoc && du_inline(d);
  const int n_conv = (F + 1) * FM;
  float* dzb = kLoc ? a.st.dz + (size_t)b * L * S : nullptr;
  float* pub = kLoc ? a.st.pu + (size_t)b * FM * S : nullptr;
  float* pcb = kLoc ? a.st.pconv + (size_t)b * n_conv : nullptr;
  if (kLoc)
    for (int l = tid; l < L; l += kThreads) s.dal_carry[l] = 0.f;
  for (int t = d.T - 1; t >= 0; --t) {
    const size_t n = (size_t)b * d.T + t;
    const bool last = t == d.T - 1;  // the first step of the walk writes dvh and dh
    // The step's saved state: s_prev, mem_prev and alpha_prev (zero at
    // step 0), c and alpha.
    for (int j = tid; j < St; j += kThreads) {
      const float v = t > 0 ? a.s_seq[(n - 1) * St + j] : 0.f;
      m.sp[j] = m.sr[j] = v;
      if (kLstm) s.mp[j] = t > 0 ? a.mem_seq[(n - 1) * St + j] : 0.f;
      m.rin[St + j] = a.yin[n * St + j];
    }
    for (int j = tid; j < A; j += kThreads) m.xo[St + j] = a.c_seq[n * A + j];
    for (int l = tid; l < L; l += kThreads) {
      m.al[l] = a.alpha_seq[n * L + l];
      if (kLoc) s.loc.ap[pad + l] = t > 0 ? a.alpha_seq[(n - 1) * L + l] : 0.f;
    }
    __syncthreads();
    // [phase] load
    // Recompute ws, r and the cell (the LSTM's gates; the GRU's gates,
    // candidate and rhr); and the location features, as attend_loc forms
    // them.
    matvec<kNone>(w.ws_w, w.ws_b, St, S, m.sp, St, m.ws, S, 1, m.scratch);
    if constexpr (kLstm)
      lstm_preacts(w, m, a.w.w_h, a.w.w_x, a.w.b, s.gates, 1, A, St);
    else
      decoder_cell(w, m, 1, A, St);
    // [phase] recompute
    if (kLoc) {
      for (int i = tid; i < L * FM; i += kThreads) {
        const int l = i / FM, q = i % FM;
        float f = 0.f;
        for (int j = 0; j < F; ++j) f = fmaf(s.loc.ap[l + j], s.loc.cw[j * FM + q], f);
        s.feat[i] = f + s.loc.cb[q];
      }
    }
    if constexpr (kLstm) {
      // The LSTM: the gates, then their cotangents and the dmem chain.
      for (int j = tid; j < St; j += kThreads) {
        const float ig = sigmoid(s.gates[j]), fg = sigmoid(s.gates[St + j]);
        const float gg = tanhf(s.gates[2 * St + j]), og = sigmoid(s.gates[3 * St + j]);
        const float mprev = s.mp[j];
        const float tm = tanhf(fg * mprev + ig * gg);
        const float ds = cot(a.ds_seq, n * St + j) + s.carry_s[j];
        const float dm = ds * og * (1.f - tm * tm) + cot(a.dmem_seq, n * St + j) + s.carry_m[j];
        s.dg[j] = dm * gg * ig * (1.f - ig);
        s.dg[St + j] = dm * mprev * fg * (1.f - fg);
        s.dg[2 * St + j] = dm * ig * (1.f - gg * gg);
        s.dg[3 * St + j] = ds * tm * og * (1.f - og);
        s.carry_m[j] = dm * fg;
      }
      __syncthreads();
      matvec_t<1>(a.w.w_h, St, St4, s.dg, 0, s.dsp, 0);
      matvec_t<1>(a.w.w_x, St, St4, s.dg, 0, s.dr, 0);
      __syncthreads();
    } else {
      gru_cell_bwd(a.w.w_zr, a.w.w_h, m, a.ds_seq ? a.ds_seq + n * St : nullptr, s.carry_s,
                   s.g, s.dsp, s.dr, St);
    }
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

    // The context: dalpha = h dc + dalpha_seq (+ the carry from step t+1),
    // dh += alpha dc^T.
    for (int l = warp; l < L; l += kWarps) {
      const float* hr = hb + (size_t)l * A;
      float acc = 0.f;
      for (int j = lane; j < A; j += 32) acc = fmaf(s.dc[j], hr[j], acc);
      acc = warp_sum(acc);
      if (lane == 0)
        s.dal[l] = acc + cot(a.dalpha_seq, n * L + l) + (kLoc ? s.dal_carry[l] : 0.f);
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
    // z recomputed as attend or attend_loc forms it, the loads of
    // kLocRows positions issued together. With the location term, the
    // step's dz also goes to the row's scratch, and dU += feat^T dz.
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
          if constexpr (kLoc) {
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
          }
          const float av = fast_tanh(z);
          const float dz = s.de[l] * wev * (1.f - av * av);
          const size_t i = (size_t)l * S + sc;
          dvhb[i] = last ? dz : dv[r] + dz;
          if constexpr (kLoc) {
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
      } else if (kLoc) {
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
    if (kLoc) {
      // dfeat = dz @ U^T: a warp per position, its lanes along sc (the
      // reads of dz coalesced, kLocCols of them issued together; those of
      // U conflict-free), kLocQ maps at a time.
      for (int l = warp; l < L; l += kWarps) {
        const float* dzl = dzb + (size_t)l * S;
        for (int q0 = 0; q0 < FM; q0 += kLocQ) {
          float acc[kLocQ] = {};
          for (int sc0 = lane; sc0 < S; sc0 += 32 * kLocCols) {
            float z[kLocCols];
#pragma unroll
            for (int g = 0; g < kLocCols; ++g) z[g] = sc0 + 32 * g < S ? dzl[sc0 + 32 * g] : 0.f;
#pragma unroll
            for (int g = 0; g < kLocCols; ++g) {
              const int sc = sc0 + 32 * g;
              if (sc >= S) break;
#pragma unroll
              for (int k = 0; k < kLocQ; ++k)
                if (q0 + k < FM) acc[k] = fmaf(z[g], s.loc.u[(q0 + k) * S + sc], acc[k]);
            }
          }
          const float v = warp_sum16(acc, lane);
          const int q = q0 + (lane >> 1);
          if (!(lane & 1) && q < FM) s.dfeat[l * FM + q] = v;
        }
      }
      __syncthreads();
      // [phase] dfeat
      // The cotangent of alpha_prev, for step t-1: alpha_prev[k] enters
      // feat[l] through tap j = k + pad - l. A warp per k, its lanes
      // along the taps' (j, q): the rows of dfeat it reads are adjacent.
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
    }
    matvec_t<1>(w.ws_w, St, S, s.dws, 0, s.tmp, 0);
    __syncthreads();
    // [phase] carry, conv, ws_w^T
    for (int j = tid; j < St; j += kThreads) {
      s.carry_s[j] = s.dsp[j] + s.tmp[j];
      a.st.dcc[n * St + j] = s.drr[j];
      a.st.dr[n * St + j] = s.dr[j];
      if (kLstm) a.st.r[n * St + j] = m.sr[St + j];
      else a.st.da_cand[n * St + j] = s.g.da_cand[j];
    }
    for (int j = tid; j < St2; j += kThreads) {
      a.st.rr[n * St2 + j] = m.rin[j];
      if (!kLstm) {
        a.st.sr[n * St2 + j] = m.sr[j];
        a.st.cand_in[n * St2 + j] = m.rhr[j];
        a.st.da_zr[n * St2 + j] = s.g.da_zr[j];
      }
    }
    if (kLstm)
      for (int j = tid; j < St4; j += kThreads) a.st.dg[n * St4 + j] = s.dg[j];
    for (int sc = tid; sc < S; sc += kThreads) a.st.dws[n * S + sc] = s.dws[sc];
    __syncthreads();
    // [phase] stash
  }
}

__global__ void __launch_bounds__(kThreads, 1) loc_lstm_bwd_kernel(const BwdArgs a) {
  extern __shared__ float sm[];
  scan_bwd<true, true>(sm, a);
}

__global__ void __launch_bounds__(kThreads, 1) scan_loc_gru_bwd_kernel(const BwdArgs a) {
  extern __shared__ float sm[];
  scan_bwd<false, true>(sm, a);
}

__global__ void __launch_bounds__(kThreads, 1) scan_lstm_bwd_kernel(const BwdArgs a) {
  extern __shared__ float sm[];
  scan_bwd<true, false>(sm, a);
}

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

template <bool kLstm, bool kLoc>
int launch_fwd(void (*kernel)(const FwdArgs), const FwdArgs& a, cudaStream_t stream) {
  if (!valid<kLoc>(a.d)) return (int)cudaErrorInvalidValue;
  size_t floats;
  carve_fwd<kLstm, kLoc>(nullptr, a.d, &floats);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.d.B, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The weight gradients; the cell's are the GRU's dw_zr and dw_h, or the
// LSTM's dw_h, dw_x and db.
struct Grads {
  float *dws_w, *dws_b, *dw_e, *dc_w, *dc_b, *ddec_w, *ddec_b;
  float *dw_zr, *dw_h, *dw_x, *db;
  float *dwconv, *dbconv, *du;
};

// The backward kernel, then the weight gradients over the B*T steps
// (s_prev = s_seq shifted by one) and, with the location term, dU,
// dwconv and dbconv as the sums of the B rows' partials.
template <bool kLstm, bool kLoc>
int launch_bwd(void (*kernel)(const BwdArgs), BwdArgs a, const Grads& g, float* scratch,
               cudaStream_t stream) {
  const Dims& d = a.d;
  if (!valid<kLoc>(d)) return (int)cudaErrorInvalidValue;
  size_t floats;
  carve_bwd<kLstm, kLoc>(nullptr, d, &floats);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  a.st = carve_stash<kLstm, kLoc>(scratch, d);
  kernel<<<d.B, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const Stash& st = a.st;
  const int St = d.St, St2 = 2 * St, St4 = 4 * St, S = d.S, A = d.A;
  AtbBatch steps{};
  steps.count = 6;
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
  steps.p[5] = AtbProblem{nullptr, 0, 0, st.dwe, S, nullptr, g.dw_e, 0, S};
  err = launch_atb(steps, stream);
  if (err != cudaSuccess || !kLoc) return (int)err;
  const int FM = d.FM, F = d.F, n_conv = (F + 1) * FM;
  AtbBatch loc{};
  loc.count = 3;
  loc.rows = d.B;
  loc.period = 1;
  loc.p[0] = AtbProblem{nullptr, 0, 0, st.pu, FM * S, nullptr, g.du, 0, FM * S};
  loc.p[1] = AtbProblem{nullptr, 0, 0, st.pconv, n_conv, nullptr, g.dwconv, 0, F * FM};
  loc.p[2] = AtbProblem{nullptr, 0, 0, st.pconv + F * FM, n_conv, nullptr, g.dbconv, 0, FM};
  return (int)launch_atb(loc, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// Entry points. The backward ones take ds_seq, dc_seq, dalpha_seq (and
// dmem_seq) as NULL where there is no cotangent.

extern "C" int attention_decode_scan_loc_lstm_fwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_h, const float* w_x, const float* b, const float* wconv,
    const float* bconv, const float* u, float* s_seq, float* c_seq, float* alpha_seq,
    float* mem_seq, int B, int T, int L, int S, int A, int St, int FM, int F,
    cudaStream_t stream) {
  const FwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, nullptr, w_h, w_x, b, wconv,
                          bconv, u},
                  s_seq, c_seq, alpha_seq, mem_seq, Dims{B, T, L, S, A, St, FM, F}};
  return launch_fwd<true, true>(loc_lstm_fwd_kernel, a, stream);
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
    float* scratch, int B, int T, int L, int S, int A, int St, int FM, int F,
    cudaStream_t stream) {
  const BwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, nullptr, w_h, w_x, b, wconv,
                          bconv, u},
                  s_seq, c_seq, alpha_seq, mem_seq, ds_seq, dc_seq, dalpha_seq, dmem_seq,
                  dvh, dh, dyin, Stash{}, Dims{B, T, L, S, A, St, FM, F}};
  const Grads g{dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, nullptr, dw_h, dw_x, db,
                dwconv, dbconv, du};
  return launch_bwd<true, true>(loc_lstm_bwd_kernel, a, g, scratch, stream);
}

extern "C" int attention_decode_scan_loc_fwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_zr, const float* w_h, const float* wconv,
    const float* bconv, const float* u, float* s_seq, float* c_seq, float* alpha_seq, int B,
    int T, int L, int S, int A, int St, int FM, int F, cudaStream_t stream) {
  const FwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_zr, w_h, nullptr, nullptr,
                          wconv, bconv, u},
                  s_seq, c_seq, alpha_seq, nullptr, Dims{B, T, L, S, A, St, FM, F}};
  return launch_fwd<false, true>(scan_loc_gru_fwd_kernel, a, stream);
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
  return launch_bwd<false, true>(scan_loc_gru_bwd_kernel, a, g, scratch, stream);
}

extern "C" int attention_decode_scan_lstm_fwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_h, const float* w_x, const float* b, float* s_seq,
    float* c_seq, float* alpha_seq, float* mem_seq, int B, int T, int L, int S, int A, int St,
    cudaStream_t stream) {
  const FwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, nullptr, w_h, w_x, b, nullptr,
                          nullptr, nullptr},
                  s_seq, c_seq, alpha_seq, mem_seq, Dims{B, T, L, S, A, St, 0, 0}};
  return launch_fwd<true, false>(scan_lstm_fwd_kernel, a, stream);
}

extern "C" int attention_decode_scan_lstm_bwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_h, const float* w_x, const float* b, const float* s_seq,
    const float* c_seq, const float* alpha_seq, const float* mem_seq, const float* ds_seq,
    const float* dc_seq, const float* dalpha_seq, const float* dmem_seq, float* dvh, float* dh,
    float* dyin, float* dws_w, float* dws_b, float* dw_e, float* dc_w, float* dc_b,
    float* ddec_w, float* ddec_b, float* dw_h, float* dw_x, float* db, float* scratch, int B,
    int T, int L, int S, int A, int St, cudaStream_t stream) {
  const BwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, nullptr, w_h, w_x, b, nullptr,
                          nullptr, nullptr},
                  s_seq, c_seq, alpha_seq, mem_seq, ds_seq, dc_seq, dalpha_seq, dmem_seq,
                  dvh, dh, dyin, Stash{}, Dims{B, T, L, S, A, St, 0, 0}};
  const Grads g{dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, nullptr, dw_h, dw_x, db,
                nullptr, nullptr, nullptr};
  return launch_bwd<true, false>(scan_lstm_bwd_kernel, a, g, scratch, stream);
}
