// One attention decoder step for one batch row (the math of
// attention_scan.py _step_core :91), in pieces used by the recompute of
// the location-aware GRU scan's backward K13 (attention_scan_loc_lstm.cu):
//
//   decoder_cell  r = dec_in(concat(c_in(c), yin)); the bias-free GRU on
//                 concat(s_prev, r), reset gate before the candidate
//                 product (cells.py:56-63)
//   gru_cell_bwd  the GRU cell's backward
//
// and the encoder mask's NEG_INF, which the beam steps (attention_step.cu)
// share.

#pragma once

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // ops/masking.py NEG_INF

struct StepWeights {
  const float *ws_w, *ws_b, *c_w, *c_b, *dec_w, *dec_b, *w_zr, *w_h;
};

// Shared-memory buffers of a step, each [K][width].
struct StepBufs {
  float* sp;       // [St]     s_prev
  float* ws;       // [S]      s_prev @ Ws + b
  float* al;       // [L]      energies, then alpha
  float* rin;      // [2St]    c_in(c) | yin
  float* sr;       // [2St]    s_prev | r
  float* zr;       // [2St]    update gate | reset gate
  float* rhr;      // [2St]    reset gate * s_prev | r (the candidate's input)
  float* xo;       // [St+A]   s_new | c
  float* cand;     // [St]     candidate
  float* we;       // [S]      w_e (not per row)
  float* msk;      // [L]      encoder mask (not per row)
  float* scratch;  // [kThreads * 4 * K]
};

// The decoder input and the GRU cell: from c (xo[:, St:]), yin (rin[:,
// St:]) and s_prev (sp and sr[:, :St]) to rin, sr, zr, rhr, cand and
// s_new (xo[:, :St]). Ends with a barrier.
__device__ void decoder_cell(const StepWeights& w, const StepBufs& m, int K, int A, int St) {
  const int St2 = 2 * St, XO = St + A;
  matvec<kNone>(w.c_w, w.c_b, A, St, m.xo + St, XO, m.rin, St2, K, m.scratch);
  matvec<kNone>(w.dec_w, w.dec_b, St2, St, m.rin, St2, m.sr + St, St2, K, m.scratch);
  matvec<kSigmoid>(w.w_zr, nullptr, St2, St2, m.sr, St2, m.zr, St2, K, m.scratch);
  for (int i = threadIdx.x; i < K * St; i += kThreads) {
    const int k = i / St, j = i % St;
    m.rhr[k * St2 + j] = m.zr[k * St2 + St + j] * m.sp[i];
    m.rhr[k * St2 + St + j] = m.sr[k * St2 + St + j];
  }
  __syncthreads();
  matvec<kTanh>(w.w_h, nullptr, St2, St, m.rhr, St2, m.cand, St, K, m.scratch);
  for (int i = threadIdx.x; i < K * St; i += kThreads) {
    const int k = i / St, j = i % St;
    const float zg = m.zr[k * St2 + j];
    m.xo[k * XO + j] = (1.f - zg) * m.sp[i] + zg * m.cand[i];
  }
  __syncthreads();
}

// Cotangent buffers of gru_cell_bwd, each in shared memory.
struct GruGrads {
  float* ds;       // [St]   the cotangent of s_new
  float* da_cand;  // [St]   of the candidate's pre-activation
  float* dcin;     // [2St]  da_cand @ w_h^T: of rhr = (reset gate * s_prev | r)
  float* da_zr;    // [2St]  of the gates' pre-activations
  float* dsr;      // [2St]  da_zr @ w_zr^T: of (s_prev | r)
};

// The backward of decoder_cell's GRU for one row (K = 1), the cell part
// of attention_scan.py _bwd_core :506-530: from the cotangent of s_new,
// ds = ds_in (a global row, or null for none) + carry, and the step's
// recomputed zr, cand and s_prev (bufs.sp), to the cell's part of the
// cotangent of s_prev (ds_prev; it may alias carry) and the cotangent of
// r (dr). The reset gate acts before the candidate product, so its
// cotangent is dcin[:St] * s_prev. The caller has passed a barrier since
// the recompute; ends with a barrier.
__device__ void gru_cell_bwd(const float* w_zr, const float* w_h, const StepBufs& m,
                             const float* ds_in, const float* carry, const GruGrads& g,
                             float* ds_prev, float* dr, int St) {
  const int tid = threadIdx.x, St2 = 2 * St;
  for (int j = tid; j < St; j += kThreads) {
    const float ds = (ds_in ? ds_in[j] : 0.f) + carry[j];
    const float cv = m.cand[j];
    g.ds[j] = ds;
    g.da_cand[j] = ds * m.zr[j] * (1.f - cv * cv);
  }
  __syncthreads();
  matvec_t<1>(w_h, St2, St, g.da_cand, 0, g.dcin, 0);
  __syncthreads();
  for (int j = tid; j < St; j += kThreads) {
    const float zg = m.zr[j], rg = m.zr[St + j], s = m.sp[j];
    const float dzg = g.ds[j] * (m.cand[j] - s);
    g.da_zr[j] = dzg * zg * (1.f - zg);
    g.da_zr[St + j] = g.dcin[j] * s * rg * (1.f - rg);
  }
  __syncthreads();
  matvec_t<1>(w_zr, St2, St2, g.da_zr, 0, g.dsr, 0);
  __syncthreads();
  for (int j = tid; j < St; j += kThreads) {
    ds_prev[j] = g.dsr[j] + g.dcin[j] * m.zr[St + j] + g.ds[j] * (1.f - m.zr[j]);
    dr[j] = g.dcin[St + j] + g.dsr[St + j];
  }
  __syncthreads();
}

}  // namespace
