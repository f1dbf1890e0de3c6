// One attention decoder step for K rows of one batch row (the math of
// attention_scan.py _step_core :91), in pieces shared by
// the beam steps (attention_step.cu, K hypotheses) and the recompute of
// the location-aware GRU scan's backward K13 (attention_scan_loc_lstm.cu,
// K = 1), with the location term (attend_loc) and
// the LSTM cell (lstm_preacts, lstm_cell) of the location-aware / LSTM
// decoders, and the GRU cell's backward (gru_cell_bwd) of the
// location-aware GRU scan's backward kernel K13:
//
//   attend        ws = s_prev @ Ws + b; e = w_e . tanh(vh + ws); alpha =
//                 masked softmax of e (NEG_INF on padding, times the mask)
//   context       c = alpha^T h
//   decoder_cell  r = dec_in(concat(c_in(c), yin)); the bias-free GRU on
//                 concat(s_prev, r), reset gate before the candidate
//                 product (cells.py:56-63)
//
// vh and h (L*S and L*A floats per row, 295 KB each at L = 144 and
// flagship width) do not fit in shared memory: they are read from global
// memory (L2) in every step, once for all K rows.

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

// Masked softmax of the energies in bufs.al, in place, a warp per row
// (attention_scan.py:118-121). Ends with a barrier.
__device__ __forceinline__ void softmax_rows(const StepBufs& m, int K, int L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < K) {
    float* e = m.al + warp * L;
    float mx = kNegInf;
    for (int l = lane; l < L; l += 32) {
      const float v = m.msk[l] > 0.f ? e[l] : kNegInf;
      e[l] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float z = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float p = m.msk[l] > 0.f ? expf(e[l] - mx) : 0.f;
      e[l] = p;
      z += p;
    }
    z = fmaxf(warp_sum(z), 1e-30f);  // ops/masking.py: a row with no valid position gets 0
    for (int l = lane; l < L; l += 32) e[l] = e[l] / z;
  }
  __syncthreads();
}

// alpha into bufs.al from bufs.sp. The caller has loaded sp, we and msk
// and passed a barrier; ends with a barrier.
__device__ void attend(const StepWeights& w, const StepBufs& m, const float* vhb, int K, int L,
                       int S, int St) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  matvec<kNone>(w.ws_w, w.ws_b, St, S, m.sp, St, m.ws, S, K, m.scratch);

  // Energies: a warp per encoder position, vh read once for all K rows.
  for (int l = warp; l < L; l += kWarps) {
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
    const float* vr = vhb + (size_t)l * S;
#pragma unroll 4
    for (int s = lane; s < S; s += 32) {
      const float v = vr[s], wv = m.we[s];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k] = fmaf(fast_tanh(v + m.ws[k * S + s]), wv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        const float e = warp_sum(acc[k]);
        if (lane == 0) m.al[k * L + l] = e;
      }
    }
  }
  __syncthreads();
  softmax_rows(m, K, L);
}

// c[k] = alpha[k]^T h into bufs.xo[k][St:], h read once for all K rows.
// Ends with a barrier.
__device__ void context(const StepBufs& m, const float* hb, int K, int L, int A, int St) {
  const int XO = St + A;
  for (int j = threadIdx.x; j < A; j += kThreads) {
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
#pragma unroll 8
    for (int l = 0; l < L; ++l) {
      const float hv = hb[(size_t)l * A + j];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k] = fmaf(m.al[k * L + l], hv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) m.xo[k * XO + St + j] = acc[k];
  }
  __syncthreads();
}

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

// The location term of location-aware attention (attention_scan.py
// _location_term :62): feat = conv1d(alpha_prev) + b over FM feature
// maps, then UF = feat @ U into score space.
struct LocBufs {
  const float* ap;  // [K][L + F - 1]  alpha_prev, zero-padded as the reference pads
  const float* u;   // [FM][S]
  const float* cw;  // [F][FM]         conv taps
  const float* cb;  // [FM]            conv bias
  float* feat;      // [kWarps][K][FM] one position's features, per warp
  int F, FM;
};

// attend with the location term: e = w_e . tanh(vh + ws + UF). UF is
// never stored as (L, S): each warp forms the K x FM features of its
// position l and adds feat[k] . U[:, s] inside the energy loop. Same
// contract as attend; the caller has also loaded ap, u, cw and cb.
__device__ void attend_loc(const StepWeights& w, const StepBufs& m, const LocBufs& loc,
                           const float* vhb, int K, int L, int S, int St) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int LP = L + loc.F - 1, FM = loc.FM;
  matvec<kNone>(w.ws_w, w.ws_b, St, S, m.sp, St, m.ws, S, K, m.scratch);

  float* feat = loc.feat + warp * K * FM;
  for (int l = warp; l < L; l += kWarps) {
    for (int i = lane; i < K * FM; i += 32) {
      const int k = i / FM, q = i % FM;
      const float* a = loc.ap + k * LP + l;
      float f = 0.f;
      for (int j = 0; j < loc.F; ++j) f = fmaf(a[j], loc.cw[j * FM + q], f);
      feat[i] = f + loc.cb[q];
    }
    __syncwarp();
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
    const float* vr = vhb + (size_t)l * S;
    for (int s = lane; s < S; s += 32) {
      float uf[kMaxK];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) uf[k] = 0.f;
      for (int q = 0; q < FM; ++q) {
        const float uv = loc.u[q * S + s];
#pragma unroll
        for (int k = 0; k < kMaxK; ++k)
          if (k < K) uf[k] = fmaf(feat[k * FM + q], uv, uf[k]);
      }
      const float v = vr[s], wv = m.we[s];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k] = fmaf(fast_tanh(v + m.ws[k * S + s] + uf[k]), wv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        const float e = warp_sum(acc[k]);
        if (lane == 0) m.al[k * L + l] = e;
      }
    }
    __syncwarp();  // feat is rewritten for the warp's next position
  }
  __syncthreads();
  softmax_rows(m, K, L);
}

// The decoder input and the LSTM's gate pre-activations without
// peepholes (attention_scan.py _step_core :131-136): r as in
// decoder_cell, then gates = s_prev @ w_h + r @ w_x + b (concat(s_prev,
// r) @ concat(w_h, w_x) + b in two products), gate order (in, forget,
// cell, out), into gates ([K][4St], which may alias bufs.rin). s_prev is
// read from sr[:, :St], c from xo[:, St:]. Ends with a barrier.
__device__ void lstm_preacts(const StepWeights& w, const StepBufs& m, const float* w_h,
                             const float* w_x, const float* gb, float* gates, int K, int A,
                             int St) {
  const int St2 = 2 * St, St4 = 4 * St, XO = St + A;
  matvec<kNone>(w.c_w, w.c_b, A, St, m.xo + St, XO, m.rin, St2, K, m.scratch);
  matvec<kNone>(w.dec_w, w.dec_b, St2, St, m.rin, St2, m.sr + St, St2, K, m.scratch);
  matvec<kNone>(w_h, gb, St, St4, m.sr, St2, gates, St4, K, m.scratch);
  matvec<kNone, true>(w_x, nullptr, St, St4, m.sr + St, St2, gates, St4, K, m.scratch);
}

// The decoder input and the LSTM cell (attention_scan.py _step_core
// :131-141): lstm_preacts, then mem (the cell state, [K][St]) is updated
// in place and s_new goes to xo[:, :St]. Ends with a barrier.
__device__ void lstm_cell(const StepWeights& w, const StepBufs& m, const float* w_h,
                          const float* w_x, const float* gb, float* gates, float* mem, int K,
                          int A, int St) {
  const int St4 = 4 * St, XO = St + A;
  lstm_preacts(w, m, w_h, w_x, gb, gates, K, A, St);
  for (int i = threadIdx.x; i < K * St; i += kThreads) {
    const int k = i / St, j = i % St;
    const float* g = gates + k * St4;
    const float ig = activate<kSigmoid>(g[j]);
    const float fg = activate<kSigmoid>(g[St + j]);
    const float gg = tanhf(g[2 * St + j]);
    const float og = activate<kSigmoid>(g[3 * St + j]);
    const float c = fg * mem[i] + ig * gg;
    mem[i] = c;
    m.xo[k * XO + j] = og * tanhf(c);
  }
  __syncthreads();
}

}  // namespace
