// One beam-search decoder step for all K hypotheses of a batch row:
// content attention, masked softmax, context, GRU cell, maxout -> linear
// readout and an f32 log_softmax, in one launch.
//
// Replaces the Pallas kernel fused_attention_step
// (seq2seq_attention_asr_tpu/ops/pallas/attention_step.py:371, _kernel
// :85, _apply_readout_fused :40; the step math is attention_scan.py
// _step_core :91) for the content-only GRU decoder. Plain PyTorch twin:
// ops/cuda/attention_step.py::fused_attention_step_plain.
//
// What bounds it: a step is a chain of dependent matrix-vector products
// (s -> Ws, alpha -> c -> c_in -> dec_in -> GRU gates -> candidate ->
// maxout -> linear) whose weights, about 4.4 MB at flagship width, are
// read from L2 for every step, and the K*L*S tanh of the energies. Bytes
// over compute: each weight is read once per block and used for all K
// hypotheses (K accumulators per thread), and vh and h are read once per
// batch row, not once per hypothesis, which is what the TPU kernel's
// design buys as well. One block per batch row keeps every intermediate
// in shared memory, so nothing but the outputs goes back to memory.
// With one block per row a small batch uses few SMs; spreading a step's
// matrix-vector products over a cluster of blocks is the way past the
// one-SM L2 rate.

#include <math.h>

#include <algorithm>

#include "attention_common.cuh"

namespace {

struct Args {
  const float *vh, *h, *mask, *yin, *sprev;
  const float *ws_w, *ws_b, *w_e, *c_w, *c_b, *dec_w, *dec_b, *w_zr, *w_h;
  const float *mo_w, *mo_b, *lin_w, *lin_b;
  float *alpha, *c, *s, *logp;
  int B, K, L, S, A, St, M, W, V;
};

__global__ void __launch_bounds__(kThreads, 1) attention_step_kernel(const Args a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int K = a.K, L = a.L, S = a.S, A = a.A, St = a.St, M = a.M, W = a.W, V = a.V;
  const int St2 = 2 * St, XO = St + A;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* sp = sm;                // [K][St]    s_prev
  float* ws = sp + K * St;       // [K][S]     s_prev @ Ws + b
  float* al = ws + K * S;        // [K][L]     energies, then alpha
  float* rin = al + K * L;       // [K][2St]   c_in(c) | yin
  float* sr = rin + K * St2;     // [K][2St]   s_prev | r
  float* zr = sr + K * St2;      // [K][2St]   z | reset gate
  float* rhr = zr + K * St2;     // [K][2St]   gate * s_prev | r
  float* xo = rhr + K * St2;     // [K][St+A]  s_new | c
  float* mop = xo + K * XO;      // [K][M*W]   maxout pre-activations
  float* mo = mop + K * M * W;   // [K][M]
  float* lg = mo + K * M;        // [K][V]     logits
  float* cand = lg + K * V;      // [K][St]
  float* we = cand + K * St;     // [S]
  float* msk = we + S;           // [L]
  float* scratch = msk + L;      // [kThreads * 4 * K]

  const size_t row = (size_t)b * K;
  for (int i = tid; i < K * St; i += kThreads) {
    const int k = i / St, j = i % St;
    const float v = a.sprev[(row + k) * St + j];
    sp[i] = v;
    sr[k * St2 + j] = v;
    rin[k * St2 + St + j] = a.yin[(row + k) * St + j];
  }
  for (int i = tid; i < S; i += kThreads) we[i] = a.w_e[i];
  for (int i = tid; i < L; i += kThreads) msk[i] = a.mask[(size_t)b * L + i];
  __syncthreads();

  const StepWeights w{a.ws_w, a.ws_b, a.c_w, a.c_b, a.dec_w, a.dec_b, a.w_zr, a.w_h};
  const StepBufs bufs{sp, ws, al, rin, sr, zr, rhr, xo, cand, we, msk, scratch};
  attend(w, bufs, a.vh + (size_t)b * L * S, K, L, S, St);
  context(bufs, a.h + (size_t)b * L * A, K, L, A, St);
  decoder_cell(w, bufs, K, A, St);
  for (int i = tid; i < K * St; i += kThreads) {
    const int k = i / St, j = i % St;
    a.s[(row + k) * St + j] = xo[k * XO + j];
  }

  // Readout: maxout over `W`-wide groups, linear, f32 log_softmax.
  matvec<kNone>(a.mo_w, a.mo_b, XO, M * W, xo, XO, mop, M * W, K, scratch);
  for (int i = tid; i < K * M; i += kThreads) {
    const int k = i / M, g = i % M;
    const float* grp = mop + k * M * W + g * W;
    float m = grp[0];
    for (int q = 1; q < W; ++q) m = fmaxf(m, grp[q]);
    mo[i] = m;
  }
  __syncthreads();
  matvec<kNone>(a.lin_w, a.lin_b, M, V, mo, M, lg, V, K, scratch);
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

  for (int i = tid; i < K * L; i += kThreads) a.alpha[row * L + i] = al[i];
  for (int i = tid; i < K * A; i += kThreads) {
    const int k = i / A, j = i % A;
    a.c[(row + k) * A + j] = xo[k * XO + St + j];
  }
}

}  // namespace

extern "C" int fused_attention_step(
    const float* vh, const float* h, const float* mask, const float* yin, const float* sprev,
    const float* ws_w, const float* ws_b, const float* w_e, const float* c_w, const float* c_b,
    const float* dec_w, const float* dec_b, const float* w_zr, const float* w_h,
    const float* mo_w, const float* mo_b, const float* lin_w, const float* lin_b,
    float* alpha, float* c, float* s, float* logp, int B, int K, int L, int S, int A, int St,
    int M, int W, int V, cudaStream_t stream) {
  if (B < 1 || K < 1 || K > kMaxK || L < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)K * (11 * St + S + L + A + M * W + M + V + 4 * kThreads) +
                        S + L;
  const size_t bytes = floats * sizeof(float);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(attention_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const Args a{vh,    h,     mask,  yin,   sprev, ws_w, ws_b, w_e, c_w, c_b, dec_w,
               dec_b, w_zr,  w_h,   mo_w,  mo_b,  lin_w, lin_b, alpha, c, s, logp,
               B,     K,     L,     S,     A,     St,   M,    W,   V};
  attention_step_kernel<<<B, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
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
