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
