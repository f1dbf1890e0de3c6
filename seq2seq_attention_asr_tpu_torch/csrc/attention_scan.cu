// Teacher-forced content-attention GRU decoder scan, forward (kernel K4,
// entry point attention_decode_scan_fwd). Its backward, K5 (entry point
// attention_decode_scan_bwd), is the <GRU, content> instance of the
// decoder backwards' cluster walk in attention_scan_loc_lstm.cu.
//
// Replaces the Pallas kernel attention_decode_scan
// (seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py): forward
// pallas_call :355 (_run_fwd :290, _fwd_kernel :165, _step_core :91).
// Plain PyTorch twin: ops/cuda/attention_scan.py
// attention_decode_scan_plain.
//
// What bounds it: the T steps are a chain, and every step reads the
// step's weights (about 2.6 MB at flagship width) and the row's vh and h
// (295 KB each at L = 144, S = A = 512) from L2, and computes L * S tanh
// of the energies. One block per batch row keeps the state and every
// intermediate of a step in shared memory, as the beam step K2 does
// (the step's pieces are shared with it, attention_common.cuh); vh and h
// do not fit in shared memory and are re-read each step. With one block
// per row a batch of 16 uses 16 SMs; batching rows per block or
// splitting a step over a cluster is the way past that.

#include "attention_common.cuh"

namespace {

struct Weights {
  const float *ws_w, *ws_b, *w_e, *c_w, *c_b, *dec_w, *dec_b, *w_zr, *w_h;
  __host__ __device__ StepWeights step() const {
    return StepWeights{ws_w, ws_b, c_w, c_b, dec_w, dec_b, w_zr, w_h};
  }
};

struct Dims {
  int B, T, L, S, A, St;
};

// Shared memory of the forward step for one row (K = 1), carved from `sm`.
__device__ StepBufs carve_step(float* sm, const Dims& d, float** end) {
  const int St = d.St;
  StepBufs m;
  m.sp = sm;
  m.ws = m.sp + St;
  m.al = m.ws + d.S;
  m.rin = m.al + d.L;
  m.sr = m.rin + 2 * St;
  m.zr = m.sr + 2 * St;
  m.rhr = m.zr + 2 * St;
  m.xo = m.rhr + 2 * St;
  m.cand = m.xo + St + d.A;
  m.we = m.cand + St;
  m.msk = m.we + d.S;
  m.scratch = m.msk + d.L;
  *end = m.scratch + kThreads * 4;
  return m;
}

size_t step_floats(const Dims& d) {
  return 11 * (size_t)d.St + 2 * d.S + 2 * d.L + d.A + kThreads * 4;
}

__device__ void load_row_constants(const Weights& w, const float* mask, const StepBufs& m,
                                   const Dims& d, int b) {
  for (int i = threadIdx.x; i < d.S; i += kThreads) m.we[i] = w.w_e[i];
  for (int i = threadIdx.x; i < d.L; i += kThreads) m.msk[i] = mask[(size_t)b * d.L + i];
}

struct FwdArgs {
  const float *vh, *h, *mask, *yin;
  Weights w;
  float *s_seq, *c_seq, *alpha_seq;
  Dims d;
};

__global__ void __launch_bounds__(kThreads, 1) scan_fwd_kernel(const FwdArgs a) {
  extern __shared__ float sm[];
  const Dims& d = a.d;
  const int b = blockIdx.x, St = d.St, A = d.A, L = d.L;
  float* end;
  const StepBufs m = carve_step(sm, d, &end);
  const StepWeights w = a.w.step();
  const float* vhb = a.vh + (size_t)b * L * d.S;
  const float* hb = a.h + (size_t)b * L * A;

  load_row_constants(a.w, a.mask, m, d, b);
  for (int j = threadIdx.x; j < St; j += kThreads) m.sp[j] = m.sr[j] = 0.f;
  for (int t = 0; t < d.T; ++t) {
    const size_t n = (size_t)b * d.T + t;
    for (int j = threadIdx.x; j < St; j += kThreads) m.rin[St + j] = a.yin[n * St + j];
    __syncthreads();
    attend(w, m, vhb, 1, L, d.S, St);
    context(m, hb, 1, L, A, St);
    decoder_cell(w, m, 1, A, St);
    for (int j = threadIdx.x; j < St; j += kThreads) {
      const float v = m.xo[j];
      a.s_seq[n * St + j] = v;
      m.sp[j] = m.sr[j] = v;
    }
    for (int j = threadIdx.x; j < A; j += kThreads) a.c_seq[n * A + j] = m.xo[St + j];
    for (int l = threadIdx.x; l < L; l += kThreads) a.alpha_seq[n * L + l] = m.al[l];
  }
}

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

bool valid(const Dims& d) {
  return d.B >= 1 && d.T >= 1 && d.L >= 1 && d.S >= 1 && d.A >= 1 && d.St >= 1;
}

}  // namespace

extern "C" int attention_decode_scan_fwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_zr, const float* w_h, float* s_seq, float* c_seq,
    float* alpha_seq, int B, int T, int L, int S, int A, int St, cudaStream_t stream) {
  const Dims d{B, T, L, S, A, St};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  const size_t bytes = step_floats(d) * sizeof(float);
  cudaError_t err = set_smem(scan_fwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const FwdArgs a{vh, h, mask, yin, Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_zr, w_h},
                  s_seq, c_seq, alpha_seq, d};
  scan_fwd_kernel<<<B, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}
