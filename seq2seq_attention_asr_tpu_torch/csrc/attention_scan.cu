// Teacher-forced content-attention GRU decoder scan: forward (kernel K4,
// entry point attention_decode_scan_fwd) and backward (kernel K5, entry
// point attention_decode_scan_bwd).
//
// Replaces the Pallas kernel attention_decode_scan
// (seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py): forward
// pallas_call :355 (_run_fwd :290, _fwd_kernel :165, _step_core :91),
// backward pallas_call :851 (_run_bwd :800, _bwd_kernel :376, _bwd_core
// :419). Plain PyTorch twins: ops/cuda/attention_scan.py
// attention_decode_scan_plain and attention_decode_scan_bwd_plain.
//
// What bounds them: the T steps are a chain, and every step reads the
// step's weights (about 2.6 MB at flagship width) and the row's vh and h
// (295 KB each at L = 144, S = A = 512) from L2, and computes L * S tanh
// of the energies. One block per batch row keeps the state and every
// intermediate of a step in shared memory, as the beam step K2 does
// (the step's pieces are shared with it, attention_common.cuh); vh and h
// do not fit in shared memory and are re-read each step. With one block
// per row a batch of 16 uses 16 SMs; batching rows per block or
// splitting a step over a cluster is the way past that.
//
// The backward walks t = T-1..0. It recomputes the step from s_prev (the
// saved s sequence shifted by one, zero at step 0) and the saved c, then
// backprops the GRU (gru_cell_bwd in attention_common.cuh, which the
// location-aware GRU scan's backward K13 shares), the decoder-input MLP,
// the context, the masked softmax and the energies as _bwd_core
// :506-573 does, with ds carried
// in shared memory. dvh and dh are summed over the steps in global
// memory, each row's slice by its own block. The nine weight gradients
// are sums over the B*T steps of outer products: the loop writes each
// step's operands (s_prev is read from s_seq, c from c_seq; rr, sr and
// cand_in are written) and cotangents (dws, dcc, dr, da_zr, da_cand, and
// the step's w_e partial sum_l tanh(z) de), and reduce_atb.cuh forms the
// products and the bias sums afterwards, deterministically.

#include "attention_common.cuh"
#include "reduce_atb.cuh"

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

// Per-step operands and cotangents the weight-gradient reduction reads,
// (B*T) rows each, carved from the caller's scratch in this order.
struct Stash {
  float *rr, *sr, *cand_in, *dws, *dcc, *dr, *da_zr, *da_cand, *dwe;
};

Stash carve_stash(float* p, const Dims& d) {
  const size_t rows = (size_t)d.B * d.T, St = d.St, S = d.S;
  Stash s;
  s.rr = p;
  s.sr = s.rr + rows * 2 * St;
  s.cand_in = s.sr + rows * 2 * St;
  s.dws = s.cand_in + rows * 2 * St;
  s.dcc = s.dws + rows * S;
  s.dr = s.dcc + rows * St;
  s.da_zr = s.dr + rows * St;
  s.da_cand = s.da_zr + rows * 2 * St;
  s.dwe = s.da_cand + rows * St;
  return s;
}

struct BwdArgs {
  const float *vh, *h, *mask, *yin;
  Weights w;
  const float *s_seq, *c_seq, *ds_seq, *dc_seq, *dalpha_seq;
  float *dvh, *dh, *dyin;
  Stash st;
  Dims d;
};

size_t bwd_floats(const Dims& d) {
  return step_floats(d) + 13 * (size_t)d.St + d.A + 2 * d.L + d.S + kWarps;
}

__global__ void __launch_bounds__(kThreads, 1) scan_gru_bwd_kernel(const BwdArgs a) {
  extern __shared__ float sm[];
  const Dims& d = a.d;
  const int b = blockIdx.x, St = d.St, St2 = 2 * d.St, A = d.A, L = d.L, S = d.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* p;
  const StepBufs m = carve_step(sm, d, &p);
  float* carry = p;             // [St]   ds carried to the previous step
  float* dsv = carry + St;      // [St]   ds of this step
  float* da_cand = dsv + St;    // [St]
  float* dcin = da_cand + St;   // [2St]  da_cand @ Wh^T
  float* da_zr = dcin + St2;    // [2St]
  float* dsr = da_zr + St2;     // [2St]  da_zr @ Wzr^T
  float* dr = dsr + St2;        // [St]
  float* drr = dr + St;         // [2St]  dr @ dec_w^T = dcc | dyin
  float* tmp = drr + St2;       // [St]   dws @ ws_w^T
  float* dc = tmp + St;         // [A]
  float* dal = dc + A;          // [L]    dalpha
  float* de = dal + L;          // [L]
  float* dws = de + L;          // [S]
  float* red = dws + S;         // [kWarps]
  const StepWeights w = a.w.step();
  const float* vhb = a.vh + (size_t)b * L * S;
  const float* hb = a.h + (size_t)b * L * A;
  float* dvhb = a.dvh + (size_t)b * L * S;
  float* dhb = a.dh + (size_t)b * L * A;

  load_row_constants(a.w, a.mask, m, d, b);
  for (int j = tid; j < St; j += kThreads) carry[j] = 0.f;
  for (int t = d.T - 1; t >= 0; --t) {
    const size_t n = (size_t)b * d.T + t;
    const bool last = t == d.T - 1;  // the first step of the walk writes dvh and dh
    for (int j = tid; j < St; j += kThreads) {
      const float v = t > 0 ? a.s_seq[(n - 1) * St + j] : 0.f;
      m.sp[j] = m.sr[j] = v;
      m.rin[St + j] = a.yin[n * St + j];
    }
    for (int j = tid; j < A; j += kThreads) m.xo[St + j] = a.c_seq[n * A + j];
    __syncthreads();
    // Recompute: alpha from s_prev, then the cell from the saved c.
    attend(w, m, vhb, 1, L, S, St);
    decoder_cell(w, m, 1, A, St);

    // The GRU.
    gru_cell_bwd(a.w.w_zr, a.w.w_h, m, a.ds_seq + n * St, carry,
                 GruGrads{dsv, da_cand, dcin, da_zr, dsr}, carry, dr, St);
    // The decoder-input MLP.
    matvec_t<1>(a.w.dec_w, St2, St, dr, 0, drr, 0);
    __syncthreads();
    for (int j = tid; j < St; j += kThreads) a.dyin[n * St + j] = drr[St + j];
    matvec_t<1>(a.w.c_w, A, St, drr, 0, dc, 0);
    __syncthreads();
    for (int j = tid; j < A; j += kThreads) dc[j] += a.dc_seq[n * A + j];
    __syncthreads();

    // The context: dalpha = h dc + dalpha_seq, dh += alpha dc^T.
    for (int l = warp; l < L; l += kWarps) {
      const float* hr = hb + (size_t)l * A;
      float acc = 0.f;
      for (int j = lane; j < A; j += 32) acc = fmaf(dc[j], hr[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) dal[l] = acc + a.dalpha_seq[n * L + l];
    }
    for (int j = tid; j < A; j += kThreads) {
      const float dcj = dc[j];
      for (int l = 0; l < L; ++l) {
        const float v = m.al[l] * dcj;
        float* o = dhb + (size_t)l * A + j;
        *o = last ? v : *o + v;
      }
    }
    __syncthreads();
    // The masked softmax.
    float part = 0.f;
    for (int l = tid; l < L; l += kThreads) part += dal[l] * m.al[l];
    const float dot = block_sum(part, red);
    for (int l = tid; l < L; l += kThreads) de[l] = m.al[l] * (dal[l] - dot);
    __syncthreads();
    // The energies: dz = de w_e (1 - tanh(z)^2), a thread per score unit.
    for (int s = tid; s < S; s += kThreads) {
      const float wsv = m.ws[s], wev = m.we[s];
      float gws = 0.f, gwe = 0.f;
      for (int l = 0; l < L; ++l) {
        const float av = fast_tanh(vhb[(size_t)l * S + s] + wsv);
        const float dz = de[l] * wev * (1.f - av * av);
        float* o = dvhb + (size_t)l * S + s;
        *o = last ? dz : *o + dz;
        gws += dz;
        gwe = fmaf(av, de[l], gwe);
      }
      dws[s] = gws;
      a.st.dwe[n * S + s] = gwe;
    }
    __syncthreads();
    matvec_t<1>(a.w.ws_w, St, S, dws, 0, tmp, 0);
    __syncthreads();
    for (int j = tid; j < St; j += kThreads) {
      carry[j] += tmp[j];
      a.st.dcc[n * St + j] = drr[j];
      a.st.dr[n * St + j] = dr[j];
      a.st.da_cand[n * St + j] = da_cand[j];
    }
    for (int j = tid; j < St2; j += kThreads) {
      a.st.rr[n * St2 + j] = m.rin[j];
      a.st.sr[n * St2 + j] = m.sr[j];
      a.st.cand_in[n * St2 + j] = m.rhr[j];
      a.st.da_zr[n * St2 + j] = da_zr[j];
    }
    for (int s = tid; s < S; s += kThreads) a.st.dws[n * S + s] = dws[s];
    __syncthreads();
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

extern "C" int attention_decode_scan_bwd(
    const float* vh, const float* h, const float* mask, const float* yin, const float* ws_w,
    const float* ws_b, const float* w_e, const float* c_w, const float* c_b, const float* dec_w,
    const float* dec_b, const float* w_zr, const float* w_h, const float* s_seq,
    const float* c_seq, const float* ds_seq, const float* dc_seq, const float* dalpha_seq,
    float* dvh, float* dh, float* dyin, float* dws_w, float* dws_b, float* dw_e, float* dc_w,
    float* dc_b, float* ddec_w, float* ddec_b, float* dw_zr, float* dw_h, float* scratch, int B,
    int T, int L, int S, int A, int St, cudaStream_t stream) {
  const Dims d{B, T, L, S, A, St};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  const size_t bytes = bwd_floats(d) * sizeof(float);
  cudaError_t err = set_smem(scan_gru_bwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const Stash st = carve_stash(scratch, d);
  const BwdArgs a{vh, h, mask, yin,
                  Weights{ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_zr, w_h},
                  s_seq, c_seq, ds_seq, dc_seq, dalpha_seq, dvh, dh, dyin, st, d};
  scan_gru_bwd_kernel<<<B, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // Weight gradients: sums over the B*T steps (s_prev = s_seq shifted by one).
  const int St2 = 2 * St;
  AtbBatch batch{};
  batch.count = 6;
  batch.rows = B * T;
  batch.period = T;
  batch.p[0] = AtbProblem{s_seq, St, -1, st.dws, S, dws_w, dws_b, St, S};
  batch.p[1] = AtbProblem{c_seq, A, 0, st.dcc, St, dc_w, dc_b, A, St};
  batch.p[2] = AtbProblem{st.rr, St2, 0, st.dr, St, ddec_w, ddec_b, St2, St};
  batch.p[3] = AtbProblem{st.sr, St2, 0, st.da_zr, St2, dw_zr, nullptr, St2, St2};
  batch.p[4] = AtbProblem{st.cand_in, St2, 0, st.da_cand, St, dw_h, nullptr, St2, St};
  batch.p[5] = AtbProblem{nullptr, 0, 0, st.dwe, S, nullptr, dw_e, 0, S};
  return (int)launch_atb(batch, stream);
}
