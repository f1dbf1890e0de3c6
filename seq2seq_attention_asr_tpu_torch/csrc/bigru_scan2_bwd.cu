// Backward of the flip-free bidirectional bias-free GRU scan (kernel K6).
//
// Replaces the Pallas kernel bigru_scan2 backward
// (seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:716, _bi2_bwd_kernel
// :567). Plain PyTorch twin: ops/cuda/gru_scan.py::bigru_scan2_bwd_plain.
//
// Direction 0 ran t = 0..L-1, so its backward walks t = L-1..0 with
// h_prev = ysf[t-1]; direction 1 ran t = L-1..0 over the natural-order
// array, so its backward walks t = 0..L-1 with h_prev = ysb[t+1]
// (zero where the index leaves [0, L); ysb is exactly 0 on the padded
// tail). Each block runs one direction's backward walk (csrc/gru_walk.cuh,
// which gives the step and what bounds it) for a group of rows; the
// forward's walk reads each step's weights once, the backward's twice
// (two recompute products and two transposed products per step). The
// walk writes r * h_prev per step, and a second kernel (reduce_atb.cuh)
// forms dWzr = sum h_prev^T [da_z | da_r] and dWh = sum (r h_prev)^T da_c
// over the B*L rows, tiled and deterministic.

#include "gru_walk.cuh"
#include "reduce_atb.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bigru_scan2_bwd_kernel(const float* __restrict__ xf, const float* __restrict__ xb,
                       const float* __restrict__ wzr2, const float* __restrict__ wh2,
                       const float* __restrict__ ysf, const float* __restrict__ ysb,
                       const float* __restrict__ dysf, const float* __restrict__ dysb,
                       float* __restrict__ dxf, float* __restrict__ dxb,
                       float* __restrict__ rh_out, int B, int L, int H) {
  extern __shared__ float smem[];
  const int d = blockIdx.x;
  gru_walk_bwd<R>(d == 0 ? xf : xb, wzr2 + (size_t)d * H * 2 * H, wh2 + (size_t)d * H * H,
                  d == 0 ? ysf : ysb, d == 0 ? -1 : 1, d == 0 ? dysf : dysb, d == 0 ? dxf : dxb,
                  rh_out + (size_t)d * B * L * H, nullptr, B, L, H, d == 0, smem);
}

template <int R>
cudaError_t launch_rows(const float* xf, const float* xb, const float* wzr2, const float* wh2,
                        const float* ysf, const float* ysb, const float* dysf, const float* dysb,
                        float* dxf, float* dxb, float* rh, int B, int L, int H,
                        cudaStream_t stream) {
  const size_t smem = gru_bwd_smem_bytes(R, H);
  cudaError_t err = cudaFuncSetAttribute(bigru_scan2_bwd_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(2, (B + R - 1) / R);
  bigru_scan2_bwd_kernel<R><<<grid, kThreads, smem, stream>>>(xf, xb, wzr2, wh2, ysf, ysb, dysf,
                                                              dysb, dxf, dxb, rh, B, L, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bigru_scan2_bwd(const float* xf, const float* xb, const float* wzr2,
                               const float* wh2, const float* ysf, const float* ysb,
                               const float* dysf, const float* dysb, float* dxf, float* dxb,
                               float* dwzr2, float* dwh2, float* rh, int B, int L, int H,
                               cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  int per_block = 1;
  cudaError_t err = gru_bwd_rows(B, H, &per_block);
  if (err != cudaSuccess) return (int)err;
  if (per_block == 4)
    err = launch_rows<4>(xf, xb, wzr2, wh2, ysf, ysb, dysf, dysb, dxf, dxb, rh, B, L, H, stream);
  else
    err = launch_rows<1>(xf, xb, wzr2, wh2, ysf, ysb, dysf, dysb, dxf, dxb, rh, B, L, H, stream);
  if (err != cudaSuccess) return (int)err;

  // dWzr[d] = sum over (b, t) of h_prev^T [da_z | da_r]; dWh[d] = sum (r h_prev)^T da_c.
  const size_t rows = (size_t)B * L;
  AtbBatch batch{};
  batch.count = 4;
  batch.rows = (int)rows;
  batch.period = L;
  batch.p[0] = AtbProblem{ysf, H, -1, dxf, 3 * H, dwzr2, nullptr, H, 2 * H};
  batch.p[1] = AtbProblem{ysb, H, 1, dxb, 3 * H, dwzr2 + (size_t)H * 2 * H, nullptr, H, 2 * H};
  batch.p[2] = AtbProblem{rh, H, 0, dxf + 2 * H, 3 * H, dwh2, nullptr, H, H};
  batch.p[3] = AtbProblem{rh + rows * H, H, 0, dxb + 2 * H, 3 * H, dwh2 + (size_t)H * H, nullptr,
                          H, H};
  return (int)launch_atb(batch, stream);
}
