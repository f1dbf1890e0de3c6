// Backward of one bias-free GRU direction from a given initial state
// (kernel K17) and of the direction-stacked BiGRU (kernel K19).
//
// K17 replaces the Pallas kernel gru_scan backward
// (seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:177, _bwd_kernel :71);
// K19 replaces bigru_scan backward (:445, _bi_bwd_kernel :308). Plain
// PyTorch twins: ops/cuda/gru_scan.py::gru_scan_bwd_plain and
// bigru_scan_bwd_plain.
//
// Inputs are D direction-stacked arrays (D = 1 for K17, 2 for K19), each
// direction in the scan order its forward ran: xproj (D, B, L, 3H), the
// state each step started from, h_prev (D, B, L, H) (h0 at t = 0: the
// caller shifts the saved outputs, as the JAX VJP does), the outputs'
// cotangent dys (D, B, L, H), wzr (D, H, 2H) and wh (D, H, H). Every
// direction's backward walks t = L-1..0 (csrc/gru_walk.cuh gives the step
// and what bounds it), writes dxproj and r * h_prev per step, and dh0,
// the carry after step 0. One reduce_atb.cuh launch then forms dWzr[d] =
// sum h_prev^T [da_z | da_r] and dWh[d] = sum (r h_prev)^T da_c over the
// B*L rows. The reduction reads h_prev as it is given (shift 0), so the
// initial state's term h0^T [da_z | da_r] at t = 0 is in dWzr; reading
// the outputs shifted by one step, as K6 does, would put a zero row there.

#include "gru_walk.cuh"
#include "reduce_atb.cuh"

namespace {

template <int R>
__device__ void stacked_walk_bwd(const float* xproj, const float* hprev, const float* dys,
                                 const float* wzr, const float* wh, float* dxproj, float* dh0,
                                 float* rh, int B, int L, int H, float* smem) {
  const size_t d = blockIdx.x, rows = (size_t)B * L;
  gru_walk_bwd<R>(xproj + d * rows * 3 * H, wzr + d * H * 2 * H, wh + d * H * H,
                  hprev + d * rows * H, 0, dys + d * rows * H, dxproj + d * rows * 3 * H,
                  rh + d * rows * H, dh0 + d * B * H, B, L, H, true, smem);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru1_walk_bwd_kernel(const float* __restrict__ xproj, const float* __restrict__ hprev,
                     const float* __restrict__ dys, const float* __restrict__ wzr,
                     const float* __restrict__ wh, float* __restrict__ dxproj,
                     float* __restrict__ dh0, float* __restrict__ rh, int B, int L, int H) {
  extern __shared__ float smem[];
  stacked_walk_bwd<R>(xproj, hprev, dys, wzr, wh, dxproj, dh0, rh, B, L, H, smem);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru2_stacked_bwd_kernel(const float* __restrict__ xproj, const float* __restrict__ hprev,
                        const float* __restrict__ dys, const float* __restrict__ wzr,
                        const float* __restrict__ wh, float* __restrict__ dxproj,
                        float* __restrict__ dh0, float* __restrict__ rh, int B, int L, int H) {
  extern __shared__ float smem[];
  stacked_walk_bwd<R>(xproj, hprev, dys, wzr, wh, dxproj, dh0, rh, B, L, H, smem);
}

template <int D, int R>
cudaError_t launch_rows(const float* xproj, const float* hprev, const float* dys,
                        const float* wzr, const float* wh, float* dxproj, float* dh0, float* rh,
                        int B, int L, int H, cudaStream_t stream) {
  const auto kernel = D == 1 ? gru1_walk_bwd_kernel<R> : gru2_stacked_bwd_kernel<R>;
  const size_t smem = gru_bwd_smem_bytes(R, H);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(D, (B + R - 1) / R);
  kernel<<<grid, kThreads, smem, stream>>>(xproj, hprev, dys, wzr, wh, dxproj, dh0, rh, B, L, H);
  return cudaGetLastError();
}

template <int D>
int run(const float* xproj, const float* hprev, const float* dys, const float* wzr,
        const float* wh, float* dxproj, float* dh0, float* dwzr, float* dwh, float* rh, int B,
        int L, int H, cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  int per_block = 1;
  cudaError_t err = gru_bwd_rows(B, H, &per_block);
  if (err != cudaSuccess) return (int)err;
  err = per_block == 4
            ? launch_rows<D, 4>(xproj, hprev, dys, wzr, wh, dxproj, dh0, rh, B, L, H, stream)
            : launch_rows<D, 1>(xproj, hprev, dys, wzr, wh, dxproj, dh0, rh, B, L, H, stream);
  if (err != cudaSuccess) return (int)err;

  const size_t rows = (size_t)B * L;
  AtbBatch batch{};
  batch.count = 2 * D;
  batch.rows = (int)rows;
  batch.period = L;
  for (int d = 0; d < D; ++d) {
    const float* dx = dxproj + d * rows * 3 * H;
    batch.p[2 * d] = AtbProblem{hprev + d * rows * H, H, 0, dx, 3 * H,
                                dwzr + (size_t)d * H * 2 * H, nullptr, H, 2 * H};
    batch.p[2 * d + 1] = AtbProblem{rh + d * rows * H, H, 0, dx + 2 * H, 3 * H,
                                    dwh + (size_t)d * H * H, nullptr, H, H};
  }
  return (int)launch_atb(batch, stream);
}

}  // namespace

// K17: xproj (B, L, 3H), h_prev (B, L, H), dys (B, L, H), wzr (H, 2H),
// wh (H, H) -> dxproj (B, L, 3H), dh0 (B, H), dwzr (H, 2H), dwh (H, H);
// rh (B, L, H) is scratch.
extern "C" int gru_scan_bwd(const float* xproj, const float* hprev, const float* dys,
                            const float* wzr, const float* wh, float* dxproj, float* dh0,
                            float* dwzr, float* dwh, float* rh, int B, int L, int H,
                            cudaStream_t stream) {
  return run<1>(xproj, hprev, dys, wzr, wh, dxproj, dh0, dwzr, dwh, rh, B, L, H, stream);
}

// K19: the same with a leading direction axis of 2.
extern "C" int bigru_scan_bwd(const float* xproj2, const float* hprev2, const float* dys2,
                              const float* wzr2, const float* wh2, float* dxproj2, float* dh02,
                              float* dwzr2, float* dwh2, float* rh2, int B, int L, int H,
                              cudaStream_t stream) {
  return run<2>(xproj2, hprev2, dys2, wzr2, wh2, dxproj2, dh02, dwzr2, dwh2, rh2, B, L, H,
                stream);
}
