// Flip-free bidirectional bias-free GRU scan, forward only.
//
// Replaces the Pallas kernel bigru_scan2 forward
// (seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:666, _bi2_fwd_kernel
// :521). Plain PyTorch twin: ops/cuda/gru_scan.py::bigru_scan2_plain.
//
// Direction 0 walks t = 0..L-1, direction 1 walks t = L-1..0 over the
// same natural-order arrays (zero padding keeps its h at 0 exactly).
//
// Each block runs one direction's walk (csrc/gru_walk.cuh, which says
// what bounds it) for a group of rows. Splitting a direction's columns
// over a cluster of blocks, with the state exchanged through distributed
// shared memory, is the way past the one-SM L2 rate.

#include "gru_walk.cuh"

namespace {

template <int R, int VW>
__global__ void __launch_bounds__(kThreads)
bigru_scan2_kernel(const float* __restrict__ xf, const float* __restrict__ xb,
                   const float* __restrict__ wzr2, const float* __restrict__ wh2,
                   float* __restrict__ ysf, float* __restrict__ ysb, int B, int L, int H) {
  extern __shared__ float smem[];
  const int d = blockIdx.x;
  gru_walk_fwd<R, VW>(d == 0 ? xf : xb, nullptr, wzr2 + (size_t)d * H * 2 * H,
                      wh2 + (size_t)d * H * H, d == 0 ? ysf : ysb, B, L, H, d == 1, smem);
}

template <int R, int VW>
cudaError_t launch(const float* xf, const float* xb, const float* wzr2, const float* wh2,
                   float* ysf, float* ysb, int B, int L, int H, cudaStream_t stream) {
  const size_t smem = gru_fwd_smem_bytes(R, VW, H);
  cudaError_t err = cudaFuncSetAttribute(bigru_scan2_kernel<R, VW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(2, (B + R - 1) / R);
  bigru_scan2_kernel<R, VW><<<grid, kThreads, smem, stream>>>(xf, xb, wzr2, wh2, ysf, ysb, B,
                                                               L, H);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_rows(const float* xf, const float* xb, const float* wzr2, const float* wh2,
                        float* ysf, float* ysb, int B, int L, int H, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<size_t>(wzr2) | reinterpret_cast<size_t>(wh2)) & 15) == 0;
  if (H % 4 == 0 && aligned) return launch<R, 4>(xf, xb, wzr2, wh2, ysf, ysb, B, L, H, stream);
  return launch<R, 1>(xf, xb, wzr2, wh2, ysf, ysb, B, L, H, stream);
}

}  // namespace

extern "C" int bigru_scan2_fwd(const float* xf, const float* xb, const float* wzr2,
                               const float* wh2, float* ysf, float* ysb, int B, int L,
                               int H, cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const cudaError_t err = B == 1 ? launch_rows<1>(xf, xb, wzr2, wh2, ysf, ysb, B, L, H, stream)
                                 : launch_rows<4>(xf, xb, wzr2, wh2, ysf, ysb, B, L, H, stream);
  return (int)err;
}
