// One bias-free GRU direction from a given initial state (kernel K16),
// and the direction-stacked BiGRU (kernel K18), forward only.
//
// K16 replaces the Pallas kernel gru_scan forward
// (seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:147, _fwd_kernel :38);
// K18 replaces bigru_scan forward (:407, _bi_fwd_kernel :257). Plain
// PyTorch twins: ops/cuda/gru_scan.py::gru_scan_plain and
// bigru_scan_plain.
//
// Both take D direction-stacked arrays: xproj (D, B, L, 3H), h0 (D, B, H),
// wzr (D, H, 2H), wh (D, H, H), ys (D, B, L, H), D = 1 for K16 and 2 for
// K18, whose direction 1 arrives flipped into its scan order by the
// caller. So every direction walks t = 0..L-1 from its own h0, and both
// kernels are one walk (csrc/gru_walk.cuh, which says what bounds it)
// per (direction, R rows) block, as K1 is. Each has a __global__ name of
// its own so that a profiler trace tells them apart; neither name holds,
// or is held in, another kernel's.

#include "gru_walk.cuh"

namespace {

template <int R, int VW>
__device__ void stacked_walk_fwd(const float* xproj, const float* h0, const float* wzr,
                                 const float* wh, float* ys, int B, int L, int H, float* smem) {
  const size_t d = blockIdx.x, rows = (size_t)B * L;
  gru_walk_fwd<R, VW>(xproj + d * rows * 3 * H, h0 + d * B * H, wzr + d * H * 2 * H,
                      wh + d * H * H, ys + d * rows * H, B, L, H, false, smem);
}

template <int R, int VW>
__global__ void __launch_bounds__(kThreads)
gru1_walk_fwd_kernel(const float* __restrict__ xproj, const float* __restrict__ h0,
                     const float* __restrict__ wzr, const float* __restrict__ wh,
                     float* __restrict__ ys, int B, int L, int H) {
  extern __shared__ float smem[];
  stacked_walk_fwd<R, VW>(xproj, h0, wzr, wh, ys, B, L, H, smem);
}

template <int R, int VW>
__global__ void __launch_bounds__(kThreads)
gru2_stacked_fwd_kernel(const float* __restrict__ xproj, const float* __restrict__ h0,
                        const float* __restrict__ wzr, const float* __restrict__ wh,
                        float* __restrict__ ys, int B, int L, int H) {
  extern __shared__ float smem[];
  stacked_walk_fwd<R, VW>(xproj, h0, wzr, wh, ys, B, L, H, smem);
}

template <int D, int R, int VW>
cudaError_t launch(const float* xproj, const float* h0, const float* wzr, const float* wh,
                   float* ys, int B, int L, int H, cudaStream_t stream) {
  const auto kernel = D == 1 ? gru1_walk_fwd_kernel<R, VW> : gru2_stacked_fwd_kernel<R, VW>;
  const size_t smem = gru_fwd_smem_bytes(R, VW, H);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(D, (B + R - 1) / R);
  kernel<<<grid, kThreads, smem, stream>>>(xproj, h0, wzr, wh, ys, B, L, H);
  return cudaGetLastError();
}

template <int D, int R>
cudaError_t launch_rows(const float* xproj, const float* h0, const float* wzr, const float* wh,
                        float* ys, int B, int L, int H, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<size_t>(wzr) | reinterpret_cast<size_t>(wh)) & 15) == 0;
  if (H % 4 == 0 && aligned) return launch<D, R, 4>(xproj, h0, wzr, wh, ys, B, L, H, stream);
  return launch<D, R, 1>(xproj, h0, wzr, wh, ys, B, L, H, stream);
}

template <int D>
int run(const float* xproj, const float* h0, const float* wzr, const float* wh, float* ys, int B,
        int L, int H, cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  return (int)(B == 1 ? launch_rows<D, 1>(xproj, h0, wzr, wh, ys, B, L, H, stream)
                      : launch_rows<D, 4>(xproj, h0, wzr, wh, ys, B, L, H, stream));
}

}  // namespace

// K16: xproj (B, L, 3H), h0 (B, H), wzr (H, 2H), wh (H, H) -> ys (B, L, H).
extern "C" int gru_scan_fwd(const float* xproj, const float* h0, const float* wzr,
                            const float* wh, float* ys, int B, int L, int H,
                            cudaStream_t stream) {
  return run<1>(xproj, h0, wzr, wh, ys, B, L, H, stream);
}

// K18: the same with a leading direction axis of 2.
extern "C" int bigru_scan_fwd(const float* xproj2, const float* h02, const float* wzr2,
                              const float* wh2, float* ys2, int B, int L, int H,
                              cudaStream_t stream) {
  return run<2>(xproj2, h02, wzr2, wh2, ys2, B, L, H, stream);
}
