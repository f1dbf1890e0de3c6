// Flip-free bidirectional bias-free GRU scan, forward only (kernel K1).
//
// Replaces the Pallas kernel bigru_scan2 forward
// (seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:666, _bi2_fwd_kernel
// :521). Plain PyTorch twin: ops/cuda/gru_scan.py::bigru_scan2_plain.
//
// Direction 0 walks t = 0..L-1, direction 1 walks t = L-1..0 over the
// same natural-order arrays (zero padding keeps its h at 0 exactly).
//
// Per direction and group of R rows, one thread-block cluster walks the
// steps with the weight slices resident in its blocks' shared memory
// (csrc/gru_walk.cuh gives the step and what bounds it). The plan (C, R,
// resident) comes from the caller (ops/cuda/walk.py).

#include "gru_walk.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(kThreads, 1) bigru_scan2_kernel(const GruFwd g, int resident) {
  extern __shared__ float smem[];
  gru_walk_fwd<R>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

}  // namespace

// The device's opt-in shared memory per block and the clusters of
// `cluster` blocks of the walk that can be resident at that size.
extern "C" int bigru_scan2_fwd_limits(int cluster, int* smem_limit, int* clusters) {
  return (int)cluster_limits(bigru_scan2_kernel<16>, cluster, smem_limit, clusters);
}

// xf, xb (B, L, 3H), wzr2 (2, H, 2H), wh2 (2, H, H) -> ysf, ysb (B, L, H);
// (cluster, rows, resident) the walk's plan.
extern "C" int bigru_scan2_fwd(const float* xf, const float* xb, const float* wzr2,
                               const float* wh2, float* ysf, float* ysb, int B, int L, int H,
                               int cluster, int rows, int resident, cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  GruFwd g{};
  g.d[0] = GruFwdDir{xf, nullptr, wzr2, wh2, ysf, 0};
  g.d[1] = GruFwdDir{xb, nullptr, wzr2 + (size_t)H * 2 * H, wh2 + (size_t)H * H, ysb, 1};
  g.B = B, g.L = L, g.H = H;
  return (int)run_gru_fwd(g, 2, WalkPlan{cluster, rows, resident},
                          GRU_WALK_INSTANCE(bigru_scan2_kernel, rows), stream);
}
