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
// kernels are K1's cluster walk (csrc/gru_walk.cuh, which says what bounds
// it), one cluster per (direction, R rows), with the plan (C, R, resident)
// from the caller (ops/cuda/walk.py). Each has a __global__ name of its
// own so that a profiler trace tells them apart; neither name holds, or
// is held in, another kernel's.
//
// gru_scan_fwd_bf16 and bigru_scan_fwd_bf16 are their bf16 entries
// (gru1_walk_fwd_bf16_kernel, gru2_stacked_fwd_bf16_kernel): the same
// walk with every array bf16, as _fwd_kernel and _bi_fwd_kernel run with
// bf16 inputs. h stays float32 (h0 widened), the products read h and
// r * h rounded to bf16, and ys stores rounded (gru_walk.cuh). Plain
// PyTorch twin: ops/cuda/gru_scan.py::bigru_scan_plain_bf16, which
// rounds at the same points, the JAX kernels' own.

#include "gru_walk.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(kThreads, 1) gru1_walk_fwd_kernel(const GruFwd g, int resident) {
  extern __shared__ float smem[];
  gru_walk_fwd<R>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru2_stacked_fwd_kernel(const GruFwd g, int resident) {
  extern __shared__ float smem[];
  gru_walk_fwd<R>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru1_walk_fwd_bf16_kernel(const GruFwdT<bf16> g, int resident) {
  extern __shared__ float smem[];
  gru_walk_fwd<R, bf16>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru2_stacked_fwd_bf16_kernel(const GruFwdT<bf16> g, int resident) {
  extern __shared__ float smem[];
  gru_walk_fwd<R, bf16>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

// D directions of IO type T through `walk`.
template <int D, class T>
int run(const T* xproj, const T* h0, const T* wzr, const T* wh, T* ys, int B, int L, int H,
        const WalkPlan& plan, void (*walk)(const GruFwdT<T>, int), cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * L;
  GruFwdT<T> g{};
  for (int d = 0; d < D; ++d)
    g.d[d] = GruFwdDirT<T>{xproj + d * rows * 3 * H, h0 + (size_t)d * B * H,
                           wzr + (size_t)d * H * 2 * H, wh + (size_t)d * H * H,
                           ys + d * rows * H, 0};
  g.B = B, g.L = L, g.H = H;
  return (int)run_gru_fwd(g, D, plan, walk, stream);
}

}  // namespace

// The device's opt-in shared memory per block and the clusters of
// `cluster` blocks of each walk that can be resident at that size.
extern "C" int gru_scan_fwd_limits(int cluster, int* smem_limit, int* clusters) {
  return (int)cluster_limits(gru1_walk_fwd_kernel<16>, cluster, smem_limit, clusters);
}

extern "C" int bigru_scan_fwd_limits(int cluster, int* smem_limit, int* clusters) {
  return (int)cluster_limits(gru2_stacked_fwd_kernel<16>, cluster, smem_limit, clusters);
}

// K16: xproj (B, L, 3H), h0 (B, H), wzr (H, 2H), wh (H, H) -> ys (B, L, H);
// (cluster, rows, resident) the walk's plan.
extern "C" int gru_scan_fwd(const float* xproj, const float* h0, const float* wzr,
                            const float* wh, float* ys, int B, int L, int H, int cluster, int rows,
                            int resident, cudaStream_t stream) {
  return run<1>(xproj, h0, wzr, wh, ys, B, L, H, WalkPlan{cluster, rows, resident},
                GRU_WALK_INSTANCE(gru1_walk_fwd_kernel, rows), stream);
}

// K18: the same with a leading direction axis of 2.
extern "C" int bigru_scan_fwd(const float* xproj2, const float* h02, const float* wzr2,
                              const float* wh2, float* ys2, int B, int L, int H, int cluster,
                              int rows, int resident, cudaStream_t stream) {
  return run<2>(xproj2, h02, wzr2, wh2, ys2, B, L, H, WalkPlan{cluster, rows, resident},
                GRU_WALK_INSTANCE(gru2_stacked_fwd_kernel, rows), stream);
}

// K16 with every array bf16, on gru_scan_fwd_limits' plan (the walk's
// shared memory is the same: its slices stay float).
extern "C" int gru_scan_fwd_bf16(const bf16* xproj, const bf16* h0, const bf16* wzr,
                                 const bf16* wh, bf16* ys, int B, int L, int H, int cluster,
                                 int rows, int resident, cudaStream_t stream) {
  return run<1>(xproj, h0, wzr, wh, ys, B, L, H, WalkPlan{cluster, rows, resident},
                GRU_WALK_INSTANCE(gru1_walk_fwd_bf16_kernel, rows), stream);
}

// K18 with every array bf16, on bigru_scan_fwd_limits' plan.
extern "C" int bigru_scan_fwd_bf16(const bf16* xproj2, const bf16* h02, const bf16* wzr2,
                                   const bf16* wh2, bf16* ys2, int B, int L, int H, int cluster,
                                   int rows, int resident, cudaStream_t stream) {
  return run<2>(xproj2, h02, wzr2, wh2, ys2, B, L, H, WalkPlan{cluster, rows, resident},
                GRU_WALK_INSTANCE(gru2_stacked_fwd_bf16_kernel, rows), stream);
}
