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
// direction's backward walks t = L-1..0 in K6's three stages
// (csrc/gru_walk.cuh; csrc/bigru_scan2_bwd.cu says what bounds each): the
// gate pre-pass on h_prev as given (shift 0), the cluster walk, which
// writes dxproj and dh0, the carry after step 0, and one reduce_atb.cuh
// launch for dWzr[d] = sum h_prev^T [da_z | da_r] and dWh[d] = sum
// (r h_prev)^T da_c over the B*L rows. The reduction reads h_prev as it
// is given, so the initial state's term h0^T [da_z | da_r] at t = 0 is in
// dWzr; reading the outputs shifted by one step, as K6 does, would put a
// zero row there.
//
// gru_scan_bwd_bf16 and bigru_scan_bwd_bf16 are their bf16 entries
// (gru1_walk_bwd_bf16_kernel, gru2_stacked_bwd_bf16_kernel): the same
// three stages with every input and output bf16, as _bwd_kernel and
// _bi_bwd_kernel run with bf16 inputs, through K6's bf16 walk: the gates
// go to a float32 scratch (`gates`), rho holds round(r * h_prev), the
// walk rounds da_c and [da_z | da_r] where it forms them (the operands
// of every product that reads them, and dxproj), h_prev is read as the
// bf16 array it is, dh0 stores the float32 carry rounded, and the
// reduction widens its bf16 operands, sums dWzr and dWh in float32 and
// rounds each once, at its store, as the JAX kernels write their float32
// scratch sums in the weights' type. Plain PyTorch twin:
// ops/cuda/gru_scan.py::bigru_scan_bwd_plain_bf16.

#include "gru_walk.cuh"
#include "reduce_atb.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(kThreads, 1) gru1_walk_bwd_kernel(const GruBwd g, int resident) {
  extern __shared__ float smem[];
  gru_walk_bwd<R>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru2_stacked_bwd_kernel(const GruBwd g, int resident) {
  extern __shared__ float smem[];
  gru_walk_bwd<R>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru1_walk_bwd_bf16_kernel(const GruBwdT<bf16> g, int resident) {
  extern __shared__ float smem[];
  gru_walk_bwd<R, bf16>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
gru2_stacked_bwd_bf16_kernel(const GruBwdT<bf16> g, int resident) {
  extern __shared__ float smem[];
  gru_walk_bwd<R, bf16>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

// D directions of IO type T through `walk`; `gates` (D, B, L, 3H)
// float32, or null for the float entries, whose pre-pass leaves the
// gates in dx.
template <int D, class T>
int run(const T* xproj, const T* hprev, const T* dys, const T* wzr, const T* wh, T* dxproj,
        T* dh0, T* dwzr, T* dwh, T* rh, float* gates, int B, int L, int H, const WalkPlan& plan,
        void (*walk)(const GruBwdT<T>, int), cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * L;
  GruBwdT<T> g{};
  for (int d = 0; d < D; ++d)
    g.d[d] = GruBwdDirT<T>{xproj + d * rows * 3 * H, wzr + (size_t)d * H * 2 * H,
                           wh + (size_t)d * H * H,   hprev + d * rows * H,
                           dys + d * rows * H,       dxproj + d * rows * 3 * H,
                           rh + d * rows * H,        dh0 + (size_t)d * B * H,
                           0,                        1,
                           gates ? gates + d * rows * 3 * H
                                 : reinterpret_cast<float*>(dxproj + d * rows * 3 * H)};
  g.B = B, g.L = L, g.H = H;
  cudaError_t err = run_gru_bwd(g, D, plan, walk, stream);
  if (err != cudaSuccess) return (int)err;

  const int io = kIsBf16<T> ? kAtbA16 | kAtbB16 | kAtbC16 : 0;
  AtbBatch batch{};
  batch.count = 2 * D;
  batch.rows = (int)rows;
  batch.period = L;
  for (int d = 0; d < D; ++d) {
    const T* dx = dxproj + d * rows * 3 * H;
    batch.p[2 * d] = AtbProblem{hprev + d * rows * H, H, 0, dx, 3 * H,
                                dwzr + (size_t)d * H * 2 * H, nullptr, H, 2 * H, io};
    batch.p[2 * d + 1] = AtbProblem{rh + d * rows * H, H, 0, dx + 2 * H, 3 * H,
                                    dwh + (size_t)d * H * H, nullptr, H, H, io};
  }
  return (int)launch_atb(batch, stream);
}

}  // namespace

// The device's opt-in shared memory per block and the clusters of
// `cluster` blocks of each walk that can be resident at that size.
extern "C" int gru_scan_bwd_limits(int cluster, int* smem_limit, int* clusters) {
  return (int)cluster_limits(gru1_walk_bwd_kernel<16>, cluster, smem_limit, clusters);
}

extern "C" int bigru_scan_bwd_limits(int cluster, int* smem_limit, int* clusters) {
  return (int)cluster_limits(gru2_stacked_bwd_kernel<16>, cluster, smem_limit, clusters);
}

// K17: xproj (B, L, 3H), h_prev (B, L, H), dys (B, L, H), wzr (H, 2H),
// wh (H, H) -> dxproj (B, L, 3H), dh0 (B, H), dwzr (H, 2H), dwh (H, H);
// rh (B, L, H) is scratch; (cluster, rows, resident) the walk's plan.
extern "C" int gru_scan_bwd(const float* xproj, const float* hprev, const float* dys,
                            const float* wzr, const float* wh, float* dxproj, float* dh0,
                            float* dwzr, float* dwh, float* rh, int B, int L, int H, int cluster,
                            int rows, int resident, cudaStream_t stream) {
  return run<1>(xproj, hprev, dys, wzr, wh, dxproj, dh0, dwzr, dwh, rh, nullptr, B, L, H,
                WalkPlan{cluster, rows, resident}, GRU_WALK_INSTANCE(gru1_walk_bwd_kernel, rows),
                stream);
}

// K19: the same with a leading direction axis of 2.
extern "C" int bigru_scan_bwd(const float* xproj2, const float* hprev2, const float* dys2,
                              const float* wzr2, const float* wh2, float* dxproj2, float* dh02,
                              float* dwzr2, float* dwh2, float* rh2, int B, int L, int H,
                              int cluster, int rows, int resident, cudaStream_t stream) {
  return run<2>(xproj2, hprev2, dys2, wzr2, wh2, dxproj2, dh02, dwzr2, dwh2, rh2, nullptr, B, L,
                H, WalkPlan{cluster, rows, resident},
                GRU_WALK_INSTANCE(gru2_stacked_bwd_kernel, rows), stream);
}

// K17 with every array bf16, rh (B, L, H) bf16 and the gates' scratch
// (B, L, 3H) float32, on gru_scan_bwd_limits' plan (the walk's shared
// memory is the same: its slices stay float).
extern "C" int gru_scan_bwd_bf16(const bf16* xproj, const bf16* hprev, const bf16* dys,
                                 const bf16* wzr, const bf16* wh, bf16* dxproj, bf16* dh0,
                                 bf16* dwzr, bf16* dwh, bf16* rh, float* gates, int B, int L,
                                 int H, int cluster, int rows, int resident,
                                 cudaStream_t stream) {
  if (gates == nullptr) return (int)cudaErrorInvalidValue;
  return run<1>(xproj, hprev, dys, wzr, wh, dxproj, dh0, dwzr, dwh, rh, gates, B, L, H,
                WalkPlan{cluster, rows, resident},
                GRU_WALK_INSTANCE(gru1_walk_bwd_bf16_kernel, rows), stream);
}

// K19 with every array bf16, rh2 (2, B, L, H) bf16 and the gates'
// scratch (2, B, L, 3H) float32, on bigru_scan_bwd_limits' plan.
extern "C" int bigru_scan_bwd_bf16(const bf16* xproj2, const bf16* hprev2, const bf16* dys2,
                                   const bf16* wzr2, const bf16* wh2, bf16* dxproj2, bf16* dh02,
                                   bf16* dwzr2, bf16* dwh2, bf16* rh2, float* gates2, int B,
                                   int L, int H, int cluster, int rows, int resident,
                                   cudaStream_t stream) {
  if (gates2 == nullptr) return (int)cudaErrorInvalidValue;
  return run<2>(xproj2, hprev2, dys2, wzr2, wh2, dxproj2, dh02, dwzr2, dwh2, rh2, gates2, B, L,
                H, WalkPlan{cluster, rows, resident},
                GRU_WALK_INSTANCE(gru2_stacked_bwd_bf16_kernel, rows), stream);
}
