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
// tail). Three stages (csrc/gru_walk.cuh gives the step):
//   1. gru_gates_kernel, twice: z, r, c and r * h_prev for all B*L rows of
//      both directions, as tiled products, off the step chain;
//   2. bigru_scan2_bwd_kernel: per direction and group of R rows, one
//      thread-block cluster walks the steps with the weight slices
//      resident in its blocks' shared memory. What bounds it: the L steps
//      form a chain, and each costs two cluster barriers, each after a
//      push of the step's gate cotangents into every block of the cluster;
//      the products per block and step are R x (H/C) x 3H multiply-adds.
//      At B = 16, L = 144, H = 256 (R = 4, 8 clusters): pre-pass 0.20 ms,
//      walk 0.73 ms, reduction 0.39 ms (chip_smoke.py phase 8 on an NVIDIA
//      H100 80GB HBM3 at 700.00 W);
//   3. reduce_atb.cuh: dWzr = sum h_prev^T [da_z | da_r] and dWh = sum
//      (r h_prev)^T da_c over the B*L rows, tiled and deterministic.
// The plan (C, R, resident) comes from the caller (ops/cuda/walk.py).
//
// bigru_scan2_bwd_bf16 is the bf16 entry (bigru_scan2_bwd_bf16_kernel): the
// same three stages with every input and output bf16, as _bi2_bwd_kernel
// runs with bf16 inputs. The gates go to a float32 scratch (`gates`: dx
// is bf16, and the JAX kernel keeps z, r and c in float32), rho holds
// round(r * h_prev) in bf16, the walk rounds da_c and [da_z | da_r] where
// it forms them (gru_walk.cuh), and the reduction widens its bf16
// operands, sums in float32 and rounds dWzr and dWh once, at their store.
// Plain PyTorch twin: ops/cuda/gru_scan.py::bigru_scan2_bwd_plain_bf16,
// which rounds at the same points.

#include "gru_walk.cuh"
#include "reduce_atb.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bigru_scan2_bwd_kernel(const GruBwd g, int resident) {
  extern __shared__ float smem[];
  gru_walk_bwd<R>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bigru_scan2_bwd_bf16_kernel(const GruBwdT<bf16> g, int resident) {
  extern __shared__ float smem[];
  gru_walk_bwd<R, bf16>(g.d[blockIdx.y], g.B, g.L, g.H, resident != 0, smem);
}

// The three stages for IO type T; `gates` (2, B, L, 3H) float32, or null
// for the float entry, whose pre-pass leaves the gates in dx.
template <class T>
int bigru_scan2_bwd_run(const T* xf, const T* xb, const T* wzr2, const T* wh2, const T* ysf,
                        const T* ysb, const T* dysf, const T* dysb, T* dxf, T* dxb, T* dwzr2,
                        T* dwh2, T* rh, float* gates, int B, int L, int H, const WalkPlan& plan,
                        void (*walk)(const GruBwdT<T>, int), cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * L;
  float* gf = gates ? gates : reinterpret_cast<float*>(dxf);
  float* gb = gates ? gates + n * 3 * H : reinterpret_cast<float*>(dxb);
  GruBwdT<T> g{};
  g.d[0] = GruBwdDirT<T>{xf, wzr2, wh2, ysf, dysf, dxf, rh, nullptr, -1, 1, gf};
  g.d[1] = GruBwdDirT<T>{xb, wzr2 + (size_t)H * 2 * H, wh2 + (size_t)H * H, ysb, dysb, dxb,
                         rh + n * H, nullptr, 1, 0, gb};
  g.B = B, g.L = L, g.H = H;
  cudaError_t err = run_gru_bwd(g, 2, plan, walk, stream);
  if (err != cudaSuccess) return (int)err;

  // dWzr[d] = sum over (b, t) of h_prev^T [da_z | da_r]; dWh[d] = sum (r h_prev)^T da_c.
  const int io = kIsBf16<T> ? kAtbA16 | kAtbB16 | kAtbC16 : 0;
  AtbBatch batch{};
  batch.count = 4;
  batch.rows = (int)n;
  batch.period = L;
  batch.p[0] = AtbProblem{ysf, H, -1, dxf, 3 * H, dwzr2, nullptr, H, 2 * H, io};
  batch.p[1] =
      AtbProblem{ysb, H, 1, dxb, 3 * H, dwzr2 + (size_t)H * 2 * H, nullptr, H, 2 * H, io};
  batch.p[2] = AtbProblem{rh, H, 0, dxf + 2 * H, 3 * H, dwh2, nullptr, H, H, io};
  batch.p[3] = AtbProblem{rh + n * H, H, 0, dxb + 2 * H, 3 * H, dwh2 + (size_t)H * H, nullptr,
                          H, H, io};
  return (int)launch_atb(batch, stream);
}

}  // namespace

// The device's opt-in shared memory per block and the clusters of
// `cluster` blocks of the walk that can be resident at that size.
extern "C" int bigru_scan2_bwd_limits(int cluster, int* smem_limit, int* clusters) {
  return (int)cluster_limits(bigru_scan2_bwd_kernel<16>, cluster, smem_limit, clusters);
}

extern "C" int bigru_scan2_bwd(const float* xf, const float* xb, const float* wzr2,
                               const float* wh2, const float* ysf, const float* ysb,
                               const float* dysf, const float* dysb, float* dxf, float* dxb,
                               float* dwzr2, float* dwh2, float* rh, int B, int L, int H,
                               int cluster, int rows, int resident, cudaStream_t stream) {
  return bigru_scan2_bwd_run(xf, xb, wzr2, wh2, ysf, ysb, dysf, dysb, dxf, dxb, dwzr2, dwh2, rh,
                             nullptr, B, L, H, WalkPlan{cluster, rows, resident},
                             GRU_WALK_INSTANCE(bigru_scan2_bwd_kernel, rows), stream);
}

// bigru_scan2_bwd with every array bf16, rh (2, B, L, H) bf16 and the
// gates' scratch (2, B, L, 3H) float32, on bigru_scan2_bwd_limits' plan
// (the walk's shared memory is the same).
extern "C" int bigru_scan2_bwd_bf16(const bf16* xf, const bf16* xb, const bf16* wzr2,
                                    const bf16* wh2, const bf16* ysf, const bf16* ysb,
                                    const bf16* dysf, const bf16* dysb, bf16* dxf, bf16* dxb,
                                    bf16* dwzr2, bf16* dwh2, bf16* rh, float* gates, int B, int L,
                                    int H, int cluster, int rows, int resident,
                                    cudaStream_t stream) {
  if (gates == nullptr) return (int)cudaErrorInvalidValue;
  return bigru_scan2_bwd_run(xf, xb, wzr2, wh2, ysf, ysb, dysf, dysb, dxf, dxb, dwzr2, dwh2, rh,
                             gates, B, L, H, WalkPlan{cluster, rows, resident},
                             GRU_WALK_INSTANCE(bigru_scan2_bwd_bf16_kernel, rows), stream);
}
