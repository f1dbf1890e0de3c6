// Backward of the bidirectional LSTM scan, without peepholes (kernel K9).
//
// Replaces the Pallas kernel bilstm_scan backward
// (seq2seq_attention_asr_tpu/ops/pallas/lstm_scan.py: _run_bwd :139,
// pallas_call :145, _bwd_kernel :58, VJP _vjp_bwd :194). Plain PyTorch
// twin: ops/cuda/lstm_scan.py::bilstm_scan_bwd_plain.
//
// Both directions walk t = L-1..0 over the direction-stacked arrays
// (direction 1 in its own scan order, as the forward ran it). Each step
// recomputes the gates from the previous hidden and cell states (the
// saved sequences shifted by one step, the initial state in front), then
//
//   dh = dys[t] + dh_carry;  dc = dc_carry + dh o (1 - tanh(c)^2)
//   da = [dc g i(1-i) | dc c_prev f(1-f) | dc i (1-g^2) | dh tanh(c) o(1-o)]
//   dxproj[t] = da;  dh_carry = da @ W_h^T;  dc_carry = dc f
//
// and dh0, dc0 are the carries after step 0.
//
// What bounds it: as in the forward (csrc/bilstm_scan.cu), the steps form
// a chain and each reads the direction's whole recurrent weight (H x 4H,
// 256 KB at H = 128) from L2 twice, for the recompute product and the
// transposed product. One block runs one direction for up to 4 batch
// rows with h_prev, c_prev, dh and dc in shared memory, so each weight
// is read once per step for all rows of the block. The weight gradient
// needs no stash: dxproj is da, and h_prev is the caller's shifted h
// sequence, so dW_h = sum h_prev^T da over the B*L rows is one pass of
// reduce_atb.cuh after the walk, tiled and deterministic (no atomics).

#include "common.cuh"
#include "reduce_atb.cuh"

namespace {

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bilstm_scan_bwd_kernel(const float* __restrict__ xproj2, const float* __restrict__ hprev2,
                       const float* __restrict__ cprev2, const float* __restrict__ dys2,
                       const float* __restrict__ wh2, float* __restrict__ dxproj2,
                       float* __restrict__ dh02, float* __restrict__ dc02, int B, int L, int H) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  float* hp = smem;           // [R][H]   h_prev
  float* cp = hp + R * H;     // [R][H]   c_prev
  float* dh = cp + R * H;     // [R][H]   dh carried to the previous step
  float* dc = dh + R * H;     // [R][H]   dc carried to the previous step
  float* g = dc + R * H;      // [R][4H]  h_prev @ W_h
  float* da = g + R * H4;     // [R][4H]  gate cotangents
  float* scratch = da + R * H4;

  const int d = blockIdx.x;
  const int b0 = blockIdx.y * R;
  const int nrows = min(R, B - b0);
  const float* wh = wh2 + (size_t)d * H * H4;
  const size_t row0 = (size_t)d * B + b0;  // first (direction, batch) row of the block

  for (int i = threadIdx.x; i < R * H; i += kThreads) dh[i] = dc[i] = 0.f;
  for (int t = L - 1; t >= 0; --t) {
    for (int i = threadIdx.x; i < R * H; i += kThreads) {
      const int r = i / H, j = i % H;
      const size_t at = ((row0 + r) * L + t) * H + j;
      hp[i] = r < nrows ? hprev2[at] : 0.f;
      cp[i] = r < nrows ? cprev2[at] : 0.f;
    }
    __syncthreads();
    matvec<kNone>(wh, nullptr, H, H4, hp, H, g, H4, R, scratch);
    for (int i = threadIdx.x; i < R * H; i += kThreads) {
      const int r = i / H, j = i % H;
      const size_t at = (row0 + r) * L + t;
      const float* x = xproj2 + at * H4;
      const float* gr = g + r * H4;
      const bool in = r < nrows;
      const float ig = sigmoid(gr[j] + (in ? x[j] : 0.f));
      const float fg = sigmoid(gr[H + j] + (in ? x[H + j] : 0.f));
      const float gg = tanhf(gr[2 * H + j] + (in ? x[2 * H + j] : 0.f));
      const float og = sigmoid(gr[3 * H + j] + (in ? x[3 * H + j] : 0.f));
      const float c = fg * cp[i] + ig * gg;
      const float tc = tanhf(c);
      const float dhv = (in ? dys2[at * H + j] : 0.f) + dh[i];
      const float dcv = dc[i] + dhv * og * (1.f - tc * tc);
      float* dar = da + r * H4;
      dar[j] = dcv * gg * ig * (1.f - ig);
      dar[H + j] = dcv * cp[i] * fg * (1.f - fg);
      dar[2 * H + j] = dcv * ig * (1.f - gg * gg);
      dar[3 * H + j] = dhv * tc * og * (1.f - og);
      dc[i] = dcv * fg;
    }
    __syncthreads();
    matvec_t<R>(wh, H, H4, da, H4, dh, H);
    for (int i = threadIdx.x; i < R * H4; i += kThreads) {
      const int r = i / H4, j = i % H4;
      if (r < nrows) dxproj2[((row0 + r) * L + t) * H4 + j] = da[i];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nrows * H; i += kThreads) {
    dh02[row0 * H + i] = dh[i];
    dc02[row0 * H + i] = dc[i];
  }
}

size_t smem_bytes(int R, int H) {
  return ((size_t)12 * R * H + (size_t)kThreads * 4 * R) * sizeof(float);
}

template <int R>
cudaError_t launch_rows(const float* xproj2, const float* hprev2, const float* cprev2,
                        const float* dys2, const float* wh2, float* dxproj2, float* dh02,
                        float* dc02, int B, int L, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, H);
  cudaError_t err = cudaFuncSetAttribute(bilstm_scan_bwd_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(2, (B + R - 1) / R);
  bilstm_scan_bwd_kernel<R><<<grid, kThreads, smem, stream>>>(xproj2, hprev2, cprev2, dys2, wh2,
                                                              dxproj2, dh02, dc02, B, L, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bilstm_scan_bwd(const float* xproj2, const float* hprev2, const float* cprev2,
                               const float* dys2, const float* wh2, float* dxproj2, float* dh02,
                               float* dc02, float* dwh2, int B, int L, int H,
                               cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes(1, H) > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (B > 1 && smem_bytes(4, H) <= (size_t)limit)
    err = launch_rows<4>(xproj2, hprev2, cprev2, dys2, wh2, dxproj2, dh02, dc02, B, L, H, stream);
  else
    err = launch_rows<1>(xproj2, hprev2, cprev2, dys2, wh2, dxproj2, dh02, dc02, B, L, H, stream);
  if (err != cudaSuccess) return (int)err;

  // dW_h[d] = sum over (b, t) of h_prev^T da, da being dxproj.
  const size_t rows = (size_t)B * L;
  AtbBatch batch{};
  batch.count = 2;
  batch.rows = (int)rows;
  batch.period = L;
  for (int d = 0; d < 2; ++d)
    batch.p[d] = AtbProblem{hprev2 + d * rows * H, H, 0, dxproj2 + d * rows * 4 * H, 4 * H,
                            dwh2 + (size_t)d * H * 4 * H, nullptr, H, 4 * H};
  return (int)launch_atb(batch, stream);
}
