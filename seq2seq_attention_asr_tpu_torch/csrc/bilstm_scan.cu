// Bidirectional LSTM scan, forward only, without peepholes.
//
// Replaces the forward of the Pallas kernel bilstm_scan
// (seq2seq_attention_asr_tpu/ops/pallas/lstm_scan.py:178, _run_fwd :103,
// _fwd_kernel :36). Plain PyTorch twin:
// ops/cuda/lstm_scan.py::bilstm_scan_plain.
//
//   gates = xproj[t] + h @ W_h          (order in, forget, cell, out)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//
// Both directions read the direction-stacked (2, B, L, 4H) projections;
// direction 1 arrives in its own scan order, so both walk t = 0..L-1.
// The LSTM has biases, so h = 0 is not a fixed point under zero input:
// the caller flips the backward direction about each row's length.
//
// What bounds it: the L steps form a dependency chain, and each step
// needs the direction's whole recurrent weight, H x 4H floats (256 KB at
// H = 128), more than one block's shared memory, so it streams from L2
// every step. One block runs one direction for up to kRows batch rows,
// with h and c in shared memory, so each weight is read once per step
// for all the rows of the block (common.cuh matvec: 16-byte loads, the
// input dimension split over thread groups to keep loads in flight).
// Splitting the gate columns over a cluster of blocks is the way past
// the one-SM L2 rate.

#include "common.cuh"

namespace {

constexpr int kRows = 4;  // batch rows per block

__global__ void __launch_bounds__(kThreads, 1)
bilstm_scan_kernel(const float* __restrict__ xproj2, const float* __restrict__ h02,
                   const float* __restrict__ c02, const float* __restrict__ wh2,
                   float* __restrict__ hs2, float* __restrict__ cs2, int B, int L, int H) {
  extern __shared__ float sm[];
  const int d = blockIdx.x;
  const int b0 = blockIdx.y * kRows;
  const int R = min(kRows, B - b0);
  const int H4 = 4 * H;
  float* hs = sm;                   // [R][H]   hidden state
  float* cs = hs + kRows * H;       // [R][H]   cell state
  float* g = cs + kRows * H;        // [R][4H]  h @ W_h
  float* scratch = g + kRows * H4;  // [kThreads * 4 * kRows]
  const float* wh = wh2 + (size_t)d * H * H4;
  const size_t row0 = (size_t)d * B + b0;  // first (direction, batch) row of the block

  for (int i = threadIdx.x; i < R * H; i += kThreads) {
    hs[i] = h02[row0 * H + i];
    cs[i] = c02[row0 * H + i];
  }
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    matvec<kNone>(wh, nullptr, H, H4, hs, H, g, H4, R, scratch);
    for (int i = threadIdx.x; i < R * H; i += kThreads) {
      const int r = i / H, j = i % H;
      const size_t at = (row0 + r) * L + t;
      const float* x = xproj2 + at * H4;
      const float* gr = g + r * H4;
      const float ig = activate<kSigmoid>(gr[j] + x[j]);
      const float fg = activate<kSigmoid>(gr[H + j] + x[H + j]);
      const float gg = tanhf(gr[2 * H + j] + x[2 * H + j]);
      const float og = activate<kSigmoid>(gr[3 * H + j] + x[3 * H + j]);
      const float c = fg * cs[i] + ig * gg;
      const float h = og * tanhf(c);
      cs[i] = c;
      hs[i] = h;
      cs2[at * H + j] = c;
      hs2[at * H + j] = h;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int bilstm_scan_fwd(const float* xproj2, const float* h02, const float* c02,
                               const float* wh2, float* hs2, float* cs2, int B, int L, int H,
                               cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const size_t bytes = ((size_t)kRows * 6 * H + (size_t)kThreads * 4 * kRows) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bilstm_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(2, (B + kRows - 1) / kRows);
  bilstm_scan_kernel<<<grid, kThreads, bytes, stream>>>(xproj2, h02, c02, wh2, hs2, cs2, B, L,
                                                         H);
  return (int)cudaGetLastError();
}
