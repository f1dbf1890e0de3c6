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
// tail). Each step recomputes the gates from h_prev, then
//
//   dh = dys[t] + carry;  dz = dh (c - h_prev);  da_c = dh z (1 - c^2)
//   drh = da_c @ Wh^T;  da_z = dz z (1 - z);  da_r = drh h_prev r (1 - r)
//   carry = drh r + [da_z | da_r] @ Wzr^T + dh (1 - z)
//   dx[t] = [da_z | da_r | da_c]
//
// What bounds it: as in the forward (csrc/bigru_scan2.cu), the steps form
// a chain and each needs the whole recurrent weight set of its direction
// (768 KB at H = 256) from L2, here twice (two recompute products and
// two transposed products per step). One block runs one direction for a
// group of rows with the state in shared memory, so every weight is read
// once per step for all rows of the block. The weight gradients are not
// summed in the loop (their 768 KB of accumulators per direction fit in
// no SM): the loop writes r * h_prev per step, and a second kernel
// (reduce_atb.cuh) forms dWzr = sum h_prev^T [da_z | da_r] and dWh =
// sum (r h_prev)^T da_c over the B*L rows, tiled and deterministic.

#include "common.cuh"
#include "reduce_atb.cuh"

namespace {

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bigru_scan2_bwd_kernel(const float* __restrict__ xf, const float* __restrict__ xb,
                       const float* __restrict__ wzr2, const float* __restrict__ wh2,
                       const float* __restrict__ ysf, const float* __restrict__ ysb,
                       const float* __restrict__ dysf, const float* __restrict__ dysb,
                       float* __restrict__ dxf, float* __restrict__ dxb,
                       float* __restrict__ rh_out, int B, int L, int H) {
  extern __shared__ float smem[];
  const int H2 = 2 * H, H3 = 3 * H;
  float* hp = smem;            // [R][H]   h_prev
  float* zr = hp + R * H;      // [R][2H]  z | r
  float* rh = zr + R * H2;     // [R][H]   r * h_prev
  float* c = rh + R * H;       // [R][H]   candidate
  float* dh = c + R * H;       // [R][H]
  float* carry = dh + R * H;   // [R][H]   dh carried to the next step of the walk
  float* da = carry + R * H;   // [R][3H]  da_z | da_r | da_c
  float* drh = da + R * H3;    // [R][H]   da_c @ Wh^T
  float* dsr = drh + R * H;    // [R][H]   [da_z | da_r] @ Wzr^T
  float* scratch = dsr + R * H;

  const int d = blockIdx.x;
  const int b0 = blockIdx.y * R;
  const int nrows = min(R, B - b0);
  const float* x = d == 0 ? xf : xb;
  const float* ys = d == 0 ? ysf : ysb;
  const float* dys = d == 0 ? dysf : dysb;
  float* dx = d == 0 ? dxf : dxb;
  float* rho = rh_out + (size_t)d * B * L * H;
  const float* wzr = wzr2 + (size_t)d * H * H2;
  const float* wh = wh2 + (size_t)d * H * H;
  const int prev = d == 0 ? -1 : 1;  // h_prev sits at t + prev

  for (int i = threadIdx.x; i < R * H; i += kThreads) carry[i] = 0.f;

  for (int s = 0; s < L; ++s) {
    const int t = d == 0 ? L - 1 - s : s;
    const int tp = t + prev;
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, u = idx % H;
      hp[idx] = r < nrows && tp >= 0 && tp < L ? ys[((size_t)(b0 + r) * L + tp) * H + u] : 0.f;
    }
    __syncthreads();
    // Recompute the gates and the candidate.
    matvec<kNone>(wzr, nullptr, H, H2, hp, H, zr, H2, R, scratch);
    for (int idx = threadIdx.x; idx < R * H2; idx += kThreads) {
      const int r = idx / H2, j = idx % H2;
      const float xv = r < nrows ? x[((size_t)(b0 + r) * L + t) * H3 + j] : 0.f;
      const float g = sigmoid(zr[idx] + xv);
      zr[idx] = g;
      if (j >= H) rh[r * H + j - H] = g * hp[r * H + j - H];
    }
    __syncthreads();
    matvec<kNone>(wh, nullptr, H, H, rh, H, c, H, R, scratch);
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, u = idx % H;
      const size_t row = (size_t)(b0 + r) * L + t;
      const float cv = tanhf(c[idx] + (r < nrows ? x[row * H3 + H2 + u] : 0.f));
      c[idx] = cv;
      const float dhv = (r < nrows ? dys[row * H + u] : 0.f) + carry[idx];
      dh[idx] = dhv;
      const float z = zr[r * H2 + u];
      da[r * H3 + H2 + u] = dhv * z * (1.f - cv * cv);
    }
    __syncthreads();
    // Backprop through the candidate product, then the gates.
    matvec_t<R>(wh, H, H, da + H2, H3, drh, H);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, u = idx % H;
      const float z = zr[r * H2 + u], rg = zr[r * H2 + H + u], h = hp[idx];
      const float dz = dh[idx] * (c[idx] - h);
      da[r * H3 + u] = dz * z * (1.f - z);
      da[r * H3 + H + u] = drh[idx] * h * rg * (1.f - rg);
    }
    __syncthreads();
    matvec_t<R>(wzr, H, H2, da, H3, dsr, H);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, u = idx % H;
      const float z = zr[r * H2 + u], rg = zr[r * H2 + H + u];
      carry[idx] = drh[idx] * rg + dsr[idx] + dh[idx] * (1.f - z);
      if (r < nrows) rho[((size_t)(b0 + r) * L + t) * H + u] = rh[idx];
    }
    for (int idx = threadIdx.x; idx < R * H3; idx += kThreads) {
      const int r = idx / H3, j = idx % H3;
      if (r < nrows) dx[((size_t)(b0 + r) * L + t) * H3 + j] = da[idx];
    }
    __syncthreads();
  }
}

size_t smem_bytes(int R, int H) {
  return ((size_t)12 * R * H + (size_t)kThreads * 4 * R) * sizeof(float);
}

template <int R>
cudaError_t launch_rows(const float* xf, const float* xb, const float* wzr2, const float* wh2,
                        const float* ysf, const float* ysb, const float* dysf, const float* dysb,
                        float* dxf, float* dxb, float* rh, int B, int L, int H,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes(R, H);
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
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes(1, H) > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (B > 1 && smem_bytes(4, H) <= (size_t)limit)
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
