// Device helpers shared by the kernels that stream input-major weights
// through one block of kThreads threads: warp reductions, activations,
// and the two matrix-vector products of a recurrence step, x @ W
// (matvec) and v @ W^T (matvec_t), for a few rows at once.
//
// Weights are input-major (in, out) in global memory, read from L2 for
// every step (a step's weights do not fit in one SM); vectors are in
// shared memory.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;  // rows (hypotheses, batch rows) of one product

enum Act { kNone, kSigmoid, kTanh };

template <int act>
__device__ __forceinline__ float activate(float x) {
  if (act == kSigmoid) return 1.f / (1.f + expf(-x));
  if (act == kTanh) return tanhf(x);
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tanh(x) = 1 - 2 / (1 + e^(2x)) with the fast exponential: absolute
// error ~1e-7, a quarter of tanhf's instructions. Used for the
// attention energies, L * S of them per row and step.
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

// y[k*ys + j] = act(sum_i x[k*xs + i] * w[i*out + j] + bias[j]) for k < K, j < out.
// w is read once for all K rows, VW consecutive columns per load
// (16-byte loads when VW = 4). Latency, not L2 bandwidth, limits one
// block's weight stream, so when there are fewer column groups than
// threads the input range is split over kThreads / (out / VW) thread
// groups, which keeps more loads in flight; their partial sums meet in
// `scratch` (kThreads * 4 * K floats). Ends with a block barrier.
template <int act, int VW>
__device__ void matvec_vw(const float* __restrict__ w, const float* __restrict__ bias, int in,
                          int out, const float* x, int xs, float* y, int ys, int K,
                          float* scratch) {
  const int tid = threadIdx.x;
  const int q = out / VW;
  const int parts = q >= kThreads ? 1 : kThreads / q;
  const int p = tid / q;
  if (p < parts) {
    for (int jq = tid - p * q; jq < q; jq += kThreads) {
      float acc[kMaxK][VW];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
#pragma unroll
        for (int v = 0; v < VW; ++v) acc[k][v] = 0.f;
#pragma unroll 4
      for (int i = p; i < in; i += parts) {
        const float* wp = w + (size_t)i * out + VW * jq;
        float wv[VW];
        if constexpr (VW == 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(wp));
          wv[0] = t.x, wv[1] = t.y, wv[2] = t.z, wv[3] = t.w;
        } else {
          wv[0] = __ldg(wp);
        }
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (k < K) {
            const float xv = x[k * xs + i];
#pragma unroll
            for (int v = 0; v < VW; ++v) acc[k][v] = fmaf(xv, wv[v], acc[k][v]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            const int j = VW * jq + v;
            if (parts == 1)
              y[k * ys + j] = activate<act>(acc[k][v] + (bias ? bias[j] : 0.f));
            else
              scratch[(p * K + k) * out + j] = acc[k][v];
          }
        }
      }
    }
  }
  __syncthreads();
  if (parts == 1) return;
  for (int idx = tid; idx < K * out; idx += kThreads) {
    const int k = idx / out, j = idx % out;
    float sum = 0.f;
    for (int r = 0; r < parts; ++r) sum += scratch[(r * K + k) * out + j];
    y[k * ys + j] = activate<act>(sum + (bias ? bias[j] : 0.f));
  }
  __syncthreads();
}

template <int act>
__device__ void matvec(const float* __restrict__ w, const float* __restrict__ bias, int in,
                       int out, const float* x, int xs, float* y, int ys, int K,
                       float* scratch) {
  if ((out & 3) == 0 && (reinterpret_cast<size_t>(w) & 15) == 0)
    matvec_vw<act, 4>(w, bias, in, out, x, xs, y, ys, K, scratch);
  else
    matvec_vw<act, 1>(w, bias, in, out, x, xs, y, ys, K, scratch);
}

// y[k*ys + i] = sum_j w[i*out + j] * v[k*vs + j] for k < K, i < in: the
// product with W^T that a backward step needs. Row i of the input-major
// W is contiguous, so a warp takes a row and its lanes stride over j
// with 16-byte loads where the layout allows; then a lane reads 4
// consecutive floats of v, and lanes 8 apart read the two halves in the
// other order, so that each read is 2-way bank-conflicted, not 4-way
// (the products are summed in the same order). No barrier at the end.
template <int K>
__device__ void matvec_t(const float* __restrict__ w, int in, int out, const float* v, int vs,
                         float* y, int ys) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, swz = (lane >> 2) & 2;
  const bool vec = (out & 3) == 0 && (reinterpret_cast<size_t>(w) & 15) == 0;
  for (int i = warp; i < in; i += kWarps) {
    const float* wr = w + (size_t)i * out;
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    if (vec) {
#pragma unroll 4
      for (int j = 4 * lane; j < out; j += 128) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(wr + j));
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float* vk = v + k * vs + j;
          const float a0 = vk[swz], a1 = vk[swz + 1], a2 = vk[swz ^ 2], a3 = vk[(swz ^ 2) + 1];
          const float v0 = swz ? a2 : a0, v1 = swz ? a3 : a1, v2 = swz ? a0 : a2,
                      v3 = swz ? a1 : a3;
          acc[k] = fmaf(t.x, v0, fmaf(t.y, v1, fmaf(t.z, v2, fmaf(t.w, v3, acc[k]))));
        }
      }
    } else {
      for (int j = lane; j < out; j += 32) {
        const float wv = __ldg(wr + j);
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = fmaf(wv, v[k * vs + j], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float s = warp_sum(acc[k]);
      if (lane == 0) y[k * ys + i] = s;
    }
  }
}

// Sum of v over the block; `red` holds kWarps floats. Every thread gets
// the result. Starts and ends with a barrier of its own.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

}  // namespace
