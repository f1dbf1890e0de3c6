// Device helpers shared by the kernels: the block size, the encoder
// mask's NEG_INF, warp reductions, activations, and the IO of the bf16
// entries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The bf16 entries' IO: a bf16 value loads widened to float (exactly) and
// a float stores rounded to the nearest even bf16; the math stays float.
// The float overloads are the plain loads and store, so that a float
// instance of a kernel templated on its IO type T is the code it was.
using bf16 = __nv_bfloat16;
template <class T>
constexpr bool kIsBf16 = false;
template <>
constexpr bool kIsBf16<bf16> = true;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const bf16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
// Four consecutive values from read-only global memory: 16 bytes of
// float (p 16-byte aligned) or 8 of bf16 (p 8-byte aligned).
__device__ __forceinline__ float4 ldg_f4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg_f4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
// v rounded to T's precision, as a float: where a bf16 entry rounds a
// product's operand (the identity for float).
template <class T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (kIsBf16<T>)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;  // rows (hypotheses, batch rows) of one product
// The encoder mask's NEG_INF (ops/masking.py), which the attention kernels
// put on masked positions.
constexpr float kNegInf = -1e30f;

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

}  // namespace
