// Fused log-mel front end: framing, Hann window, real power spectrum,
// mel-128 filterbank, 10*log10(max(amin, .)) and per-frame RMS energy.
//
// Replaces the Pallas kernel stft_logmel_power
// (seq2seq_attention_asr_tpu/ops/pallas/logmel.py:119, _kernel :69).
// Plain PyTorch twin: ops/cuda/logmel.py::stft_logmel_power_plain.
//
// What bounds it: neither bytes nor operations. A frame is 8 KB in and
// 516 B out and ~60k flops; a served request is one bucket of ~112
// frames, one block a frame, one wave on the card, so the kernel's time
// is one block's dependent chain (loads, FFT passes, barriers, the mel
// sums) plus the launch. The TPU kernel spends 2*2048*1152*2 flops a
// frame on dense DFT matmuls because its matrix unit makes them cheap;
// here the design shortens the chain instead:
//   - the 2048 real samples are packed as 1024 complex points z[n] =
//     x[2n] + i x[2n+1] and transformed as two 512-point FFTs (z's even
//     and odd points), each thread holding 8 points in registers: three
//     radix-8 passes (a four-step 8 x 8 x 8 split), with two block
//     barriers and one warp-local exchange, no bit-reversal pass;
//   - one split step forms the radix-2 merge and the real spectrum:
//     X[k] = (Z[k] + conj Z[1024-k]) / 2 - i W^k (Z[k] - conj Z[1024-k]) / 2,
//     W = exp(-2 pi i / 2048), four bins {k, 512-k, 512+k, 1024-k} from
//     E and O at k and 512-k;
//   - every twiddle comes from tables built once on the host in float64
//     (ops/cuda/logmel.py::_consts), loaded with the frame in one burst:
//     pass 1's seven per thread as three loads and four products, the
//     merge's as the square of the split's;
//   - the mel product runs on each filter's nonzero taps, cut into chunks
//     of at most kRun taps (a table of kSlots chunks, of which the first
//     nchunks hold taps), loaded into registers in the same burst,
//     kSlots / kThreads chunks a thread; then one thread a filter sums
//     its chunks in order, so two calls give the same bits.
// Every load of a block comes from L2 (one block an SM at serving
// sizes), so the burst's bytes set its first phase: ~36 KB a frame, the
// frame and the window 16 KB of it. One block per frame over the B * L
// frames on blockIdx.x. A row that starts off an 8-byte boundary (odd S)
// loads its samples one by one.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 2048;               // frame
constexpr int kHalf = kN / 2;          // the complex FFT's points
constexpr int kSub = kHalf / 2;        // each of its two halves (E, O)
constexpr int kHop = 512;
constexpr int kNFreq = kN / 2 + 1;
constexpr int kMels = 128;
constexpr int kRun = 16;               // taps a chunk
constexpr int kSlots = 256;            // chunks in the table
constexpr int kThreads = 128;          // block: 2 x 64 FFT threads of 8 points
constexpr int kGroups = (kHalf / 4 + kThreads) / kThreads;  // split groups a thread
constexpr int kPer = kSlots / kThreads;                     // chunks a thread
constexpr float kAmin = 1e-10f;
// Shared-memory layouts, padded so that each pass's accesses fall on
// distinct banks in every half-warp (8-byte accesses): rows of pass 1's
// output and of the warp exchange are 72 points apart (72 = 8 mod 16),
// a row of the exchange holds 8 runs of 9, and O's spectrum starts 8
// points after E's 512, each XOR-swizzled within runs of 8.
constexpr int kRow = 72;
constexpr int kSpecO = kSub + 8;

static_assert(kThreads == kHalf / 8 && kThreads == kMels, "a point of 8 and a filter a thread");
static_assert(kSlots % kThreads == 0, "chunks a thread");

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// p[k] <- sum_m p[m] (-i)^(m k).
__device__ __forceinline__ void dft4(float2& p0, float2& p1, float2& p2, float2& p3) {
  const float2 q0 = cadd(p0, p2), q2 = csub(p0, p2), q1 = cadd(p1, p3), d = csub(p1, p3);
  const float2 q3 = make_float2(d.y, -d.x);  // -i (p1 - p3)
  p0 = cadd(q0, q1);
  p2 = csub(q0, q1);
  p1 = cadd(q2, q3);
  p3 = csub(q2, q3);
}

// v[k] <- sum_m v[m] exp(-2 pi i m k / 8), in registers (radix-2 split).
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  constexpr float r = 0.70710678118654752f;
  float2 b0 = cadd(v[0], v[4]), b1 = cadd(v[1], v[5]), b2 = cadd(v[2], v[6]),
         b3 = cadd(v[3], v[7]);
  float2 c0 = csub(v[0], v[4]);
  const float2 d1 = csub(v[1], v[5]), d2 = csub(v[2], v[6]), d3 = csub(v[3], v[7]);
  float2 c1 = make_float2(r * (d1.x + d1.y), r * (d1.y - d1.x));   // W8 d1
  float2 c2 = make_float2(d2.y, -d2.x);                            // -i d2
  float2 c3 = make_float2(r * (d3.y - d3.x), -r * (d3.x + d3.y));  // W8^3 d3
  dft4(b0, b1, b2, b3);
  dft4(c0, c1, c2, c3);
  v[0] = b0; v[2] = b1; v[4] = b2; v[6] = b3;
  v[1] = c0; v[3] = c1; v[5] = c2; v[7] = c3;
}

// A bin's place in the spectrum buffer.
__device__ __forceinline__ int swz(int bin) { return bin ^ ((bin >> 3) & 7); }

// 4 |X|^2 for X = P + s Q, P = (a + conj b) / 2 and Q = -i (a - conj b) / 2
// the spectra of the frame's even and odd samples at the bin.
__device__ __forceinline__ float power4(float2 a, float2 b, float2 s) {
  const float px = a.x + b.x, py = a.y - b.y, qx = a.y + b.y, qy = b.x - a.x;
  const float x = px + s.x * qx - s.y * qy, y = py + s.x * qy + s.y * qx;
  return x * x + y * y;
}

// Bins k, 1024-k, 512-k and 512+k (k <= 256) from E and O at k and
// 512-k, w = exp(-2 pi i k / 1024) and s = exp(-2 pi i k / 2048): writes
// their power and returns its sum over the distinct bins.
__device__ __forceinline__ float split_group(const float2* spec, float* pw, int k, float2 w,
                                             float2 s) {
  const int k2 = (kSub - k) & (kSub - 1);
  const float2 e1 = spec[swz(k)], o1 = spec[kSpecO + swz(k)];
  const float2 e2 = spec[swz(k2)], o2 = spec[kSpecO + swz(k2)];
  const float2 wo1 = cmul(w, o1), wo2 = cmul(make_float2(w.x, -w.y), o2);
  const float2 z0 = cadd(e1, wo1), z1 = csub(e2, wo2);   // Z[k], Z[512-k]
  const float2 z2 = cadd(e1, make_float2(-wo1.x, -wo1.y)), z3 = cadd(e2, wo2);  // Z[512+k], Z[1024-k]
  const float p0 = 0.25f * power4(z0, z3, s);
  const float p3 = 0.25f * power4(z3, z0, make_float2(-s.x, s.y));    // s at 1024-k
  const float p1 = 0.25f * power4(z1, z2, make_float2(-s.y, -s.x));   // s at 512-k
  const float p2 = 0.25f * power4(z2, z1, make_float2(s.y, -s.x));    // s at 512+k
  pw[k] = p0;
  pw[kHalf - k] = p3;
  float sum = p0 + p3;
  if (k < kHalf / 4) {  // k = 256: 512-k and 512+k are k and 1024-k again
    pw[kSub - k] = p1;
    sum += p1;
    if (k > 0) {  // k = 0: 512+k is 512-k
      pw[kSub + k] = p2;
      sum += p2;
    }
  }
  return sum;
}

__global__ void __launch_bounds__(kThreads)
stft_logmel_kernel(const float* __restrict__ yp, const float* __restrict__ window,
                   const float2* __restrict__ fft_tw, const float2* __restrict__ split_tw,
                   const float4* __restrict__ taps, const int* __restrict__ tap_start,
                   const int* __restrict__ mel_first, float* __restrict__ lm,
                   float* __restrict__ energy, int S, int nframes, int nchunks) {
  __shared__ float2 buf1[2 * 8 * kRow];   // pass 1's output, by (k1, half) row
  __shared__ float2 buf2[2 * 8 * kRow];   // pass 2's output, exchanged in a warp
  __shared__ float2 spec[kSpecO + kSub];  // E and O
  __shared__ float pw[kNFreq];
  __shared__ float part[kSlots];
  __shared__ float red[kThreads / 32];

  const int tid = threadIdx.x, fid = blockIdx.x;
  const int row = fid / nframes, f = fid - row * nframes;
  const float* frame = yp + (size_t)row * S + (size_t)f * kHop;
  // FFT thread: half g (0: E, z's even points; 1: O), u < 64 its place;
  // lanes 2u and 2u + 1 read adjacent pairs of samples.
  const int g = tid & 1, u = tid >> 1;
  const int k1 = u >> 3, lo3 = u & 7;

  // One burst: the frame's samples (pass 1 takes z_g[u + 64 m], m < 8:
  // x[4 (u + 64 m) + 2 g] and the next), the twiddles, this thread's
  // split groups, its chunks of taps and its filter's chunk range.
  float2 v[8], w1[7], w2[7], sw[kGroups];
  float4 tv[kPer][kRun / 4];
  int ts[kPer];
  if ((reinterpret_cast<uintptr_t>(frame) & 7) == 0) {
    const float2* f2 = reinterpret_cast<const float2*>(frame);
    const float2* w2p = reinterpret_cast<const float2*>(window);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float2 x = __ldg(f2 + 2 * (u + 64 * m) + g), h = __ldg(w2p + 2 * (u + 64 * m) + g);
      v[m] = make_float2(x.x * h.x, x.y * h.y);
    }
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int n = 4 * (u + 64 * m) + 2 * g;
      v[m] = make_float2(__ldg(frame + n) * __ldg(window + n),
                         __ldg(frame + n + 1) * __ldg(window + n + 1));
    }
  }
  w1[0] = __ldg(fft_tw + 2 * u);   // exp(-2 pi i u k / 512), k = 1, 2, 4
  w1[1] = __ldg(fft_tw + 4 * u);
  w1[3] = __ldg(fft_tw + 8 * u);
#pragma unroll
  for (int k = 1; k < 8; ++k) w2[k - 1] = __ldg(fft_tw + 16 * lo3 * k);  // exp(-2 pi i j1 q1 / 64)

#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int k = min(tid + i * kThreads, kHalf / 4);
    sw[i] = __ldg(split_tw + k);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = tid + i * kThreads;
    ts[i] = 0;  // an empty slot: no load, zero taps
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) tv[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < nchunks) {
      ts[i] = __ldg(tap_start + s);
#pragma unroll
      for (int q = 0; q < kRun / 4; ++q) tv[i][q] = __ldg(taps + s * (kRun / 4) + q);
    }
  }
  const int c_lo = __ldg(mel_first + tid), c_hi = __ldg(mel_first + tid + 1);

  // Pass 1: the 8-point DFT over m, then exp(-2 pi i u k1 / 512).
  w1[2] = cmul(w1[0], w1[1]);
  w1[4] = cmul(w1[0], w1[3]);
  w1[5] = cmul(w1[1], w1[3]);
  w1[6] = cmul(w1[2], w1[3]);
  dft8(v);
#pragma unroll
  for (int k = 1; k < 8; ++k) v[k] = cmul(v[k], w1[k - 1]);
#pragma unroll
  for (int k = 0; k < 8; ++k) buf1[(2 * k + g) * kRow + u] = v[k];
  __syncthreads();
  // [phase] loads, pass 1

  // Pass 2, thread (k1, j1 = lo3): the 8-point DFT over j2 of the pass-1
  // outputs k1 at u' = j1 + 8 j2, then exp(-2 pi i j1 q1 / 64).
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = buf1[(2 * k1 + g) * kRow + lo3 + 8 * j];
  dft8(v);
#pragma unroll
  for (int q = 1; q < 8; ++q) v[q] = cmul(v[q], w2[q - 1]);
#pragma unroll
  for (int q = 0; q < 8; ++q) buf2[(2 * k1 + g) * kRow + lo3 * 9 + q] = v[q];
  // Pass 3, thread (k1, q1 = lo3): the 8-point DFT over j1; the 8 lanes
  // of (k1, g) are in this warp.
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = buf2[(2 * k1 + g) * kRow + j * 9 + lo3];
  dft8(v);
#pragma unroll
  for (int q = 0; q < 8; ++q) spec[g * kSpecO + swz(k1 + 8 * lo3 + 64 * q)] = v[q];
  __syncthreads();
  // [phase] passes 2, 3

  // The split, the power of every bin, and the energy's partial sums.
  float e = 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int k = tid + i * kThreads;
    if (k <= kHalf / 4) e += split_group(spec, pw, k, cmul(sw[i], sw[i]), sw[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
  if ((tid & 31) == 0) red[tid >> 5] = e;
  __syncthreads();
  // [phase] split, power, energy

  if (tid == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
    energy[fid] = sqrtf(sum / (float)kNFreq);
  }
  // The chunks' sums: four chains of 4 taps each, then their sum.
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float* p = pw + ts[i];
    float acc[kRun / 4];
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const float4 t = tv[i][q];
      acc[q] = fmaf(t.w, p[4 * q + 3], fmaf(t.z, p[4 * q + 2],
                    fmaf(t.y, p[4 * q + 1], t.x * p[4 * q])));
    }
    part[tid + i * kThreads] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncthreads();
  // [phase] mel chunks

  float m = 0.f;
  for (int c = c_lo; c < c_hi; ++c) m += part[c];
  lm[(size_t)fid * kMels + tid] = 10.f * log10f(fmaxf(kAmin, m));
  // [phase] filters, store
}

}  // namespace

extern "C" int stft_logmel_power(const float* yp, const float* window, const float2* fft_tw,
                                 const float2* split_tw, const float* taps,
                                 const int* tap_start, const int* mel_first, float* lm,
                                 float* energy, int B, int S, int nframes, int nfreq,
                                 int nchunks, cudaStream_t stream) {
  const long long frames = (long long)B * nframes;
  if (nfreq != kNFreq || B < 1 || nframes < 1 || frames > INT_MAX ||
      (long long)(nframes - 1) * kHop + kN > (long long)S)
    return (int)cudaErrorInvalidValue;
  stft_logmel_kernel<<<(unsigned)frames, kThreads, 0, stream>>>(
      yp, window, fft_tw, split_tw, reinterpret_cast<const float4*>(taps), tap_start, mel_first,
      lm, energy, S, nframes, nchunks);
  return (int)cudaGetLastError();
}
