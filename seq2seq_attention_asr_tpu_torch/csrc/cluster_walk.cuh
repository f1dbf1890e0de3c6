// Pieces shared by the recurrent walks that run on a thread-block cluster:
// the GRU's forward and backward (csrc/gru_walk.cuh, kernels K1, K16, K18
// and K6, K17, K19) and the LSTM's forward and backward
// (csrc/bilstm_scan.cu, kernel K7; csrc/bilstm_scan_bwd.cu, kernel K9).
//
// One cluster of C blocks runs one direction's walk for R batch rows;
// block k owns the state units [k H / C, (k + 1) H / C) and holds the
// slice of the recurrent weight that forms them (in shared memory when
// the slice fits, else read from L2 each step). A step forms its units'
// share of a product from its slice and the gathered vectors (R rows of
// every unit, in every block's shared memory), pushes the values it
// forms into every block's gathered copy through distributed shared
// memory, and waits until the peers' pushes have arrived: at a cluster
// barrier (the backwards) or on an mbarrier that counts the bytes pushed
// into the block (the forwards).
//
// A backward splits into a gate pre-pass and a walk. Every step's h_prev
// is an input of the backward, so the gates of all B*L rows come from
// batched products before the walk (tile_product, 64 x 64 tiles of 4 x 4
// per thread as reduce_atb.cuh's), off the step chain. The walk keeps only
// the transposed products on the chain, from its rows of the weight.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // the largest portable cluster
constexpr int kTileThreads = 256;
constexpr int kTile = 64;
constexpr int kTileK = 32;

// The walk's plan, computed by the caller (ops/cuda/walk.py): blocks of a
// cluster, batch rows of a cluster, and whether the weight slices are
// held in shared memory (else read from L2 each step).
struct WalkPlan {
  int cluster, rows, resident;
};

// Shared memory of a walk, in bytes: the weight slice when resident
// (ceil(H / C) rows of `width` floats), `gathered` floats a batch row of
// the vectors gathered from every unit, two buffers of `staged` per-unit
// step inputs and `held` per-unit values kept across a step's phases.
// ops/cuda/walk.py computes the same.
size_t walk_smem_bytes(const WalkPlan& p, int H, int width, int gathered, int staged, int held) {
  const size_t hs = (H + p.cluster - 1) / p.cluster;
  return ((p.resident ? hs * width : 0) + (size_t)gathered * p.rows +
          (size_t)(2 * staged + held) * p.rows * hs) *
         sizeof(float);
}

// Whether the plan is one the walk instances take, and fits the device.
cudaError_t check_plan(const WalkPlan& p, int H, size_t smem) {
  const bool rows_ok = p.rows == 1 || p.rows == 2 || p.rows == 4 || p.rows == 8 || p.rows == 16;
  if (!rows_ok || p.cluster < 1 || p.cluster > kMaxCluster || p.cluster > H)
    return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return smem <= (size_t)limit ? cudaSuccess : cudaErrorInvalidValue;
}

// A launch configuration of kThreads-thread blocks in clusters of
// `cluster` along x (it points into itself: use it where it is built).
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;

  ClusterLaunch(dim3 grid, int cluster, size_t smem, cudaStream_t stream) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Launch `kernel` on clusters of `cluster` blocks along x.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int cluster, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const ClusterLaunch launch(grid, cluster, smem, stream);
  err = cudaLaunchKernelEx(&launch.cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The dynamic shared memory a block of `kernel` can take (the device's
// opt-in shared memory per block less the kernel's static shared memory),
// and how many clusters of `cluster` blocks of `kernel` can be resident at
// once when each block takes that much (one block to an SM).
template <typename... Params>
cudaError_t cluster_limits(void (*kernel)(Params...), int cluster, int* smem_limit,
                           int* clusters) {
  int dev = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  *smem_limit -= static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_limit);
  if (err != cudaSuccess) return err;
  const ClusterLaunch launch(dim3(cluster), cluster, *smem_limit, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel),
                                        &launch.cfg);
}

// Asynchronous copies global -> shared of 4 bytes, or 16 (both addresses
// 16-byte aligned); copy_async_wait waits for every copy this thread
// started.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[r * ldd + i] = src[r * lds + i] for r < nrows, i < n by asynchronous
// copies, and 0 for the rows nrows <= r < R or every row when src is null.
// With vec (dst, src, ldd, lds and n all multiples of 4 floats) the
// copies are 16 bytes wide: a quarter of the copy instructions.
template <int R>
__device__ void stage_async(float* dst, int ldd, const float* src, size_t lds, int n, int nrows,
                            bool vec) {
  const int w = vec ? 4 : 1, nw = n / w;
  for (int idx = threadIdx.x; idx < R * nw; idx += kThreads) {
    const int r = idx / nw, i = w * (idx - r * nw);
    float* d = dst + r * ldd + i;
    if (src == nullptr || r >= nrows) {
      for (int q = 0; q < w; ++q) d[q] = 0.f;
    } else if (vec) {
      copy_async16(d, src + r * lds + i);
    } else {
      copy_async(d, src + r * lds + i);
    }
  }
}

// As stage_async, from a bf16 source: plain loads widened to float, which
// have landed by the caller's next block barrier.
template <int R>
__device__ void stage_async(float* dst, int ldd, const bf16* src, size_t lds, int n, int nrows,
                            bool) {
  for (int idx = threadIdx.x; idx < R * n; idx += kThreads) {
    const int r = idx / n, i = idx - r * n;
    dst[r * ldd + i] = src == nullptr || r >= nrows ? 0.f : ldg_f(src + r * lds + i);
  }
}

// A cluster barrier in two halves (barrier.cluster): arrive releases this
// thread's earlier writes, wait returns once every thread of the cluster
// has arrived and acquires theirs. Work between the two overlaps the
// barrier's latency.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Exchanges through mbarriers instead of cluster barriers: a block stores
// into a peer's shared memory with st.async, each store counting its bytes
// on an mbarrier in the peer, and a block waits on its own mbarrier until
// the bytes it expects have arrived. Unlike barrier.cluster's release, no
// GPU-wide fence waits for the block's outstanding memory operations.
//
// The address of `p` (in this block's shared memory) in the shared-memory
// window of block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_map(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
  return out;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier of one arrival a phase; mbar_init_fence makes the inits of
// this thread visible to the cluster's asynchronous stores.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The phase's arrival, expecting `bytes` of asynchronous stores in it.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` of this parity has completed; what the
// stores that completed it wrote is then visible to the thread.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Store v at `dst`, an address in a block's window of the cluster's shared
// memory, and count its 4 bytes on the mbarrier at `bar` in the same block.
__device__ __forceinline__ void st_async(unsigned dst, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   dst),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// Store block k's units [lo, lo + hs) of the R rows of `buf` (R x H,
// every unit, in its shared memory) into the copy of every other block of
// its cluster of C with st.async, each store counted on that block's
// mbarrier at `bar`; consecutive threads store to consecutive addresses.
// With fewer values than threads, the peers are dealt out over groups of
// threads, so that more warps share the stores (at R = 1 one warp issuing
// all 7 x 32 stores made the exchange twice as long). The caller makes
// the block's values visible to its threads first (a block barrier).
template <int R>
__device__ __forceinline__ void push_units(float* buf, unsigned long long* bar, int H, int lo,
                                           int hs, int C, int k) {
  const int n = R * hs, groups = max(1, min(C - 1, kThreads / n));
  for (int idx = threadIdx.x; idx < n * groups; idx += kThreads) {
    const int g = idx / n, e = idx - g * n, r = e / hs, o = r * H + lo + e - r * hs;
    const float v = buf[o];
    for (int q = g; q < C - 1; q += groups) {
      const int p = q < k ? q : q + 1;
      st_async(cluster_map(buf + o, p), v, cluster_map(bar, p));
    }
  }
}

// Sum each of the R values of v over the warp, R a power of two <= 32,
// in about R shuffles: each level halves the values a lane keeps, the
// lanes whose bit `mask` is set keeping the upper half. Returns, on every
// lane, the sum of row `row`; the lanes l < R hold each row once.
template <int R>
__device__ __forceinline__ float reduce_rows(float (&v)[R], int& row) {
  static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0, "R is a power of two up to 32");
  const int lane = threadIdx.x & 31;
  row = 0;
#pragma unroll
  for (int k = R / 2, mask = 1; k >= 1; k /= 2, mask *= 2) {
    const bool up = lane & mask;
#pragma unroll
    for (int j = 0; j < k; ++j) {
      const float send = up ? v[j] : v[j + k];
      const float keep = up ? v[j + k] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
    if (up) row += k;
  }
#pragma unroll
  for (int mask = R; mask < 32; mask *= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], mask);
  return v[0];
}

// For the rows i < n of w (shared or global memory): the sums over j < m
// of w[i][j] v[r * ldv + j] for r < R, then emit(i, r, sum) on lane
// r' < R for its row r. Row i of w starts at w + i * ldw, its elements
// consecutive; with kColumns, row i is column i of an input-major matrix:
// w[i][j] at w[j * ldw + i]. With kGlobal, w is read-only global memory,
// read through the non-coherent cache 4 loads ahead of their use, each
// lane taking 4 consecutive floats of each row with 16-byte loads where
// `vec` (m, ldw, ldv, w and v 16-byte aligned). A warp takes two rows at
// once, i and i + kWarps, so that each load of v feeds two products. No
// barrier. A bf16 w (TW) is widened as it is read; with kRoundV each
// value of v is rounded to bf16 as it is read (a bf16 entry's operand
// rounding: v itself stays float).
template <int R, bool kColumns = false, bool kGlobal = false, bool kRoundV = false, class TW,
          class Emit>
__device__ __forceinline__ void rows_dot(const TW* w, int ldw, int n, const float* v, int ldv,
                                         int m, Emit emit, bool vec = false) {
  static_assert(!(kColumns && kGlobal), "kGlobal reads rows");
  static_assert(!(kRoundV && kGlobal), "kGlobal reads v unrounded");
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += 2 * kWarps) {
    const int i2 = i + kWarps < n ? i + kWarps : i;  // a lone last row is summed twice
    const TW* wa = kColumns ? w + i : w + (size_t)i * ldw;
    const TW* wb = kColumns ? w + i2 : w + (size_t)i2 * ldw;
    float sa[R], sb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sa[r] = sb[r] = 0.f;
    if constexpr (kGlobal) {
      if (vec) {
#pragma unroll 4
        for (int j = 4 * lane; j < m; j += 128) {
          const float4 xa = ldg_f4(wa + j);
          const float4 xb = ldg_f4(wb + j);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(v + r * ldv + j);
            sa[r] = fmaf(xa.w, x.w, fmaf(xa.z, x.z, fmaf(xa.y, x.y, fmaf(xa.x, x.x, sa[r]))));
            sb[r] = fmaf(xb.w, x.w, fmaf(xb.z, x.z, fmaf(xb.y, x.y, fmaf(xb.x, x.x, sb[r]))));
          }
        }
      } else {
#pragma unroll 4
        for (int j = lane; j < m; j += 32) {
          const float xa = ldg_f(wa + j), xb = ldg_f(wb + j);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float x = v[r * ldv + j];
            sa[r] = fmaf(xa, x, sa[r]);
            sb[r] = fmaf(xb, x, sb[r]);
          }
        }
      }
    } else {
#pragma unroll 2
      for (int j = lane; j < m; j += 32) {
        float xa, xb;
        if constexpr (kColumns) {
          xa = to_f(wa[(size_t)j * ldw]), xb = to_f(wb[(size_t)j * ldw]);
        } else {
          xa = to_f(wa[j]), xb = to_f(wb[j]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = kRoundV ? round_to<bf16>(v[r * ldv + j]) : v[r * ldv + j];
          sa[r] = fmaf(xa, x, sa[r]);
          sb[r] = fmaf(xb, x, sb[r]);
        }
      }
    }
    int ra, rb;
    const float suma = reduce_rows<R>(sa, ra);
    const float sumb = reduce_rows<R>(sb, rb);
    if (lane < R) {
      if constexpr (kGlobal) {  // one copy of emit: the walk's code a step is large
#pragma unroll 1
        for (int pass = 0; pass < (i2 != i ? 2 : 1); ++pass)
          emit(pass ? i2 : i, pass ? rb : ra, pass ? sumb : suma);
      } else {
        emit(i, ra, suma);
        if (i2 != i) emit(i2, rb, sumb);
      }
    }
  }
}

// acc[r][c] = sum_{k < K} a(i0 + 4 ty + r, k) * b(k, j0 + 4 tx + c) for
// the 64 x 64 tile (i0, j0), thread (ty, tx) = (tid / 16, tid % 16) of
// kTileThreads; a and b return 0 outside their arrays. K is taken 32 at a
// time through shared memory.
template <class A, class Bf>
__device__ void tile_product(float (&acc)[4][4], A a, Bf b, int i0, int j0, int K) {
  __shared__ float as[kTileK][kTile + 1];
  __shared__ float bs[kTileK][kTile + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int idx = tid; idx < kTileK * kTile; idx += kTileThreads) {
      const int xa = idx / kTileK, ka = idx % kTileK;  // a's rows are contiguous in k
      as[ka][xa] = k0 + ka < K ? a(i0 + xa, k0 + ka) : 0.f;
      const int kb = idx / kTile, xb = idx % kTile;  // b's rows are contiguous in j
      bs[kb][xb] = k0 + kb < K ? b(k0 + kb, j0 + xb) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = as[k][4 * ty + r], bv[r] = bs[k][4 * tx + r];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
}

}  // namespace
