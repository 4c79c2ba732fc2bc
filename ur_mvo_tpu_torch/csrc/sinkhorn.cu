// Log-domain Sinkhorn iterations for Hopper (sm_90a).
//
// Replaces the TPU kernel ur_mvo_tpu/ops/pallas_kernels.py::_sinkhorn_kernel
// (:31). Given the prepared (M, N) couplings C (dustbin row/column included,
// -1e9 at invalid entries) and log-marginals log_mu (M) / log_nu (N), it runs
//   u = log_mu - lse_rows(C + v);  v = log_nu - lse_cols(C + u)
// `iters` times from u = v = 0 and writes out = C + u + v. Each log-sum-exp
// clamps its max at -1e9 and floors its sum at 1e-30, as the TPU kernel does
// (pallas_kernels.py:37-45).
//
// Design. The TPU kernel keeps the whole matrix in VMEM for all sweeps; one
// SM's shared memory cannot hold 1025^2 float32 (4.2 MB), but the card's 132
// together can. So ONE persistent cooperative launch, one block of 1,024
// threads an SM, runs every sweep and the final write: block b owns a band
// of rows and a band of columns and copies both bands of C into shared
// memory once (cp.async; rows as they lie, columns transposed). At 1025 x
// 1025 a band is 8 rows or 8 columns, 32.8 KB each. After each half-sweep
// the blocks write their slice of u (or v) to device memory, meet at a grid
// barrier and read the whole vector back into shared memory: 2 x iters
// barriers, and device memory sees C once and `out` once. Where the two
// bands and the vectors do not fit in shared memory (2049 x 2049: 16-row
// bands), the row band stays resident and the column sweep reads its band
// from L2 (the "streamed" route). The route is a property of the shape
// (`urmvo_sinkhorn_info`). A shape whose row band and vectors alone exceed a
// block's shared memory (from about 2640 x 2640; the matcher's capacity
// stops at 2048, 2049 x 2049 with the dustbins) is refused.
//
// The bits are those of the earlier design (a block a row, then a block per
// 32 columns, a launch a half-sweep), because the partition of every sum is
// kept, whatever block, warp or memory holds the work:
// - row i: "virtual thread" t of 256 sums expf(C[i,j] + v[j] - mx) over
//   j = t, t+256, ... in order, a __shfl_xor butterfly (16 ... 1) sums each
//   virtual warp, and the 8 warp partials go through a second butterfly over
//   32 lanes with lanes >= 8 at 0 (-inf for the max);
// - column j: row group g of 32 sums rows i = g, g+32, ... in order, then the
//   32 groups are added in order from 0.f (the max likewise, in order).
// Here a physical warp takes two of the band's 64 virtual warps (lane =
// t % 32), their elements of C + v kept in registers from the max to the
// sum, and a warp takes a column (lane = g); a reduction stage costs one
// block barrier for the whole band, not one a row.
//
// Bound: C read once and `out` written once from device memory; 2 x iters
// passes of an add, a max, and an add, sub, expf and add per element. What
// the card spends is latency: the 2 x iters grid barriers
// (`urmvo_sinkhorn_barriers` times them alone in an empty kernel of the same
// grid), the vector read after each, and the column sweep's 32-long serial
// chains on the 8 warps that hold a band's columns.

#include "common.cuh"

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e9f;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_THREADS = 256;              // virtual threads a row
constexpr int ROW_WARPS = ROW_THREADS / 32;   // their warps: the 8 partials of a row
constexpr int ROW_GROUPS = 32;                // row groups a column (one warp's lanes)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// floats, rounded up to 16 bytes
__host__ __device__ __forceinline__ size_t pad4(size_t n) { return (n + 3) & ~size_t(3); }

struct Args {
  const float* C;
  const float* log_mu;
  const float* log_nu;
  float* u;  // (M) and (N): the vectors' exchange between blocks
  float* v;
  float* out;
  int M, N, iters, rows_per_block, cols_per_block, stale_u;
};

// Shared memory, in floats: u (M), v (N), the band's own u, the max and sum
// partials of the band's rows (8 a row), then the row band (rows x N) and
// the transposed column band (cols x M) where they are resident.
__host__ __device__ __forceinline__ size_t base_floats(int M, int N, int rb) {
  return pad4(M) + pad4(N) + pad4(rb) + 2 * pad4(size_t(rb) * ROW_WARPS);
}

// The 8 partials of a row (lanes < 8; the other lanes hold -inf for the max,
// 0 for the sum) through the 32-lane butterfly, as the earlier
// block_reduce's second stage.
__device__ __forceinline__ float row_stage(const float* part, int lane, bool is_max) {
  const float y = lane < ROW_WARPS ? part[lane] : (is_max ? -CUDART_INF_F : 0.f);
  return is_max ? warp_max(y) : warp_sum(y);
}

// After a grid barrier: src[0, n), written by all blocks before it, into
// dst (from L2; each thread's loads in flight at once). The caller syncs.
__device__ __forceinline__ void load_vector(float* dst, const float* src, int n) {
  constexpr int G = 4;
  for (int k0 = threadIdx.x; k0 < n; k0 += G * THREADS) {
    float x[G];
#pragma unroll
    for (int g = 0; g < G; ++g) x[g] = k0 + g * THREADS < n ? __ldcg(src + k0 + g * THREADS) : 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (k0 + g * THREADS < n) dst[k0 + g * THREADS] = x[g];
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(unsigned(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

// The row sweep's elements in registers: a warp's two virtual warps of at
// most ROW_K elements each (rows <= 8 a block, N <= 1280: the main path).
constexpr int ROW_K = 5;

template <bool COLS>
__global__ void __launch_bounds__(THREADS, 1) sinkhorn_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* const s_u = reinterpret_cast<float*>(smem4);
  const int M = a.M, N = a.N, rb = a.rows_per_block, cb = a.cols_per_block;
  float* const s_v = s_u + pad4(M);
  float* const s_own = s_v + pad4(N);  // the band's own u
  float* const s_pmax = s_own + pad4(rb);
  float* const s_psum = s_pmax + pad4(size_t(rb) * ROW_WARPS);
  float* const s_rows = s_psum + pad4(size_t(rb) * ROW_WARPS);
  float* const s_cols = s_rows + pad4(size_t(rb) * N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * rb, nr = max(0, min(rb, M - r0));
  const int c0 = blockIdx.x * cb, nc = max(0, min(cb, N - c0));
  const bool cached = rb * ROW_WARPS <= 2 * WARPS && N <= ROW_K * ROW_THREADS;
  cg::grid_group grid = cg::this_grid();

  // C as the column sweep sees it: from its band or from L2
  auto c_col = [&](int c, int i) { return COLS ? s_cols[c * M + i] : __ldg(a.C + size_t(i) * N + c0 + c); };

  // (a resident band fits in shared memory: int indices)
  for (int k = tid; k < nr * N; k += THREADS) cp_async4(s_rows + k, a.C + size_t(r0) * N + k);
  if (COLS) {
    for (int k = tid; k < nc * M; k += THREADS) {
      const int i = k / nc, c = k - i * nc;
      cp_async4(s_cols + c * M + i, a.C + size_t(i) * N + c0 + c);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int k = tid; k < M; k += THREADS) s_u[k] = 0.f;
  for (int k = tid; k < N; k += THREADS) s_v[k] = 0.f;
  for (int k = tid; k < nr; k += THREADS) s_own[k] = 0.f;
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // Between half-sweeps: the blocks' slices of u (or v) to device memory,
  // a grid barrier, the whole vector back. The barrier also orders the reuse
  // of a.u and a.v: a block writes u again only after every block has
  // read the last u.
#pragma unroll 1
  for (int it = 0; it < a.iters; ++it) {
    // ---- rows: u = log_mu - lse(C + v), v of the previous iteration -----
    if (it > 0) {
      grid.sync();
      load_vector(s_v, a.v, N);
      __syncthreads();
    }
    if (cached) {
      // virtual warps q = warp and warp + 32, their C + v kept for the sums
      float x[2][ROW_K];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = warp + h * WARPS, r = q / ROW_WARPS, t = (q % ROW_WARPS) * 32 + lane;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int k = 0; k < ROW_K; ++k) {
          const int j = t + k * ROW_THREADS;
          x[h][k] = q < nr * ROW_WARPS && j < N ? s_rows[r * N + j] + s_v[j] : -CUDART_INF_F;
          mx = fmaxf(mx, x[h][k]);  // -inf past the end leaves it as it is
        }
        if (q < nr * ROW_WARPS) {
          mx = warp_max(mx);
          if (lane == 0) s_pmax[q] = mx;
        }
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = warp + h * WARPS, r = q / ROW_WARPS, t = (q % ROW_WARPS) * 32 + lane;
        if (q < nr * ROW_WARPS) {
          const float mx = fmaxf(row_stage(s_pmax + r * ROW_WARPS, lane, true), NEG);
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < ROW_K; ++k) {
            const float e = expf(x[h][k] - mx);
            if (t + k * ROW_THREADS < N) s += e;
          }
          s = warp_sum(s);
          if (lane == 0) s_psum[q] = s;
        }
      }
    } else {
      for (int q = warp; q < nr * ROW_WARPS; q += WARPS) {
        const int r = q / ROW_WARPS, t = (q % ROW_WARPS) * 32 + lane;
        float mx = -CUDART_INF_F;
        for (int j = t; j < N; j += ROW_THREADS) mx = fmaxf(mx, s_rows[r * N + j] + s_v[j]);
        mx = warp_max(mx);
        if (lane == 0) s_pmax[q] = mx;
      }
      __syncthreads();
      for (int q = warp; q < nr * ROW_WARPS; q += WARPS) {
        const int r = q / ROW_WARPS, t = (q % ROW_WARPS) * 32 + lane;
        const float mx = fmaxf(row_stage(s_pmax + r * ROW_WARPS, lane, true), NEG);
        float s = 0.f;
        for (int j = t; j < N; j += ROW_THREADS) s += expf(s_rows[r * N + j] + s_v[j] - mx);
        s = warp_sum(s);
        if (lane == 0) s_psum[q] = s;
      }
    }
    __syncthreads();
    for (int r = warp; r < nr; r += WARPS) {
      const float mx = fmaxf(row_stage(s_pmax + r * ROW_WARPS, lane, true), NEG);
      const float s = row_stage(s_psum + r * ROW_WARPS, lane, false);
      const float u = a.log_mu[r0 + r] - (mx + logf(fmaxf(s, 1e-30f)));
      if (lane == 0) {
        a.u[r0 + r] = u;
        s_own[r] = u;
      }
    }

    // ---- columns: v = log_nu - lse(C + u) -------------------------------
    // (stale_u, a control: keep the previous iteration's u)
    grid.sync();
    if (!a.stale_u) {
      load_vector(s_u, a.u, M);
      __syncthreads();
    }
    for (int c = warp; c < nc; c += WARPS) {
      float mx = -CUDART_INF_F;
      for (int i = lane; i < M; i += ROW_GROUPS) mx = fmaxf(mx, c_col(c, i) + s_u[i]);
      // every lane folds the 32 groups in order: all hold the same bits
      float m = __shfl_sync(FULL, mx, 0);
      for (int g = 1; g < ROW_GROUPS; ++g) m = fmaxf(m, __shfl_sync(FULL, mx, g));
      m = fmaxf(m, NEG);
      float s = 0.f;
      for (int i = lane; i < M; i += ROW_GROUPS) s += expf(c_col(c, i) + s_u[i] - m);
      float r = 0.f;
      for (int g = 0; g < ROW_GROUPS; ++g) r += __shfl_sync(FULL, s, g);
      if (lane == 0) a.v[c0 + c] = a.log_nu[c0 + c] - (m + logf(fmaxf(r, 1e-30f)));
    }
  }

  // ---- out = C + u + v over the row band --------------------------------
  if (a.iters > 0) {
    grid.sync();
    load_vector(s_v, a.v, N);
    __syncthreads();
  }
  for (int r = 0; r < nr; ++r) {
    float* const out = a.out + size_t(r0 + r) * N;
    for (int j = tid; j < N; j += THREADS) out[j] = s_rows[r * N + j] + s_own[r] + s_v[j];
  }
}

// The yardstick: `steps` grid barriers of the same grid and nothing else.
__global__ void __launch_bounds__(THREADS, 1) barrier_kernel(int steps) {
  cg::grid_group grid = cg::this_grid();
#pragma unroll 1
  for (int k = 0; k < steps; ++k) grid.sync();
}

struct Plan {
  int blocks, blocks_per_sm, rows_per_block, cols_per_block, cols_resident;
  size_t smem;
  const void* kernel;
};

// Bands and route for `blocks` blocks: the vectors and the row band in
// shared memory, the column band too if it fits beside them (else it is
// read from L2). Returns false if the row band and the vectors do not fit.
bool route(int M, int N, int blocks, int smem_max, Plan* p) {
  const int rb = (M + blocks - 1) / blocks, cb = (N + blocks - 1) / blocks;
  const size_t base = base_floats(M, N, rb) + pad4(size_t(rb) * N), cols = pad4(size_t(cb) * M);
  const size_t cap = size_t(smem_max) / sizeof(float);
  if (base > cap) return false;
  const bool c = base + cols <= cap;
  *p = Plan{blocks, 0, rb, cb, int(c), sizeof(float) * (base + (c ? cols : 0)),
            c ? reinterpret_cast<const void*>(sinkhorn_kernel<true>)
              : reinterpret_cast<const void*>(sinkhorn_kernel<false>)};
  return true;
}

// The launch for (M, N) on the current device, once per shape and device:
// the blocks the card holds at once (occupancy x SMs) with their bands, the
// kernel's shared-memory attribute set. Returns a cudaError_t, or -2 where
// the row band and the vectors do not fit in shared memory or the device
// takes no cooperative launch.
int plan_for(int M, int N, Plan* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, Plan> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, M, N);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  int sms = 0, smem_max = 0, coop = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return int(err);
  if (!coop) return -2;
  // one block an SM first; where the card holds more, bands for that many.
  // Each kernel may take all the shared memory a block can have: the launch
  // passes what its shape needs.
  Plan p{};
  for (int blocks = sms;;) {
    Plan q{};
    if (!route(M, N, blocks, smem_max, &q)) {
      if (!p.kernel) return -2;
      break;
    }
    for (const void* k : {q.kernel, reinterpret_cast<const void*>(barrier_kernel)})
      if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max)) != cudaSuccess)
        return int(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&q.blocks_per_sm, q.kernel, THREADS, q.smem)) !=
        cudaSuccess)
      return int(err);
    if (q.blocks_per_sm * sms < blocks) {
      if (!p.kernel) return int(cudaErrorCooperativeLaunchTooLarge);
      break;
    }
    p = q;
    if (q.blocks_per_sm * sms == blocks) break;
    blocks = q.blocks_per_sm * sms;
  }
  cache.emplace(key, p);
  *out = p;
  return 0;
}

}  // namespace

// C (M, N), log_mu (M), log_nu (N), out (M, N), all float32 and contiguous;
// work (M + N floats) holds u and v between the sweeps and needs no
// initialisation. `stale_u` (a control) makes each column sweep use the
// previous iteration's u. Returns a cudaError_t (the occupancy query's or the
// cooperative launch's), -2 for a shape or device it does not take.
extern "C" int urmvo_sinkhorn(const float* C, const float* log_mu, const float* log_nu, float* work, float* out,
                              int M, int N, int iters, int stale_u, void* stream) {
  if (M < 1 || N < 1 || iters < 0) return -2;
  Plan p{};
  const int err = plan_for(M, N, &p);
  if (err) return err;
  Args a{C, log_mu, log_nu, work, work + M, out, M, N, iters, p.rows_per_block, p.cols_per_block, stale_u};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(p.kernel, dim3(p.blocks), dim3(THREADS), args, p.smem,
                                                    static_cast<cudaStream_t>(stream));
  return int(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch for (M, N): blocks, blocks per SM, threads, registers a thread,
// shared memory a block (dynamic and static), local memory a thread, rows and
// columns a block, and whether the column band is resident (1) or read from
// L2 (0).
extern "C" int urmvo_sinkhorn_info(int M, int N, int* info) {
  if (M < 1 || N < 1) return -2;
  Plan p{};
  int err = plan_for(M, N, &p);
  if (err) return err;
  cudaFuncAttributes fa;
  if ((err = int(cudaFuncGetAttributes(&fa, p.kernel)))) return err;
  const int v[9] = {p.blocks,         p.blocks_per_sm,        THREADS,
                    fa.numRegs,       int(fa.sharedSizeBytes + p.smem), int(fa.localSizeBytes),
                    p.rows_per_block, p.cols_per_block,       p.cols_resident};
  for (int k = 0; k < 9; ++k) info[k] = v[k];
  return 0;
}

// 2 x iters grid barriers in an empty cooperative kernel with the grid,
// block and shared memory of (M, N)'s launch: the yardstick of the sweeps.
extern "C" int urmvo_sinkhorn_barriers(int M, int N, int iters, void* stream) {
  if (M < 1 || N < 1 || iters < 0) return -2;
  Plan p{};
  const int err = plan_for(M, N, &p);
  if (err) return err;
  int steps = 2 * iters;
  void* args[] = {&steps};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_kernel), dim3(p.blocks),
                                                    dim3(THREADS), args, p.smem, static_cast<cudaStream_t>(stream));
  return int(e != cudaSuccess ? e : cudaGetLastError());
}
