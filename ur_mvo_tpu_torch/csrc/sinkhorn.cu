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
// Design. At the main path's 1025 x 1025 float32 the matrix is 4.2 MB: more
// than one block's 227 KB of shared memory, well inside the 50 MB L2. So the
// matrix stays in L2 across sweeps and each half-sweep is one launch: a
// block-per-row reduction for u, and for v a block per 32 columns whose warps
// read whole rows (coalesced) and reduce across row groups in shared memory.
// Each reduction is two passes (max, then sum of exp) over L2-resident data.
// One host loop launches the 2 x iters sweeps and the final write on the
// caller's stream. A single persistent cooperative kernel is a later step.
//
// Bound: 40 sweeps over 1025^2 float32 re-read from L2; device memory sees C
// once and `out` once.

#include "common.cuh"

namespace {

constexpr float NEG = -1e9f;
constexpr int ROW_THREADS = 256;
constexpr int COLS = 32;       // columns per block in the column sweep
constexpr int ROW_GROUPS = 32;  // row groups per block in the column sweep

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// all threads get the block-wide result
template <bool IS_MAX>
__device__ float block_reduce(float x, float* s_red) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  x = IS_MAX ? warp_max(x) : warp_sum(x);
  if (lane == 0) s_red[warp] = x;
  __syncthreads();
  const int nw = blockDim.x / 32;
  float y = lane < nw ? s_red[lane] : (IS_MAX ? -CUDART_INF_F : 0.f);
  y = IS_MAX ? warp_max(y) : warp_sum(y);
  __syncthreads();
  return y;
}

__global__ void __launch_bounds__(ROW_THREADS)
row_sweep(const float* __restrict__ C, const float* __restrict__ v, const float* __restrict__ log_mu,
          float* __restrict__ u, int N) {
  __shared__ float s_red[ROW_THREADS / 32];
  const float* row = C + size_t(blockIdx.x) * N;
  float mx = -CUDART_INF_F;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) mx = fmaxf(mx, row[j] + v[j]);
  mx = fmaxf(block_reduce<true>(mx, s_red), NEG);
  float s = 0.f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) s += expf(row[j] + v[j] - mx);
  s = block_reduce<false>(s, s_red);
  if (threadIdx.x == 0) u[blockIdx.x] = log_mu[blockIdx.x] - (mx + logf(fmaxf(s, 1e-30f)));
}

__global__ void __launch_bounds__(COLS * ROW_GROUPS)
col_sweep(const float* __restrict__ C, const float* __restrict__ u, const float* __restrict__ log_nu,
          float* __restrict__ v, int M, int N) {
  __shared__ float s_red[ROW_GROUPS][COLS + 1];
  const int tx = threadIdx.x % COLS;
  const int ty = threadIdx.x / COLS;
  const int j = blockIdx.x * COLS + tx;
  const bool ok = j < N;
  float mx = -CUDART_INF_F;
  if (ok)
    for (int i = ty; i < M; i += ROW_GROUPS) mx = fmaxf(mx, C[size_t(i) * N + j] + u[i]);
  s_red[ty][tx] = mx;
  __syncthreads();
  if (ty == 0) {
    float r = s_red[0][tx];
    for (int g = 1; g < ROW_GROUPS; ++g) r = fmaxf(r, s_red[g][tx]);
    s_red[0][tx] = fmaxf(r, NEG);
  }
  __syncthreads();
  mx = s_red[0][tx];
  __syncthreads();
  float s = 0.f;
  if (ok)
    for (int i = ty; i < M; i += ROW_GROUPS) s += expf(C[size_t(i) * N + j] + u[i] - mx);
  s_red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && ok) {
    float r = 0.f;
    for (int g = 0; g < ROW_GROUPS; ++g) r += s_red[g][tx];
    v[j] = log_nu[j] - (mx + logf(fmaxf(r, 1e-30f)));
  }
}

__global__ void finalize(const float* __restrict__ C, const float* __restrict__ u, const float* __restrict__ v,
                         float* __restrict__ out, int M, int N) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= size_t(M) * N) return;
  const int i = int(idx / N);
  const int j = int(idx % N);
  out[idx] = C[idx] + u[i] + v[j];
}

}  // namespace

// C (M, N), log_mu (M), log_nu (N), u (M) and v (N) zero-initialised scratch,
// out (M, N); all float32, contiguous. Returns a cudaError_t, -2 for a bad
// shape.
extern "C" int urmvo_sinkhorn(const float* C, const float* log_mu, const float* log_nu, float* u, float* v,
                              float* out, int M, int N, int iters, void* stream) {
  if (M < 1 || N < 1 || iters < 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int it = 0; it < iters; ++it) {
    row_sweep<<<M, ROW_THREADS, 0, s>>>(C, v, log_mu, u, N);
    col_sweep<<<(N + COLS - 1) / COLS, COLS * ROW_GROUPS, 0, s>>>(C, u, log_nu, v, M, N);
  }
  const size_t total = size_t(M) * N;
  finalize<<<unsigned((total + 255) / 256), 256, 0, s>>>(C, u, v, out, M, N);
  return int(cudaGetLastError());
}
