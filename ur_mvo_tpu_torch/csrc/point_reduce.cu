// Bundle adjustment's point-side segment sums for Hopper (sm_90a): the
// coupling blocks U and the point blocks [H_pp | b_p] of the normal
// equations, summed over each point's observations.
//
// Replaces the two TPU kernels of ur_mvo_tpu/ops/pallas_ba.py:
//   _sorted_reduce_kernel (:141)  ->  point_reduce_sorted_kernel
//   _reduce_kernel        (:38)   ->  point_reduce_atomic_kernel
// Both compute, for value rows A (O, 18) and Vp (O, 12), point ids pt and
// free-frame slots slot in [0, FF):
//   out[p, f*18 + v] = sum over o with pt[o] = p, slot[o] = f of bf16(A[o, v])
//   out[p, FF*18 + v] = sum over o with pt[o] = p of bf16(Vp[o, v])
// as (P, FF*18 + 12) float32: each summand is rounded to bf16 (round to
// nearest even) and accumulated in float32, as the TPU kernels and the JAX
// one-hot matmul do. Slot ids are clipped to [0, FF), point ids to [0, P).
//
// The TPU kernels build a one-hot indicator per 512-row chunk in VMEM and
// contract it on the MXU, carrying the accumulator from one sequential grid
// step to the next. Blocks on Hopper run in no order, so neither carries over:
//
// Sorted. The observations come sorted by point (a stable sort, once per BA
// problem), and seg_start (P + 1) marks each point's rows. One warp owns one
// point: it zero-fills the point's output row in shared memory, lane l < 18
// adds column l of A into column slot*18 + l and lanes 18..29 add the Vp
// columns, going through the point's rows in order, then the warp writes the
// row out coalesced. No one-hot matrix, no atomics, every output row is
// written exactly once (points without observations as exact zeros), and
// the sums are taken in a fixed order: the result is the same bit for bit
// from one launch to the next.
//
// Unsorted. The output is zeroed, then one thread per (observation, value)
// adds its bf16-rounded summand with a float atomic. The sums are exact up to
// float32 summation order, which the atomics leave to the scheduler: two
// launches agree only to that order.
//
// Bound: the bytes. Per observation 30 floats (120 bytes) plus its ids are
// read; the (P, FF*18+12) float32 output is written once. At a global BA's
// 65,536 points and FF = 48 the output alone is 230 MB (69 us at 3.35 TB/s)
// against 30 additions per observation, so the sorted kernel's design aims
// at writing each output row once, from shared memory, with 32 lanes side by
// side.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NA = 18;  // coupling values per observation (6 x 3)
constexpr int NV = 12;  // [H_pp (9) | b_p (3)] values per observation
constexpr int MAX_WARPS = 8;
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float bf16_round(float x) { return urmvo::round_to<__nv_bfloat16>(x); }

__global__ void point_reduce_sorted_kernel(const float* __restrict__ A, const float* __restrict__ Vp,
                                           const int* __restrict__ slot, const int* __restrict__ seg_start,
                                           float* __restrict__ out, int P, int FF) {
  extern __shared__ float s_rows[];
  const int V = FF * NA + NV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;  // the whole warp leaves together
  float* row = s_rows + static_cast<size_t>(warp) * V;
  for (int c = lane; c < V; c += 32) row[c] = 0.f;
  __syncwarp();
  const int s1 = seg_start[p + 1];
  for (int o = seg_start[p]; o < s1; ++o) {
    if (lane < NA) {
      const int f = min(max(slot[o], 0), FF - 1);
      row[f * NA + lane] += bf16_round(A[static_cast<size_t>(o) * NA + lane]);
    } else if (lane < NA + NV) {
      row[FF * NA + (lane - NA)] += bf16_round(Vp[static_cast<size_t>(o) * NV + (lane - NA)]);
    }
  }
  __syncwarp();
  float* dst = out + static_cast<size_t>(p) * V;
  for (int c = lane; c < V; c += 32) dst[c] = row[c];
}

__global__ void point_reduce_atomic_kernel(const float* __restrict__ A, const float* __restrict__ Vp,
                                           const int* __restrict__ pt, const int* __restrict__ slot,
                                           float* __restrict__ out, int O, int P, int FF) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(O) * (NA + NV)) return;
  const int o = static_cast<int>(t / (NA + NV));
  const int v = static_cast<int>(t % (NA + NV));
  const int p = min(max(pt[o], 0), P - 1);
  int col;
  float x;
  if (v < NA) {
    col = min(max(slot[o], 0), FF - 1) * NA + v;
    x = A[static_cast<size_t>(o) * NA + v];
  } else {
    col = FF * NA + (v - NA);
    x = Vp[static_cast<size_t>(o) * NV + (v - NA)];
  }
  x = bf16_round(x);
  // a zero summand leaves the sum as it is (the output starts at +0)
  if (x != 0.f) atomicAdd(out + static_cast<size_t>(p) * (FF * NA + NV) + col, x);
}

}  // namespace

// A (O, 18), Vp (O, 12) float32 in point-sorted order, slot (O,) int32,
// seg_start (P + 1,) int32 non-decreasing with seg_start[0] = 0 and
// seg_start[P] = O; out (P, FF*18 + 12) float32. Returns a cudaError_t, -2 for
// a bad shape, -3 for an output row beyond a block's shared memory.
extern "C" int urmvo_point_reduce_sorted(const float* A, const float* Vp, const int* slot, const int* seg_start,
                                         float* out, int P, int FF, void* stream) {
  if (P < 1 || FF < 1) return -2;
  const size_t row_bytes = static_cast<size_t>(FF * NA + NV) * sizeof(float);
  if (row_bytes > SMEM_MAX) return -3;
  const int warps = static_cast<int>(std::max<size_t>(1, std::min<size_t>(MAX_WARPS, SMEM_DEFAULT / row_bytes)));
  const size_t smem = warps * row_bytes;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(point_reduce_sorted_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int blocks = (P + warps - 1) / warps;
  point_reduce_sorted_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(A, Vp, slot, seg_start,
                                                                                               out, P, FF);
  return int(cudaGetLastError());
}

// A (O, 18), Vp (O, 12) float32 in any order, pt / slot (O,) int32; out
// (P, FF*18 + 12) float32, zeroed here. Returns a cudaError_t, -2 for a bad
// shape.
extern "C" int urmvo_point_reduce(const float* A, const float* Vp, const int* pt, const int* slot, float* out,
                                  int O, int P, int FF, void* stream) {
  if (O < 0 || P < 1 || FF < 1) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = static_cast<size_t>(P) * (FF * NA + NV) * sizeof(float);
  cudaError_t e = cudaMemsetAsync(out, 0, out_bytes, s);
  if (e != cudaSuccess || O == 0) return int(e);
  constexpr int THREADS = 256;
  const int64_t n = static_cast<int64_t>(O) * (NA + NV);
  point_reduce_atomic_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(A, Vp, pt, slot,
                                                                                                   out, O, P, FF);
  return int(cudaGetLastError());
}
