// Pose-only robust Gauss-Newton for Hopper (sm_90a): the whole 4 x 10
// schedule of the per-frame tracking optimizer in one launch.
//
// Replaces the TPU kernel ur_mvo_tpu/ops/pallas_pose.py::_pose_kernel (:93).
// For each of B problems: N candidate tracks (world point X, observation
// u, v, u_right with u_right <= 0 meaning mono, valid flag) and an initial pose
// (R0, t0) of T_cw. `rounds` rounds of `iters` damped Gauss-Newton steps on the
// SE(3) tangent (left-multiplicative update), each round restarting at
// (R0, t0) with the current inlier set, Huber weights in rounds 0-2 and none
// from round 3 on, a step kept only if it does not raise the robust cost, and
// a chi^2 + positive-depth reclassification after every round. Outputs the
// last round's pose as 12 floats (R row-major, then t) and the inlier flags.
// The constants are the TPU kernel's: depth clamp 1e-6, chi^2 floor 1e-12,
// lam = damping * max(tr/6, 1e-6) from the undamped trace, the system scaled
// by 1 / max(tr/6, 1e-12), Cholesky pivots floored at 1e-12, the small-angle
// branch of the exponential at theta^2 < 1e-12.
//
// Design. The work is a dependent chain, not throughput: 40 steps, each a
// block-wide sum of 28 numbers (21 of H's upper triangle, 6 of g, the cost),
// a 6x6 solve, a pose update and a second block-wide sum (the new cost). One
// CTA of 256 threads per problem; for N <= 1024 every thread keeps its 4
// points in registers for the whole schedule, so device memory is read once
// and written once (larger N streams the points from L1/L2 each step). A sum
// is a shuffle butterfly inside each warp, one shared-memory row per warp, one
// barrier, and then EVERY thread adds the 8 rows in the same fixed order: all
// threads hold the same H, g and costs bit for bit, so each runs the scalar
// solve, the exponential and the accept test redundantly and no broadcast or
// third barrier is needed. No atomics: the result is the same run to run.
//
// Bound: 28 bytes a point in, 1 byte a point and 48 bytes out; about 230
// float operations a point and step. Both are far under a microsecond at
// N = 1024: what the card spends is the latency of 80 dependent
// reduce-and-broadcast steps, which `urmvo_pose_gn_chain` measures in an empty
// kernel of the same shape.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NACC = 28;  // 21 H (upper, row-major) + 6 g + cost0

struct PoseParams {
  float fx, fy, cx, cy, bf, chi2_mono, chi2_stereo, damping;
  int rounds, iters;
};

struct Point {
  float X, Y, Z, uo, vo, uro, stereo, th, dth;
};

struct Pose {
  float R[9];
  float t[3];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Block-wide sums of NV numbers; every thread returns with the same totals in
// `v`. `s_part` holds WARPS x NV floats. One barrier: the caller alternates
// two buffers so that a warp running ahead never overwrites rows still read.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* s_part) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) s_part[warp * NV + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float s = s_part[k];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += s_part[w * NV + k];
    v[k] = s;
  }
}

__device__ __forceinline__ Point load_point(const float* __restrict__ X, const float* __restrict__ uv, int i, int N,
                                            const PoseParams& p) {
  Point q;
  if (i < N) {
    q.X = X[3 * i + 0];
    q.Y = X[3 * i + 1];
    q.Z = X[3 * i + 2];
    q.uo = uv[3 * i + 0];
    q.vo = uv[3 * i + 1];
    q.uro = uv[3 * i + 2];
  } else {  // a padded slot reads as mono (and invalid)
    q.X = q.Y = q.Z = q.uo = q.vo = 0.f;
    q.uro = -1.f;
  }
  q.stereo = q.uro > 0.f ? 1.f : 0.f;
  q.th = q.stereo * p.chi2_stereo + (1.f - q.stereo) * p.chi2_mono;
  q.dth = sqrtf(q.th);
  return q;
}

struct Projection {
  float pcx, pcy, pcz, iz, ru, rv, rr, chi2;
};

__device__ __forceinline__ Projection project(const Pose& T, const Point& q, const PoseParams& p) {
  Projection o;
  o.pcx = T.R[0] * q.X + T.R[1] * q.Y + T.R[2] * q.Z + T.t[0];
  o.pcy = T.R[3] * q.X + T.R[4] * q.Y + T.R[5] * q.Z + T.t[1];
  o.pcz = T.R[6] * q.X + T.R[7] * q.Y + T.R[8] * q.Z + T.t[2];
  o.iz = 1.f / fmaxf(o.pcz, 1e-6f);
  const float u = p.fx * o.pcx * o.iz + p.cx;
  const float v = p.fy * o.pcy * o.iz + p.cy;
  o.ru = u - q.uo;
  o.rv = v - q.vo;
  o.rr = q.stereo * (u - p.bf * o.iz - q.uro);
  o.chi2 = o.ru * o.ru + o.rv * o.rv + o.rr * o.rr;
  return o;
}

// the objective the step acceptance watches: Huber rho while the robust
// kernel is active, raw chi^2 after
__device__ __forceinline__ float robust_cost(float chi2, const Point& q, bool huber) {
  if (!huber) return chi2;
  const float s = sqrtf(fmaxf(chi2, 1e-12f));
  return chi2 <= q.th ? chi2 : 2.f * q.dth * s - q.th;
}

__device__ __forceinline__ void jac_row(float d0, float d1, float d2, const Projection& o, float (&J)[6]) {
  J[0] = d1 * (-o.pcz) + d2 * o.pcy;
  J[1] = d0 * o.pcz + d2 * (-o.pcx);
  J[2] = d0 * (-o.pcy) + d1 * o.pcx;
  J[3] = d0;
  J[4] = d1;
  J[5] = d2;
}

// adds one point's weighted normal terms and cost to acc
__device__ __forceinline__ void accumulate(const Pose& T, const Point& q, float inl, bool huber, const PoseParams& p,
                                           float (&acc)[NACC]) {
  const Projection o = project(T, q, p);
  const float iz2 = o.iz * o.iz;
  float w = inl;
  if (huber) w = fminf(1.f, q.dth / sqrtf(fmaxf(o.chi2, 1e-12f))) * inl;
  float Ju[6], Jv[6], Jr[6];
  const float du0 = p.fx * o.iz, du2 = -p.fx * o.pcx * iz2;
  jac_row(du0, 0.f, du2, o, Ju);
  jac_row(0.f, p.fy * o.iz, -p.fy * o.pcy * iz2, o, Jv);
  jac_row(q.stereo * du0, 0.f, q.stereo * (du2 + p.bf * iz2), o, Jr);
  int idx = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int k = j; k < 6; ++k) acc[idx++] += w * (Ju[j] * Ju[k] + Jv[j] * Jv[k] + Jr[j] * Jr[k]);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) acc[21 + j] -= w * (Ju[j] * o.ru + Jv[j] * o.rv + Jr[j] * o.rr);
  acc[27] += robust_cost(o.chi2, q, huber) * inl;
}

// H x = g for a 6x6 SPD system: unrolled Cholesky and two substitutions
__device__ __forceinline__ void chol_solve6(const float (&H)[6][6], const float (&g)[6], float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float d = sqrtf(fmaxf(s, 1e-12f));
    L[j][j] = d;
    const float inv_d = 1.f / d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv_d;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// T_new = exp(dx) * T, dx = (omega, upsilon)
__device__ __forceinline__ Pose se3_step(const float (&dx)[6], const Pose& T) {
  const float wx = dx[0], wy = dx[1], wz = dx[2];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(fmaxf(th2, 1e-30f));
  const bool small = th2 < 1e-12f;
  const float A = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float Bc = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / fmaxf(th2, 1e-30f);
  const float C = small ? 1.f / 6.f - th2 / 120.f : (1.f - A) / fmaxf(th2, 1e-30f);
  const float K[9] = {0.f, -wz, wy, wz, 0.f, -wx, -wy, wx, 0.f};
  const float K2[9] = {-(wy * wy + wz * wz), wx * wy, wx * wz, wx * wy, -(wx * wx + wz * wz), wy * wz,
                       wx * wz, wy * wz, -(wx * wx + wy * wy)};
  float dR[9], V[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.f : 0.f;
    dR[i] = eye + A * K[i] + Bc * K2[i];
    V[i] = eye + Bc * K[i] + C * K2[i];
  }
  Pose out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float dt = V[3 * i] * dx[3] + V[3 * i + 1] * dx[4] + V[3 * i + 2] * dx[5];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.R[3 * i + j] = dR[3 * i] * T.R[j] + dR[3 * i + 1] * T.R[3 + j] + dR[3 * i + 2] * T.R[6 + j];
    out.t[i] = dR[3 * i] * T.t[0] + dR[3 * i + 1] * T.t[1] + dR[3 * i + 2] * T.t[2] + dt;
  }
  return out;
}

// PPT > 0: each thread keeps PPT points and their inlier flags in registers
// (N <= PPT * THREADS). PPT == 0: points are read from device memory (cached)
// at every use and the flags live in `inl_out`, each entry private to its
// thread.
template <int PPT>
__global__ void __launch_bounds__(THREADS)
pose_gn_kernel(const float* __restrict__ Xg, const float* __restrict__ uvg, const uint8_t* __restrict__ validg,
               const float* __restrict__ R0g, const float* __restrict__ t0g, float* __restrict__ pose_out,
               uint8_t* __restrict__ inl_out, int N, PoseParams p) {
  __shared__ float s_acc[WARPS * NACC];
  __shared__ float s_cost[WARPS];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* X = Xg + size_t(b) * N * 3;
  const float* uv = uvg + size_t(b) * N * 3;
  const uint8_t* valid = validg + size_t(b) * N;
  uint8_t* inl_g = inl_out + size_t(b) * N;

  constexpr int NREG = PPT > 0 ? PPT : 1;
  Point pts[NREG];
  float inl[NREG];
  if constexpr (PPT > 0) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * THREADS;
      pts[k] = load_point(X, uv, i, N, p);
      inl[k] = (i < N && valid[i]) ? 1.f : 0.f;
    }
  } else {
    for (int i = tid; i < N; i += THREADS) inl_g[i] = valid[i] ? 1 : 0;
  }

  // f(point, inlier flag by reference, index) over this thread's points
  auto for_each_point = [&](auto&& f) {
    if constexpr (PPT > 0) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) f(pts[k], inl[k], tid + k * THREADS);
    } else {
      for (int i = tid; i < N; i += THREADS) {
        const Point q = load_point(X, uv, i, N, p);
        float il = float(inl_g[i]);
        f(q, il, i);
        inl_g[i] = il > 0.5f ? 1 : 0;
      }
    }
  };

  Pose T0;
#pragma unroll
  for (int i = 0; i < 9; ++i) T0.R[i] = R0g[b * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) T0.t[i] = t0g[b * 3 + i];
  Pose T = T0;

#pragma unroll 1
  for (int rnd = 0; rnd < p.rounds; ++rnd) {
    const bool huber = rnd < 3;
    T = T0;  // the vertex is reset at the start of every round
#pragma unroll 1
    for (int it = 0; it < p.iters; ++it) {
      float acc[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
      for_each_point([&](const Point& q, float& il, int) { accumulate(T, q, il, huber, p, acc); });
      block_sum<NACC>(acc, s_acc);

      float H[6][6], g[6];
      int idx = 0;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
#pragma unroll
        for (int k = j; k < 6; ++k) {
          H[j][k] = acc[idx];
          H[k][j] = acc[idx];
          ++idx;
        }
      }
      const float tr = H[0][0] + H[1][1] + H[2][2] + H[3][3] + H[4][4] + H[5][5];
      const float lam = p.damping * fmaxf(tr / 6.f, 1e-6f);
      const float inv_s = 1.f / fmaxf(tr / 6.f, 1e-12f);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        H[j][j] += lam;
#pragma unroll
        for (int k = 0; k < 6; ++k) H[j][k] *= inv_s;
        g[j] = acc[21 + j] * inv_s;
      }
      float dx[6];
      chol_solve6(H, g, dx);
      const Pose Tn = se3_step(dx, T);

      float cost1[1] = {0.f};
      for_each_point([&](const Point& q, float& il, int) {
        cost1[0] += robust_cost(project(Tn, q, p).chi2, q, huber) * il;
      });
      block_sum<1>(cost1, s_cost);
      // a step that raises the robust cost, or is not finite, is reverted
      const bool ok = (cost1[0] <= acc[27]) && isfinite(Tn.t[0] + Tn.t[1] + Tn.t[2]);
      if (ok) T = Tn;
    }
    for_each_point([&](const Point& q, float& il, int i) {
      const Projection o = project(T, q, p);
      il = (i < N && valid[i] && o.chi2 <= q.th && o.pcz > 0.f) ? 1.f : 0.f;
    });
  }

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) pose_out[b * 12 + i] = T.R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) pose_out[b * 12 + 9 + i] = T.t[i];
  }
  if constexpr (PPT > 0) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * THREADS;
      if (i < N) inl_g[i] = inl[k] > 0.5f ? 1 : 0;
    }
  }
}

// The yardstick of the chain: `steps` dependent pairs of block-wide sums (28
// numbers, then 1), each fed by the one before, and no other work.
__global__ void __launch_bounds__(THREADS) chain_kernel(float* __restrict__ out, int steps) {
  __shared__ float s_acc[WARPS * NACC];
  __shared__ float s_cost[WARPS];
  float carry = float(threadIdx.x) * 1e-6f;
#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    float acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = carry * 1e-3f + float(k);
    block_sum<NACC>(acc, s_acc);
    float c[1] = {acc[27] * 1e-3f + acc[0]};
    block_sum<1>(c, s_cost);
    carry = c[0] * 1e-6f;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = carry;
}

}  // namespace

// X, uv (B, N, 3) float32; valid (B, N) uint8; R0 (B, 3, 3); t0 (B, 3);
// pose_out (B, 12) float32; inliers (B, N) uint8; all contiguous. Returns a
// cudaError_t, -2 for a bad shape.
extern "C" int urmvo_pose_gn(const float* X, const float* uv, const uint8_t* valid, const float* R0,
                             const float* t0, float* pose_out, uint8_t* inliers, int B, int N, float fx, float fy,
                             float cx, float cy, float bf, float chi2_mono, float chi2_stereo, int rounds, int iters,
                             float damping, void* stream) {
  if (B < 1 || N < 1 || rounds < 0 || iters < 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PoseParams p{fx, fy, cx, cy, bf, chi2_mono, chi2_stereo, damping, rounds, iters};
  if (N <= 4 * THREADS)
    pose_gn_kernel<4><<<B, THREADS, 0, s>>>(X, uv, valid, R0, t0, pose_out, inliers, N, p);
  else
    pose_gn_kernel<0><<<B, THREADS, 0, s>>>(X, uv, valid, R0, t0, pose_out, inliers, N, p);
  return int(cudaGetLastError());
}

// out (B,) float32. Returns a cudaError_t, -2 for a bad shape.
extern "C" int urmvo_pose_gn_chain(float* out, int B, int steps, void* stream) {
  if (B < 1 || steps < 0) return -2;
  chain_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(out, steps);
  return int(cudaGetLastError());
}
