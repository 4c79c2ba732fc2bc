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
// last round's pose as 12 floats (R row-major, then t), the inlier flags and
// the number of steps run. The constants are the TPU kernel's: depth clamp
// 1e-6, chi^2 floor 1e-12, lam = damping * max(tr/6, 1e-6) from the undamped
// trace, the system scaled by 1 / max(tr/6, 1e-12), Cholesky pivots floored
// at 1e-12, the small-angle branch of the exponential at theta^2 < 1e-12.
//
// Bound: 28 bytes a point in, 1 byte a point and 52 bytes out; about 280
// float operations a point and pass (a pass a step, and one at T0 a round
// that runs) and 35 a point for each round's reclassification. Both are far
// under a microsecond at N = 1024: what the card spends is the latency of a
// dependent chain of steps, each a pass over the points, a block-wide sum
// and a 6x6 solve.
//
// Design: shorten the chain, keep every bit. One CTA of 256 threads per
// problem; for N <= 1024 every thread keeps its 4 points in registers for the
// whole schedule (larger N streams the points from L1/L2 each pass).
// - A step that is rejected, or that lands on the bits of the pose it started
//   from, is a fixed point of its round: the next step would see the same
//   pose, inlier set and Huber flag, and the kernel is deterministic, so it
//   would repeat that step bit for bit. The round stops there.
// - A round whose inlier set and Huber flag equal the previous round's
//   repeats its result (every round starts at T0): it is skipped, and the
//   test chains to the round after it. Round 3 drops Huber and always runs.
// - One pass a step: at the start of a round the normal terms at T0; then each
//   pass evaluates the candidate Tn once, for its cost (the accept test) and
//   for the normal terms at Tn, which an accepted step needs next and a
//   rejected one never does (it ends the round). 29 sums a pass, one
//   reduction: a recursive-halving butterfly in each warp (31 shuffles, each
//   value added in the xor butterfly's tree), one shared-memory row a warp,
//   a barrier, lane l of warp 0 adding value l's 8 rows in warp order, and
//   the 29 totals published to the block behind a second barrier. Every
//   thread then runs the solve, the exponential and the accept test on the
//   same totals (on the card that beat warp 0 solving alone and publishing
//   the candidate: the other warps only wait for it).
// Every sum keeps the earlier kernel's partition (each thread's 4 points in
// order, the xor tree 16..1, warps 0..7 in order), and each value keeps its
// expression, so the outputs are that kernel's bits. No atomics on the
// outputs: the result is the same run to run. `urmvo_pose_gn_chain` measures
// one step's reduce-and-publish in an empty kernel of the same shape.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NACC = 28;  // 21 H (upper, row-major) + 6 g + the cost at the pose
constexpr int NSUM = 29;  // + the cost at the candidate, for the accept test
constexpr unsigned FULL = 0xffffffffu;

struct PoseParams {
  float fx, fy, cx, cy, bf, chi2_mono, chi2_stereo, damping;
  int rounds, iters;
  int huber_blind;  // a control: the repeat test ignores the Huber flag
};

struct Point {
  float X, Y, Z, uo, vo, uro, stereo, th, dth;
};

struct Pose {
  float R[9];
  float t[3];
};

// Recursive-halving butterfly: at offset n a lane keeps half of the n x 2
// values it holds and sends the other half to lane ^ n, from n = 16 down to
// 1. On return lane l holds the warp's sum of v[l] in v[0]. Lane i adds lane
// i ^ n's partial to its own, as the xor butterfly does, and a + b == b + a,
// so every sum has the xor butterfly's bits. One template instance a stage,
// so that every index is a constant and v stays in registers.
template <int n>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = lane & n;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float send = upper ? v[k] : v[k + n];
    const float keep = upper ? v[k + n] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL, send, n);
  }
  if constexpr (n > 1) halve<n / 2>(v, lane);
}

__device__ __forceinline__ float warp_sum_halving(float (&v)[32]) {
  halve<16>(v, threadIdx.x % 32);
  return v[0];
}

// Block-wide sums of 32 numbers a thread: lane l of warp 0 returns the sum of
// v[l] (other warps return 0). `s_rows` holds WARPS x 32 floats; the caller
// puts a barrier between this call's read in warp 0 and the next call.
__device__ __forceinline__ float block_sum_to_warp0(float (&v)[32], float* s_rows) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  s_rows[warp * 32 + lane] = warp_sum_halving(v);
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = s_rows[lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += s_rows[w * 32 + lane];
  }
  return s;
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

// adds one point's weighted normal terms and cost at the pose `o` was
// projected at to v[0..27], and the same cost to v[28]. Each cost enters its
// sum as one fused multiply-add, as each did in the kernel that evaluated the
// normal terms and the accept test's cost in two passes.
__device__ __forceinline__ void accumulate(const Projection& o, const Point& q, float inl, bool huber,
                                           const PoseParams& p, float (&v)[32]) {
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
    for (int k = j; k < 6; ++k) v[idx++] += w * (Ju[j] * Ju[k] + Jv[j] * Jv[k] + Jr[j] * Jr[k]);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) v[21 + j] -= w * (Ju[j] * o.ru + Jv[j] * o.rv + Jr[j] * o.rr);
  const float rho = robust_cost(o.chi2, q, huber);
  v[NACC - 1] = fmaf(rho, inl, v[NACC - 1]);
  v[NACC] = fmaf(rho, inl, v[NACC]);
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

// dx from H, g (acc) at T, and the candidate exp(dx) * T
__device__ __forceinline__ Pose gn_step(const float (&acc)[NACC], const Pose& T, float damping) {
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
  const float lam = damping * fmaxf(tr / 6.f, 1e-6f);
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
  return se3_step(dx, T);
}

__device__ __forceinline__ bool same_bits(const Pose& a, const Pose& b) {
  bool same = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) same &= __float_as_uint(a.R[i]) == __float_as_uint(b.R[i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) same &= __float_as_uint(a.t[i]) == __float_as_uint(b.t[i]);
  return same;
}

// PPT > 0: each thread keeps PPT points and their inlier flags in registers
// (N <= PPT * THREADS). PPT == 0: points are read from device memory (cached)
// at every pass and the flags live in `inl_out`, each entry private to its
// thread.
template <int PPT>
__global__ void __launch_bounds__(THREADS)
pose_gn_kernel(const float* __restrict__ Xg, const float* __restrict__ uvg, const uint8_t* __restrict__ validg,
               const float* __restrict__ R0g, const float* __restrict__ t0g, float* __restrict__ pose_out,
               uint8_t* __restrict__ inl_out, int* __restrict__ steps_out,
               unsigned long long* __restrict__ step_total, int N, PoseParams p) {
  __shared__ float s_rows[WARPS * 32];
  __shared__ float s_tot[32];  // the block's 29 sums of the last pass
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
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

  // f(point, inlier flag by reference, index) over this thread's points, in
  // the same order at every pass
  auto for_each_point = [&](auto&& f) {
    if constexpr (PPT > 0) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) f(pts[k], inl[k], tid + k * THREADS);
    } else {
      for (int i = tid; i < N; i += THREADS) {
        const Point q = load_point(X, uv, i, N, p);
        const float was = float(inl_g[i]);
        float il = was;
        f(q, il, i);
        if (il != was) inl_g[i] = il > 0.5f ? 1 : 0;
      }
    }
  };

  Pose T0;
#pragma unroll
  for (int i = 0; i < 9; ++i) T0.R[i] = R0g[b * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) T0.t[i] = t0g[b * 3 + i];
  Pose T = T0;
  int steps = 0;
  bool repeat = false;  // this round's inputs equal the last round's

#pragma unroll 1
  for (int rnd = 0; rnd < p.rounds; ++rnd) {
    const bool huber = rnd < 3;
    if (rnd == 3 && !p.huber_blind) repeat = false;  // round 3 drops Huber: it never repeats round 2
    if (repeat) continue;                            // the round would repeat the last one: T and the flags stay
    T = T0;  // the vertex is reset at the start of every round
    if (p.iters > 0) {
      float acc[NACC];  // H, g and the cost at T, the same bits in every thread
      Pose P = T0;      // the pose the next pass evaluates: T0, then each step's candidate
#pragma unroll 1
      for (int it = 0;; ++it) {  // it: the steps this round has run
        float v[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) v[k] = 0.f;
        for_each_point([&](const Point& q, float& il, int) { accumulate(project(P, q, p), q, il, huber, p, v); });
        const float tot = block_sum_to_warp0(v, s_rows);
        if (warp == 0) s_tot[lane] = tot;
        __syncthreads();
        float sum[NSUM];
#pragma unroll
        for (int k = 0; k < NSUM; ++k) sum[k] = s_tot[k];
        // the candidate is kept if it does not raise the robust cost and is
        // finite; a rejected step, or one onto T's own bits, is a fixed point
        const bool ok = it == 0 || (sum[NACC] <= acc[NACC - 1] && isfinite(P.t[0] + P.t[1] + P.t[2]));
        const bool fixed = it > 0 && (!ok || same_bits(P, T));
        if (ok) {
          T = P;
#pragma unroll
          for (int k = 0; k < NACC; ++k) acc[k] = sum[k];
        }
        const bool go = !fixed && it < p.iters;
        if (!go) {
          steps += it;
          break;
        }
        P = gn_step(acc, T, p.damping);
      }
    }
    bool changed = false;
    for_each_point([&](const Point& q, float& il, int i) {
      const Projection o = project(T, q, p);
      const float now = (i < N && valid[i] && o.chi2 <= q.th && o.pcz > 0.f) ? 1.f : 0.f;
      changed |= now != il;
      il = now;
    });
    repeat = !__syncthreads_or(changed);
  }

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) pose_out[b * 12 + i] = T.R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) pose_out[b * 12 + 9 + i] = T.t[i];
    steps_out[b] = steps;
    atomicAdd(step_total, (unsigned long long)steps);
  }
  if constexpr (PPT > 0) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * THREADS;
      if (i < N) inl_g[i] = inl[k] > 0.5f ? 1 : 0;
    }
  }
}

// The yardstick of the chain: `steps` dependent reductions of a step's 29
// sums (the halving butterfly, warp 0's ordered adds), each published to the
// block through shared memory behind a second barrier, and no other work.
__global__ void __launch_bounds__(THREADS) chain_kernel(float* __restrict__ out, int steps) {
  __shared__ float s_rows[WARPS * 32];
  __shared__ float s_tot[32];
  float carry = float(threadIdx.x) * 1e-6f;
#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = k < NSUM ? carry * 1e-3f + float(k) : 0.f;
    const float tot = block_sum_to_warp0(v, s_rows);
    if (threadIdx.x < 32) s_tot[threadIdx.x] = tot;
    __syncthreads();
    carry = (s_tot[NACC] * 1e-3f + s_tot[0]) * 1e-6f;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = carry;
}

}  // namespace

// X, uv (B, N, 3) float32; valid (B, N) uint8; R0 (B, 3, 3); t0 (B, 3);
// pose_out (B, 12) float32; inliers (B, N) uint8; steps (B,) int32, the GN
// steps each problem ran; step_total, one counter that each block adds its
// steps to. All contiguous. huber_blind != 0 is a control that must miss the
// right result. Returns a cudaError_t, -2 for a bad shape.
extern "C" int urmvo_pose_gn(const float* X, const float* uv, const uint8_t* valid, const float* R0,
                             const float* t0, float* pose_out, uint8_t* inliers, int* steps,
                             unsigned long long* step_total, int B, int N, float fx, float fy, float cx, float cy,
                             float bf, float chi2_mono, float chi2_stereo, int rounds, int iters, float damping,
                             int huber_blind, void* stream) {
  if (B < 1 || N < 1 || rounds < 0 || iters < 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PoseParams p{fx, fy, cx, cy, bf, chi2_mono, chi2_stereo, damping, rounds, iters, huber_blind};
  if (N <= 4 * THREADS)
    pose_gn_kernel<4><<<B, THREADS, 0, s>>>(X, uv, valid, R0, t0, pose_out, inliers, steps, step_total, N, p);
  else
    pose_gn_kernel<0><<<B, THREADS, 0, s>>>(X, uv, valid, R0, t0, pose_out, inliers, steps, step_total, N, p);
  return int(cudaGetLastError());
}

// out (B,) float32. Returns a cudaError_t, -2 for a bad shape.
extern "C" int urmvo_pose_gn_chain(float* out, int B, int steps, void* stream) {
  if (B < 1 || steps < 0) return -2;
  chain_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(out, steps);
  return int(cudaGetLastError());
}
