// Masked multi-head attention core for Hopper (sm_90a), flash-style.
//
// Replaces the TPU kernel ur_mvo_tpu/ops/pallas_kernels.py::_attention_kernel
// (:122), the core of every SuperGlue GNN layer (models/superglue.py:_attention):
//   out[b, q, h] = softmax_k(where(valid[b, k], q.k / sqrt(d), -1e9)) @ v[b, :, h]
// with q/k/v in T (bf16 on the main path, or float) and logits, max and sum in
// float32. Probabilities are rounded to T before the value product, as the TPU
// kernel casts them to the value dtype.
//
// Layout: q (B, Kq, H, 64), k/v (B, Kkv, H, 64), valid (B, Kkv) uint8, out like
// q: the (batch, slot, head, dim) layout of the projections, read in place.
//
// Both kernels keep a running max, sum and output per query row (online
// softmax) over tiles of 64 keys staged in shared memory, so the K x K logits
// never reach device memory.
//
// bf16 (the main path): tensor cores. One block per (batch, head, 64
// queries), one warp per 16 query rows. QK^T and PV run as
// mma.sync.m16n8k16 (bf16 in, float32 accumulate) with operands loaded by
// ldmatrix from padded shared-memory rows; the score accumulators become the
// PV A-operand in registers (rounded to bf16 there).
//
// float32: CUDA cores. One block per (batch, head, 32 queries); 8 threads per
// query split the keys and are merged with warp shuffles at the end.
//
// Masking is a substitution, not a skip: an invalid key's logit is exactly
// -1e9 and still enters the softmax. With zero valid keys every logit is -1e9
// and the output is the mean of V over all slots, as the dense softmax gives;
// an online softmax that skipped masked keys would get that case wrong.
//
// Bound: 2.15 GFLOP per GNN layer at B=2, H=4, K=1024 against 4 MB of bf16
// operands: bound by operations (tensor-core rate). Loads are synchronous;
// cp.async/TMA double buffering and wgmma are the next steps.

#include "common.cuh"

namespace {

using urmvo::from_f;
using urmvo::round_to;
using urmvo::to_f;

constexpr int D = 64;          // head dim
constexpr float NEG = -1e9f;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int BM = 16 * MMA_WARPS;  // queries per block
constexpr int BN = 64;              // keys per tile
constexpr int SP = D + 8;           // bf16 row pitch: 144 bytes, ldmatrix rows hit distinct banks

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 64 rows of 64 bf16 (128 bytes each) from global into padded shared rows;
// rows at or past `n_rows` are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, size_t row_stride, int n_rows) {
  for (int i = threadIdx.x; i < 64 * (D / 8); i += 32 * MMA_WARPS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_rows) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * SP + c) = val;
  }
}

__global__ void __launch_bounds__(32 * MMA_WARPS)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                     __nv_bfloat16* __restrict__ out, int Kq, int Kkv, int H, float scale) {
  __shared__ __align__(16) __nv_bfloat16 s_q[BM * SP];
  __shared__ __align__(16) __nv_bfloat16 s_k[BN * SP];
  __shared__ __align__(16) __nv_bfloat16 s_v[BN * SP];
  __shared__ float s_bias[BN];  // 0 valid, 1 masked (-1e9), 2 past the end

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator rows g and g + 8 of the warp's 16
  const int c = lane % 4;  // accumulator columns 2c, 2c + 1 of each 8-wide tile
  const size_t stride = size_t(H) * D;  // between consecutive slots

  load_tile(s_q, q + (size_t(b) * Kq + q0) * stride + size_t(h) * D, stride, Kq - q0);
  __syncthreads();
  unsigned qa[D / 16][4];  // A fragments of this warp's 16 query rows, per 16-wide d step
  {
    const __nv_bfloat16* base = s_q + (warp * 16 + lane % 16) * SP + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], base + kk * 16);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, rows g and g + 8
  float l0 = 0.f, l1 = 0.f;                      // running sums (this thread's columns)

  for (int k0 = 0; k0 < Kkv; k0 += BN) {
    __syncthreads();
    const size_t kv_off = (size_t(b) * Kkv + k0) * stride + size_t(h) * D;
    load_tile(s_k, k + kv_off, stride, Kkv - k0);
    load_tile(s_v, v + kv_off, stride, Kkv - k0);
    for (int j = threadIdx.x; j < BN; j += 32 * MMA_WARPS) {
      const int key = k0 + j;
      s_bias[j] = key < Kkv ? (valid[size_t(b) * Kkv + key] ? 0.f : 1.f) : 2.f;
    }
    __syncthreads();

    // S = Q K^T: 16 x 64 per warp, as 8 tiles of 16 x 8
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BN / 8; n += 2) {
        // matrices: keys [8n, 8n+8) x d [16kk, +8), [16kk+8, +8); keys [8n+8, +8) x the same
        unsigned b0, b1, b2, b3;
        const __nv_bfloat16* p = s_k + (n * 8 + (lane % 8) + (lane / 16) * 8) * SP + kk * 16 + ((lane / 8) % 2) * 8;
        ldmatrix_x4(b0, b1, b2, b3, p);
        mma_bf16(s[n], qa[kk], b0, b1);
        mma_bf16(s[n + 1], qa[kk], b2, b3);
      }
    }

    // scale, mask, online softmax (rows g and g + 8; a row's 4 threads are a quad)
    float tmax0 = -CUDART_INF_F, tmax1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float st = s_bias[n * 8 + 2 * c + (e & 1)];
        const float x = st == 0.f ? s[n][e] * scale : (st == 1.f ? NEG : -CUDART_INF_F);
        s[n][e] = x;
      }
      tmax0 = fmaxf(tmax0, fmaxf(s[n][0], s[n][1]));
      tmax1 = fmaxf(tmax1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
    }
    const float mn0 = fmaxf(m0, tmax0);
    const float mn1 = fmaxf(m1, tmax1);
    const float corr0 = expf(m0 - mn0);  // 0 on the first tile (m = -inf)
    const float corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }
    unsigned pa[BN / 16][4];  // P as the A operand of PV, per 16-key step
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float p0 = expf(s[n][0] - m0), p1 = expf(s[n][1] - m0);
      const float p2 = expf(s[n][2] - m1), p3 = expf(s[n][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: 16 x 64 per warp; V rows are keys, read transposed
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        // matrices: keys [16kk, +8), [16kk+8, +8) x d [8n, +8); the same keys x d [8n+8, +8)
        unsigned b0, b1, b2, b3;
        const __nv_bfloat16* p = s_v + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * SP + n * 8 + (lane / 16) * 8;
        ldmatrix_x4_trans(b0, b1, b2, b3, p);
        mma_bf16(o[n], pa[kk], b0, b1);
        mma_bf16(o[n + 1], pa[kk], b2, b3);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * c;
    if (r0 < Kq)
      *reinterpret_cast<unsigned*>(out + size_t(b * Kq + r0) * stride + size_t(h) * D + d) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < Kq)
      *reinterpret_cast<unsigned*>(out + size_t(b * Kq + r1) * stride + size_t(h) * D + d) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int QT = 32;         // queries per block
constexpr int LANES = 8;       // threads per query
constexpr int KT = 64;         // keys per shared-memory tile
constexpr int KPL = KT / LANES;  // keys per lane per tile
constexpr int PITCH = D + 4;   // float row pitch: 16-byte aligned rows, banks spread
constexpr int THREADS = QT * LANES;

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ valid, T* __restrict__ out, int Kq, int Kkv, int H, float scale) {
  __shared__ __align__(16) float s_k[KT * PITCH];
  __shared__ __align__(16) float s_v[KT * PITCH];
  __shared__ int s_state[KT];  // 1 valid, 0 masked (-1e9), -1 past the end (no weight)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int qrow = blockIdx.x * QT + qi;
  const bool qok = qrow < Kq;

  float qr[D];
  {
    const T* qp = q + ((size_t(b) * Kq + (qok ? qrow : 0)) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qok ? to_f<T>(qp[d]) : 0.f;
  }
  float o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int k0 = 0; k0 < Kkv; k0 += KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < KT * D; i += THREADS) {
      const int j = i / D;
      const int d = i % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Kkv) {
        const size_t off = ((size_t(b) * Kkv + key) * H + h) * D + d;
        kv = to_f<T>(k[off]);
        vv = to_f<T>(v[off]);
      }
      s_k[j * PITCH + d] = kv;
      s_v[j * PITCH + d] = vv;
    }
    for (int j = threadIdx.x; j < KT; j += THREADS) {
      const int key = k0 + j;
      s_state[j] = key < Kkv ? (valid[size_t(b) * Kkv + key] ? 1 : 0) : -1;
    }
    __syncthreads();

    float s[KPL];
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int j = lane + LANES * r;
      const float4* kr = reinterpret_cast<const float4*>(s_k + j * PITCH);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      const int st = s_state[j];
      s[r] = st > 0 ? dot * scale : (st == 0 ? NEG : -CUDART_INF_F);
      tmax = fmaxf(tmax, s[r]);
    }
    if (tmax > m) {
      const float corr = expf(m - tmax);  // 0 on the first tile (m = -inf)
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] *= corr;
      m = tmax;
    }
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int j = lane + LANES * r;
      const float p = expf(s[r] - m);  // 0 for keys past the end
      l += p;
      const float pr = round_to<T>(p);
      const float4* vr = reinterpret_cast<const float4*>(s_v + j * PITCH);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        o[4 * d4 + 0] = fmaf(pr, vv.x, o[4 * d4 + 0]);
        o[4 * d4 + 1] = fmaf(pr, vv.y, o[4 * d4 + 1]);
        o[4 * d4 + 2] = fmaf(pr, vv.z, o[4 * d4 + 2]);
        o[4 * d4 + 3] = fmaf(pr, vv.w, o[4 * d4 + 3]);
      }
    }
  }

  // merge the LANES partial states of this query (consecutive lanes of one warp)
  float M = m;
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  const float corr = (m == -CUDART_INF_F) ? 0.f : expf(m - M);
  l *= corr;
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  T* op = out + ((size_t(b) * Kq + (qok ? qrow : 0)) * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float od = o[d] * corr;
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) od += __shfl_xor_sync(0xffffffffu, od, off);
    if (qok && d / (D / LANES) == lane) op[d] = from_f<T>(od * inv_l);
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const uint8_t* valid, void* out, int B, int Kq, int Kkv,
                int H, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const dim3 grid((Kq + BM - 1) / BM, H, B);
  attention_mma_kernel<<<grid, 32 * MMA_WARPS, 0, stream>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                                             static_cast<const bf*>(v), valid, static_cast<bf*>(out),
                                                             Kq, Kkv, H, scale);
  return int(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, const uint8_t* valid, void* out, int B, int Kq, int Kkv,
               int H, float scale, cudaStream_t stream) {
  const dim3 grid((Kq + QT - 1) / QT, H, B);
  attention_fma_kernel<float><<<grid, THREADS, 0, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                            static_cast<const float*>(v), valid,
                                                            static_cast<float*>(out), Kq, Kkv, H, scale);
  return int(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t, or -1 for a head dim other than 64 / bad dtype, -2
// for a bad shape.
extern "C" int urmvo_attention(int dtype, const void* q, const void* k, const void* v, const uint8_t* valid,
                               void* out, int B, int Kq, int Kkv, int H, int head_dim, float scale, void* stream) {
  if (head_dim != D) return -1;
  if (B < 1 || Kq < 1 || Kkv < 1 || H < 1) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == urmvo::DT_BF16) return launch_bf16(q, k, v, valid, out, B, Kq, Kkv, H, scale, s);
  if (dtype == urmvo::DT_F32) return launch_f32(q, k, v, valid, out, B, Kq, Kkv, H, scale, s);
  return -1;
}
