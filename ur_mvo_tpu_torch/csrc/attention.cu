// Masked multi-head attention core for Hopper (sm_90a), flash-style.
//
// Replaces the TPU kernel ur_mvo_tpu/ops/pallas_kernels.py::_attention_kernel
// (:122), the core of every SuperGlue GNN layer (models/superglue.py:_attention):
//   out[b, q, h] = softmax_k(where(valid[b, k], q.k / sqrt(d), -1e9)) @ v[b, :, h]
// with q/k/v in T (bf16 on the main path, or float) and logits, max and sum in
// float32. Probabilities are rounded to T before the value product, as the TPU
// kernel casts them to the value dtype.
//
// Layout: q (B, Kq, H, 64), k/v (B, Kkv, H, 64), valid (B, Kkv) bool or
// uint8, out like q: the (batch, slot, head, dim) layout of the projections,
// read in place.
//
// Both kernels keep a running max, sum and output per query row (online
// softmax) over tiles of 64 keys staged in shared memory, so the K x K logits
// never reach device memory.
//
// Masking is a substitution, not a skip: an invalid key's logit is exactly
// -1e9 and still enters the softmax. With zero valid keys every logit is -1e9
// and the output is the mean of V over all slots, as the dense softmax gives;
// an online softmax that skipped masked keys would get that case wrong.
//
// bf16: tensor cores. One block per (batch, head, 64 queries), 16 query rows
// a warp. QK^T and PV run as mma.sync.m16n8k16 (bf16 in, float32
// accumulate) with operands loaded by ldmatrix from padded shared-memory
// rows (144-byte pitch: the 8 rows of an ldmatrix hit distinct banks); the
// score accumulators become the PV A-operand in registers (rounded to bf16
// there).
//
// What bounds it. One GNN layer at B=2, H=4, K=1024 is 2.15 GFLOP on 4 MB of
// operands: by the card's peaks, operations (2.2 us at 989 TFLOP/s) over
// bytes (1.3 us). Below that sit 8.4 M exponentials and the launch. But a
// block of 64 query rows per (batch, head) makes only Kq/64 * H * B = 128
// blocks at that shape, under one an SM: with one warp per 16 rows the card
// holds 4 warps an SM, one per scheduler, and the time is each warp's
// latency over its 16 key tiles. Waiting on each tile's synchronous load as
// well, the first version took 2.6x SDPA's time. Two kernels work on that:
//
// attention_mma_kernel (the main path) keeps the first version's arithmetic
// bit for bit (the long protocol's gate was set on those bits) and works on
// latency only:
// - Q, K and V arrive through a ring of 16-byte cp.async.cg copies, the next
//   step's in flight while this step's MMAs run; rows past the end are
//   zero-filled by the copies' src-size operand.
// - The validity of the whole key range is read once into shared memory (a
//   byte a key: valid, masked, past the end), not per tile from memory.
// - A step is SUB = 2 key tiles: their QK^T and their exponentials, which do
//   not depend on each other, are issued together, giving the one warp per
//   scheduler independent work; the max, sum and output recurrence then
//   runs tile by tile as before.
//
// attention_split_kernel splits the key range inside the block: SPLITS = 4
// groups of 4 warps walk contiguous shares of the key tiles over the same 64
// query rows, each with its own running (max, sum, output) and its own
// two-stage cp.async ring, and merge at the end in float32 through shared
// memory (M = max m_g, weights 2^(m_g - M)), in a fixed order: one launch,
// no atomics, bitwise repeatable, 16 warps an SM. Exponentials are ex2 with
// log2(e)/sqrt(d) folded into one FFMA a logit. It rounds the probabilities
// against each group's max, so its outputs differ from the main path's by
// about a bf16 ulp. It is not on the main path: the long protocol's 3-seed
// accuracy gate was set on the main path's bits, and from scene to scene a
// change of bits this small moves that protocol's ATE as much as the scenes
// differ, so three seeds cannot tell it from a fault (PERF.md, section 6).
//
// float32: CUDA cores. One block per (batch, head, 32 queries); 8 threads per
// query split the keys and are merged with warp shuffles at the end.

#include <atomic>

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

constexpr int MMA_WARPS = 4;                    // warps of a block, 16 query rows each
constexpr int BM = 16 * MMA_WARPS;              // queries per block
constexpr int BN = 64;                          // keys per tile
constexpr int SP = D + 8;                       // bf16 row pitch: 144 bytes, ldmatrix rows hit distinct banks
constexpr int SUB = 2;                          // key tiles a step
constexpr int STAGES = 2;                       // steps in the block's ring
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int TILE = BN * SP;                   // elements of one staged K or V tile
constexpr int MAX_KKV = 65536;                  // keys whose flags fit in shared memory beside the ring

// Dynamic shared memory: Q (BM rows), the ring ([stage][sub-tile][K, V]),
// then a flag byte per key of the key range padded to whole steps.
constexpr size_t SMEM_Q = size_t(BM) * SP * 2;
constexpr size_t SMEM_RING = size_t(STAGES) * SUB * 2 * TILE * 2;

size_t mma_smem_bytes(int Kkv) {
  return SMEM_Q + SMEM_RING + size_t((Kkv + SUB * BN - 1) / (SUB * BN)) * SUB * BN;
}

// The key-group kernel: SPLITS groups of MMA_WARPS warps, each with a
// two-stage ring of [K, V] tiles; flags padded to whole tiles. The merge
// reuses the rings for the groups' partial outputs (float rows, pitch OP).
constexpr int SPLITS = 4;
constexpr int SPLIT_THREADS = MMA_THREADS * SPLITS;
constexpr int OP = D + 8;
constexpr size_t SMEM_SPLIT_RING = size_t(SPLITS) * 2 * 2 * TILE * 2;
static_assert(size_t(SPLITS) * BM * OP * 4 <= SMEM_SPLIT_RING, "the merge's partial outputs must fit in the rings");
constexpr float LOG2E = 1.4426950408889634f;

size_t split_smem_bytes(int Kkv) { return SMEM_Q + SMEM_SPLIT_RING + size_t((Kkv + BN - 1) / BN) * BN; }

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier of one key group's MMA_THREADS threads (ids 1..SPLITS; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(MMA_THREADS) : "memory");
}

// 16 bytes global -> shared, bypassing L1; the bytes past `src_bytes` (all
// 16 when it is 0) are written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `N` of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of 64 rows of 64 bf16 (row r at src + r * row_stride) into
// padded shared rows, by `n_threads` threads of which this is thread `t`:
// each copies 16 bytes of every (n_threads / 8)-th row. Rows at or past
// `n_rows` are zero-filled (their source clamped to src).
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, size_t row_stride,
                                          int n_rows, int t, int n_threads) {
  const int c = (t % (D / 8)) * 8;
#pragma unroll
  for (int r = t / (D / 8); r < 64; r += n_threads / (D / 8)) {
    const bool in = r < n_rows;
    cp_async16(dst + r * SP + c, in ? src + r * row_stride + c : src, in ? 16 : 0);
  }
}

// S = Q K^T for one staged key tile: 16 x 64 per warp, as 8 tiles of 16 x 8.
__device__ __forceinline__ void tile_logits(float (&s)[BN / 8][4], const unsigned (&qa)[D / 16][4],
                                            const __nv_bfloat16* s_k, int lane) {
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
}

__global__ void __launch_bounds__(MMA_THREADS)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                     __nv_bfloat16* __restrict__ out, int Kq, int Kkv, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = s_q + BM * SP;          // [stage][sub-tile][K, V]
  uint8_t* s_flag = smem + SMEM_Q + SMEM_RING;  // 0 valid, 1 masked (-1e9), 2 past the end

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;  // query rows [warp * 16, + 16)
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator rows g and g + 8 of the warp's 16
  const int c = lane % 4;  // accumulator columns 2c, 2c + 1 of each 8-wide tile
  const size_t stride = size_t(H) * D;  // between consecutive slots
  const int n_steps = (Kkv + SUB * BN - 1) / (SUB * BN);
  const __nv_bfloat16* kb = k + size_t(b) * Kkv * stride + size_t(h) * D;
  const __nv_bfloat16* vb = v + size_t(b) * Kkv * stride + size_t(h) * D;
  auto tile = [&](int i, int u) { return ring + ((i % STAGES) * SUB + u) * 2 * TILE; };  // K, then V
  auto issue = [&](int i) {  // step i's key tiles into their stage, by the whole block
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const int k0 = (i * SUB + u) * BN;
      copy_tile(tile(i, u), kb + k0 * stride, stride, Kkv - k0, threadIdx.x, MMA_THREADS);
      copy_tile(tile(i, u) + TILE, vb + k0 * stride, stride, Kkv - k0, threadIdx.x, MMA_THREADS);
    }
  };

  copy_tile(s_q, q + (size_t(b) * Kq + q0) * stride + size_t(h) * D, stride, Kq - q0, threadIdx.x, MMA_THREADS);
  cp_async_commit();
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_steps) issue(i);
    cp_async_commit();
  }
  for (int j0 = threadIdx.x; j0 < n_steps * SUB * BN; j0 += 4 * MMA_THREADS) {  // four loads in flight a thread
    uint8_t f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * MMA_THREADS;
      f[u] = j < Kkv ? (valid[size_t(b) * Kkv + j] ? 0 : 1) : 2;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u * MMA_THREADS < n_steps * SUB * BN) s_flag[j0 + u * MMA_THREADS] = f[u];
  }
  cp_async_wait<STAGES - 1>();  // Q has landed (this thread's part)
  __syncthreads();              // Q and the flags, the whole block's
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

  // A step runs the online softmax over SUB key tiles, tile by tile in the
  // same arithmetic as one tile at a time; only the independent parts (the
  // tiles' QK^T and their exponentials) are issued together, for the ILP
  // that one warp per scheduler needs. A tile past the end (Kkv not a whole
  // number of steps) has every logit -inf: its max, correction (exp 0 = 1),
  // probabilities (0) and PV (0 * 0) leave the state exactly as it was.
  for (int i = 0; i < n_steps; ++i) {
    if (i + STAGES - 1 < n_steps) issue(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // step i has landed (this thread's copies)
    __syncthreads();              // ... and the block's

    float s[SUB][BN / 8][4];  // logits, then probabilities
#pragma unroll
    for (int u = 0; u < SUB; ++u) tile_logits(s[u], qa, tile(i, u), lane);

    // scale, mask and each tile's max (rows g and g + 8; a row's 4 threads are a quad)
    float mt[SUB][2], corr[SUB][2];
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const uint8_t* flag = s_flag + (i * SUB + u) * BN;
      float tmax0 = -CUDART_INF_F, tmax1 = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const uchar2 f = *reinterpret_cast<const uchar2*>(flag + n * 8 + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint8_t st = (e & 1) ? f.y : f.x;
          const float x = st == 0 ? s[u][n][e] * scale : (st == 1 ? NEG : -CUDART_INF_F);
          s[u][n][e] = x;
        }
        tmax0 = fmaxf(tmax0, fmaxf(s[u][n][0], s[u][n][1]));
        tmax1 = fmaxf(tmax1, fmaxf(s[u][n][2], s[u][n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
        tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
      }
      const float mn0 = fmaxf(m0, tmax0);
      const float mn1 = fmaxf(m1, tmax1);
      corr[u][0] = expf(m0 - mn0);  // 0 on the first tile (m = -inf)
      corr[u][1] = expf(m1 - mn1);
      m0 = mt[u][0] = mn0;
      m1 = mt[u][1] = mn1;
    }
#pragma unroll
    for (int u = 0; u < SUB; ++u)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        s[u][n][0] = expf(s[u][n][0] - mt[u][0]);
        s[u][n][1] = expf(s[u][n][1] - mt[u][0]);
        s[u][n][2] = expf(s[u][n][2] - mt[u][1]);
        s[u][n][3] = expf(s[u][n][3] - mt[u][1]);
      }

#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      l0 *= corr[u][0];
      l1 *= corr[u][1];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= corr[u][0];
        o[n][1] *= corr[u][0];
        o[n][2] *= corr[u][1];
        o[n][3] *= corr[u][1];
      }
      unsigned pa[BN / 16][4];  // P as the A operand of PV, per 16-key step
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        l0 += s[u][n][0] + s[u][n][1];
        l1 += s[u][n][2] + s[u][n][3];
        pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(s[u][n][0], s[u][n][1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[u][n][2], s[u][n][3]);
      }
      // O += P V: 16 x 64 per warp; V rows are keys, read transposed
      const __nv_bfloat16* s_v = tile(i, u) + TILE;
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
    __syncthreads();  // the stage is read; the next issue may overwrite it
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

// The key range split inside the block (see the header): group `grp` walks
// its share of the key tiles with its own online softmax in the log2
// domain, then the groups merge through shared memory.
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
attention_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                       __nv_bfloat16* __restrict__ out, int Kq, int Kkv, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_ring = s_q + BM * SP;
  uint8_t* s_flag = smem + SMEM_Q + SMEM_SPLIT_RING;  // 0 valid, 1 masked (-1e9), 2 past the end
  __shared__ float s_m[SPLITS][BM];                   // each group's row max, log2 domain
  __shared__ float s_l[SPLITS][BM];                   // each group's row sum

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int grp = threadIdx.x / MMA_THREADS;
  const int t = threadIdx.x % MMA_THREADS;
  const int warp = t / 32;  // query rows [warp * 16, + 16)
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator rows g and g + 8 of the warp's 16
  const int c = lane % 4;  // accumulator columns 2c, 2c + 1 of each 8-wide tile
  const size_t stride = size_t(H) * D;  // between consecutive slots

  // this group's key tiles: [tile0, tile0 + n); a group may have none
  const int n_tiles = (Kkv + BN - 1) / BN;
  const int tile0 = grp * n_tiles / SPLITS;
  const int n = (grp + 1) * n_tiles / SPLITS - tile0;
  __nv_bfloat16* ring = s_ring + grp * 4 * TILE;  // [stage][K, V]
  const __nv_bfloat16* kb = k + size_t(b) * Kkv * stride + size_t(h) * D;
  const __nv_bfloat16* vb = v + size_t(b) * Kkv * stride + size_t(h) * D;
  auto issue = [&](int i) {  // the group's i-th tile into stage i % 2, by the group
    const int k0 = (tile0 + i) * BN;
    __nv_bfloat16* st = ring + (i & 1) * 2 * TILE;
    copy_tile(st, kb + k0 * stride, stride, Kkv - k0, t, MMA_THREADS);
    copy_tile(st + TILE, vb + k0 * stride, stride, Kkv - k0, t, MMA_THREADS);
  };

  // Q by the whole block, each group's first tile by the group
  copy_tile(s_q, q + (size_t(b) * Kq + q0) * stride + size_t(h) * D, stride, Kq - q0, threadIdx.x, SPLIT_THREADS);
  cp_async_commit();
  if (n > 0) issue(0);
  cp_async_commit();
  for (int j = threadIdx.x; j < n_tiles * BN; j += SPLIT_THREADS)
    s_flag[j] = j < Kkv ? (valid[size_t(b) * Kkv + j] ? 0 : 1) : 2;
  cp_async_wait<1>();  // Q has landed (this thread's part)
  __syncthreads();     // Q and the flags, the whole block's
  unsigned qa[D / 16][4];  // A fragments of this warp's 16 query rows, per 16-wide d step
  {
    const __nv_bfloat16* base = s_q + (warp * 16 + lane % 16) * SP + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], base + kk * 16);
  }

  // Logits stay raw (q.k) until the exponential. A masked key's raw logit
  // is substituted first (-1e9 / scale, so -1e9 once scaled), a key past the
  // end's is -inf; then one FFMA scales to the log2 domain and subtracts the
  // running max there: p = 2^(x c2 - m c2) with c2 = scale * log2(e).
  const float c2 = scale * LOG2E;
  const float neg_raw = NEG / scale;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;    // running raw max, rows g and g + 8
  float mc0 = -CUDART_INF_F, mc1 = -CUDART_INF_F;  // the same in the log2 domain
  float l0 = 0.f, l1 = 0.f;                        // running sums (this thread's columns)

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile i has landed (this thread's copies)
    group_sync(1 + grp);  // ... and the group's
    const __nv_bfloat16* s_k = ring + (i & 1) * 2 * TILE;
    const __nv_bfloat16* s_v = s_k + TILE;
    const uint8_t* flag = s_flag + (tile0 + i) * BN;

    float s[BN / 8][4];
    tile_logits(s, qa, s_k, lane);

    // substitute, online softmax in the log2 domain (rows g and g + 8; a row's 4 threads are a quad)
    float tmax0 = -CUDART_INF_F, tmax1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const uchar2 f = *reinterpret_cast<const uchar2*>(flag + j * 8 + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint8_t st = (e & 1) ? f.y : f.x;
        s[j][e] = st == 0 ? s[j][e] : (st == 1 ? neg_raw : -CUDART_INF_F);
      }
      tmax0 = fmaxf(tmax0, fmaxf(s[j][0], s[j][1]));
      tmax1 = fmaxf(tmax1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
    }
    // every tile holds a key before the end, so the new max is finite
    m0 = fmaxf(m0, tmax0);
    m1 = fmaxf(m1, tmax1);
    const float mn0 = m0 * c2, mn1 = m1 * c2;
    const float corr0 = ex2(mc0 - mn0);  // 0 on the group's first tile (mc = -inf)
    const float corr1 = ex2(mc1 - mn1);
    mc0 = mn0;
    mc1 = mn1;
    // a masked key weighs 1 while the row has seen no valid key (as 2^0 for
    // equal -1e9 logits), else 0 (2^(-1e9 log2 e - m) is 0 in float32)
    const float w0 = m0 == neg_raw ? 1.f : 0.f;
    const float w1 = m1 == neg_raw ? 1.f : 0.f;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr0;
      o[j][1] *= corr0;
      o[j][2] *= corr1;
      o[j][3] *= corr1;
    }
    unsigned pa[BN / 16][4];  // P as the A operand of PV, per 16-key step
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p0 = s[j][0] == neg_raw ? w0 : ex2(fmaf(s[j][0], c2, -mn0));
      const float p1 = s[j][1] == neg_raw ? w0 : ex2(fmaf(s[j][1], c2, -mn0));
      const float p2 = s[j][2] == neg_raw ? w1 : ex2(fmaf(s[j][2], c2, -mn1));
      const float p3 = s[j][3] == neg_raw ? w1 : ex2(fmaf(s[j][3], c2, -mn1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: 16 x 64 per warp; V rows are keys, read transposed
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        // matrices: keys [16kk, +8), [16kk+8, +8) x d [8j, +8); the same keys x d [8j+8, +8)
        unsigned b0, b1, b2, b3;
        const __nv_bfloat16* p = s_v + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * SP + j * 8 + (lane / 16) * 8;
        ldmatrix_x4_trans(b0, b1, b2, b3, p);
        mma_bf16(o[j], pa[kk], b0, b1);
        mma_bf16(o[j + 1], pa[kk], b2, b3);
      }
    }
    group_sync(1 + grp);  // the stage is read; the next issue may overwrite it
  }

  // Merge the groups' states in float32, in a fixed order: M = max_g m_g,
  // L = sum_g l_g 2^(m_g - M), out = sum_g o_g 2^(m_g - M) / L. A group with
  // no key (m = -inf, l = 0) weighs 0.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = warp * 16 + g;  // block-local rows of this thread
  const int r1 = r0 + 8;
  if (c == 0) {
    s_m[grp][r0] = mc0;
    s_m[grp][r1] = mc1;
    s_l[grp][r0] = l0;
    s_l[grp][r1] = l1;
  }
  __syncthreads();  // the states are posted and every group is done with its ring
  float M0 = -CUDART_INF_F, M1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < SPLITS; ++j) {
    M0 = fmaxf(M0, s_m[j][r0]);
    M1 = fmaxf(M1, s_m[j][r1]);
  }
  float L0 = 0.f, L1 = 0.f;
#pragma unroll
  for (int j = 0; j < SPLITS; ++j) {
    if (s_m[j][r0] != -CUDART_INF_F) L0 += s_l[j][r0] * ex2(s_m[j][r0] - M0);
    if (s_m[j][r1] != -CUDART_INF_F) L1 += s_l[j][r1] * ex2(s_m[j][r1] - M1);
  }
  const float f0 = mc0 == -CUDART_INF_F ? 0.f : ex2(mc0 - M0) / fmaxf(L0, 1e-30f);
  const float f1 = mc1 == -CUDART_INF_F ? 0.f : ex2(mc1 - M1) / fmaxf(L1, 1e-30f);
  float* s_o = reinterpret_cast<float*>(s_ring);  // [group][BM][OP]
  float* po = s_o + grp * BM * OP;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * c;
    *reinterpret_cast<float2*>(po + r0 * OP + d) = make_float2(o[j][0] * f0, o[j][1] * f0);
    *reinterpret_cast<float2*>(po + r1 * OP + d) = make_float2(o[j][2] * f1, o[j][3] * f1);
  }
  __syncthreads();
  // the block's 64 rows x 64 bf16, eight to a thread: sum the groups, store 16 bytes
  for (int i = threadIdx.x; i < BM * (D / 8); i += SPLIT_THREADS) {
    const int r = i / (D / 8);
    const int d = (i % (D / 8)) * 8;
    if (q0 + r >= Kq) continue;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < SPLITS; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(s_o + (j * BM + r) * OP + d);
      const float4 z = *reinterpret_cast<const float4*>(s_o + (j * BM + r) * OP + d + 4);
      acc[0] += a.x, acc[1] += a.y, acc[2] += a.z, acc[3] += a.w;
      acc[4] += z.x, acc[5] += z.y, acc[6] += z.z, acc[7] += z.w;
    }
    const uint4 packed = make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]), pack_bf16(acc[4], acc[5]),
                                    pack_bf16(acc[6], acc[7]));
    *reinterpret_cast<uint4*>(out + (size_t(b) * Kq + q0 + r) * stride + size_t(h) * D + d) = packed;
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

// A bf16 kernel with its launch shape and dynamic shared memory.
struct Bf16Kernel {
  void (*fn)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*, const uint8_t*, __nv_bfloat16*, int,
             int, int, float);
  int threads;
  size_t (*smem_bytes)(int);
};

Bf16Kernel bf16_kernel(bool split) {
  return split ? Bf16Kernel{attention_split_kernel, SPLIT_THREADS, split_smem_bytes}
               : Bf16Kernel{attention_mma_kernel, MMA_THREADS, mma_smem_bytes};
}

// Lets the kernel take the dynamic shared memory of the longest key range it
// accepts, once per kernel and device (the launches then skip the call).
cudaError_t allow_smem(const Bf16Kernel& kern, bool split) {
  static std::atomic<uint64_t> done[2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (done[split].load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern.fn), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kern.smem_bytes(MAX_KKV)));
  if (err == cudaSuccess) done[split].fetch_or(bit);
  return err;
}

int launch_bf16(const void* q, const void* k, const void* v, const uint8_t* valid, void* out, int B, int Kq, int Kkv,
                int H, float scale, bool split, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (Kkv > MAX_KKV) return -2;
  const Bf16Kernel kern = bf16_kernel(split);
  const cudaError_t attr = allow_smem(kern, split);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Kq + BM - 1) / BM, H, B);
  kern.fn<<<grid, kern.threads, kern.smem_bytes(Kkv), stream>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                                                static_cast<const bf*>(v), valid,
                                                                static_cast<bf*>(out), Kq, Kkv, H, scale);
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
// for a bad shape (bf16 takes at most 65,536 keys). `split` picks the bf16
// key-group kernel.
extern "C" int urmvo_attention(int dtype, const void* q, const void* k, const void* v, const uint8_t* valid,
                               void* out, int B, int Kq, int Kkv, int H, int head_dim, float scale, int split,
                               void* stream) {
  if (head_dim != D) return -1;
  if (B < 1 || Kq < 1 || Kkv < 1 || H < 1) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == urmvo::DT_BF16) return launch_bf16(q, k, v, valid, out, B, Kq, Kkv, H, scale, split != 0, s);
  if (dtype == urmvo::DT_F32 && !split) return launch_f32(q, k, v, valid, out, B, Kq, Kkv, H, scale, s);
  return -1;
}

// What a bf16 kernel (`split`: the key-group one) takes on this device for
// Kkv keys: resident blocks per SM, registers per thread, shared memory per
// block (static and dynamic) and local memory per thread (spills). Returns a
// cudaError_t, or -2 for a Kkv it does not take.
extern "C" int urmvo_attention_occupancy(int Kkv, int split, int* blocks_per_sm, int* regs, int* smem,
                                         int* local_bytes) {
  if (Kkv < 1 || Kkv > MAX_KKV) return -2;
  const Bf16Kernel kern = bf16_kernel(split != 0);
  const size_t dyn = kern.smem_bytes(Kkv);
  cudaError_t err = allow_smem(kern, split != 0);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern.fn, kern.threads, dyn);
  if (err != cudaSuccess) return int(err);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kern.fn));
  if (err != cudaSuccess) return int(err);
  *regs = a.numRegs;
  *smem = int(a.sharedSizeBytes + dyn);
  *local_bytes = int(a.localSizeBytes);
  return 0;
}
