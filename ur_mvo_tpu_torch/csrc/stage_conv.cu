// Fused SuperPoint encoder stage for Hopper (sm_90a):
//   conv_a 3x3 + bias + ReLU -> round to the activation type -> conv_b 3x3 +
//   bias + ReLU -> 2x2 max-pool.
//
// Replaces the TPU kernels ur_mvo_tpu/ops/pallas_conv.py::_stage1_kernel (:106,
// Cin = 1, stage 1) and ::_stage2_kernel (:140, Cin = 64, stages 2 and 3). It
// computes what they compute; the TPU's slab layout, K-paired matmuls and
// indicator-matmul pooling are not carried over.
//
// Layout: activations NHWC (B, H, W, C); biases float holding the
// dtype-rounded values. Accumulation is float32 throughout.
//
// Tiling. A tile is 4 x 8 pooled outputs (an 8 x 16 tile of conv_b outputs).
// Its 12 x 20 input window is staged in shared memory with SAME zero padding;
// conv_a runs over the 10 x 18 halo region into shared memory, rounded to the
// activation type as the TPU kernel does (pallas_conv.py:127/:151), with
// LITERAL zeros for halo pixels outside the image: conv_b's SAME padding is
// zeros, not conv_a of padded pixels, which bias + ReLU make nonzero
// (pallas_conv.py:128-133, :152-155). conv_b, ReLU and the pool follow; only
// the pooled tile goes to device memory. Tiles need not divide the image:
// partial tiles (pooled 120x160, 60x80, 30x40 at 240x320) are masked.
//
// bf16 (the main path): tensor cores. Each 3x3 conv is an implicit GEMM
// (pixels x output channels, K = 9 taps x input channels) on
// mma.sync.m16n8k16 with float32 accumulation: A rows are pixels, gathered per
// tap by ldmatrix from padded shared-memory rows; B is the weight, packed on
// the host in the mma fragment order ([tap][k16][n8][lane] x 2 registers).
// Every output is one chain of MMAs, tap-major then 16-channel chunks in
// ascending order, from 0, with the bias added after: the same chain whatever
// the block, warp or fragment row that computes it. conv_a with Cin = 1 (a
// 9-tap filter) runs on the CUDA cores as an fmaf chain from the bias.
//
// What bounds it, and the design. At 240x320 the three stages do ~10.7 GFLOP
// and move ~3 MB, so the card's bound is operations (0.0058 / 0.0029 / 0.0021
// ms). What held the first design back was data movement and the grid, not
// the MMAs: every warp read its B fragments from L2 (~4 MB a block at stage
// 3, for 442 KB of distinct weights), and stage 3 launched 40 blocks on 132
// SMs. So:
// - Weights are staged in shared memory by cp.async and read by all warps of
//   the block: a B fragment is 32 lanes x 8 contiguous bytes, free of bank
//   conflicts. conv_a's are loaded once a block, with the first input
//   window; conv_b's once (stages 1-2, waited for only before the first
//   conv_b) or, where they do not fit (stage 3), through a ring of 4 tap
//   slots that streams them continuously: each conv_b tap's copy is issued
//   three taps ahead, across the end of a tile into the next one's.
// - The grid is persistent: as many blocks as the card holds, each looping
//   over tiles with its weights in place, the next tile's input window
//   copied in while the current tile's conv_b runs.
// - Stage 3 (128 channels) runs as 2-block thread-block clusters over the
//   channels: each block computes half of conv_a's channels, pulls the other
//   half from its peer's shared memory (distributed shared memory) and
//   computes half of conv_b's, so 40 tiles give 80 blocks, one round. No sum
//   is split: a block computes whole chains for its channels.
// - Each warp takes several fragment rows and columns a k-step (conv_a 3
//   pixel blocks x 4 columns, conv_b two conv_b rows x 4 columns), so each A
//   and B fragment read from shared memory feeds 8-12 MMAs; the 2x2 pool
//   runs in registers (the two rows in one warp, the two columns a lane
//   shuffle apart), so conv_b's outputs never go to shared memory. The pool
//   takes the rounded values (rounding is monotonic, so pooling rounded
//   values equals rounding the pooled one).
// What bounds it now: shared-memory reads (~2 wavefronts an MMA), the
// mma.sync issue rate and the grid's last round (stage 2's 150 tiles on
// 132 blocks); measured times in PERF.md (chip_smoke.py phase 3).
//
// float32: the first design's tiling on the CUDA cores (a block a tile, each
// thread a register tile of 4 pixels x 8 channels; weights [tap][ci][co]
// through the read-only cache).

#include "common.cuh"

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int PH = 4;            // pooled rows per tile
constexpr int PW = 8;            // pooled cols per tile
constexpr int BH = 2 * PH;       // conv_b rows per tile
constexpr int BW = 2 * PW;       // conv_b cols per tile (one m16 fragment row block)
constexpr int MH = BH + 2;       // conv_a halo region rows
constexpr int MW = BW + 2;       // conv_a halo region cols
constexpr int NMID = MH * MW;    // conv_a halo pixels
constexpr int IH = BH + 4;       // input window rows
constexpr int IW = BW + 4;       // input window cols
constexpr int THREADS = 256;
constexpr int CG = 8;            // output channels per thread item (CUDA-core loops)
constexpr int PXG = 4;           // conv_a pixels per thread item (CUDA-core loops)
static_assert(NMID % PXG == 0, "pixel groups");

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int fpitch(int c) { return c == 1 ? 1 : c + 1; }  // float pitch: spreads banks

template <int CIN, int CMID>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (size_t(IH * IW * fpitch(CIN)) + size_t(NMID * fpitch(CMID)));
}

template <int CIN, int CMID, int COUT>
__global__ void __launch_bounds__(THREADS)
stage_fma_kernel(const float* __restrict__ x, const float* __restrict__ wa, const float* __restrict__ ba,
                 const float* __restrict__ wb, const float* __restrict__ bb, float* __restrict__ out, int H, int W) {
  static_assert(CMID % CG == 0 && COUT % CG == 0, "channel groups");
  constexpr int CIN_P = fpitch(CIN);
  constexpr int CMID_P = fpitch(CMID);
  extern __shared__ float fsmem[];
  float* s_in = fsmem;                     // [IH*IW][CIN_P]
  float* s_mid = fsmem + IH * IW * CIN_P;  // [NMID][CMID_P]

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * PH;
  const int px0 = blockIdx.x * PW;
  const int cy0 = 2 * py0;  // conv_b tile origin (image coords)
  const int cx0 = 2 * px0;
  const int Ho = H / 2;
  const int Wo = W / 2;
  const float* xb = x + size_t(b) * H * W * CIN;

  // 1. input window, SAME zero padding
  for (int i = threadIdx.x; i < IH * IW * CIN; i += THREADS) {
    const int c = i % CIN;
    const int p = i / CIN;
    const int gy = cy0 - 2 + p / IW;
    const int gx = cx0 - 2 + p % IW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xb[(size_t(gy) * W + gx) * CIN + c];
    s_in[p * CIN_P + c] = v;
  }
  __syncthreads();

  // 2. conv_a + bias + ReLU over the halo region; zeros outside the image
  constexpr int NPG_A = NMID / PXG;
  constexpr int NCG_A = CMID / CG;
  for (int item = threadIdx.x; item < NPG_A * NCG_A; item += THREADS) {
    const int co0 = (item % NCG_A) * CG;
    const int pg = item / NCG_A;
    int base[PXG];
    float acc[PXG][CG];
#pragma unroll
    for (int p = 0; p < PXG; ++p) {
      const int pix = pg * PXG + p;
      base[p] = ((pix / MW) * IW + pix % MW) * CIN_P;
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[p][c] = ba[co0 + c];
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int toff = ((t / 3) * IW + t % 3) * CIN_P;
      const float* wt = wa + size_t(t) * CIN * CMID + co0;
#pragma unroll 4
      for (int ci = 0; ci < CIN; ++ci) {
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wt + ci * CMID));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wt + ci * CMID + 4));
        const float w[CG] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int p = 0; p < PXG; ++p) {
          const float a = s_in[base[p] + toff + ci];
#pragma unroll
          for (int c = 0; c < CG; ++c) acc[p][c] = fmaf(a, w[c], acc[p][c]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PXG; ++p) {
      const int pix = pg * PXG + p;
      const int gy = cy0 - 1 + pix / MW;
      const int gx = cx0 - 1 + pix % MW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int c = 0; c < CG; ++c) s_mid[pix * CMID_P + co0 + c] = inside ? fmaxf(acc[p][c], 0.f) : 0.f;
    }
  }
  __syncthreads();

  // 3. conv_b + bias + ReLU + 2x2 max-pool, one pooled pixel x CG channels per item
  constexpr int NPOS = PH * PW;
  constexpr int NCG_B = COUT / CG;
  for (int item = threadIdx.x; item < NPOS * NCG_B; item += THREADS) {
    const int co0 = (item % NCG_B) * CG;
    const int pos = item / NCG_B;
    const int ly = pos / PW;
    const int lx = pos % PW;
    const int oy = py0 + ly;
    const int ox = px0 + lx;
    if (oy >= Ho || ox >= Wo) continue;
    int base[4];
    float acc[4][CG];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // conv_b pixel (2ly + q/2, 2lx + q%2) of the tile; the halo region
      // starts one pixel up-left, so its tap (0, 0) sits at the same index
      base[q] = ((2 * ly + q / 2) * MW + 2 * lx + q % 2) * CMID_P;
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[q][c] = bb[co0 + c];
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int toff = ((t / 3) * MW + t % 3) * CMID_P;
      const float* wt = wb + size_t(t) * CMID * COUT + co0;
#pragma unroll 4
      for (int ci = 0; ci < CMID; ++ci) {
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wt + ci * COUT));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wt + ci * COUT + 4));
        const float w[CG] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = s_mid[base[q] + toff + ci];
#pragma unroll
          for (int c = 0; c < CG; ++c) acc[q][c] = fmaf(a, w[c], acc[q][c]);
        }
      }
    }
    float* o = out + ((size_t(b) * Ho + oy) * Wo + ox) * COUT + co0;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const float m = fmaxf(fmaxf(acc[0][c], acc[1][c]), fmaxf(acc[2][c], acc[3][c]));
      o[c] = fmaxf(m, 0.f);  // max(relu(.)) == relu(max(.))
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int bpitch(int c) { return c == 1 ? 1 : c + 8; }  // bf16 pitch: 16-byte rows, banks spread

// conv_a's 16-pixel fragment rows over the halo region (the last one partly
// past it), and the warp grid that covers them: 4 groups of 3 x 2 halves of
// the block's channels = 8 warps. conv_b: 4 pairs of conv_b rows (one pooled
// row each) x 2 halves of the block's channels.
constexpr int NMT_A = (NMID + 15) / 16;
constexpr int MT_A = 3;
static_assert(NMT_A == 4 * MT_A && THREADS == 8 * 32 && BH == 2 * 4, "warp grids");

// Blocks of a thread-block cluster over the channels: stage 3 (128 channels)
// splits them two ways, stages 1-2 not at all.
__host__ __device__ constexpr int cluster_size(int cmid) { return cmid == 128 ? 2 : 1; }

constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may take
constexpr int PXG_1 = 6;             // conv_a pixels per thread item, Cin = 1: 240 items, one round
static_assert(NMID % PXG_1 == 0, "pixel groups");

template <int CIN, int CMID, int COUT>
struct MmaCfg {
  static constexpr int CL = cluster_size(CMID);
  static constexpr int KA = CIN / 16;        // conv_a k-steps a tap (Cin > 1)
  static constexpr int KB = CMID / 16;       // conv_b k-steps a tap
  static constexpr int NA = CMID / 8 / CL;   // conv_a 8-channel fragment columns of a block
  static constexpr int NB = COUT / 8 / CL;   // conv_b's
  static constexpr int CIN_P = bpitch(CIN);
  static constexpr int CMID_P = bpitch(CMID);
  static constexpr size_t in_bytes = round16(sizeof(bf16) * IH * IW * CIN_P);
  static constexpr size_t mid_bytes = round16(sizeof(bf16) * NMID * CMID_P);
  static constexpr size_t wa_bytes = CIN == 1 ? 0 : size_t(9) * KA * NA * 32 * sizeof(uint2);
  static constexpr int TAP_WORDS = KB * NB * 32;  // uint2 words of conv_b's weights a tap
  static constexpr size_t TAP_BYTES = TAP_WORDS * sizeof(uint2);
  static constexpr size_t fixed_bytes = in_bytes + mid_bytes + wa_bytes;
  // conv_b's weights: all 9 taps, loaded once, where they fit; else a ring
  // of RING tap slots that streams them through every tile
  static constexpr int RING = fixed_bytes + 9 * TAP_BYTES <= SMEM_MAX ? 9 : int((SMEM_MAX - fixed_bytes) / TAP_BYTES);
  static constexpr size_t bytes = fixed_bytes + RING * TAP_BYTES;
  // two blocks an SM where their shared memory fits (stage 1): registers <= 128
  static constexpr int MIN_BLOCKS = 2 * (bytes + 1024) <= SMEM_MAX + 1024 ? 2 : 1;
  static_assert(CMID % (16 * CL) == 0 && COUT % (16 * CL) == 0, "two fragment columns per warp half");
  static_assert(CIN == 1 ? CL == 1 : CIN % 16 == 0, "input channels");
  static_assert(RING >= 3 && bytes <= SMEM_MAX, "shared memory a block");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 16 bytes global -> shared, bypassing L1; zeros where `valid` is false
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `N` of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return int(r);
}

// The two halves of a cluster barrier: arrive (releasing this thread's shared
// memory writes) and wait for every thread of the cluster (acquiring theirs).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// 16 bytes at the same shared-memory offset as `p`, in cluster block `rank`.
__device__ __forceinline__ uint4 ld_peer16(const void* p, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote));
  return v;
}

// This block's slice of a packed weight ([tap][k16][n8][lane] uint2, `nt`
// fragment columns a (tap, k16) row): columns [n0, n0 + N) of each of the
// `rows` rows, into dst as [row][N][lane].
template <int N>
__device__ __forceinline__ void copy_weight_slice(uint2* dst, const uint2* src, int rows, int nt, int n0) {
  constexpr int CHUNKS = N * 32 * sizeof(uint2) / 16;  // 16-byte copies a row
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int row = i / CHUNKS;
    const int k = i % CHUNKS;
    cp_async16(reinterpret_cast<uint4*>(dst + size_t(row) * N * 32) + k,
               reinterpret_cast<const uint4*>(src + (size_t(row) * nt + n0) * 32) + k, true);
  }
}

// The 12 x 20 input window of the tile at conv_b origin (cy0, cx0), SAME zero
// padding, as cp.async copies (Cin > 1).
template <int CIN>
__device__ __forceinline__ void copy_window(bf16* s_in, const bf16* xb, int cy0, int cx0, int H, int W) {
  constexpr int CHUNKS = CIN / 8;
  for (int i = threadIdx.x; i < IH * IW * CHUNKS; i += THREADS) {
    const int p = i / CHUNKS;
    const int c8 = (i % CHUNKS) * 8;
    const int gy = cy0 - 2 + p / IW;
    const int gx = cx0 - 2 + p % IW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(s_in + p * bpitch(CIN) + c8, inside ? xb + (size_t(gy) * W + gx) * CIN + c8 : xb, inside);
  }
}

// A persistent grid of thread-block clusters (CL blocks along x; CL = 1 is a
// plain block). Cluster q takes tiles q, q + clusters, ... of the B x tiles_y
// x tiles_x tiles; its block `rank` computes conv_a's channels
// [rank, rank + 1) * CMID / CL and conv_b's [rank, rank + 1) * COUT / CL.
template <int CIN, int CMID, int COUT>
__global__ void __launch_bounds__(THREADS, MmaCfg<CIN, CMID, COUT>::MIN_BLOCKS)
stage_mma_kernel(const bf16* __restrict__ x, const void* __restrict__ wa, const float* __restrict__ ba,
                 const uint2* __restrict__ wb, const float* __restrict__ bb, bf16* __restrict__ out, int H, int W,
                 int tiles_x, int tiles_y, int n_tiles) {
  using C = MmaCfg<CIN, CMID, COUT>;
  constexpr int CL = C::CL;
  constexpr int RING = C::RING;
  constexpr bool STREAM = RING < 9;  // conv_b's weights stream through a ring
  constexpr int NTA = C::NA / 2;     // a warp's conv_a fragment columns
  constexpr int NTB = C::NB / 2;     // a warp's conv_b fragment columns
  constexpr int CIN_P = C::CIN_P;
  constexpr int CMID_P = C::CMID_P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);                                 // [IH*IW][CIN_P]
  bf16* s_mid = reinterpret_cast<bf16*>(smem + C::in_bytes);                  // [NMID][CMID_P]
  uint2* s_wa = reinterpret_cast<uint2*>(smem + C::in_bytes + C::mid_bytes);  // [9*KA][NA][32]
  uint2* s_wb = reinterpret_cast<uint2*>(smem + C::fixed_bytes);              // [RING][KB][NB][32]

  const int rank = CL > 1 ? cluster_rank() : 0;
  const int clusters = gridDim.x / CL;
  const int Ho = H / 2;
  const int Wo = W / 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  auto tile_origin = [&](int tile, int& b, int& py0, int& px0) {
    b = tile / (tiles_x * tiles_y);
    py0 = (tile / tiles_x % tiles_y) * PH;
    px0 = (tile % tiles_x) * PW;
  };
  // conv_b's weights, taps [t0, t0 + taps) of the block's slice, into slots from `slot`
  auto copy_wb = [&](int t0, int taps, int slot) {
    copy_weight_slice<C::NB>(s_wb + size_t(slot) * C::TAP_WORDS, wb + size_t(t0) * C::KB * (COUT / 8) * 32,
                             taps * C::KB, COUT / 8, rank * C::NB);
  };

  // 0. the block's weights: conv_a's once, with the first input window
  //    (group 0); conv_b's once (group 1) or, streamed, its first RING - 1
  //    taps (a group each)
  int tile = blockIdx.x / CL;
  int b, py0, px0;
  tile_origin(tile, b, py0, px0);
  if constexpr (CIN > 1) {
    copy_weight_slice<C::NA>(s_wa, static_cast<const uint2*>(wa), 9 * C::KA, CMID / 8, rank * C::NA);
    if (tile < n_tiles) copy_window<CIN>(s_in, x + size_t(b) * H * W * CIN, 2 * py0, 2 * px0, H, W);
  }
  cp_async_commit();
  if constexpr (STREAM) {
#pragma unroll
    for (int t = 0; t < RING - 1; ++t) {
      copy_wb(t, 1, t);
      cp_async_commit();
    }
  } else {
    copy_wb(0, 9, 0);
    cp_async_commit();
  }

  // q counts the conv_b taps this block has started: tap t of its k-th tile
  // is q = 9 k + t, in ring slot q % RING
  for (int q = 0; tile < n_tiles; tile += clusters, q += 9) {
    const bool first = q == 0;
    tile_origin(tile, b, py0, px0);
    const int cy0 = 2 * py0;
    const int cx0 = 2 * px0;
    if constexpr (CIN == 1) {
      const bf16* xb = x + size_t(b) * H * W;
      for (int p = threadIdx.x; p < IH * IW; p += THREADS) {
        const int gy = cy0 - 2 + p / IW;
        const int gx = cx0 - 2 + p % IW;
        s_in[p] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? xb[size_t(gy) * W + gx] : __float2bfloat16_rn(0.f);
      }
    }
    // the window (and conv_a's weights): behind it fly conv_b's weights on
    // the first tile, or the ring's 9 step groups of the last tile's conv_b
    if constexpr (STREAM) {
      if (first)
        cp_async_wait<RING - 1>();
      else
        cp_async_wait<9>();
    } else {
      if (first)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    }
    if constexpr (CL > 1) {
      if (!first) cluster_wait();  // the peers have read the last tile's s_mid
    }
    __syncthreads();

    // 1. conv_a + bias + ReLU over the halo region, rounded to bf16, into the
    //    block's channels of s_mid; zeros outside the image
    if constexpr (CIN == 1) {
      const float* wf = static_cast<const float*>(wa);  // [9][CMID]
      constexpr int NCG_A = CMID / CG;
      for (int item = threadIdx.x; item < (NMID / PXG_1) * NCG_A; item += THREADS) {
        const int co0 = (item % NCG_A) * CG;
        const int pg = item / NCG_A;
        float acc[PXG_1][CG];
#pragma unroll
        for (int p = 0; p < PXG_1; ++p)
#pragma unroll
          for (int k = 0; k < CG; ++k) acc[p][k] = ba[co0 + k];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float4 w0 = __ldg(reinterpret_cast<const float4*>(wf + t * CMID + co0));
          const float4 w1 = __ldg(reinterpret_cast<const float4*>(wf + t * CMID + co0 + 4));
          const float w[CG] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < PXG_1; ++p) {
            const int pix = pg * PXG_1 + p;
            const float a = __bfloat162float(s_in[(pix / MW + t / 3) * IW + pix % MW + t % 3]);
#pragma unroll
            for (int k = 0; k < CG; ++k) acc[p][k] = fmaf(a, w[k], acc[p][k]);
          }
        }
#pragma unroll
        for (int p = 0; p < PXG_1; ++p) {
          const int pix = pg * PXG_1 + p;
          const int gy = cy0 - 1 + pix / MW;
          const int gx = cx0 - 1 + pix % MW;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int k = 0; k < CG; k += 2) {
            const unsigned v = inside ? pack_bf16(fmaxf(acc[p][k], 0.f), fmaxf(acc[p][k + 1], 0.f)) : 0u;
            *reinterpret_cast<unsigned*>(s_mid + pix * CMID_P + co0 + k) = v;
          }
        }
      }
    } else {
      // warp: fragment rows mg * 3 + {0, 1, 2} of the halo region x columns
      // [ng, ng + 1) * NTA of the block's
      const int mg = warp % 4;
      const int ng = warp / 4;
      const bf16* arow[MT_A];
#pragma unroll
      for (int m = 0; m < MT_A; ++m) {
        const int pix = min((mg * MT_A + m) * 16 + lane % 16, NMID - 1);  // ldmatrix row of this lane
        arow[m] = s_in + ((pix / MW) * IW + pix % MW) * CIN_P + (lane / 16) * 8;
      }
      float acc[MT_A][NTA][4];
#pragma unroll
      for (int m = 0; m < MT_A; ++m)
#pragma unroll
        for (int n = 0; n < NTA; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int toff = ((t / 3) * IW + t % 3) * CIN_P;
#pragma unroll
        for (int ks = 0; ks < C::KA; ++ks) {
          unsigned a[MT_A][4];
#pragma unroll
          for (int m = 0; m < MT_A; ++m) ldmatrix_x4(a[m], arow[m] + toff + ks * 16);
          const uint2* wk = s_wa + ((t * C::KA + ks) * C::NA + ng * NTA) * 32 + lane;
#pragma unroll
          for (int n = 0; n < NTA; ++n) {
            const uint2 bfrag = wk[n * 32];
#pragma unroll
            for (int m = 0; m < MT_A; ++m) mma_bf16(acc[m][n], a[m], bfrag);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT_A; ++m)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pix = (mg * MT_A + m) * 16 + g + 8 * r;
          if (pix >= NMID) continue;
          const int gy = cy0 - 1 + pix / MW;
          const int gx = cx0 - 1 + pix % MW;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int n = 0; n < NTA; ++n) {
            const int ch = (rank * C::NA + ng * NTA + n) * 8 + 2 * c;
            const unsigned v = inside ? pack_bf16(fmaxf(acc[m][n][2 * r] + ba[ch], 0.f),
                                                  fmaxf(acc[m][n][2 * r + 1] + ba[ch + 1], 0.f))
                                      : 0u;
            *reinterpret_cast<unsigned*>(s_mid + pix * CMID_P + ch) = v;
          }
        }
    }
    if constexpr (CL > 1) {
      cluster_arrive();  // every block's channels of s_mid are written
      cluster_wait();
    } else {
      __syncthreads();
    }

    // 2. s_in is free: the next tile's window flies in while conv_b runs
    const bool has_next = tile + clusters < n_tiles;
    if constexpr (CIN > 1) {
      if (has_next) {
        int nb, npy, npx;
        tile_origin(tile + clusters, nb, npy, npx);
        copy_window<CIN>(s_in, x + size_t(nb) * H * W * CIN, 2 * npy, 2 * npx, H, W);
      }
    }
    cp_async_commit();
    // the peers' channels of s_mid, 16 bytes at a time: all of a thread's
    // loads in flight before its stores; each block starts at another peer
    if constexpr (CL > 1) {
      constexpr int CHUNKS = CMID / CL / 8;
      constexpr int TOTAL = (CL - 1) * NMID * CHUNKS;
      constexpr int ITERS = (TOTAL + THREADS - 1) / THREADS;
      uint4 v[ITERS];
#pragma unroll
      for (int k = 0; k < ITERS; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (i < TOTAL) {
          const int peer = (rank + 1 + i / (NMID * CHUNKS)) % CL;
          const int j = i % (NMID * CHUNKS);
          v[k] = ld_peer16(s_mid + (j / CHUNKS) * CMID_P + (peer * CHUNKS + j % CHUNKS) * 8, peer);
        }
      }
#pragma unroll
      for (int k = 0; k < ITERS; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (i < TOTAL) {
          const int peer = (rank + 1 + i / (NMID * CHUNKS)) % CL;
          const int j = i % (NMID * CHUNKS);
          *reinterpret_cast<uint4*>(s_mid + (j / CHUNKS) * CMID_P + (peer * CHUNKS + j % CHUNKS) * 8) = v[k];
        }
      }
    }
    if constexpr (!STREAM) {
      if (first) cp_async_wait<1>();  // conv_b's weights (the next window may still fly)
    }
    __syncthreads();
    if constexpr (CL > 1) cluster_arrive();  // done reading the peers' s_mid

    // 3. conv_b + bias + ReLU, rounded to bf16, and the 2x2 max-pool in
    //    registers. Warp: conv_b rows 2i, 2i + 1 (pooled row i) x columns
    //    [h, h + 1) * NTB of the block's
    {
      const int i = warp % 4;
      const int h = warp / 4;
      const bf16* arow[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) arow[m] = s_mid + ((2 * i + m) * MW + lane % 16) * CMID_P + (lane / 16) * 8;
      float acc[2][NTB][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NTB; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const uint2* wt = s_wb;
        if constexpr (STREAM) {
          // tap q + t has landed (behind it fly the taps issued later, and
          // the window when it came from the last tile); every warp is done
          // with tap q + t - 1, so its slot takes tap q + t + RING - 1
          if (t <= RING - 2)
            cp_async_wait<RING - 1>();
          else
            cp_async_wait<RING - 2>();
          __syncthreads();
          if (t + RING - 1 < 9 || has_next) copy_wb((t + RING - 1) % 9, 1, (q + t + RING - 1) % RING);
          cp_async_commit();
          wt += size_t((q + t) % RING) * C::TAP_WORDS;
        } else {
          wt += size_t(t) * C::TAP_WORDS;
        }
        const int toff = ((t / 3) * MW + t % 3) * CMID_P;
#pragma unroll
        for (int ks = 0; ks < C::KB; ++ks) {
          unsigned a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) ldmatrix_x4(a[m], arow[m] + toff + ks * 16);
          const uint2* wk = wt + (ks * C::NB + h * NTB) * 32 + lane;
#pragma unroll
          for (int n = 0; n < NTB; ++n) {
            const uint2 bfrag = wk[n * 32];
#pragma unroll
            for (int m = 0; m < 2; ++m) mma_bf16(acc[m][n], a[m], bfrag);
          }
        }
      }
      // lane (g, c) holds conv_b columns g and g + 8 of both rows; columns g
      // and g ^ 1 meet in lanes 4 apart. Even g stores pooled column g / 2,
      // odd g pooled column 4 + g / 2.
      const int oy = py0 + i;
      const int ox = px0 + 4 * (g & 1) + g / 2;
      const bool store = oy < Ho && ox < Wo;
      bf16* o = out + ((size_t(b) * Ho + oy) * Wo + ox) * COUT;
#pragma unroll
      for (int n = 0; n < NTB; ++n) {
        const int ch = (rank * C::NB + h * NTB + n) * 8 + 2 * c;
        __nv_bfloat162 pooled[2];  // conv_b columns g and g + 8, pooled with g ^ 1 and (g ^ 1) + 8
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const unsigned top =
              pack_bf16(fmaxf(acc[0][n][2 * r] + bb[ch], 0.f), fmaxf(acc[0][n][2 * r + 1] + bb[ch + 1], 0.f));
          const unsigned bot =
              pack_bf16(fmaxf(acc[1][n][2 * r] + bb[ch], 0.f), fmaxf(acc[1][n][2 * r + 1] + bb[ch + 1], 0.f));
          const __nv_bfloat162 col = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&top),
                                             *reinterpret_cast<const __nv_bfloat162*>(&bot));
          const unsigned mine = *reinterpret_cast<const unsigned*>(&col);
          const unsigned other = __shfl_xor_sync(0xffffffffu, mine, 4);
          pooled[r] = __hmax2(col, *reinterpret_cast<const __nv_bfloat162*>(&other));
        }
        if (store) *reinterpret_cast<__nv_bfloat162*>(o + ch) = (g & 1) ? pooled[1] : pooled[0];
      }
    }
  }
  if constexpr (CL > 1) {
    if (int(blockIdx.x) / CL < n_tiles) cluster_wait();  // no block leaves while a peer reads its s_mid
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// The launch of `blocks` blocks of a bf16 stage kernel in clusters of CL
// along x (`attr` holds the cluster's shape).
template <int CIN, int CMID, int COUT>
cudaLaunchConfig_t launch_config(int blocks, cudaStream_t stream, cudaLaunchAttribute* attr) {
  using C = MmaCfg<CIN, CMID, COUT>;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C::CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = C::CL > 1 ? 1 : 0;
  return cfg;
}

// The clusters of a bf16 stage that the current device holds at once, with
// the kernel's shared-memory attribute set; both once per device.
template <int CIN, int CMID, int COUT>
cudaError_t resident_clusters(int* clusters) {
  using C = MmaCfg<CIN, CMID, COUT>;
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((*clusters = cached[dev & 63].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  auto kern = stage_mma_kernel<CIN, CMID, COUT>;
  if ((err = set_smem(kern, C::bytes)) != cudaSuccess) return err;
  if constexpr (C::CL == 1) {
    int per_sm = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, C::bytes)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    *clusters = per_sm * sms;
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config<CIN, CMID, COUT>(C::CL, nullptr, &attr);
    if ((err = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg)) != cudaSuccess) return err;
  }
  if (*clusters < 1) return cudaErrorInvalidConfiguration;
  cached[dev & 63].store(*clusters, std::memory_order_relaxed);
  return cudaSuccess;
}

struct Grid {
  int tiles_x, tiles_y, tiles, blocks;
};

template <int CIN, int CMID, int COUT>
cudaError_t bf16_grid(int B, int H, int W, Grid* grid) {
  int clusters = 0;
  const cudaError_t err = resident_clusters<CIN, CMID, COUT>(&clusters);
  if (err != cudaSuccess) return err;
  grid->tiles_x = (W / 2 + PW - 1) / PW;
  grid->tiles_y = (H / 2 + PH - 1) / PH;
  grid->tiles = B * grid->tiles_x * grid->tiles_y;
  grid->blocks = (grid->tiles < clusters ? grid->tiles : clusters) * cluster_size(CMID);
  return cudaSuccess;
}

template <int CIN, int CMID, int COUT>
int launch_bf16(const void* x, const void* wa, const float* ba, const void* wb, const float* bb, void* out, int B,
                int H, int W, cudaStream_t stream) {
  Grid grid;
  if (const cudaError_t err = bf16_grid<CIN, CMID, COUT>(B, H, W, &grid)) return int(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<CIN, CMID, COUT>(grid.blocks, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, stage_mma_kernel<CIN, CMID, COUT>, static_cast<const bf16*>(x), wa,
                                             ba, static_cast<const uint2*>(wb), bb, static_cast<bf16*>(out), H, W,
                                             grid.tiles_x, grid.tiles_y, grid.tiles);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

template <int CIN, int CMID, int COUT>
int launch_f32(const void* x, const void* wa, const float* ba, const void* wb, const float* bb, void* out, int B,
               int H, int W, cudaStream_t stream) {
  const dim3 grid((W / 2 + PW - 1) / PW, (H / 2 + PH - 1) / PH, B);
  constexpr size_t smem = fma_smem_bytes<CIN, CMID>();
  auto kern = stage_fma_kernel<CIN, CMID, COUT>;
  if (const cudaError_t e = set_smem(kern, smem)) return int(e);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(x), static_cast<const float*>(wa), ba,
                                        static_cast<const float*>(wb), bb, static_cast<float*>(out), H, W);
  return int(cudaGetLastError());
}

// What the bf16 kernel of a stage takes on this device at B x H x W: blocks
// launched, cluster size, tiles, resident blocks per SM, registers per
// thread, shared memory per block, local memory per thread (spills).
template <int CIN, int CMID, int COUT>
int info_bf16(int B, int H, int W, int* info) {
  using C = MmaCfg<CIN, CMID, COUT>;
  Grid grid;
  cudaError_t err = bf16_grid<CIN, CMID, COUT>(B, H, W, &grid);
  if (err != cudaSuccess) return int(err);
  int per_sm = 0;
  auto kern = stage_mma_kernel<CIN, CMID, COUT>;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, C::bytes)) != cudaSuccess)
    return int(err);
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kern))) != cudaSuccess) return int(err);
  const int v[7] = {grid.blocks, C::CL, grid.tiles, per_sm, a.numRegs, int(a.sharedSizeBytes + C::bytes),
                    int(a.localSizeBytes)};
  for (int k = 0; k < 7; ++k) info[k] = v[k];
  return 0;
}

}  // namespace

// The (cin, cmid, cout) the kernels are instantiated for: stages 1, 2, 3.
#define URMVO_STAGE_DISPATCH(F, ...)                                                 \
  if (cin == 1 && cmid == 64 && cout == 64) return F<1, 64, 64>(__VA_ARGS__);       \
  if (cin == 64 && cmid == 64 && cout == 64) return F<64, 64, 64>(__VA_ARGS__);     \
  if (cin == 64 && cmid == 128 && cout == 128) return F<64, 128, 128>(__VA_ARGS__); \
  return -1

// x (B, H, W, cin) -> out (B, H/2, W/2, cout), dtype urmvo::DType.
// float32: wa/wb are float [tap][ci][co]. bf16: wb, and wa when cin > 1, are
// the mma-fragment packing ([tap][ci/16][co/8][lane] x 2 bf16x2 registers),
// 16-byte aligned as x is; wa for cin == 1 is float [tap][co]. Biases are
// float. Returns a cudaError_t, or -1 for a configuration it does not take,
// -2 for a bad shape.
extern "C" int urmvo_stage_conv(int dtype, int cin, int cmid, int cout, const void* x, const void* wa,
                                const float* ba, const void* wb, const float* bb, void* out, int B, int H, int W,
                                void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 != 0 || W % 2 != 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == urmvo::DT_BF16) {
    URMVO_STAGE_DISPATCH(launch_bf16, x, wa, ba, wb, bb, out, B, H, W, s);
  }
  if (dtype == urmvo::DT_F32) {
    URMVO_STAGE_DISPATCH(launch_f32, x, wa, ba, wb, bb, out, B, H, W, s);
  }
  return -1;
}

// The bf16 kernel of a stage at B x H x W on the current device, info[7]: see
// info_bf16. Returns a cudaError_t, or -1 / -2 as above.
extern "C" int urmvo_stage_conv_info(int cin, int cmid, int cout, int B, int H, int W, int* info) {
  if (B < 1 || H < 2 || W < 2 || H % 2 != 0 || W % 2 != 0) return -2;
  URMVO_STAGE_DISPATCH(info_bf16, B, H, W, info);
}
#undef URMVO_STAGE_DISPATCH
