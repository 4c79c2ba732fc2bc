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
// Design. One block computes a 4 x 8 tile of pooled outputs (an 8 x 16 tile of
// conv_b outputs) for all output channels. It stages the 12 x 20 input window
// in shared memory with SAME zero padding, computes conv_a over the 10 x 18
// halo region into shared memory, rounded to the activation type as the TPU
// kernel does (pallas_conv.py:127/:151), and writes LITERAL zeros for halo
// pixels outside the image: conv_b's SAME padding is zeros, not conv_a of
// padded pixels, which bias + ReLU make nonzero (pallas_conv.py:128-133,
// :152-155). conv_b, ReLU and the pool then run from shared memory; only the
// pooled tile goes to device memory, so the full-resolution conv_a activation
// never does. Tiles need not divide the image: partial tiles at 240x320
// (pooled 120x160, 60x80, 30x40) are masked.
//
// bf16 (the main path): tensor cores. Each 3x3 conv is an implicit GEMM
// (pixels x output channels, K = 9 taps x input channels) on
// mma.sync.m16n8k16 with float32 accumulation: A rows are pixels, gathered
// per tap by ldmatrix from padded shared-memory rows; B is the weight, packed
// on the host in the mma fragment order ([tap][k16][n8][lane] x 2 registers)
// and read from the L1-cached weight array. conv_a with Cin = 1 (a 9-tap
// filter) runs on the CUDA cores. The pool reads the rounded conv_b outputs
// from shared memory (rounding is monotonic, so pooling rounded values equals
// rounding the pooled one).
//
// float32: the same tiling on the CUDA cores (each thread a register tile of 4
// pixels x 8 channels; weights [tap][ci][co] through the read-only cache).
//
// Bound: at 240x320 the three stages do ~10.7 GFLOP and move ~3 MB, so they
// are bound by operations. Next steps: wgmma, TMA weight staging, more pixels
// per block for stage 3's small grid.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int PH = 4;            // pooled rows per tile
constexpr int PW = 8;            // pooled cols per tile
constexpr int BH = 2 * PH;       // conv_b rows per tile (one warp each on the mma path)
constexpr int BW = 2 * PW;       // conv_b cols per tile (one m16 tile)
constexpr int MH = BH + 2;       // conv_a halo region rows
constexpr int MW = BW + 2;       // conv_a halo region cols
constexpr int NMID = MH * MW;    // conv_a halo pixels
constexpr int IH = BH + 4;       // input window rows
constexpr int IW = BW + 4;       // input window cols
constexpr int THREADS = 256;
constexpr int CG = 8;            // output channels per thread item (CUDA-core loops)
constexpr int PXG = 4;           // conv_a pixels per thread item (CUDA-core loops)
static_assert(THREADS == 32 * BH, "one warp per conv_b row");
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

template <int CIN, int CMID, int COUT>
struct MmaSmem {
  static constexpr size_t in_bytes = round16(sizeof(bf16) * IH * IW * bpitch(CIN));
  static constexpr size_t stage_bytes = round16(sizeof(bf16) * BH * BW * (COUT + 8));
  static constexpr size_t union_bytes = in_bytes > stage_bytes ? in_bytes : stage_bytes;  // s_in, then conv_b outputs
  static constexpr size_t mid_bytes = round16(sizeof(bf16) * NMID * bpitch(CMID));
  static constexpr size_t bytes = union_bytes + mid_bytes;
};

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
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

// One warp: a 16-row block of pixels (row j of the block at `a_row(j)`, a
// bf16 pointer to its channel 0 for tap (0, 0)) times NT 8-wide output
// channel tiles starting at nt0, K = 9 taps x CI channels. Tap (dy, dx) of
// pixel row j sits at a_row(j) + (dy * row_pitch + dx) * CI_P.
template <int CI, int CO, int NT, int ROW_PITCH>
__device__ __forceinline__ void conv_mma(float (*acc)[4], const bf16* a_row, int nt0, const uint2* __restrict__ w) {
  constexpr int CI_P = bpitch(CI);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const bf16* ap = a_row + ((t / 3) * ROW_PITCH + t % 3) * CI_P + (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < CI / 16; ++ks) {
      unsigned a[4];
      ldmatrix_x4(a, ap + ks * 16);
      const uint2* wk = w + (size_t(t * (CI / 16) + ks) * (CO / 8) + nt0) * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_bf16(acc[n], a, __ldg(wk + n * 32));
    }
  }
}

template <int CIN, int CMID, int COUT>
__global__ void __launch_bounds__(THREADS)
stage_mma_kernel(const bf16* __restrict__ x, const void* __restrict__ wa, const float* __restrict__ ba,
                 const uint2* __restrict__ wb, const float* __restrict__ bb, bf16* __restrict__ out, int H, int W) {
  static_assert(CMID % 16 == 0 && COUT % 16 == 0, "channel tiles");
  static_assert(CIN == 1 || CIN % 16 == 0, "input channels");
  using S = MmaSmem<CIN, CMID, COUT>;
  constexpr int CIN_P = bpitch(CIN);
  constexpr int CMID_P = bpitch(CMID);
  constexpr int ST_P = COUT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);     // [IH*IW][CIN_P]
  bf16* s_out = reinterpret_cast<bf16*>(smem);    // [BH*BW][ST_P], after conv_a is done with s_in
  bf16* s_mid = reinterpret_cast<bf16*>(smem + S::union_bytes);  // [NMID][CMID_P]

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * PH;
  const int px0 = blockIdx.x * PW;
  const int cy0 = 2 * py0;
  const int cx0 = 2 * px0;
  const int Ho = H / 2;
  const int Wo = W / 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const bf16* xb = x + size_t(b) * H * W * CIN;

  // 1. input window, SAME zero padding
  if constexpr (CIN == 1) {
    for (int p = threadIdx.x; p < IH * IW; p += THREADS) {
      const int gy = cy0 - 2 + p / IW;
      const int gx = cx0 - 2 + p % IW;
      s_in[p] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? xb[size_t(gy) * W + gx] : __float2bfloat16_rn(0.f);
    }
  } else {
    for (int i = threadIdx.x; i < IH * IW * (CIN / 8); i += THREADS) {
      const int p = i / (CIN / 8);
      const int c8 = (i % (CIN / 8)) * 8;
      const int gy = cy0 - 2 + p / IW;
      const int gx = cx0 - 2 + p % IW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(xb + (size_t(gy) * W + gx) * CIN + c8);
      *reinterpret_cast<uint4*>(s_in + p * CIN_P + c8) = v;
    }
  }
  __syncthreads();

  // 2. conv_a + bias + ReLU over the halo region, rounded to bf16; zeros outside the image
  if constexpr (CIN == 1) {
    const float* wf = static_cast<const float*>(wa);  // [9][CMID]
    constexpr int NCG_A = CMID / CG;
    for (int item = threadIdx.x; item < (NMID / PXG) * NCG_A; item += THREADS) {
      const int co0 = (item % NCG_A) * CG;
      const int pg = item / NCG_A;
      float acc[PXG][CG];
#pragma unroll
      for (int p = 0; p < PXG; ++p)
#pragma unroll
        for (int k = 0; k < CG; ++k) acc[p][k] = ba[co0 + k];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wf + t * CMID + co0));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wf + t * CMID + co0 + 4));
        const float w[CG] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int p = 0; p < PXG; ++p) {
          const int pix = pg * PXG + p;
          const float a = __bfloat162float(s_in[(pix / MW + t / 3) * IW + pix % MW + t % 3]);
#pragma unroll
          for (int k = 0; k < CG; ++k) acc[p][k] = fmaf(a, w[k], acc[p][k]);
        }
      }
#pragma unroll
      for (int p = 0; p < PXG; ++p) {
        const int pix = pg * PXG + p;
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
    // items: 16-pixel blocks of the halo region x halves of the channels
    constexpr int NMT = (NMID + 15) / 16;
    constexpr int NT = CMID / 16;  // 8-wide tiles per half
    const uint2* wp = static_cast<const uint2*>(wa);
    for (int item = warp; item < NMT * 2; item += THREADS / 32) {
      const int mt = item / 2;
      const int half = item % 2;
      const int pix_a = min(mt * 16 + lane % 16, NMID - 1);  // ldmatrix row of this lane
      float acc[NT][4];
      conv_mma<CIN, CMID, NT, IW>(acc, s_in + ((pix_a / MW) * IW + pix_a % MW) * CIN_P, half * NT, wp);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pix = mt * 16 + g + 8 * r;
        if (pix >= NMID) continue;
        const int gy = cy0 - 1 + pix / MW;
        const int gx = cx0 - 1 + pix % MW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int ch = (half * NT + n) * 8 + 2 * c;
          const unsigned v = inside ? pack_bf16(fmaxf(acc[n][2 * r] + ba[ch], 0.f),
                                                fmaxf(acc[n][2 * r + 1] + ba[ch + 1], 0.f))
                                    : 0u;
          *reinterpret_cast<unsigned*>(s_mid + pix * CMID_P + ch) = v;
        }
      }
    }
  }
  __syncthreads();

  // 3. conv_b + bias + ReLU, one warp per conv_b row, rounded to bf16 into s_out
  {
    constexpr int NT = COUT / 8;
    const int ty = warp;
    float acc[NT][4];
    conv_mma<CMID, COUT, NT, MW>(acc, s_mid + (ty * MW + lane % 16) * CMID_P, 0, wb);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int px = g + 8 * r;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int ch = n * 8 + 2 * c;
        *reinterpret_cast<unsigned*>(s_out + (ty * BW + px) * ST_P + ch) =
            pack_bf16(fmaxf(acc[n][2 * r] + bb[ch], 0.f), fmaxf(acc[n][2 * r + 1] + bb[ch + 1], 0.f));
      }
    }
  }
  __syncthreads();

  // 4. 2x2 max-pool of the rounded outputs, two channels per item
  for (int i = threadIdx.x; i < PH * PW * (COUT / 2); i += THREADS) {
    const int ch = (i % (COUT / 2)) * 2;
    const int pos = i / (COUT / 2);
    const int ly = pos / PW;
    const int lx = pos % PW;
    const int oy = py0 + ly;
    const int ox = px0 + lx;
    if (oy >= Ho || ox >= Wo) continue;
    const bf16* q = s_out + ((2 * ly) * BW + 2 * lx) * ST_P + ch;
    const __nv_bfloat162 v = __hmax2(__hmax2(*reinterpret_cast<const __nv_bfloat162*>(q),
                                             *reinterpret_cast<const __nv_bfloat162*>(q + ST_P)),
                                     __hmax2(*reinterpret_cast<const __nv_bfloat162*>(q + BW * ST_P),
                                             *reinterpret_cast<const __nv_bfloat162*>(q + BW * ST_P + ST_P)));
    *reinterpret_cast<__nv_bfloat162*>(out + ((size_t(b) * Ho + oy) * Wo + ox) * COUT + ch) = v;
  }
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
}

template <int CIN, int CMID, int COUT>
int launch(bool bf16_path, const void* x, const void* wa, const float* ba, const void* wb, const float* bb, void* out,
           int B, int H, int W, cudaStream_t stream) {
  const dim3 grid((W / 2 + PW - 1) / PW, (H / 2 + PH - 1) / PH, B);
  if (bf16_path) {
    constexpr size_t smem = MmaSmem<CIN, CMID, COUT>::bytes;
    auto kern = stage_mma_kernel<CIN, CMID, COUT>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const bf16*>(x), wa, ba, static_cast<const uint2*>(wb), bb,
                                          static_cast<bf16*>(out), H, W);
  } else {
    constexpr size_t smem = fma_smem_bytes<CIN, CMID>();
    auto kern = stage_fma_kernel<CIN, CMID, COUT>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(x), static_cast<const float*>(wa), ba,
                                          static_cast<const float*>(wb), bb, static_cast<float*>(out), H, W);
  }
  return int(cudaGetLastError());
}

}  // namespace

// x (B, H, W, cin) -> out (B, H/2, W/2, cout), dtype urmvo::DType.
// float32: wa/wb are float [tap][ci][co]. bf16: wb, and wa when cin > 1, are
// the mma-fragment packing ([tap][ci/16][co/8][lane] x 2 bf16x2 registers);
// wa for cin == 1 is float [tap][co]. Biases are float. Returns a
// cudaError_t, or -1 for a configuration it does not take, -2 for a bad shape.
extern "C" int urmvo_stage_conv(int dtype, int cin, int cmid, int cout, const void* x, const void* wa,
                                const float* ba, const void* wb, const float* bb, void* out, int B, int H, int W,
                                void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 != 0 || W % 2 != 0) return -2;
  if (dtype != urmvo::DT_F32 && dtype != urmvo::DT_BF16) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16_path = dtype == urmvo::DT_BF16;
#define URMVO_STAGE_CASE(CI, CM, CO) \
  if (cin == CI && cmid == CM && cout == CO) return launch<CI, CM, CO>(bf16_path, x, wa, ba, wb, bb, out, B, H, W, s);
  URMVO_STAGE_CASE(1, 64, 64)
  URMVO_STAGE_CASE(64, 64, 64)
  URMVO_STAGE_CASE(64, 128, 128)
#undef URMVO_STAGE_CASE
  return -1;
}
