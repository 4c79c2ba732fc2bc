// Python bindings of the port's CUDA kernels.
//
// torch.utils.cpp_extension.load compiles this file together with
// stage_conv.cu, attention.cu, sinkhorn.cu, pose_gn.cu and point_reduce.cu into
// one extension
// (ur_mvo_tpu_torch/ops/cuda_ext.py). It is the only source that includes
// PyTorch's headers: the .cu files export plain C launchers, so nvcc compiles
// them without those headers. Each binding checks device, dtype, size and
// contiguity, allocates the outputs on the input's device, launches on
// PyTorch's current stream and raises if the launcher refused the
// configuration or the launch failed. The Python wrappers (ops/cuda_conv.py,
// ops/cuda_kernels.py, ops/cuda_pose.py, ops/cuda_ba.py) own the layouts and
// count the launches.

#include <torch/extension.h>

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <map>
#include <string>

extern "C" int urmvo_stage_conv(int dtype, int cin, int cmid, int cout, const void* x, const void* wa,
                                const float* ba, const void* wb, const float* bb, void* out, int B, int H, int W,
                                void* stream);
extern "C" int urmvo_stage_conv_info(int cin, int cmid, int cout, int B, int H, int W, int* info);
extern "C" int urmvo_attention(int dtype, const void* q, const void* k, const void* v, const uint8_t* valid,
                               void* out, int B, int Kq, int Kkv, int H, int head_dim, float scale, int split,
                               void* stream);
extern "C" int urmvo_attention_occupancy(int Kkv, int split, int* blocks_per_sm, int* regs, int* smem,
                                         int* local_bytes);
extern "C" int urmvo_sinkhorn(const float* C, const float* log_mu, const float* log_nu, float* work, float* out,
                              int M, int N, int iters, int stale_u, void* stream);
extern "C" int urmvo_sinkhorn_info(int M, int N, int* info);
extern "C" int urmvo_sinkhorn_barriers(int M, int N, int iters, void* stream);

extern "C" int urmvo_pose_gn(const float* X, const float* uv, const uint8_t* valid, const float* R0,
                             const float* t0, float* pose_out, uint8_t* inliers, int B, int N, float fx, float fy,
                             float cx, float cy, float bf, float chi2_mono, float chi2_stereo, int rounds, int iters,
                             float damping, void* stream);
extern "C" int urmvo_pose_gn_chain(float* out, int B, int steps, void* stream);
extern "C" int urmvo_point_reduce_sorted(const float* A, const float* Vp, const int* slot, const int* seg_start,
                                         float* out, int P, int FF, void* stream);
extern "C" int urmvo_point_reduce(const float* A, const float* Vp, const int* pt, const int* slot, float* out,
                                  int O, int P, int FF, void* stream);

namespace {

// urmvo::DType of csrc/common.cuh
int dtype_code(const at::Tensor& t, const char* what) {
  const at::ScalarType s = t.scalar_type();
  TORCH_CHECK(s == at::kFloat || s == at::kBFloat16, what, ": dtype ", s, " not supported (float32 or bfloat16)");
  return s == at::kBFloat16 ? 1 : 0;
}

void expect(const at::Tensor& t, const at::Tensor& like, at::ScalarType dtype, int64_t numel, const char* what) {
  TORCH_CHECK(t.device() == like.device(), what, " is on ", t.device(), ", expected ", like.device());
  TORCH_CHECK(t.scalar_type() == dtype, what, " has dtype ", t.scalar_type(), ", expected ", dtype);
  TORCH_CHECK(t.numel() == numel, what, " has ", t.numel(), " elements, expected ", numel);
  TORCH_CHECK(t.is_contiguous(), what, " must be contiguous");
}

// A launcher returns a cudaError_t, or a negative code for a configuration it
// does not take. A refused launch never runs, and a later synchronize would
// not report it.
void check_launch(int err, const char* what) {
  TORCH_CHECK(err >= 0, what, ": the kernel does not take this configuration (code ", err, ")");
  TORCH_CHECK(err == 0, what, ": CUDA launch failed: ", cudaGetErrorString(static_cast<cudaError_t>(err)));
}

void* stream_of(const at::Tensor& t) { return c10::cuda::getCurrentCUDAStream(t.device().index()).stream(); }

// x (B, H, W, cin) NHWC -> (B, H/2, W/2, cout). Weights in the kernel's
// packing (ops/cuda_conv.pack_stage): bfloat16 activations take wb, and wa
// when cin > 1, as int32 mma fragments of 9 * ci * co / 2 words, wa for
// cin == 1 as float [tap][co]; float32 activations take float [tap][ci][co].
// Biases are float32.
at::Tensor stage_conv(const at::Tensor& x, const at::Tensor& wa, const at::Tensor& ba, const at::Tensor& wb,
                      const at::Tensor& bb) {
  TORCH_CHECK(x.is_cuda() && x.dim() == 4 && x.is_contiguous(), "stage_conv: x must be a contiguous 4-D CUDA tensor");
  const int dt = dtype_code(x, "stage_conv");
  const int64_t B = x.size(0), H = x.size(1), W = x.size(2), cin = x.size(3);
  const int64_t cmid = ba.numel(), cout = bb.numel();
  const bool mma = dt == 1;
  expect(ba, x, at::kFloat, cmid, "stage_conv: ba");
  expect(bb, x, at::kFloat, cout, "stage_conv: bb");
  if (mma && cin > 1)
    expect(wa, x, at::kInt, 9 * cin * cmid / 2, "stage_conv: wa");
  else
    expect(wa, x, at::kFloat, 9 * cin * cmid, "stage_conv: wa");
  if (mma)
    expect(wb, x, at::kInt, 9 * cmid * cout / 2, "stage_conv: wb");
  else
    expect(wb, x, at::kFloat, 9 * cmid * cout, "stage_conv: wb");
  if (mma)
    for (const at::Tensor* t : {&x, &wa, &wb})
      TORCH_CHECK((cin == 1 && t == &x) || reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                  "stage_conv: x (cin > 1) and the packed weights must be 16-byte aligned");
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({B, H / 2, W / 2, cout}, x.options());
  check_launch(urmvo_stage_conv(dt, int(cin), int(cmid), int(cout), x.data_ptr(), wa.data_ptr(),
                                ba.data_ptr<float>(), wb.data_ptr(), bb.data_ptr<float>(), out.data_ptr(), int(B),
                                int(H), int(W), stream_of(x)),
               "stage_conv");
  return out;
}

// q (B, Kq, H, d), k / v (B, Kkv, H, d), kv_valid (B, Kkv) bool or uint8 (one
// byte a key either way, nonzero valid) -> (B, Kq, H, d). `split`: the bf16
// key-group kernel.
at::Tensor attention(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v, const at::Tensor& kv_valid,
                     double scale, bool split) {
  TORCH_CHECK(q.is_cuda() && q.dim() == 4 && q.is_contiguous(), "attention: q must be a contiguous 4-D CUDA tensor");
  const int dt = dtype_code(q, "attention");
  TORCH_CHECK(!split || q.scalar_type() == at::kBFloat16, "attention: the key-group kernel takes bf16");
  const int64_t B = q.size(0), Kq = q.size(1), H = q.size(2), d = q.size(3);
  TORCH_CHECK(k.dim() == 4 && k.size(0) == B && k.size(2) == H && k.size(3) == d, "attention: k has shape ",
              k.sizes(), " for q ", q.sizes());
  const int64_t Kkv = k.size(1);
  expect(k, q, q.scalar_type(), B * Kkv * H * d, "attention: k");
  expect(v, q, q.scalar_type(), B * Kkv * H * d, "attention: v");
  TORCH_CHECK(v.sizes() == k.sizes(), "attention: v has shape ", v.sizes(), ", k ", k.sizes());
  expect(kv_valid, q, kv_valid.scalar_type() == at::kBool ? at::kBool : at::kByte, B * Kkv, "attention: kv_valid");
  for (const at::Tensor* t : {&q, &k, &v})
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0, "attention: q, k and v must be 16-byte aligned");
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor out = at::empty_like(q);
  check_launch(urmvo_attention(dt, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               static_cast<const uint8_t*>(kv_valid.data_ptr()), out.data_ptr(), int(B), int(Kq),
                               int(Kkv), int(H), int(d), float(scale), int(split), stream_of(q)),
               "attention");
  return out;
}

// The bf16 stage kernel's launch and footprint for (B, H, W, cin) inputs on
// the current device.
std::map<std::string, int64_t> stage_conv_info(int64_t cin, int64_t cmid, int64_t cout, int64_t B, int64_t H,
                                               int64_t W) {
  int v[7] = {0};
  check_launch(urmvo_stage_conv_info(int(cin), int(cmid), int(cout), int(B), int(H), int(W), v), "stage_conv_info");
  return {{"blocks", v[0]},         {"cluster", v[1]},         {"tiles", v[2]},
          {"blocks_per_sm", v[3]},  {"regs_per_thread", v[4]}, {"smem_per_block", v[5]},
          {"local_bytes_per_thread", v[6]}};
}

// A bf16 attention kernel's footprint for Kkv keys on the current device.
std::map<std::string, int64_t> attention_occupancy(int64_t Kkv, bool split) {
  int blocks = 0, regs = 0, smem = 0, local = 0;
  check_launch(urmvo_attention_occupancy(int(Kkv), int(split), &blocks, &regs, &smem, &local),
               "attention_occupancy");
  return {{"blocks_per_sm", blocks}, {"regs_per_thread", regs}, {"smem_per_block", smem},
          {"local_bytes_per_thread", local}};
}

// C (M, N), log_mu (M), log_nu (N), all float32 -> C + u + v after `iters`
// row/column sweeps from u = v = 0, in one cooperative launch. The one
// allocation holds `out` and, past its end, the M + N floats through which
// the kernel's blocks exchange u and v. `stale_u` (a control for the checks
// on the card) makes each column sweep use the previous iteration's u.
at::Tensor sinkhorn(const at::Tensor& C, const at::Tensor& log_mu, const at::Tensor& log_nu, int64_t iters,
                    bool stale_u) {
  TORCH_CHECK(C.is_cuda() && C.dim() == 2, "sinkhorn: C must be a 2-D CUDA tensor");
  const int64_t M = C.size(0), N = C.size(1);
  expect(C, C, at::kFloat, M * N, "sinkhorn: C");
  expect(log_mu, C, at::kFloat, M, "sinkhorn: log_mu");
  expect(log_nu, C, at::kFloat, N, "sinkhorn: log_nu");
  const c10::cuda::CUDAGuard guard(C.device());
  at::Tensor buf = at::empty({M * N + M + N}, C.options());
  float* work = buf.data_ptr<float>() + M * N;
  check_launch(urmvo_sinkhorn(C.data_ptr<float>(), log_mu.data_ptr<float>(), log_nu.data_ptr<float>(), work,
                              buf.data_ptr<float>(), int(M), int(N), int(iters), int(stale_u), stream_of(C)),
               "sinkhorn");
  return buf.narrow(0, 0, M * N).view({M, N});
}

// The Sinkhorn kernel's launch for (M, N) on the current device.
std::map<std::string, int64_t> sinkhorn_info(int64_t M, int64_t N) {
  int v[9] = {0};
  check_launch(urmvo_sinkhorn_info(int(M), int(N), v), "sinkhorn_info");
  return {{"blocks", v[0]},          {"blocks_per_sm", v[1]},  {"threads", v[2]},
          {"regs_per_thread", v[3]}, {"smem_per_block", v[4]}, {"local_bytes_per_thread", v[5]},
          {"rows_per_block", v[6]},  {"cols_per_block", v[7]}, {"cols_resident", v[8]}};
}

// 2 x iters grid barriers in an empty kernel of (M, N)'s Sinkhorn launch on
// `like`'s device: the yardstick of the sweeps.
void sinkhorn_barriers(const at::Tensor& like, int64_t M, int64_t N, int64_t iters) {
  TORCH_CHECK(like.is_cuda(), "sinkhorn_barriers: needs a CUDA tensor for its device");
  const c10::cuda::CUDAGuard guard(like.device());
  check_launch(urmvo_sinkhorn_barriers(int(M), int(N), int(iters), stream_of(like)), "sinkhorn_barriers");
}

// X, uv (B, N, 3) float32, valid (B, N) uint8, R0 (B, 3, 3), t0 (B, 3) ->
// {pose (B, 12) float32: R row-major then t; inliers (B, N) uint8}.
std::vector<at::Tensor> pose_gn(const at::Tensor& X, const at::Tensor& uv, const at::Tensor& valid,
                                const at::Tensor& R0, const at::Tensor& t0, double fx, double fy, double cx,
                                double cy, double bf, double chi2_mono, double chi2_stereo, int64_t rounds,
                                int64_t iters, double damping) {
  TORCH_CHECK(X.is_cuda() && X.dim() == 3 && X.size(2) == 3, "pose_gn: X must be a (B, N, 3) CUDA tensor");
  const int64_t B = X.size(0), N = X.size(1);
  expect(X, X, at::kFloat, B * N * 3, "pose_gn: X");
  expect(uv, X, at::kFloat, B * N * 3, "pose_gn: uv");
  expect(valid, X, at::kByte, B * N, "pose_gn: valid");
  expect(R0, X, at::kFloat, B * 9, "pose_gn: R0");
  expect(t0, X, at::kFloat, B * 3, "pose_gn: t0");
  const c10::cuda::CUDAGuard guard(X.device());
  at::Tensor pose = at::empty({B, 12}, X.options());
  at::Tensor inliers = at::empty({B, N}, valid.options());
  check_launch(urmvo_pose_gn(X.data_ptr<float>(), uv.data_ptr<float>(), valid.data_ptr<uint8_t>(),
                             R0.data_ptr<float>(), t0.data_ptr<float>(), pose.data_ptr<float>(),
                             inliers.data_ptr<uint8_t>(), int(B), int(N), float(fx), float(fy), float(cx), float(cy),
                             float(bf), float(chi2_mono), float(chi2_stereo), int(rounds), int(iters),
                             float(damping), stream_of(X)),
               "pose_gn");
  return {pose, inliers};
}

// `steps` dependent block-wide reduce-and-broadcast pairs of pose_gn's width in
// an otherwise empty kernel, B blocks: the yardstick of pose_gn's chain.
at::Tensor pose_gn_chain(const at::Tensor& like, int64_t B, int64_t steps) {
  TORCH_CHECK(like.is_cuda(), "pose_gn_chain: needs a CUDA tensor for its device");
  const c10::cuda::CUDAGuard guard(like.device());
  at::Tensor out = at::empty({B}, like.options().dtype(at::kFloat));
  check_launch(urmvo_pose_gn_chain(out.data_ptr<float>(), int(B), int(steps), stream_of(like)), "pose_gn_chain");
  return out;
}

// A (O, 18), Vp (O, 12) float32 point-sorted, slot (O,) int32, seg_start
// (P + 1,) int32 -> (P, FF*18 + 12) float32 point-side segment sums.
at::Tensor point_reduce_sorted(const at::Tensor& A, const at::Tensor& Vp, const at::Tensor& slot,
                               const at::Tensor& seg_start, int64_t FF) {
  TORCH_CHECK(A.is_cuda() && A.dim() == 2 && A.size(1) == 18, "point_reduce_sorted: A must be an (O, 18) CUDA tensor");
  const int64_t O = A.size(0), P = seg_start.numel() - 1;
  TORCH_CHECK(P >= 1 && FF >= 1 && O < (int64_t(1) << 31), "point_reduce_sorted: P ", P, ", FF ", FF, ", O ", O);
  expect(A, A, at::kFloat, O * 18, "point_reduce_sorted: A");
  expect(Vp, A, at::kFloat, O * 12, "point_reduce_sorted: Vp");
  expect(slot, A, at::kInt, O, "point_reduce_sorted: slot");
  expect(seg_start, A, at::kInt, P + 1, "point_reduce_sorted: seg_start");
  const c10::cuda::CUDAGuard guard(A.device());
  at::Tensor out = at::empty({P, FF * 18 + 12}, A.options());
  check_launch(urmvo_point_reduce_sorted(A.data_ptr<float>(), Vp.data_ptr<float>(), slot.data_ptr<int>(),
                                         seg_start.data_ptr<int>(), out.data_ptr<float>(), int(P), int(FF),
                                         stream_of(A)),
               "point_reduce_sorted");
  return out;
}

// A (O, 18), Vp (O, 12) float32, pt / slot (O,) int32 -> (P, FF*18 + 12)
// float32 point-side segment sums, by atomics.
at::Tensor point_reduce(const at::Tensor& A, const at::Tensor& Vp, const at::Tensor& pt, const at::Tensor& slot,
                        int64_t P, int64_t FF) {
  TORCH_CHECK(A.is_cuda() && A.dim() == 2 && A.size(1) == 18, "point_reduce: A must be an (O, 18) CUDA tensor");
  const int64_t O = A.size(0);
  TORCH_CHECK(P >= 1 && FF >= 1 && O < (int64_t(1) << 31), "point_reduce: P ", P, ", FF ", FF, ", O ", O);
  expect(A, A, at::kFloat, O * 18, "point_reduce: A");
  expect(Vp, A, at::kFloat, O * 12, "point_reduce: Vp");
  expect(pt, A, at::kInt, O, "point_reduce: pt");
  expect(slot, A, at::kInt, O, "point_reduce: slot");
  const c10::cuda::CUDAGuard guard(A.device());
  at::Tensor out = at::empty({P, FF * 18 + 12}, A.options());
  check_launch(urmvo_point_reduce(A.data_ptr<float>(), Vp.data_ptr<float>(), pt.data_ptr<int>(), slot.data_ptr<int>(),
                                  out.data_ptr<float>(), int(O), int(P), int(FF), stream_of(A)),
               "point_reduce");
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("stage_conv", &stage_conv, "Fused SuperPoint encoder stage (csrc/stage_conv.cu)");
  m.def("stage_conv_info", &stage_conv_info,
        "The bf16 stage kernel's blocks, cluster, tiles, blocks per SM, registers, shared and local memory");
  m.def("attention", &attention, "Masked multi-head attention core (csrc/attention.cu)");
  m.def("attention_occupancy", &attention_occupancy,
        "Blocks per SM, registers, shared and local memory of a bf16 attention kernel");
  m.def("sinkhorn", &sinkhorn, "Log-domain Sinkhorn sweeps in one cooperative launch (csrc/sinkhorn.cu)",
        py::arg("C"), py::arg("log_mu"), py::arg("log_nu"), py::arg("iters"), py::arg("stale_u") = false);
  m.def("sinkhorn_info", &sinkhorn_info,
        "The Sinkhorn kernel's blocks, blocks per SM, threads, registers, shared and local memory, bands and route");
  m.def("sinkhorn_barriers", &sinkhorn_barriers, "2 x iters grid barriers of the Sinkhorn launch (csrc/sinkhorn.cu)");
  m.def("pose_gn", &pose_gn, "Pose-only robust Gauss-Newton schedule (csrc/pose_gn.cu)");
  m.def("pose_gn_chain", &pose_gn_chain, "Dependent reduce-and-broadcast chain of pose_gn's width (csrc/pose_gn.cu)");
  m.def("point_reduce_sorted", &point_reduce_sorted, "BA point-side segment sums over point-sorted rows (csrc/point_reduce.cu)");
  m.def("point_reduce", &point_reduce, "BA point-side segment sums by atomics (csrc/point_reduce.cu)");
}
