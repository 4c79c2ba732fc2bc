// Python bindings of the port's CUDA kernels.
//
// torch.utils.cpp_extension.load compiles this file together with
// stage_conv.cu, attention.cu and sinkhorn.cu into one extension
// (ur_mvo_tpu_torch/ops/cuda_ext.py). It is the only source that includes
// PyTorch's headers: the .cu files export plain C launchers, so nvcc compiles
// them without those headers. Each binding checks device, dtype, size and
// contiguity, allocates the outputs on the input's device, launches on
// PyTorch's current stream and raises if the launcher refused the
// configuration or the launch failed. The Python wrappers (ops/cuda_conv.py,
// ops/cuda_kernels.py) own the layouts and count the launches.

#include <torch/extension.h>

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int urmvo_stage_conv(int dtype, int cin, int cmid, int cout, const void* x, const void* wa,
                                const float* ba, const void* wb, const float* bb, void* out, int B, int H, int W,
                                void* stream);
extern "C" int urmvo_attention(int dtype, const void* q, const void* k, const void* v, const uint8_t* valid,
                               void* out, int B, int Kq, int Kkv, int H, int head_dim, float scale, void* stream);
extern "C" int urmvo_sinkhorn(const float* C, const float* log_mu, const float* log_nu, float* u, float* v,
                              float* out, int M, int N, int iters, void* stream);

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
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({B, H / 2, W / 2, cout}, x.options());
  check_launch(urmvo_stage_conv(dt, int(cin), int(cmid), int(cout), x.data_ptr(), wa.data_ptr(),
                                ba.data_ptr<float>(), wb.data_ptr(), bb.data_ptr<float>(), out.data_ptr(), int(B),
                                int(H), int(W), stream_of(x)),
               "stage_conv");
  return out;
}

// q (B, Kq, H, d), k / v (B, Kkv, H, d), kv_valid (B, Kkv) uint8 -> (B, Kq, H, d).
at::Tensor attention(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v, const at::Tensor& kv_valid,
                     double scale) {
  TORCH_CHECK(q.is_cuda() && q.dim() == 4 && q.is_contiguous(), "attention: q must be a contiguous 4-D CUDA tensor");
  const int dt = dtype_code(q, "attention");
  const int64_t B = q.size(0), Kq = q.size(1), H = q.size(2), d = q.size(3);
  TORCH_CHECK(k.dim() == 4 && k.size(0) == B && k.size(2) == H && k.size(3) == d, "attention: k has shape ",
              k.sizes(), " for q ", q.sizes());
  const int64_t Kkv = k.size(1);
  expect(k, q, q.scalar_type(), B * Kkv * H * d, "attention: k");
  expect(v, q, q.scalar_type(), B * Kkv * H * d, "attention: v");
  TORCH_CHECK(v.sizes() == k.sizes(), "attention: v has shape ", v.sizes(), ", k ", k.sizes());
  expect(kv_valid, q, at::kByte, B * Kkv, "attention: kv_valid");
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor out = at::empty_like(q);
  check_launch(urmvo_attention(dt, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr<uint8_t>(),
                               out.data_ptr(), int(B), int(Kq), int(Kkv), int(H), int(d), float(scale), stream_of(q)),
               "attention");
  return out;
}

// C (M, N), log_mu (M), log_nu (N), all float32 -> C + u + v after `iters`
// row/column sweeps from u = v = 0.
at::Tensor sinkhorn(const at::Tensor& C, const at::Tensor& log_mu, const at::Tensor& log_nu, int64_t iters) {
  TORCH_CHECK(C.is_cuda() && C.dim() == 2, "sinkhorn: C must be a 2-D CUDA tensor");
  const int64_t M = C.size(0), N = C.size(1);
  expect(C, C, at::kFloat, M * N, "sinkhorn: C");
  expect(log_mu, C, at::kFloat, M, "sinkhorn: log_mu");
  expect(log_nu, C, at::kFloat, N, "sinkhorn: log_nu");
  const c10::cuda::CUDAGuard guard(C.device());
  at::Tensor u = at::zeros({M}, C.options());
  at::Tensor v = at::zeros({N}, C.options());
  at::Tensor out = at::empty_like(C);
  check_launch(urmvo_sinkhorn(C.data_ptr<float>(), log_mu.data_ptr<float>(), log_nu.data_ptr<float>(),
                              u.data_ptr<float>(), v.data_ptr<float>(), out.data_ptr<float>(), int(M), int(N),
                              int(iters), stream_of(C)),
               "sinkhorn");
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("stage_conv", &stage_conv, "Fused SuperPoint encoder stage (csrc/stage_conv.cu)");
  m.def("attention", &attention, "Masked multi-head attention core (csrc/attention.cu)");
  m.def("sinkhorn", &sinkhorn, "Log-domain Sinkhorn sweeps (csrc/sinkhorn.cu)");
}
