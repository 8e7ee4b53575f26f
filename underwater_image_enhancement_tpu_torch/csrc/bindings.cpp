// PyTorch entry points of the package's CUDA kernels (ops/kernels.py calls
// them for CUDA tensors).  Each checks its tensors, allocates the outputs,
// launches on the current stream of the inputs' device and checks the
// launch.  The only source that includes the PyTorch headers: the kernels
// in csrc/*.cu see raw pointers.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <tuple>

namespace uie {

void launch_lab_forward_unit(const float* r, const float* g, const float* b,
                             const int* tab, int* L, int* a, int* bb,
                             long long n, cudaStream_t stream);
void launch_clahe_apply(const int* src, const int* luts, const float* ya,
                        const float* xa, int* out, int H, int W, int th,
                        int tw, int pt, int plf, int tiles_x, int tiles_y,
                        cudaStream_t stream);
void launch_lab_inverse_unit(const int* L, const int* a, const int* b,
                             const int* tab, const float* glut, float* r,
                             float* g, float* bb, long long n,
                             cudaStream_t stream);

}  // namespace uie

namespace {

using Planes = std::tuple<at::Tensor, at::Tensor, at::Tensor>;

// int32 table blocks of ops/lab_tables.py (FWD_TABLE, INV_TABLE)
constexpr int64_t kFwdTable = 11 + 256 + 3072;
constexpr int64_t kInvTable = 15 + 256 + 256 + 4096;

void check(const at::Tensor& t, const at::Tensor& like, at::ScalarType dtype,
           const char* what) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), what,
              ": expected a tensor on ", like.device(), ", got ", t.device());
  TORCH_CHECK(t.scalar_type() == dtype, what, ": expected ", dtype, ", got ",
              t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), what, ": expected a contiguous tensor");
}

void check_planes(const at::Tensor& p0, const at::Tensor& p1,
                  const at::Tensor& p2, at::ScalarType dtype) {
  for (const auto* p : {&p0, &p1, &p2}) {
    check(*p, p0, dtype, "plane");
    TORCH_CHECK(p->dim() == 2 && p->sizes() == p0.sizes(),
                "planes: expected equal 2-D shapes");
  }
}

Planes empty_planes(const at::Tensor& like, at::ScalarType dtype) {
  auto opts = like.options().dtype(dtype);
  return {at::empty(like.sizes(), opts), at::empty(like.sizes(), opts),
          at::empty(like.sizes(), opts)};
}

Planes lab_forward_unit(const at::Tensor& r, const at::Tensor& g,
                        const at::Tensor& b, const at::Tensor& tab) {
  check_planes(r, g, b, at::kFloat);
  check(tab, r, at::kInt, "table");
  TORCH_CHECK(tab.numel() == kFwdTable, "table: expected FWD_TABLE");
  const c10::cuda::CUDAGuard guard(r.device());
  auto outs = empty_planes(r, at::kInt);
  uie::launch_lab_forward_unit(
      r.data_ptr<float>(), g.data_ptr<float>(), b.data_ptr<float>(),
      tab.data_ptr<int>(), std::get<0>(outs).data_ptr<int>(),
      std::get<1>(outs).data_ptr<int>(), std::get<2>(outs).data_ptr<int>(),
      r.numel(), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return outs;
}

at::Tensor clahe_apply(const at::Tensor& src, const at::Tensor& luts,
                       const at::Tensor& ya, const at::Tensor& xa, int64_t th,
                       int64_t tw, int64_t pt, int64_t plf, int64_t tiles_x,
                       int64_t tiles_y) {
  check(src, src, at::kInt, "src");
  TORCH_CHECK(src.dim() == 2, "src: expected a 2-D plane");
  check(luts, src, at::kInt, "luts");
  check(ya, src, at::kFloat, "ya");
  check(xa, src, at::kFloat, "xa");
  TORCH_CHECK(luts.numel() == tiles_y * tiles_x * 256 &&
                  ya.numel() == (tiles_y + 1) * th &&
                  xa.numel() == (tiles_x + 1) * tw,
              "clahe_apply: LUT or fraction sizes do not match the tiling");
  const c10::cuda::CUDAGuard guard(src.device());
  auto out = at::empty_like(src);
  uie::launch_clahe_apply(
      src.data_ptr<int>(), luts.data_ptr<int>(), ya.data_ptr<float>(),
      xa.data_ptr<float>(), out.data_ptr<int>(), (int)src.size(0),
      (int)src.size(1), (int)th, (int)tw, (int)pt, (int)plf, (int)tiles_x,
      (int)tiles_y, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

Planes lab_inverse(const at::Tensor& L, const at::Tensor& a,
                   const at::Tensor& b, const at::Tensor& tab,
                   const float* glut) {
  const c10::cuda::CUDAGuard guard(L.device());
  auto outs = empty_planes(L, at::kFloat);
  uie::launch_lab_inverse_unit(
      L.data_ptr<int>(), a.data_ptr<int>(), b.data_ptr<int>(),
      tab.data_ptr<int>(), glut, std::get<0>(outs).data_ptr<float>(),
      std::get<1>(outs).data_ptr<float>(), std::get<2>(outs).data_ptr<float>(),
      L.numel(), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return outs;
}

Planes lab_inverse_unit(const at::Tensor& L, const at::Tensor& a,
                        const at::Tensor& b, const at::Tensor& tab) {
  check_planes(L, a, b, at::kInt);
  check(tab, L, at::kInt, "table");
  TORCH_CHECK(tab.numel() == kInvTable, "table: expected INV_TABLE");
  return lab_inverse(L, a, b, tab, nullptr);
}

Planes lab_inverse_unit_gamma(const at::Tensor& L, const at::Tensor& a,
                              const at::Tensor& b, const at::Tensor& tab,
                              const at::Tensor& glut) {
  check_planes(L, a, b, at::kInt);
  check(tab, L, at::kInt, "table");
  TORCH_CHECK(tab.numel() == kInvTable, "table: expected INV_TABLE");
  check(glut, L, at::kFloat, "glut");
  TORCH_CHECK(glut.numel() == 256, "glut: expected 256 entries");
  return lab_inverse(L, a, b, tab, glut.data_ptr<float>());
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("lab_forward_unit", &lab_forward_unit,
        "csrc/lab_forward.cu: f32 unit planes -> int32 (L, a, b)");
  m.def("clahe_apply", &clahe_apply,
        "csrc/clahe_apply.cu: int32 plane through its tile LUTs");
  m.def("lab_inverse_unit", &lab_inverse_unit,
        "csrc/lab_inverse.cu: int32 (L, a, b) -> f32 unit planes");
  m.def("lab_inverse_unit_gamma", &lab_inverse_unit_gamma,
        "csrc/lab_inverse.cu: int32 (L, a, b) -> gamma LUT of the u8 planes");
}
