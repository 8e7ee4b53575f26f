// PyTorch entry points of the package's CUDA kernels (ops/kernels.py calls
// them for CUDA tensors).  Each checks its tensors, allocates the outputs,
// launches on the current stream of the inputs' device and checks the
// launch.  The only source that includes the PyTorch headers: the kernels
// in csrc/*.cu see raw pointers.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>
#include <pybind11/stl.h>

#include <cstdint>
#include <optional>
#include <tuple>
#include <vector>

namespace uie {

void launch_lab_forward_unit(const float* r, const float* g, const float* b,
                             const int* tab, const int* fix, int n_fix,
                             int* L, int* a, int* bb, long long n, int cbrt,
                             cudaStream_t stream);
void launch_lab_forward_u8(const int* r, const int* g, const int* b,
                           const int* tab, int* L, int* a, int* bb,
                           long long n, bool l_only, cudaStream_t stream);
void lab_forward_info(int which, long long n, int* out);
void launch_clahe_apply(const int* src, const int* luts, const float* ya,
                        const float* xa, int* out, int H, int W, int th,
                        int tw, int pt, int plf, int tiles_x, int tiles_y,
                        cudaStream_t stream);
void clahe_apply_info(int th, int tiles_x, int tiles_y, int* out);
void launch_lab_inverse_lut(const int* L, const int* a, const int* b,
                            const int* tab, const float* lut, float* r,
                            float* g, float* bb, long long n,
                            cudaStream_t stream);
void launch_lab_inverse_u8(const int* L, const int* a, const int* b,
                           const int* tab, int* r, int* g, int* bb,
                           long long n, cudaStream_t stream);
void lab_inverse_info(int which, long long n, int* out);
void launch_clahe_lab_apply(const int* L, const int* a, const int* b,
                            const int* luts, const float* ya, const float* xa,
                            const int* tab, int* r, int* g, int* bb, int H,
                            int W, int th, int tw, int pt, int plf,
                            int tiles_x, int tiles_y, cudaStream_t stream);
void launch_surrogate_probe(const int* idx, int* out, int n, int which,
                            cudaStream_t stream);
long long hysteresis_smem_bytes(int tile_h, int halo_rows, int group);
cudaError_t launch_hysteresis(const int* strong, const int* weak,
                              unsigned* bits, int* out, int N, int H, int W,
                              int iters, int tile_h, int halo_rows,
                              int halo_words, int group, cudaStream_t stream);
int scan_max_length();
cudaError_t launch_scan(const float* x, float* out, int N, int L, int M,
                        bool lead, cudaStream_t stream);

}  // namespace uie

namespace {

using Planes = std::tuple<at::Tensor, at::Tensor, at::Tensor>;

// int32 table blocks of ops/lab_tables.py (FWD_TABLE_U16, INV_TABLE_U8)
constexpr int64_t kFwdTable = 12 + 256 + 3072 / 2;
constexpr int64_t kInvTableU8 = 16 + 256 + 256 + 4096 / 4;
// csrc/lab_forward.cu's cube-root policies and its largest fix-up set
constexpr int kCbrtTable = 0, kCbrtApprox = 1, kCbrtCorrected = 2;
constexpr int64_t kMaxFix = 32;

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

// A table block of `ints` int32 on the planes' device, 16-byte aligned:
// csrc/lab_forward.cu and csrc/lab_inverse.cu read theirs in 16-byte
// chunks
void check_table16(const at::Tensor& tab, const at::Tensor& like,
                   int64_t ints, const char* name) {
  check(tab, like, at::kInt, "table");
  TORCH_CHECK(tab.numel() == ints, "table: expected ", name);
  TORCH_CHECK(reinterpret_cast<std::uintptr_t>(tab.data_ptr()) % 16 == 0,
              "table: expected a 16-byte aligned ", name);
}

void check_fwd_table(const at::Tensor& tab, const at::Tensor& like) {
  check_table16(tab, like, kFwdTable, "FWD_TABLE_U16");
}

Planes empty_planes(const at::Tensor& like, at::ScalarType dtype) {
  auto opts = like.options().dtype(dtype);
  return {at::empty(like.sizes(), opts), at::empty(like.sizes(), opts),
          at::empty(like.sizes(), opts)};
}

Planes lab_forward(const at::Tensor& r, const at::Tensor& g,
                   const at::Tensor& b, const at::Tensor& tab, int cbrt,
                   const int* fix = nullptr, int n_fix = 0) {
  check_planes(r, g, b, at::kFloat);
  check_fwd_table(tab, r);
  const c10::cuda::CUDAGuard guard(r.device());
  auto outs = empty_planes(r, at::kInt);
  uie::launch_lab_forward_unit(
      r.data_ptr<float>(), g.data_ptr<float>(), b.data_ptr<float>(),
      tab.data_ptr<int>(), fix, n_fix, std::get<0>(outs).data_ptr<int>(),
      std::get<1>(outs).data_ptr<int>(), std::get<2>(outs).data_ptr<int>(),
      r.numel(), cbrt, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return outs;
}

Planes lab_forward_unit(const at::Tensor& r, const at::Tensor& g,
                        const at::Tensor& b, const at::Tensor& tab) {
  return lab_forward(r, g, b, tab, kCbrtTable);
}

Planes lab_forward_unit_approx(const at::Tensor& r, const at::Tensor& g,
                               const at::Tensor& b, const at::Tensor& tab) {
  return lab_forward(r, g, b, tab, kCbrtApprox);
}

// fix: the probe's (2, k) int32 fix-ups (indices, deltas), k <= 32, or
// None where the probe found more differences: then the table policy.
Planes lab_forward_unit_fast(const at::Tensor& r, const at::Tensor& g,
                             const at::Tensor& b, const at::Tensor& tab,
                             const std::optional<at::Tensor>& fix) {
  if (!fix.has_value()) return lab_forward(r, g, b, tab, kCbrtTable);
  check(*fix, r, at::kInt, "fix");
  TORCH_CHECK(fix->dim() == 2 && fix->size(0) == 2 && fix->size(1) <= kMaxFix,
              "fix: expected (2, k <= 32) fix-ups");
  return lab_forward(r, g, b, tab, kCbrtCorrected, fix->data_ptr<int>(),
                     (int)fix->size(1));
}

Planes lab_forward_u8(const at::Tensor& r, const at::Tensor& g,
                      const at::Tensor& b, const at::Tensor& tab) {
  check_planes(r, g, b, at::kInt);
  check_fwd_table(tab, r);
  const c10::cuda::CUDAGuard guard(r.device());
  auto outs = empty_planes(r, at::kInt);
  uie::launch_lab_forward_u8(
      r.data_ptr<int>(), g.data_ptr<int>(), b.data_ptr<int>(),
      tab.data_ptr<int>(), std::get<0>(outs).data_ptr<int>(),
      std::get<1>(outs).data_ptr<int>(), std::get<2>(outs).data_ptr<int>(),
      r.numel(), false, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return outs;
}

at::Tensor lab_forward_l_u8(const at::Tensor& r, const at::Tensor& g,
                            const at::Tensor& b, const at::Tensor& tab) {
  check_planes(r, g, b, at::kInt);
  check_fwd_table(tab, r);
  const c10::cuda::CUDAGuard guard(r.device());
  auto L = at::empty(r.sizes(), r.options().dtype(at::kInt));
  uie::launch_lab_forward_u8(
      r.data_ptr<int>(), g.data_ptr<int>(), b.data_ptr<int>(),
      tab.data_ptr<int>(), L.data_ptr<int>(), nullptr, nullptr, r.numel(),
      true, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return L;
}

// registers, local bytes a thread, resident blocks a SM, grid (for an
// aligned call of n pixels) and threads a block of forward-LAB kernel
// `which` (0 K1, 1 K8 _approx, 2 K8 _fast, 3 K1b, 4 K4) on the current
// device
std::vector<int64_t> lab_forward_info(int64_t which, int64_t n) {
  TORCH_CHECK(which >= 0 && which <= 4, "which: expected 0 to 4");
  int out[5] = {};
  uie::lab_forward_info((int)which, n, out);
  C10_CUDA_CHECK(cudaGetLastError());
  return std::vector<int64_t>(out, out + 5);
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

// registers, local bytes a thread, resident blocks a SM, grid x (band
// blocks), grid y (strips), strip rows and threads a block of the CLAHE
// apply kernel for a plane of tile height th on the current device
std::vector<int64_t> clahe_apply_info(int64_t th, int64_t tiles_x,
                                      int64_t tiles_y) {
  TORCH_CHECK(th >= 1 && tiles_x >= 1 && tiles_y >= 1,
              "clahe_apply_info: expected a positive tile height and counts");
  int out[7] = {};
  uie::clahe_apply_info((int)th, (int)tiles_x, (int)tiles_y, out);
  C10_CUDA_CHECK(cudaGetLastError());
  return std::vector<int64_t>(out, out + 7);
}

// tab: INV_TABLE_U8
Planes lab_inverse_u8(const at::Tensor& L, const at::Tensor& a,
                      const at::Tensor& b, const at::Tensor& tab) {
  check_planes(L, a, b, at::kInt);
  check_table16(tab, L, kInvTableU8, "INV_TABLE_U8");
  const c10::cuda::CUDAGuard guard(L.device());
  auto outs = empty_planes(L, at::kInt);
  uie::launch_lab_inverse_u8(
      L.data_ptr<int>(), a.data_ptr<int>(), b.data_ptr<int>(),
      tab.data_ptr<int>(), std::get<0>(outs).data_ptr<int>(),
      std::get<1>(outs).data_ptr<int>(), std::get<2>(outs).data_ptr<int>(),
      L.numel(), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return outs;
}

Planes clahe_lab_apply(const at::Tensor& L, const at::Tensor& a,
                       const at::Tensor& b, const at::Tensor& luts,
                       const at::Tensor& ya, const at::Tensor& xa,
                       const at::Tensor& tab, int64_t th, int64_t tw,
                       int64_t pt, int64_t plf, int64_t tiles_x,
                       int64_t tiles_y) {
  check_planes(L, a, b, at::kInt);
  check(luts, L, at::kInt, "luts");
  check(ya, L, at::kFloat, "ya");
  check(xa, L, at::kFloat, "xa");
  check_table16(tab, L, kInvTableU8, "INV_TABLE_U8");
  TORCH_CHECK(luts.numel() == tiles_y * tiles_x * 256 &&
                  ya.numel() == (tiles_y + 1) * th &&
                  xa.numel() == (tiles_x + 1) * tw,
              "clahe_lab_apply: LUT or fraction sizes do not match the tiling");
  TORCH_CHECK(L.numel() < (int64_t{1} << 31),
              "clahe_lab_apply: expected fewer than 2^31 pixels");
  const c10::cuda::CUDAGuard guard(L.device());
  auto outs = empty_planes(L, at::kInt);
  uie::launch_clahe_lab_apply(
      L.data_ptr<int>(), a.data_ptr<int>(), b.data_ptr<int>(),
      luts.data_ptr<int>(), ya.data_ptr<float>(), xa.data_ptr<float>(),
      tab.data_ptr<int>(), std::get<0>(outs).data_ptr<int>(),
      std::get<1>(outs).data_ptr<int>(), std::get<2>(outs).data_ptr<int>(),
      (int)L.size(0), (int)L.size(1), (int)th, (int)tw, (int)pt, (int)plf,
      (int)tiles_x, (int)tiles_y, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return outs;
}

// which: 0 = CBRT_TAB's surrogate, 1 = INV_GAMMA_TAB's; idx: int32 indices
at::Tensor surrogate_probe(const at::Tensor& idx, int64_t which) {
  check(idx, idx, at::kInt, "idx");
  TORCH_CHECK(idx.dim() == 1 && idx.numel() > 0 && (which == 0 || which == 1),
              "surrogate_probe: expected 1-D indices and a table 0 or 1");
  const c10::cuda::CUDAGuard guard(idx.device());
  auto out = at::empty_like(idx);
  uie::launch_surrogate_probe(idx.data_ptr<int>(), out.data_ptr<int>(),
                              (int)idx.numel(), (int)which,
                              at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// tab: INV_TABLE_U8; lut: the (256,) f32 value of each u8 result, 16-byte
// aligned (stretch.U8_GRID for K3, a gamma table for K3g)
Planes lab_inverse_lut(const at::Tensor& L, const at::Tensor& a,
                       const at::Tensor& b, const at::Tensor& tab,
                       const at::Tensor& lut) {
  check_planes(L, a, b, at::kInt);
  check_table16(tab, L, kInvTableU8, "INV_TABLE_U8");
  check(lut, L, at::kFloat, "lut");
  TORCH_CHECK(lut.numel() == 256 &&
                  reinterpret_cast<std::uintptr_t>(lut.data_ptr()) % 16 == 0,
              "lut: expected 256 16-byte aligned entries");
  const c10::cuda::CUDAGuard guard(L.device());
  auto outs = empty_planes(L, at::kFloat);
  uie::launch_lab_inverse_lut(
      L.data_ptr<int>(), a.data_ptr<int>(), b.data_ptr<int>(),
      tab.data_ptr<int>(), lut.data_ptr<float>(),
      std::get<0>(outs).data_ptr<float>(), std::get<1>(outs).data_ptr<float>(),
      std::get<2>(outs).data_ptr<float>(), L.numel(),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return outs;
}

// registers, local bytes a thread, resident blocks a SM, grid (for an
// aligned call of n pixels) and threads a block of inverse-LAB kernel
// `which` (0 K3 and K3g, 1 K3b) on the current device
std::vector<int64_t> lab_inverse_info(int64_t which, int64_t n) {
  TORCH_CHECK(which == 0 || which == 1, "which: expected 0 or 1");
  int out[5] = {};
  uie::lab_inverse_info((int)which, n, out);
  C10_CUDA_CHECK(cudaGetLastError());
  return std::vector<int64_t>(out, out + 5);
}

// The largest shared-memory block of an H100 (227 KB).
constexpr long long kMaxSmem = 232448;

// ops/kernels.py picks the plan (hysteresis_tile); checked here: a halo of
// at least `iters` cells on every side, or one region that holds the whole
// plane, and a region that fits in shared memory.
at::Tensor hysteresis_propagate(const at::Tensor& strong,
                                const at::Tensor& weak, int64_t iters,
                                int64_t tile_h, int64_t halo_rows,
                                int64_t halo_words, int64_t group) {
  check(strong, strong, at::kInt, "strong");
  check(weak, strong, at::kInt, "weak");
  TORCH_CHECK(strong.dim() == 3 && weak.sizes() == strong.sizes(),
              "hysteresis: expected equal (N, H, W) planes");
  const int64_t H = strong.size(1), W = strong.size(2);
  const int64_t tile_w = group - 2 * halo_words;  // words
  const bool whole = halo_rows == 0 && halo_words == 0 && tile_h >= H &&
                     32 * group >= W;
  TORCH_CHECK(iters >= 0 && iters < (int64_t{1} << 30) &&
                  (group == 16 || group == 32) && tile_h > 0 && tile_w > 0 &&
                  (whole || (halo_rows >= iters && 32 * halo_words >= iters)),
              "hysteresis: the plan does not cover the rounds");
  TORCH_CHECK(uie::hysteresis_smem_bytes((int)tile_h, (int)halo_rows,
                                         (int)group) <= kMaxSmem,
              "hysteresis: the region does not fit in shared memory");
  const c10::cuda::CUDAGuard guard(strong.device());
  auto out = at::empty_like(strong);
  if (out.numel() == 0) return out;
  // the packed strong and weak planes, 32 cells a word
  auto bits = at::empty({2 * strong.size(0) * H * ((W + 31) / 32)},
                        strong.options());
  C10_CUDA_CHECK(uie::launch_hysteresis(
      strong.data_ptr<int>(), weak.data_ptr<int>(),
      reinterpret_cast<unsigned*>(bits.data_ptr<int>()), out.data_ptr<int>(),
      (int)strong.size(0), (int)H, (int)W, (int)iters, (int)tile_h,
      (int)halo_rows, (int)halo_words, (int)group,
      at::cuda::getCurrentCUDAStream()));
  return out;
}

// csrc/scan.cu on (N, L, M): one launch, L <= scan_max_length().
at::Tensor prefix_scan(const at::Tensor& x, int64_t dim, bool lead) {
  check(x, x, at::kFloat, "x");
  TORCH_CHECK(x.dim() >= 1 && dim >= 0 && dim < x.dim(),
              "prefix_scan: dim out of range");
  int64_t N = 1, M = 1;
  for (int64_t d = 0; d < dim; ++d) N *= x.size(d);
  for (int64_t d = dim + 1; d < x.dim(); ++d) M *= x.size(d);
  const int64_t L = x.size(dim);
  TORCH_CHECK(L >= 1 && L <= uie::scan_max_length() &&
                  x.numel() < (int64_t{1} << 31),
              "prefix_scan: expected 1 to 2^16 values along dim and fewer "
              "than 2^31 in all");
  auto sizes = x.sizes().vec();
  sizes[dim] += lead ? 1 : 0;
  const c10::cuda::CUDAGuard guard(x.device());
  auto out = at::empty(sizes, x.options());
  if (x.numel() == 0) return out.zero_();
  C10_CUDA_CHECK(uie::launch_scan(x.data_ptr<float>(), out.data_ptr<float>(),
                                  (int)N, (int)L, (int)M, lead,
                                  at::cuda::getCurrentCUDAStream()));
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("lab_forward_unit", &lab_forward_unit,
        "csrc/lab_forward.cu: f32 unit planes -> int32 (L, a, b)");
  m.def("lab_forward_unit_approx", &lab_forward_unit_approx,
        "csrc/lab_forward.cu: f32 unit planes -> int32 (L, a, b), "
        "2-step Newton cube root");
  m.def("lab_forward_unit_fast", &lab_forward_unit_fast,
        "csrc/lab_forward.cu: f32 unit planes -> int32 (L, a, b), "
        "4-step Newton cube root plus the probe's fix-ups");
  m.def("lab_forward_u8", &lab_forward_u8,
        "csrc/lab_forward.cu: u8-valued int32 planes -> int32 (L, a, b)");
  m.def("lab_forward_l_u8", &lab_forward_l_u8,
        "csrc/lab_forward.cu: u8-valued int32 planes -> int32 L");
  m.def("lab_forward_info", &lab_forward_info,
        "csrc/lab_forward.cu: registers, local bytes, blocks a SM, grid and "
        "threads of a forward-LAB kernel");
  m.def("clahe_apply", &clahe_apply,
        "csrc/clahe_apply.cu: int32 plane through its tile LUTs");
  m.def("clahe_apply_info", &clahe_apply_info,
        "csrc/clahe_apply.cu: registers, local bytes, blocks a SM, grid "
        "(band blocks, strips), strip rows and threads");
  m.def("lab_inverse_lut", &lab_inverse_lut,
        "csrc/lab_inverse.cu: int32 (L, a, b) -> f32 table of the u8 planes");
  m.def("lab_inverse_u8", &lab_inverse_u8,
        "csrc/lab_inverse.cu: int32 (L, a, b) -> u8-valued int32 planes");
  m.def("lab_inverse_info", &lab_inverse_info,
        "csrc/lab_inverse.cu: registers, local bytes, blocks a SM, grid and "
        "threads of an inverse-LAB kernel");
  m.def("clahe_lab_apply", &clahe_lab_apply,
        "csrc/clahe_lab_apply.cu: CLAHE of L, then int32 (L', a, b) -> "
        "u8-valued int32 planes");
  m.def("surrogate_probe", &surrogate_probe,
        "csrc/probe.cu: a LAB table's surrogate at each index");
  m.def("hysteresis_propagate", &hysteresis_propagate,
        "csrc/hysteresis.cu: bounded 8-connected flood of (N, H, W) planes");
  m.def("sat_rows", &prefix_scan,
        "csrc/scan.cu: f32 prefix sum along dim in XLA:CPU's order");
}
