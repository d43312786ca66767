// repro_torch::ssd_scan on CUDA: the chunked scan of ssd_scan.cu, (y (B,
// S, H, P) in x's dtype, final state (B, H, N, P) float32).  One call runs
// the three kernels back to back on the current stream, with scratch
// allocated here.  The checks are the wrapper's (kernels/ssd_scan/ops.py),
// word for word.
#include "torch_op.h"

#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>

#include <algorithm>
#include <cstdint>
#include <optional>

extern "C" long long ssd_scan_smem_bytes(int N, int P, int Q, int dtype);
extern "C" long long ssd_scan_work_bytes(int B, int S, int H, int P, int N, int Q);
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* Bm,
                               const void* Cm, const float* h0, void* y, float* h_out,
                               void* work, int B, int S, int H, int P, int N, int Q, int dtype,
                               int device, void* stream);
extern "C" const char* ssd_scan_error_string(int code);

namespace {

using repro_torch_op::pydtype;
using repro_torch_op::tup;

// the card's shared memory a block can opt into (H100: 227 KB)
constexpr long long kSmemLimit = 232448;

std::tuple<at::Tensor, at::Tensor> ssd_scan(const at::Tensor& x, const at::Tensor& dt,
                                            const at::Tensor& A, const at::Tensor& Bm,
                                            const at::Tensor& Cm,
                                            const std::optional<at::Tensor>& h0,
                                            int64_t chunk) {
  TORCH_CHECK_VALUE(x.is_cuda(), "ssd_chunked: unsupported device ", x.device());
  TORCH_CHECK_VALUE(x.dim() == 4, "x must be (B, S, H, P), got ", tup(x.sizes()));
  const int64_t B = x.size(0), S = x.size(1), H = x.size(2), P = x.size(3);
  TORCH_CHECK_VALUE(Bm.dim() == 4 && Bm.size(0) == B && Bm.size(1) == S &&
                        Cm.sizes() == Bm.sizes(),
                    "Bm/Cm must be (B, S, G, N), got ", tup(Bm.sizes()), " / ",
                    tup(Cm.sizes()));
  TORCH_CHECK_VALUE(Bm.size(2) == 1, "the ssd_scan kernel is written for one B/C group (G=1)");
  const int64_t N = Bm.size(3);
  TORCH_CHECK_VALUE(dt.sizes() == c10::IntArrayRef({B, S, H}) &&
                        A.sizes() == c10::IntArrayRef({H}),
                    "dt must be ", tup({B, S, H}), " and A ", tup({H}), ", got ",
                    tup(dt.sizes()), " / ", tup(A.sizes()));
  const auto xt = x.scalar_type();
  TORCH_CHECK_VALUE((xt == at::kFloat || xt == at::kBFloat16) && Bm.scalar_type() == xt &&
                        Cm.scalar_type() == xt,
                    "x, Bm, Cm must share float32 or bfloat16, got ", pydtype(xt), ", ",
                    pydtype(Bm.scalar_type()), ", ", pydtype(Cm.scalar_type()));
  TORCH_CHECK_VALUE(!h0 || h0->sizes() == c10::IntArrayRef({B, H, N, P}), "h0 must be ",
                    tup({B, H, N, P}), ", got ", tup(h0->sizes()));
  const c10::Device dev = x.device();
  repro_torch_op::check_device(dt, "dt", "x", dev);
  repro_torch_op::check_device(A, "A", "x", dev);
  repro_torch_op::check_device(Bm, "Bm", "x", dev);
  repro_torch_op::check_device(Cm, "Cm", "x", dev);
  if (h0) repro_torch_op::check_device(*h0, "h0", "x", dev);
  const int64_t Q = std::min(chunk, S);
  TORCH_CHECK_VALUE(Q > 0 && S % Q == 0 && Q <= 128, "chunk ", Q, " must divide S=", S,
                    " and be at most 128");
  const int dtype = xt == at::kBFloat16 ? 1 : 0;
  const long long need = ssd_scan_smem_bytes((int)N, (int)P, (int)Q, dtype);
  TORCH_CHECK_VALUE(need <= kSmemLimit, "ssd_scan needs ", need,
                    " bytes of shared memory at N=", N, ", P=", P, ", chunk=", Q, " (",
                    pydtype(xt), "); the card offers ", kSmemLimit);
  const at::Tensor xc = x.contiguous(), bc = Bm.contiguous(), cc = Cm.contiguous();
  const at::Tensor dtc = repro_torch_op::as(dt, at::kFloat);
  const at::Tensor Ac = repro_torch_op::as(A, at::kFloat);
  const std::optional<at::Tensor> h0c =
      h0 ? std::optional<at::Tensor>(repro_torch_op::as(*h0, at::kFloat)) : std::nullopt;
  at::Tensor y = at::empty_like(xc);
  at::Tensor h = at::empty({B, H, N, P}, x.options().dtype(at::kFloat));
  // scratch: the cumsums, each chunk's state and the entering states' bf16 terms
  const at::Tensor work =
      at::empty({(int64_t)ssd_scan_work_bytes((int)B, (int)S, (int)H, (int)P, (int)N, (int)Q)},
                x.options().dtype(at::kByte));
  const int index = dev.index();
  const int rc = ssd_scan_launch(
      xc.data_ptr(), dtc.data_ptr<float>(), Ac.data_ptr<float>(), bc.data_ptr(), cc.data_ptr(),
      h0c ? h0c->data_ptr<float>() : nullptr, y.data_ptr(), h.data_ptr<float>(),
      work.data_ptr(), (int)B, (int)S, (int)H, (int)P, (int)N, (int)Q, dtype, index,
      repro_torch_op::stream(index));
  repro_torch_op::check_launch("ssd_scan", rc, ssd_scan_error_string);
  return {y, h};
}

}  // namespace

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) { m.impl("ssd_scan", &ssd_scan); }
