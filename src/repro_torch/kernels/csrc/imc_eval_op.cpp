// repro_torch::imc_eval on CUDA: the layer sums (3, B, W, P) float32 of
// imc_eval.cu for B searches' populations against their workloads.  The
// checks are the wrapper's (kernels/imc_eval/ops.py), word for word.
#include "torch_op.h"

#include <ATen/ops/empty.h>

#include <cstdint>

extern "C" int imc_eval_launch(const float* designs, const float* feats,
                               const uint8_t* mask, float* energy, float* latency,
                               float* demand, int B, int P, int W, int L,
                               const float* consts_host, int n_consts, int device,
                               void* stream);
extern "C" const char* imc_eval_error_string(int code);

namespace {

using repro_torch_op::tup;

at::Tensor imc_eval(const at::Tensor& designs, const at::Tensor& feats,
                    const at::Tensor& mask, c10::ArrayRef<double> consts) {
  TORCH_CHECK_VALUE(designs.is_cuda(), "imc_eval_multi: unsupported device ", designs.device());
  TORCH_CHECK_VALUE(designs.dim() == 3 && designs.size(-1) == 9,
                    "designs must be (B, P, 9), got ", tup(designs.sizes()));
  const int64_t B = designs.size(0), P = designs.size(1);
  TORCH_CHECK_VALUE(feats.dim() == 4 && feats.size(0) == B && feats.size(-1) == 6,
                    "feats must be (B, W, L, 6), got ", tup(feats.sizes()));
  const int64_t W = feats.size(1), L = feats.size(2);
  TORCH_CHECK_VALUE(mask.sizes() == c10::IntArrayRef({B, W, L}), "mask must be ",
                    tup({B, W, L}), ", got ", tup(mask.sizes()));
  const c10::Device dev = designs.device();
  repro_torch_op::check_device(feats, "feats", "designs", dev);
  repro_torch_op::check_device(mask, "mask", "designs", dev);
  const at::Tensor d = repro_torch_op::as(designs, at::kFloat);
  const at::Tensor f = repro_torch_op::as(feats, at::kFloat);
  const at::Tensor m = repro_torch_op::as(mask, at::kBool);
  at::Tensor out = at::empty({3, B, W, P}, designs.options().dtype(at::kFloat));
  const repro_torch_op::Floats c(consts);
  float* o = out.data_ptr<float>();
  const int64_t n = B * W * P;  // floats of one sum
  const int index = dev.index();
  // the launcher selects the device itself, in its own runtime
  const int rc = imc_eval_launch(d.data_ptr<float>(), f.data_ptr<float>(),
                                 reinterpret_cast<const uint8_t*>(m.data_ptr<bool>()), o,
                                 o + n, o + 2 * n, (int)B, (int)P, (int)W, (int)L, c.v.data(),
                                 c.n, index, repro_torch_op::stream(index));
  repro_torch_op::check_launch("imc_eval", rc, imc_eval_error_string);
  return out;
}

}  // namespace

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) { m.impl("imc_eval", &imc_eval); }
