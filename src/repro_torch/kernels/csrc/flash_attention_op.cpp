// repro_torch::flash_attention on CUDA: attention output (B, Sq, H, D) in
// q's dtype from flash_attention.cu.  The checks are the wrapper's
// (kernels/flash_attention/ops.py), word for word.  TMA addresses bf16
// tensors with 16-byte aligned bases and rows of a multiple of 16 bytes:
// a call that does not meet this (D not a multiple of 8, a misaligned
// view) is copied into a zero-padded layout (D up to a multiple of 8),
// runs the same kernel, and its output is cut back to D.
#include "torch_op.h"

#include <ATen/ops/empty_like.h>
#include <ATen/ops/zeros.h>

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Skv, int H, int KV, int D,
                                      float scale, int causal, int window, int q_offset,
                                      int dtype, int device, void* stream);
extern "C" const char* flash_attention_error_string(int code);

namespace {

using repro_torch_op::pydtype;
using repro_torch_op::tup;

constexpr int64_t kMaxHeadDim = 256;  // ops.py:MAX_HEAD_DIM

bool aligned(const at::Tensor& t) {
  return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0;
}

// `t` (..., D) copied into a fresh (..., Dk) tensor, zeros past D.
at::Tensor padded(const at::Tensor& t, int64_t Dk) {
  std::vector<int64_t> sizes = t.sizes().vec();
  sizes.back() = Dk;
  at::Tensor out = at::zeros(sizes, t.options());
  out.narrow(-1, 0, t.size(-1)).copy_(t);
  return out;
}

at::Tensor flash_attention(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                           bool causal, int64_t window, int64_t q_offset) {
  TORCH_CHECK_VALUE(q.is_cuda(), "flash_attention: unsupported device ", q.device());
  TORCH_CHECK_VALUE(q.dim() == 4, "q must be (B, Sq, H, D), got ", tup(q.sizes()));
  const int64_t B = q.size(0), Sq = q.size(1), H = q.size(2), D = q.size(3);
  TORCH_CHECK_VALUE(k.dim() == 4, "k, v must be (B, Skv, KV, D), got ", tup(k.sizes()), " / ",
                    tup(v.sizes()));
  const int64_t Skv = k.size(1), KV = k.size(2);
  TORCH_CHECK_VALUE(k.size(0) == B && k.size(3) == D && v.sizes() == k.sizes(),
                    "k, v must be (B, Skv, KV, D) = ", tup({B, Skv, KV, D}), ", got ",
                    tup(k.sizes()), " / ", tup(v.sizes()));
  TORCH_CHECK_VALUE(KV != 0 && H % KV == 0, "H=", H, " must be a multiple of KV=", KV);
  TORCH_CHECK_VALUE(0 < D && D <= kMaxHeadDim, "head dim ", D, " outside 1..", kMaxHeadDim,
                    " (the kernel's largest tier; the largest config head_dim is 256)");
  TORCH_CHECK_VALUE(Skv != 0, "flash_attention needs at least one key");
  const auto dt = q.scalar_type();
  TORCH_CHECK_VALUE((dt == at::kFloat || dt == at::kBFloat16) && k.scalar_type() == dt &&
                        v.scalar_type() == dt,
                    "q, k, v must share float32 or bfloat16, got ", pydtype(dt), ", ",
                    pydtype(k.scalar_type()), ", ", pydtype(v.scalar_type()));
  TORCH_CHECK_VALUE(q_offset >= 0, "q_offset must be >= 0, got ", q_offset);
  const c10::Device dev = q.device();
  repro_torch_op::check_device(k, "k", "q", dev);
  repro_torch_op::check_device(v, "v", "q", dev);
  at::Tensor qc = q.contiguous(), kc = k.contiguous(), vc = v.contiguous();
  int64_t Dk = D;
  if (dt == at::kBFloat16 && !(D % 8 == 0 && aligned(qc) && aligned(kc) && aligned(vc))) {
    Dk = (D + 7) / 8 * 8;
    qc = padded(qc, Dk);
    kc = padded(kc, Dk);
    vc = padded(vc, Dk);
  }
  at::Tensor out = at::empty_like(qc);
  const int index = dev.index();
  const float scale = (float)std::pow((double)D, -0.5);  // D ** -0.5, as a float32
  const int rc = flash_attention_launch(
      qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), (int)B, (int)Sq, (int)Skv,
      (int)H, (int)KV, (int)Dk, scale, (int)causal, (int)window, (int)q_offset,
      dt == at::kBFloat16 ? 1 : 0, index, repro_torch_op::stream(index));
  repro_torch_op::check_launch("flash_attention", rc, flash_attention_error_string);
  return Dk == D ? out : out.narrow(-1, 0, D).contiguous();
}

}  // namespace

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) { m.impl("flash_attention", &flash_attention); }
