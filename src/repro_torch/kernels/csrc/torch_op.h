// Shared by the <kernel>_op.cpp sources.  Each of them registers the CUDA
// implementation of one repro_torch operator with PyTorch's dispatcher:
// its checks, its inputs as the launcher reads them, its outputs (and
// scratch), the device index, the current stream and the launch.  The
// operator's schema and its fake implementation are defined in Python
// (kernels/<kernel>/ops.py); no operator has a CPU implementation.  Each
// <kernel>_op.cpp is built into one shared library with <kernel>.cu
// (kernels/_build.py), so it calls the launcher's extern "C" symbol
// directly.
#pragma once

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAStream.h>
#include <c10/util/Exception.h>
#include <torch/library.h>

#include <array>
#include <sstream>
#include <string>

namespace repro_torch_op {

// `t` as a contiguous `dtype` tensor: `t` itself when it is one.
inline at::Tensor as(const at::Tensor& t, c10::ScalarType dtype) {
  if (t.scalar_type() == dtype && t.is_contiguous()) return t;
  return t.to(dtype).contiguous();
}

// `t` as a contiguous `dtype` tensor on `device` (a copy when it lies
// elsewhere).
inline at::Tensor as(const at::Tensor& t, c10::ScalarType dtype, c10::Device device) {
  if (t.device() == device) return as(t, dtype);
  return t.to(device, dtype).contiguous();
}

// A float[] argument as the launchers read it: float32 values in host
// memory (each the C cast of its double, as ctypes.c_float made it).
struct Floats {
  std::array<float, 64> v;
  int n;
  explicit Floats(c10::ArrayRef<double> xs) : n((int)xs.size()) {
    TORCH_CHECK_VALUE(xs.size() <= v.size(), "at most ", v.size(), " constants, got ", n);
    for (int i = 0; i < n; ++i) v[i] = (float)xs[i];
  }
};

// Sizes as Python prints a tuple of them: "(8, 40, 9)", "(8,)".
inline std::string tup(c10::IntArrayRef sizes) {
  std::ostringstream s;
  s << "(";
  for (size_t i = 0; i < sizes.size(); ++i) s << (i ? ", " : "") << sizes[i];
  s << (sizes.size() == 1 ? ",)" : ")");
  return s.str();
}

// A dtype as Python prints it ("torch.float32").
inline std::string pydtype(c10::ScalarType t) {
  switch (t) {
    case at::kFloat: return "torch.float32";
    case at::kBFloat16: return "torch.bfloat16";
    case at::kHalf: return "torch.float16";
    case at::kDouble: return "torch.float64";
    case at::kInt: return "torch.int32";
    case at::kLong: return "torch.int64";
    case at::kBool: return "torch.bool";
    default: return std::string("torch.") + c10::toString(t);
  }
}

// The handle of PyTorch's current stream on CUDA device `index`.
inline void* stream(int index) {
  return c10::cuda::getCurrentCUDAStream(static_cast<c10::DeviceIndex>(index)).stream();
}

// Raise if a launcher returned a CUDA error.
inline void check_launch(const char* name, int rc, const char* (*error_string)(int)) {
  TORCH_CHECK(rc == 0, name, " launch failed: CUDA error ", rc, " (", error_string(rc), ")");
}

// Raise unless `t` lies on `device`: "<name> on <its device>, <first> on <device>".
inline void check_device(const at::Tensor& t, const char* name, const char* first,
                         c10::Device device) {
  TORCH_CHECK_VALUE(t.device() == device, name, " on ", t.device(), ", ", first, " on ",
                    device);
}

}  // namespace repro_torch_op
