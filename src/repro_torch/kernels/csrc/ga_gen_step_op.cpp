// repro_torch::ga_gen_step on CUDA: one GA generation of ga_gen_step.cu
// for B searches, (new_pop, new_scores, children, child_scores).  The
// shape checks are the wrapper's (kernels/ga_gen_step/ops.py), word for
// word; the rest keep a direct call from reading past its inputs.  The
// grids, sizes and V/f mask must be those the tables were built on (the
// wrapper passes the active grid's).
#include "torch_op.h"

#include <ATen/ops/empty.h>

#include <array>
#include <cstdint>

extern "C" long long ga_gen_step_smem_bytes(int P, int W, int gmax, int R, int C, int Bc,
                                            int Gn, int V, int Tc);
extern "C" int ga_gen_step_max_smem_bytes(int device);
extern "C" int ga_gen_step_launch(
    const float* pop, const float* scores, const float* u, const float* demand,
    const float* dac, const float* spill, const float* sum_m, const float* sum_bytes,
    const float* sum_mkng, const float* sum_mng, const float* grids, const int* sizes,
    const uint8_t* vt_mask, const long long* kind, const float* area, float* new_pop,
    float* new_scores, float* children, float* child_scores, int B, int P, int W, int gmax,
    int R, int C, int Bc, int Gn, int V, int Tc, const float* consts_host, int n_consts,
    int device, void* stream);
extern "C" const char* ga_gen_step_error_string(int code);

namespace {

using repro_torch_op::tup;

constexpr int64_t kGenes = 9;
constexpr const char* kTables[7] = {"demand", "dac", "spill", "sum_m",
                                    "sum_bytes", "sum_mkng", "sum_mng"};

// block_layout(P, n).tot of core/ga.py: the uniform draws of one generation.
int64_t tot(int64_t P, int64_t n) {
  const int64_t pairs = (P + 1) / 2;
  return 2 * (2 * pairs) + pairs * n + pairs + pairs * n + P * n + P * n;
}

// The card's opt-in shared memory per block, asked once per device.
int max_smem(int index) {
  static std::array<int, 64> limit{};
  TORCH_CHECK(index >= 0 && index < (int)limit.size(), "ga_gen_step: device ", index);
  if (limit[index] == 0) limit[index] = ga_gen_step_max_smem_bytes(index);
  return limit[index];
}

std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor> ga_gen_step(
    const at::Tensor& pop, const at::Tensor& scores, const at::Tensor& u,
    const at::Tensor& demand, const at::Tensor& dac, const at::Tensor& spill,
    const at::Tensor& sum_m, const at::Tensor& sum_bytes, const at::Tensor& sum_mkng,
    const at::Tensor& sum_mng, const at::Tensor& kind, const at::Tensor& area,
    const at::Tensor& grids, const at::Tensor& sizes, const at::Tensor& vt_mask,
    c10::ArrayRef<double> consts) {
  TORCH_CHECK_VALUE(pop.is_cuda(), "ga_gen_step: unsupported device ", pop.device());
  TORCH_CHECK_VALUE(pop.dim() == 3 && pop.size(2) == kGenes, "pop must be (B, P, ", kGenes,
                    "), got ", tup(pop.sizes()));
  const int64_t B = pop.size(0), P = pop.size(1), T = tot(P, kGenes);
  TORCH_CHECK_VALUE(scores.sizes() == c10::IntArrayRef({B, P}) &&
                        u.sizes() == c10::IntArrayRef({B, T}),
                    "scores ", tup(scores.sizes()), " / u ", tup(u.sizes()),
                    " do not match (B, P) = ", tup({B, P}), ", tot = ", T);
  const c10::Device dev = pop.device();
  repro_torch_op::check_device(scores, "scores", "pop", dev);
  repro_torch_op::check_device(u, "u", "pop", dev);
  TORCH_CHECK_VALUE(demand.dim() == 5, "table demand: ", tup(demand.sizes()),
                    ", expected (B, W, R, C, Bc)");
  TORCH_CHECK_VALUE(spill.dim() == 3, "table spill: ", tup(spill.sizes()),
                    ", expected (B, W, Gn)");
  const int64_t W = demand.size(1), R = demand.size(2), C = demand.size(3),
                Bc = demand.size(4), Gn = spill.size(2);
  const std::array<const at::Tensor*, 7> tabs{&demand, &dac, &spill, &sum_m,
                                              &sum_bytes, &sum_mkng, &sum_mng};
  struct Shape {
    int64_t d[5];
    size_t n;
  };
  const Shape want[7] = {{{B, W, R, C, Bc}, 5}, {{B, W, C, Bc}, 4}, {{B, W, Gn}, 3},
                         {{B, W}, 2}, {{B, W}, 2}, {{B, W}, 2}, {{B, W}, 2}};
  for (int i = 0; i < 7; ++i) {
    const at::Tensor& leaf = *tabs[i];
    TORCH_CHECK_VALUE(leaf.dim() >= 2 && leaf.size(0) == B && leaf.size(1) == W &&
                          leaf.device() == dev,
                      "table ", kTables[i], ": ", tup(leaf.sizes()), " on ", leaf.device(),
                      ", expected leading ", tup({B, W}), " on ", dev);
    const c10::IntArrayRef expect(want[i].d, want[i].n);
    TORCH_CHECK_VALUE(leaf.sizes() == expect, "table ", kTables[i], ": ", tup(leaf.sizes()),
                      ", expected ", tup(expect));
  }
  TORCH_CHECK_VALUE(kind.numel() == B && area.numel() == B, "kind ", tup(kind.sizes()),
                    " / area ", tup(area.sizes()), " must hold one value per search (B = ",
                    B, ")");
  TORCH_CHECK_VALUE(grids.dim() == 2 && grids.size(0) == kGenes &&
                        sizes.sizes() == c10::IntArrayRef({kGenes}) && vt_mask.dim() == 2,
                    "grids ", tup(grids.sizes()), " / sizes ", tup(sizes.sizes()),
                    " / vt_mask ", tup(vt_mask.sizes()), " must be (9, Gmax), (9,) and (V, Tc)");
  repro_torch_op::check_device(grids, "grids", "pop", dev);
  repro_torch_op::check_device(sizes, "sizes", "pop", dev);
  repro_torch_op::check_device(vt_mask, "vt_mask", "pop", dev);
  const int index = dev.index();
  const int gmax = (int)grids.size(1), V = (int)vt_mask.size(0), Tc = (int)vt_mask.size(1);
  const long long smem =
      ga_gen_step_smem_bytes((int)P, (int)W, gmax, (int)R, (int)C, (int)Bc, (int)Gn, V, Tc);
  const int limit = max_smem(index);
  TORCH_CHECK_VALUE(smem <= limit, "ga_gen_step: P=", P, ", W=", W, " needs ", smem,
                    " bytes of shared memory per block; this card allows ", limit);
  std::array<at::Tensor, 3> f32{repro_torch_op::as(pop, at::kFloat),
                                repro_torch_op::as(scores, at::kFloat),
                                repro_torch_op::as(u, at::kFloat)};
  std::array<at::Tensor, 7> t32;
  for (int i = 0; i < 7; ++i) t32[i] = repro_torch_op::as(*tabs[i], at::kFloat);
  const at::Tensor g = repro_torch_op::as(grids, at::kFloat);
  const at::Tensor s = repro_torch_op::as(sizes, at::kInt);
  const at::Tensor vt = repro_torch_op::as(vt_mask, at::kByte);
  const at::Tensor k64 = repro_torch_op::as(kind, at::kLong, dev);
  const at::Tensor a32 = repro_torch_op::as(area, at::kFloat, dev);
  const auto opts = pop.options().dtype(at::kFloat);
  at::Tensor new_pop = at::empty({B, P, kGenes}, opts), children = at::empty({B, P, kGenes}, opts);
  at::Tensor new_scores = at::empty({B, P}, opts), child_scores = at::empty({B, P}, opts);
  const repro_torch_op::Floats c(consts);
  // the launcher selects the device itself, in its own runtime
  const int rc = ga_gen_step_launch(
      f32[0].data_ptr<float>(), f32[1].data_ptr<float>(), f32[2].data_ptr<float>(),
      t32[0].data_ptr<float>(), t32[1].data_ptr<float>(), t32[2].data_ptr<float>(),
      t32[3].data_ptr<float>(), t32[4].data_ptr<float>(), t32[5].data_ptr<float>(),
      t32[6].data_ptr<float>(), g.data_ptr<float>(), s.data_ptr<int>(),
      vt.data_ptr<uint8_t>(), reinterpret_cast<const long long*>(k64.data_ptr<int64_t>()),
      a32.data_ptr<float>(), new_pop.data_ptr<float>(), new_scores.data_ptr<float>(),
      children.data_ptr<float>(), child_scores.data_ptr<float>(), (int)B, (int)P, (int)W,
      gmax, (int)R, (int)C, (int)Bc, (int)Gn, V, Tc, c.v.data(), c.n, index,
      repro_torch_op::stream(index));
  repro_torch_op::check_launch("ga_gen_step", rc, ga_gen_step_error_string);
  return {new_pop, new_scores, children, child_scores};
}

}  // namespace

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) { m.impl("ga_gen_step", &ga_gen_step); }
