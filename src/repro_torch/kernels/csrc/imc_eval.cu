// imc_eval: the IMC cost model's layer sums for a population of designs
// against a set of workloads, for B independent searches in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/imc_eval/kernel.py
// (_eval_kernel, launched by imc_eval_pallas_multi).  Plain version:
// repro_torch/kernels/imc_eval/ref.py (eval_workloads).
//
// Layout: one block per (design tile of 128, workload, search), grid
// (ceil(P/128), W, B), one thread per design.  The block stages its
// workload's layer features and mask in shared memory, kChunk layers at a
// time; each thread keeps energy, latency and crossbar demand in registers
// over ALL layers in one loop (on the TPU the sequential L grid axis
// accumulated into the output block; blocks carry nothing between them
// here, so the loop inside the block takes its place).  The ragged edges of
// P and L are masked in the kernel, so nothing is padded.  Output is
// (B, W, P) for each of the three sums.
//
// Bound: ~40 float operations (4 divisions, 2 ceilings) per (design,
// workload, active layer) against 60 bytes of input per design and 12 per
// (design, workload) of output, so the work is bound by operations (the
// FP32 pipes), not by memory.  The design keeps every operand in registers
// or shared memory; nothing but the first read of a design and the final
// three sums touches device memory.
//
// Built with -fmad=false and IEEE division (no fast math): ceil(K/rows)
// and ceil(N*cpw/cols) must see exact quotients (512/128 is 4, not
// 4.0000005), and products stay rounded as PyTorch rounds them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // designs per block
constexpr int kChunk = 128;    // layers staged in shared memory per pass
constexpr int kGenes = 9;      // FIELDS order of repro_torch/core/space.py

// technology constants, in the order of ops.py:_consts
enum Const {
  kPhases, kWeightBits, kAdcShare, kFlit, kDramBw, kGAvg, kAdcE, kDacE,
  kRouterE, kBufE, kDramE, kNumConsts
};
struct Consts {
  float v[kNumConsts];
};

__global__ void __launch_bounds__(kThreads) imc_eval_kernel(
    const float* __restrict__ designs,  // (B, P, 9)
    const float* __restrict__ feats,    // (B, W, L, 6)
    const uint8_t* __restrict__ mask,   // (B, W, L)
    float* __restrict__ energy,         // (B, W, P)
    float* __restrict__ latency,        // (B, W, P)
    float* __restrict__ demand,         // (B, W, P)
    int P, int W, int L, Consts c) {
  __shared__ float s_feat[kChunk * 6];
  __shared__ uint8_t s_mask[kChunk];

  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int w = blockIdx.y;
  const int b = blockIdx.z;
  const bool live = p < P;

  // a dead lane (ragged P edge) computes on ones and stores nothing
  float rows = 1.f, cols = 1.f, g_chip = 1.f, v_op = 1.f, bits = 1.f;
  float t_cyc = 1.f, glb_mb = 1.f;
  if (live) {
    const float* d = designs + ((size_t)b * P + p) * kGenes;
    rows = d[0];
    cols = d[1];
    g_chip = d[4];
    v_op = d[5];
    bits = d[6];
    t_cyc = d[7];
    glb_mb = d[8];
  }
  const float phases = c.v[kPhases];
  const float cpw = ceilf(c.v[kWeightBits] / bits);
  const float glb_bytes = glb_mb * 1048576.0f;
  const float router_bw = g_chip * c.v[kFlit];
  const float e_cell = v_op * v_op * c.v[kGAvg] * t_cyc * 1e3f;

  float acc_e = 0.f, acc_l = 0.f, acc_x = 0.f;
  const float* f = feats + ((size_t)b * W + w) * (size_t)L * 6;
  const uint8_t* m = mask + ((size_t)b * W + w) * (size_t)L;
  for (int l0 = 0; l0 < L; l0 += kChunk) {
    const int n = min(kChunk, L - l0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n * 6; i += kThreads) s_feat[i] = f[(size_t)l0 * 6 + i];
    for (int i = threadIdx.x; i < n; i += kThreads) s_mask[i] = m[l0 + i];
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (!s_mask[i]) continue;  // masked layers add exactly nothing
      const float M = s_feat[i * 6 + 0];
      const float K = s_feat[i * 6 + 1];
      const float N = s_feat[i * 6 + 2];
      const float A_in = s_feat[i * 6 + 3];
      const float A_out = s_feat[i * 6 + 4];
      const float G = s_feat[i * 6 + 5];

      const float ncol = ceilf(N * cpw / cols);
      const float nrow = ceilf(K / rows);
      acc_x += nrow * ncol * G;

      const float bytes_l = A_in + A_out;
      const float l_comp = M * phases * c.v[kAdcShare] * t_cyc;
      const float l_comm = bytes_l / router_bw * t_cyc;
      const float spill = fmaxf(bytes_l - glb_bytes, 0.0f);
      const float l_dram = spill / c.v[kDramBw];
      acc_l += l_comp + l_comm + l_dram;

      const float cells = K * (N * cpw) * G;
      const float e_analog = M * phases * cells * e_cell;
      const float e_adc = M * phases * (N * cpw) * G * c.v[kAdcE];
      const float e_dac = M * phases * K * ncol * G * c.v[kDacE];
      const float e_route = bytes_l * c.v[kRouterE];
      const float e_buf = bytes_l * c.v[kBufE];
      const float e_dram = spill * c.v[kDramE];
      acc_e += e_analog + e_adc + e_dac + e_route + e_buf + e_dram;
    }
  }
  if (live) {
    const size_t o = ((size_t)b * W + w) * P + p;
    energy[o] = acc_e;
    latency[o] = acc_l;
    demand[o] = acc_x;
  }
}

}  // namespace

extern "C" int imc_eval_launch(const float* designs, const float* feats,
                               const uint8_t* mask, float* energy,
                               float* latency, float* demand, int B, int P,
                               int W, int L, const float* consts_host,
                               int n_consts, int device, void* stream) {
  if (n_consts != kNumConsts) return (int)cudaErrorInvalidValue;
  if (B <= 0 || P <= 0 || W <= 0) return (int)cudaSuccess;
  // this library carries its own runtime: select the tensors' device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (W > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  Consts c;
  for (int i = 0; i < kNumConsts; ++i) c.v[i] = consts_host[i];
  const dim3 grid((P + kThreads - 1) / kThreads, W, B);
  imc_eval_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      designs, feats, mask, energy, latency, demand, P, W, L, c);
  return (int)cudaGetLastError();
}

extern "C" const char* imc_eval_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
