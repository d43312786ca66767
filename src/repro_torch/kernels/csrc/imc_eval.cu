// imc_eval: the IMC cost model's layer sums for a population of designs
// against a set of workloads, for B independent searches in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/imc_eval/kernel.py
// (_eval_kernel, launched by imc_eval_pallas_multi).  Plain version:
// repro_torch/kernels/imc_eval/ref.py (eval_workloads).
//
// Layout: kLanes lanes on each (design, workload, search).  A block of
// 256 threads holds kThreads / kLanes designs of one (workload, search),
// grid (ceil(P / designs per block), W, B), and stages that workload's
// layer features and mask in shared memory once per kChunk layers, with
// 16-byte loads.  The sum order is fixed whatever kLanes is: layer l goes
// to partial sum l % 32, each partial adds its layers in order, and the 32
// partials combine in the order of a warp's __shfl_xor_sync butterfly
// (offsets 16, 8, 4, 2, 1).  A lane holds the 32 / kLanes partials of its
// layers in registers, combines them over the butterfly's first steps
// itself and shuffles for the rest, so every lane count gives the same bits
// and a design scores the same in any batch.  The launcher gives each
// design the most lanes (up to a warp) that keep all (design, workload,
// search) triples within one full wave of the card (132 SMs x 2048
// threads), and at least 4: the search's shapes (160-1280 triples) get a
// warp each, each lane walking 2 of 64 layers; a large population (B=16,
// P=4096, W=4) 4 lanes each, which stage a workload once per 64 designs
// instead of once per 8.  (1 or 2 lanes would hold 32 or 16 partials of
// each sum, which ptxas put on the stack.)  (On the TPU the sequential L grid axis accumulated into the
// output block; blocks carry nothing between them here.)  Ragged P and L
// are masked in the kernel; nothing is padded.  Output is (B, W, P) for
// each of the three sums.
//
// Bound: ~40 float operations (4 divisions, 2 ceilings) per (design,
// workload, active layer) against 60 bytes of input per design and 12 per
// (design, workload) of output: bound by operations on paper, but at the
// search's sizes (P = 40, L = 64) by latency.  One thread per design walked
// all 64 layers in one dependent chain on 4-32 blocks; spread over a warp,
// each lane walks 2 layers and the chain is 2 layers plus 5 shuffle steps,
// on 20-160 blocks.
//
// Built with -fmad=false and IEEE division (no fast math): ceil(K/rows)
// and ceil(N*cpw/cols) must see exact quotients (512/128 is 4, not
// 4.0000005), and products stay rounded as PyTorch rounds them.  The sum
// order differs from the plain version's torch.sum (all terms are
// positive; demand sums integers below 2^24 and stays exact).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinLanes = 4;  // 8 partials a lane stay in registers; 16 did not
constexpr int kChunk = 256;   // layers staged in shared memory per pass
constexpr int kGenes = 9;     // FIELDS order of repro_torch/core/space.py
constexpr long long kWave = 132LL * 2048;  // threads of one full wave on an H100

// technology constants, in the order of ops.py:_consts
enum Const {
  kPhases, kWeightBits, kAdcShare, kFlit, kDramBw, kGAvg, kAdcE, kDacE,
  kRouterE, kBufE, kDramE, kNumConsts
};
struct Consts {
  float v[kNumConsts];
};

template <int kLanes>
__global__ void __launch_bounds__(kThreads) imc_eval_kernel(
    const float* __restrict__ designs,  // (B, P, 9)
    const float* __restrict__ feats,    // (B, W, L, 6)
    const uint8_t* __restrict__ mask,   // (B, W, L)
    float* __restrict__ energy,         // (B, W, P)
    float* __restrict__ latency,        // (B, W, P)
    float* __restrict__ demand,         // (B, W, P)
    int P, int W, int L, Consts c) {
  __shared__ __align__(16) float s_feat[kChunk * 6];
  __shared__ uint8_t s_mask[kChunk];
  constexpr int kDesigns = kThreads / kLanes;  // designs per block

  const int lane = threadIdx.x % kLanes;
  const int p = blockIdx.x * kDesigns + threadIdx.x / kLanes;
  const int w = blockIdx.y;
  const int b = blockIdx.z;
  const bool live = p < P;

  // a dead design (ragged P edge) computes on ones and stores nothing, so
  // every lane takes part in the barriers and shuffles
  float rows = 1.f, cols = 1.f, g_chip = 1.f, v_op = 1.f, bits = 1.f;
  float t_cyc = 1.f, glb_mb = 1.f;
  if (live) {
    const float* d = designs + ((size_t)b * P + p) * kGenes;
    rows = __ldg(d + 0);
    cols = __ldg(d + 1);
    g_chip = __ldg(d + 4);
    v_op = __ldg(d + 5);
    bits = __ldg(d + 6);
    t_cyc = __ldg(d + 7);
    glb_mb = __ldg(d + 8);
  }
  const float phases = c.v[kPhases];
  const float cpw = ceilf(c.v[kWeightBits] / bits);
  const float glb_bytes = glb_mb * 1048576.0f;
  const float router_bw = g_chip * c.v[kFlit];
  const float e_cell = v_op * v_op * c.v[kGAvg] * t_cyc * 1e3f;

  constexpr int kParts = 32 / kLanes;  // partial sums a lane holds
  float acc_e[kParts], acc_l[kParts], acc_x[kParts];
#pragma unroll
  for (int q = 0; q < kParts; ++q) acc_e[q] = acc_l[q] = acc_x[q] = 0.f;
  const float* f = feats + ((size_t)b * W + w) * (size_t)L * 6;
  const uint8_t* m = mask + ((size_t)b * W + w) * (size_t)L;
  // kChunk * 6 floats is a multiple of 16 bytes, so every chunk of an
  // aligned workload is aligned
  const bool vec = ((uintptr_t)f & 15) == 0;
  for (int l0 = 0; l0 < L; l0 += kChunk) {
    const int n = min(kChunk, L - l0);
    if (l0 > 0) __syncthreads();  // the previous chunk is consumed
    const float* src = f + (size_t)l0 * 6;
    int done = 0;
    if (vec) {
      const int n4 = n * 6 / 4;
      for (int i = threadIdx.x; i < n4; i += kThreads)
        reinterpret_cast<float4*>(s_feat)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
      done = n4 * 4;
    }
    for (int i = done + threadIdx.x; i < n * 6; i += kThreads) s_feat[i] = __ldg(src + i);
    for (int i = threadIdx.x; i < n; i += kThreads) s_mask[i] = m[l0 + i];
    __syncthreads();
    // kChunk is a multiple of 32: layer i of the chunk goes to partial i % 32
    for (int i32 = 0; i32 < n; i32 += 32) {
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        const int i = i32 + q * kLanes + lane;
        if (i >= n || !s_mask[i]) continue;  // masked layers add exactly nothing
        const float M = s_feat[i * 6 + 0];
        const float K = s_feat[i * 6 + 1];
        const float N = s_feat[i * 6 + 2];
        const float A_in = s_feat[i * 6 + 3];
        const float A_out = s_feat[i * 6 + 4];
        const float G = s_feat[i * 6 + 5];

        const float ncol = ceilf(N * cpw / cols);
        const float nrow = ceilf(K / rows);
        acc_x[q] += nrow * ncol * G;

        const float bytes_l = A_in + A_out;
        const float l_comp = M * phases * c.v[kAdcShare] * t_cyc;
        const float l_comm = bytes_l / router_bw * t_cyc;
        const float spill = fmaxf(bytes_l - glb_bytes, 0.0f);
        const float l_dram = spill / c.v[kDramBw];
        acc_l[q] += l_comp + l_comm + l_dram;

        const float cells = K * (N * cpw) * G;
        const float e_analog = M * phases * cells * e_cell;
        const float e_adc = M * phases * (N * cpw) * G * c.v[kAdcE];
        const float e_dac = M * phases * K * ncol * G * c.v[kDacE];
        const float e_route = bytes_l * c.v[kRouterE];
        const float e_buf = bytes_l * c.v[kBufE];
        const float e_dram = spill * c.v[kDramE];
        acc_e[q] += e_analog + e_adc + e_dac + e_route + e_buf + e_dram;
      }
    }
  }
  // the butterfly's steps with offset >= kLanes inside the lane: partial q
  // is layer-lane lane + q * kLanes, its partner at offset h * kLanes is
  // partial q + h (both partners of a step hold the same sum)
#pragma unroll
  for (int h = kParts / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int q = 0; q < h; ++q) {
      acc_e[q] += acc_e[q + h];
      acc_l[q] += acc_l[q + h];
      acc_x[q] += acc_x[q + h];
    }
  }
  // and the rest across the design's lanes: every lane ends with the sums
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    acc_e[0] += __shfl_xor_sync(0xffffffffu, acc_e[0], o);
    acc_l[0] += __shfl_xor_sync(0xffffffffu, acc_l[0], o);
    acc_x[0] += __shfl_xor_sync(0xffffffffu, acc_x[0], o);
  }
  if (live && lane == 0) {
    const size_t o = ((size_t)b * W + w) * P + p;
    energy[o] = acc_e[0];
    latency[o] = acc_l[0];
    demand[o] = acc_x[0];
  }
}

template <int kLanes>
void launch(const float* designs, const float* feats, const uint8_t* mask,
            float* energy, float* latency, float* demand, int B, int P, int W,
            int L, const Consts& c, cudaStream_t stream) {
  constexpr int kDesigns = kThreads / kLanes;
  const dim3 grid((P + kDesigns - 1) / kDesigns, W, B);
  imc_eval_kernel<kLanes><<<grid, kThreads, 0, stream>>>(
      designs, feats, mask, energy, latency, demand, P, W, L, c);
}

// This library carries its own runtime: select the tensors' device in it
// for the launch and give the calling thread's device back afterwards (the
// current context is per thread and shared with PyTorch's runtime).
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = -1;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// Lanes per design for B*W*P (design, workload, search) triples.
extern "C" int imc_eval_lanes(int B, int P, int W) {
  const long long triples = (long long)B * P * W;
  int lanes = 32;
  while (lanes > kMinLanes && triples * lanes > kWave) lanes >>= 1;
  return lanes;
}

extern "C" int imc_eval_launch(const float* designs, const float* feats,
                               const uint8_t* mask, float* energy,
                               float* latency, float* demand, int B, int P,
                               int W, int L, const float* consts_host,
                               int n_consts, int device, void* stream) {
  if (n_consts != kNumConsts) return (int)cudaErrorInvalidValue;
  if (B <= 0 || P <= 0 || W <= 0) return (int)cudaSuccess;
  if (W > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  Consts c;
  for (int i = 0; i < kNumConsts; ++i) c.v[i] = consts_host[i];
  const cudaStream_t st = (cudaStream_t)stream;
  switch (imc_eval_lanes(B, P, W)) {
    case 32: launch<32>(designs, feats, mask, energy, latency, demand, B, P, W, L, c, st); break;
    case 16: launch<16>(designs, feats, mask, energy, latency, demand, B, P, W, L, c, st); break;
    case 8: launch<8>(designs, feats, mask, energy, latency, demand, B, P, W, L, c, st); break;
    default: launch<4>(designs, feats, mask, energy, latency, demand, B, P, W, L, c, st); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* imc_eval_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
