// ga_gen_step: one WHOLE generation of the table-backend GA for B
// independent searches in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ga_gen_step/kernel.py
// (_gen_kernel, launched by ga_gen_step_pallas).  Plain version: the port's
// table-backend generation step, repro_torch/kernels/ga_gen_step/ref.py.
//
// Layout: one block per search, grid (B,).  The block keeps in dynamic
// shared memory the population and the children (2*P*9 floats), both
// generations' scores, the N = next_pow2(2P) survival keys and indices,
// and its own search's tables (W * (R*C*Bc + C*Bc + Gn + 4) floats), so
// searches over different workload sets share a launch.  Inside the block,
// in order, separated by __syncthreads():
//   1. binary tournaments        (one thread per contest)
//   2. SBX                       (one thread per (pair, gene))
//   3. polynomial mutation       (one thread per (child, gene))
//   4. decode + table cost model + indexed objective (one thread per child);
//      table lookups are plain indexed loads (the TPU used one-hot matmuls;
//      both are exact), V/f validity is a lookup in the host-built mask
//   5. (mu + lambda) survival: a bitonic network over the unique
//      (total-order int32 score, index) keys; unique keys mean any correct
//      sort gives the same permutation as the plain version's sort.
// Only the new population, its scores and the history row are written.
//
// Bound: a few KB in and out per search and ~1e3 float operations per
// child, so at the GA's sizes the kernel is bound by latency (the chain of
// dependent phases and barriers), not by bytes or operations; the design
// keeps the whole generation on chip in one launch instead of the plain
// version's ~60 launches.
//
// Bit-exactness with the plain version on the card: every expression below
// is the plain version's, in the same order of operations.  Built with
// -fmad=false (no a*b+c contraction) and IEEE division and square root, so
// each operation rounds as PyTorch's elementwise kernels round it.  The
// constants arrive as float32 values computed on the host exactly as
// PyTorch converts a Python scalar.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGenes = 9;
// FIELDS order of repro_torch/core/space.py
constexpr int kRows = 0, kCols = 1, kCpt = 2, kTpr = 3, kGpc = 4, kVop = 5,
              kBits = 6, kTcyc = 7, kGlb = 8;

// constants, in the order of ops.py:_consts
enum Const {
  kSbxProb, kMutProb, kGeneMax, kPhases, kWeightBits, kCycPerVec, kFlit,
  kDramBw, kGAvg, kAdcE, kDacE, kRouterE, kBufE, kDramE, kCellArea,
  kDriverArea, kAdcShare, kAdcArea, kTileBuf, kRouterArea, kSramArea, kLeak,
  kOverhead, kMilli, kNumConsts
};
struct Consts {
  float v[kNumConsts];
};

struct Dims {
  int P, W, gmax, R, C, Bc, Gn, Tc;
};

int next_pow2(int x) {
  int n = 1;
  while (n < x) n <<= 1;
  return n;
}

// dynamic shared memory carve-up, in 4-byte words
struct Layout {
  int pop, child, alls, key, idx, parents, tab, total;
};

__host__ __device__ Layout make_layout(int P, int N, int W, int tab_w) {
  const int n_pairs = (P + 1) / 2;
  Layout s;
  s.pop = 0;
  s.child = s.pop + P * kGenes;
  s.alls = s.child + 2 * n_pairs * kGenes;
  s.key = s.alls + 2 * P;
  s.idx = s.key + N;
  s.parents = s.idx + N;
  s.tab = s.parents + 2 * n_pairs;
  s.total = s.tab + W * tab_w;
  return s;
}

// torch.clamp: NaN passes through, else min(max(x, lo), hi)
__device__ __forceinline__ float clamp_gene(float x, float hi) {
  if (isnan(x)) return x;
  return fminf(fmaxf(x, 0.0f), hi);
}

__device__ __forceinline__ float pow_recip_eta1(float x) {  // x ** (1/4)
  return sqrtf(sqrtf(x));
}

__device__ __forceinline__ float pow_eta1(float x) {  // x ** 4
  const float x2 = x * x;
  return x2 * x2;
}

// torch.amax: NaN wins
__device__ __forceinline__ float nan_max(float m, float x) {
  return (isnan(x) || x > m) ? x : m;
}

__global__ void __launch_bounds__(kThreads) ga_gen_step_kernel(
    const float* __restrict__ pop_g,      // (B, P, 9)
    const float* __restrict__ scores_g,   // (B, P)
    const float* __restrict__ u_g,        // (B, tot)
    const float* __restrict__ demand_g,   // (B, W, R*C*Bc)
    const float* __restrict__ dac_g,      // (B, W, C*Bc)
    const float* __restrict__ spill_g,    // (B, W, Gn)
    const float* __restrict__ sum_m_g,    // (B, W)
    const float* __restrict__ sum_bytes_g,
    const float* __restrict__ sum_mkng_g,
    const float* __restrict__ sum_mng_g,
    const float* __restrict__ grids_g,    // (9, gmax)
    const int* __restrict__ sizes_g,      // (9,)
    const uint8_t* __restrict__ vt_g,     // (V, Tc)
    const int* __restrict__ kind_g,       // (B,)
    const float* __restrict__ area_g,     // (B,)
    float* __restrict__ new_pop_g,        // (B, P, 9)
    float* __restrict__ new_scores_g,     // (B, P)
    float* __restrict__ children_g,       // (B, P, 9)
    float* __restrict__ child_scores_g,   // (B, P)
    Dims dm, Consts c) {
  extern __shared__ float smem[];
  const int P = dm.P, W = dm.W;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  const int n_pairs = (P + 1) / 2;
  const int n_contest = 2 * n_pairs;
  const int o_t = 2 * n_contest;
  const int o_u = o_t + n_pairs * kGenes;
  const int o_p = o_u + n_pairs;
  const int o_g = o_p + n_pairs * kGenes;
  const int o_mu = o_g + P * kGenes;
  const int tot = o_mu + P * kGenes;

  const int RCB = dm.R * dm.C * dm.Bc;
  const int CB = dm.C * dm.Bc;
  const int tab_w = RCB + CB + dm.Gn + 4;
  int N = 1;
  while (N < 2 * P) N <<= 1;
  const Layout lay = make_layout(P, N, W, tab_w);
  float* s_pop = smem + lay.pop;
  float* s_child = smem + lay.child;
  float* s_alls = smem + lay.alls;  // [scores | child scores]
  int* s_key = reinterpret_cast<int*>(smem + lay.key);
  int* s_idx = reinterpret_cast<int*>(smem + lay.idx);
  int* s_par = reinterpret_cast<int*>(smem + lay.parents);
  float* s_tab = smem + lay.tab;

  const float* u = u_g + (size_t)b * tot;
  const float gene_max = c.v[kGeneMax];

  // ---- 0. stage the population, its scores and this search's tables
  for (int i = tid; i < P * kGenes; i += kThreads)
    s_pop[i] = pop_g[(size_t)b * P * kGenes + i];
  for (int i = tid; i < P; i += kThreads) s_alls[i] = scores_g[(size_t)b * P + i];
  for (int i = tid; i < W * tab_w; i += kThreads) {
    const int w = i / tab_w, j = i % tab_w;
    const size_t bw = (size_t)b * W + w;
    float v;
    if (j < RCB) {
      v = demand_g[bw * RCB + j];
    } else if (j < RCB + CB) {
      v = dac_g[bw * CB + (j - RCB)];
    } else if (j < RCB + CB + dm.Gn) {
      v = spill_g[bw * dm.Gn + (j - RCB - CB)];
    } else {
      const int k = j - RCB - CB - dm.Gn;
      const float* s = k == 0 ? sum_m_g : k == 1 ? sum_bytes_g : k == 2 ? sum_mkng_g : sum_mng_g;
      v = s[bw];
    }
    s_tab[i] = v;
  }
  __syncthreads();

  // ---- 1. binary tournaments; an index that rounds up to P takes P - 1
  for (int i = tid; i < n_contest; i += kThreads) {
    const int a = min((int)(u[i] * (float)P), P - 1);
    const int bb = min((int)(u[n_contest + i] * (float)P), P - 1);
    s_par[i] = (s_alls[a] <= s_alls[bb]) ? a : bb;
  }
  __syncthreads();

  // ---- 2. SBX: pair i makes child rows i and n_pairs + i
  for (int e = tid; e < n_pairs * kGenes; e += kThreads) {
    const int i = e / kGenes, j = e % kGenes;
    const float p1 = s_pop[s_par[i] * kGenes + j];
    const float p2 = s_pop[s_par[n_pairs + i] * kGenes + j];
    const float ub = u[o_t + e];
    const float beta = (ub <= 0.5f)
        ? pow_recip_eta1(2.0f * ub)
        : pow_recip_eta1(1.0f / (2.0f * (1.0f - ub)));
    const float c1 = 0.5f * ((1.0f + beta) * p1 + (1.0f - beta) * p2);
    const float c2 = 0.5f * ((1.0f - beta) * p1 + (1.0f + beta) * p2);
    const bool use = (u[o_u + i] < c.v[kSbxProb]) && (u[o_p + e] < 0.5f);
    s_child[i * kGenes + j] = clamp_gene(use ? c1 : p1, gene_max);
    s_child[(n_pairs + i) * kGenes + j] = clamp_gene(use ? c2 : p2, gene_max);
  }
  __syncthreads();

  // ---- 3. polynomial mutation of child rows [0, P) (odd P drops the last)
  for (int e = tid; e < P * kGenes; e += kThreads) {
    const float x = s_child[e];
    const float um = u[o_g + e];
    const float lo = x;
    const float hi = 1.0f - x;
    const float d1 = pow_recip_eta1(
        2.0f * um + (1.0f - 2.0f * um) * pow_eta1(1.0f - lo)) - 1.0f;
    const float d2 = 1.0f - pow_recip_eta1(
        2.0f * (1.0f - um) + (2.0f * um - 1.0f) * pow_eta1(1.0f - hi));
    const float delta = (um <= 0.5f) ? d1 : d2;
    const bool mutate = u[o_mu + e] < c.v[kMutProb];
    const float y = clamp_gene(mutate ? x + delta : x, gene_max);
    s_child[e] = y;
    children_g[(size_t)b * P * kGenes + e] = y;
  }
  __syncthreads();

  // ---- 4. decode, table cost model, indexed objective
  const int kind = kind_g[b];
  const float area_c = area_g[b];
  const float phases = c.v[kPhases];
  for (int p = tid; p < P; p += kThreads) {
    int ix[kGenes];
    float d[kGenes];
    for (int j = 0; j < kGenes; ++j) {
      const int nj = sizes_g[j];
      int k = (int)(s_child[p * kGenes + j] * (float)nj);
      k = min(max(k, 0), nj - 1);
      ix[j] = k;
      d[j] = grids_g[j * dm.gmax + k];
    }
    const float rows = d[kRows], cols = d[kCols], cpt = d[kCpt];
    const float tpr = d[kTpr], gpc = d[kGpc], v_op = d[kVop];
    const float bits = d[kBits], t_cyc = d[kTcyc], glb = d[kGlb];

    const float capacity = gpc * tpr * cpt;
    const float cpw = ceilf(c.v[kWeightBits] / bits);
    const float e_cell = v_op * v_op * c.v[kGAvg] * t_cyc * c.v[kMilli];

    // area_mm2
    const float n_tiles = gpc * tpr;
    const float n_xbars = n_tiles * cpt;
    const float xbar = rows * cols * c.v[kCellArea] + rows * c.v[kDriverArea] +
                       (cols / c.v[kAdcShare]) * c.v[kAdcArea];
    const float area = (n_xbars * xbar + n_tiles * c.v[kTileBuf] +
                        gpc * c.v[kRouterArea] + glb * c.v[kSramArea]) *
                       c.v[kOverhead];
    const bool valid = vt_g[ix[kVop] * dm.Tc + ix[kTcyc]] != 0;

    const int fi = (ix[kRows] * dm.C + ix[kCols]) * dm.Bc + ix[kBits];
    const int fj = ix[kCols] * dm.Bc + ix[kBits];
    bool fits = true;
    float e_max = 0.0f, l_max = 0.0f;
    for (int w = 0; w < W; ++w) {
      const float* t = s_tab + w * tab_w;
      const float demand = t[fi];
      const float dac = t[RCB + fj];
      const float spill = t[RCB + CB + ix[kGlb]];
      const float sum_m = t[RCB + CB + dm.Gn + 0];
      const float sum_bytes = t[RCB + CB + dm.Gn + 1];
      const float sum_mkng = t[RCB + CB + dm.Gn + 2];
      const float sum_mng = t[RCB + CB + dm.Gn + 3];
      fits = fits && (demand <= capacity);

      const float l_comp = sum_m * c.v[kCycPerVec] * t_cyc;
      const float l_comm = sum_bytes / (gpc * c.v[kFlit]) * t_cyc;
      const float l_dram = spill / c.v[kDramBw];
      const float latency = l_comp + l_comm + l_dram;

      const float e_analog = sum_mkng * phases * cpw * e_cell;
      const float e_adc = sum_mng * phases * cpw * c.v[kAdcE];
      const float e_dac = dac * phases * c.v[kDacE];
      const float e_route = sum_bytes * c.v[kRouterE];
      const float e_buf = sum_bytes * c.v[kBufE];
      const float e_dram = spill * c.v[kDramE];
      const float e_leak = c.v[kLeak] * area * latency;
      const float energy =
          e_analog + e_adc + e_dac + e_route + e_buf + e_dram + e_leak;
      e_max = w == 0 ? energy : nan_max(e_max, energy);
      l_max = w == 0 ? latency : nan_max(l_max, latency);
    }
    const float s = kind == 0 ? e_max * l_max * area
                  : kind == 1 ? e_max * l_max
                  : kind == 2 ? e_max : l_max;
    const bool feasible = fits && valid && (area <= area_c);
    const float score = feasible ? s : INFINITY;
    s_alls[P + p] = score;
    child_scores_g[(size_t)b * P + p] = score;
  }
  __syncthreads();

  // ---- 5. survival keys: total-order int32 of the score, ties by index;
  // the pad keys (INT_MAX, index >= 2P) sort last
  for (int i = tid; i < N; i += kThreads) {
    int key = INT_MAX;
    if (i < 2 * P) {
      const int bits = __float_as_int(s_alls[i]);
      key = bits < 0 ? -(bits & 0x7FFFFFFF) : bits;
    }
    s_key[i] = key;
    s_idx[i] = i;
  }
  __syncthreads();

  // ---- 6. bitonic sort, ascending on (key, index)
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < N; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const int ki = s_key[i], kl = s_key[l];
          const int ii = s_idx[i], il = s_idx[l];
          const bool gt = ki > kl || (ki == kl && ii > il);
          const bool ascending = (i & k) == 0;
          if (gt == ascending) {
            s_key[i] = kl;
            s_key[l] = ki;
            s_idx[i] = il;
            s_idx[l] = ii;
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- 7. survivors
  for (int e = tid; e < P * kGenes; e += kThreads) {
    const int p = e / kGenes, j = e % kGenes;
    const int src = s_idx[p];
    new_pop_g[(size_t)b * P * kGenes + e] =
        src < P ? s_pop[src * kGenes + j] : s_child[(src - P) * kGenes + j];
  }
  for (int p = tid; p < P; p += kThreads)
    new_scores_g[(size_t)b * P + p] = s_alls[s_idx[p]];
}

}  // namespace

// Dynamic shared memory the launch needs, in bytes (0 when P < 1).
extern "C" long long ga_gen_step_smem_bytes(int P, int W, int R, int C,
                                            int Bc, int Gn) {
  if (P < 1) return 0;
  const int tab_w = R * C * Bc + C * Bc + Gn + 4;
  return 4LL * make_layout(P, next_pow2(2 * P), W, tab_w).total;
}

extern "C" int ga_gen_step_launch(
    const float* pop, const float* scores, const float* u,
    const float* demand, const float* dac, const float* spill,
    const float* sum_m, const float* sum_bytes, const float* sum_mkng,
    const float* sum_mng, const float* grids, const int* sizes,
    const uint8_t* vt_mask, const int* kind, const float* area,
    float* new_pop, float* new_scores, float* children, float* child_scores,
    int B, int P, int W, int gmax, int R, int C, int Bc, int Gn, int Tc,
    const float* consts_host, int n_consts, int device, void* stream) {
  if (n_consts != kNumConsts) return (int)cudaErrorInvalidValue;
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  const long long smem = ga_gen_step_smem_bytes(P, W, R, C, Bc, Gn);
  // this library carries its own runtime: select the tensors' device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > optin) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(ga_gen_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Consts c;
  for (int i = 0; i < kNumConsts; ++i) c.v[i] = consts_host[i];
  Dims dm{P, W, gmax, R, C, Bc, Gn, Tc};
  ga_gen_step_kernel<<<B, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      pop, scores, u, demand, dac, spill, sum_m, sum_bytes, sum_mkng, sum_mng,
      grids, sizes, vt_mask, kind, area, new_pop, new_scores, children,
      child_scores, dm, c);
  return (int)cudaGetLastError();
}

extern "C" int ga_gen_step_max_smem_bytes(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return optin;
}

extern "C" const char* ga_gen_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
