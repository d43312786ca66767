// ga_gen_step: one WHOLE generation of the table-backend GA for B
// independent searches in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ga_gen_step/kernel.py
// (_gen_kernel, launched by ga_gen_step_pallas).  Plain version: the port's
// table-backend generation step, repro_torch/kernels/ga_gen_step/ref.py.
//
// Layout: one block per search, grid (B,): a generation is a dependent
// chain inside one search.  The block keeps in dynamic shared memory the
// population and its children, both generations' scores and survival
// keys, its own search's tables (so searches over different workload sets
// share a launch) and the small lookups (the 9 decode grids, their sizes,
// the (V, Tc) validity mask).  Inside the block, in order, separated by
// __syncthreads():
//   0. stage all of the above with cp.async, all copies in flight at once;
//      each thread meanwhile loads the uniforms of its first phase-1 item
//      into registers, so the block waits on device memory once;
//   1. tournament + SBX + polynomial mutation in one pass, one thread per
//      (pair, gene): the thread recomputes its pair's two tournament picks,
//      crosses, and mutates both child rows (the second only below P: odd
//      P drops the last row);
//   2. decode + table cost model + indexed objective, one thread per child
//      (its max over W taken in workload order); table lookups are plain indexed loads from shared memory (the TPU
//      used one-hot matmuls; both are exact);
//   3. (mu + lambda) survival over the unique keys (total-order int32
//      score, index as tiebreak): for 2P <= kRankMax a candidate's place is
//      the number of keys below its own (one pass, one barrier); above it a
//      bitonic network whose stages with j < 32 run in registers with warp
//      shuffles and no barrier.  Unique keys mean both give the plain
//      version's permutation.
// Only the new population, its scores and the history row are written.
//
// Bound: a few KB in and out per search and ~1e3 float operations per
// child, so at the GA's sizes the kernel is bound by latency: the chain of
// device-memory round trips and barriers.  The design keeps one round trip
// and 4 barriers at P = 40 (a phase per operator with a bitonic sort took
// ~5 round trips and 33 barriers) and the whole generation in one launch
// instead of the plain version's ~60.
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

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGenes = 9;
constexpr int kRankMax = 256;  // most candidates (2P) ranked by counting
constexpr int kMaxDevices = 64;
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
  int P, W, gmax, R, C, Bc, Gn, V, Tc;
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

// keys held for survival: 2P when ranked by counting, else the bitonic
// network's power of two
__host__ __device__ inline int n_keys(int P) {
  if (2 * P <= kRankMax) return 2 * P;
  int n = 1;
  while (n < 2 * P) n <<= 1;
  return n;
}

// dynamic shared memory carve-up, in 4-byte words; every section starts on
// 16 bytes for cp.async and int4 reads
struct Layout {
  int pop, child, alls, key, idx, dem, dac, spill, sums, grids, sizes, vt;
  int total;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  const int P = d.P, W = d.W;
  Layout s;
  int o = 0;
  s.pop = o;   o += up4(P * kGenes);
  s.child = o; o += up4(P * kGenes);
  s.alls = o;  o += up4(2 * P);  // [scores | child scores]
  s.key = o;   o += up4(n_keys(P));
  s.idx = o;   o += up4(n_keys(P));
  s.dem = o;   o += up4(W * d.R * d.C * d.Bc);
  s.dac = o;   o += up4(W * d.C * d.Bc);
  s.spill = o; o += up4(W * d.Gn);
  s.sums = o;  o += up4(4 * W);  // sum_m, sum_bytes, sum_mkng, sum_mng
  s.grids = o; o += up4(kGenes * d.gmax);
  s.sizes = o; o += up4(kGenes);
  s.vt = o;    o += up4((d.V * d.Tc + 3) / 4);
  s.total = o;
  return s;
}

// ---- staging: cp.async global -> shared, 16 bytes where both sides allow
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n 4-byte words
__device__ __forceinline__ void stage(void* dst, const void* src, int n, int tid) {
  uint32_t* d = static_cast<uint32_t*>(dst);
  const uint32_t* s = static_cast<const uint32_t*>(src);
  int done = 0;
  if ((((uintptr_t)s | (uintptr_t)d) & 15) == 0) {
    const int n4 = n / 4;
    for (int i = tid; i < n4; i += kThreads) cp_async16(d + 4 * i, s + 4 * i);
    done = 4 * n4;
  }
  for (int i = done + tid; i < n; i += kThreads) cp_async4(d + i, s + i);
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

// core/ga.py:order_keys: total-order int32 of a float32 score
__device__ __forceinline__ int order_key(float s) {
  const int bits = __float_as_int(s);
  return bits < 0 ? -(bits & 0x7FFFFFFF) : bits;
}

// offsets into one generation's uniform block (core/ga.py:block_layout)
struct Block {
  int P, n_pairs, n_contest, o_t, o_u, o_p, o_g, o_mu, tot;
};

__device__ __forceinline__ Block block_layout(int P) {
  Block k;
  k.P = P;
  k.n_pairs = (P + 1) / 2;
  k.n_contest = 2 * k.n_pairs;
  k.o_t = 2 * k.n_contest;
  k.o_u = k.o_t + k.n_pairs * kGenes;
  k.o_p = k.o_u + k.n_pairs;
  k.o_g = k.o_p + k.n_pairs * kGenes;
  k.o_mu = k.o_g + P * kGenes;
  k.tot = k.o_mu + P * kGenes;
  return k;
}

// the uniforms of one phase-1 item e = (pair i, gene j)
struct ItemU {
  float a1, b1, a2, b2;  // contestants of contests i and n_pairs + i
  float ub, pair, gene;  // SBX spread, per-pair and per-gene gates
  float um1, mu1;        // mutation of child row i
  float um2, mu2;        // mutation of child row n_pairs + i (if below P)
};

__device__ __forceinline__ ItemU load_item_u(const float* __restrict__ u,
                                             const Block& k, int e) {
  const int i = e / kGenes;
  const int e2 = e + k.n_pairs * kGenes;
  ItemU r;
  r.a1 = __ldg(u + i);
  r.b1 = __ldg(u + k.n_contest + i);
  r.a2 = __ldg(u + k.n_pairs + i);
  r.b2 = __ldg(u + k.n_contest + k.n_pairs + i);
  r.ub = __ldg(u + k.o_t + e);
  r.pair = __ldg(u + k.o_u + i);
  r.gene = __ldg(u + k.o_p + e);
  r.um1 = __ldg(u + k.o_g + e);
  r.mu1 = __ldg(u + k.o_mu + e);
  const bool row2 = e2 < k.P * kGenes;
  r.um2 = row2 ? __ldg(u + k.o_g + e2) : 0.0f;
  r.mu2 = row2 ? __ldg(u + k.o_mu + e2) : 0.0f;
  return r;
}

// binary tournament; an index that rounds up to P takes P - 1
__device__ __forceinline__ int pick(float ua, float ub, int P, const float* s_scores) {
  const int a = min((int)(ua * (float)P), P - 1);
  const int b = min((int)(ub * (float)P), P - 1);
  return (s_scores[a] <= s_scores[b]) ? a : b;
}

// polynomial mutation of one gene
__device__ __forceinline__ float mutate(float x, float um, float gate, const Consts& c) {
  const float lo = x;
  const float hi = 1.0f - x;
  const float d1 = pow_recip_eta1(
      2.0f * um + (1.0f - 2.0f * um) * pow_eta1(1.0f - lo)) - 1.0f;
  const float d2 = 1.0f - pow_recip_eta1(
      2.0f * (1.0f - um) + (2.0f * um - 1.0f) * pow_eta1(1.0f - hi));
  const float delta = (um <= 0.5f) ? d1 : d2;
  const bool on = gate < c.v[kMutProb];
  return clamp_gene(on ? x + delta : x, c.v[kGeneMax]);
}

// a decoded child and its design-global terms
struct Child {
  float t_cyc, gpc, capacity, cpw, e_cell, area;
  int fi, fj, glb;
  bool valid;
};

struct Tabs {
  const float *dem, *dac, *spill, *sums;
  int W, RCB, CB, Gn;
};

__device__ __forceinline__ Child decode(const float* genes, const float* s_grids,
                                        const int* s_sizes, const uint8_t* s_vt,
                                        const Dims& dm, const Consts& c) {
  int ix[kGenes];
  float d[kGenes];
#pragma unroll
  for (int j = 0; j < kGenes; ++j) {
    const int nj = s_sizes[j];
    int k = (int)(genes[j] * (float)nj);
    k = min(max(k, 0), nj - 1);
    ix[j] = k;
    d[j] = s_grids[j * dm.gmax + k];
  }
  const float rows = d[kRows], cols = d[kCols], cpt = d[kCpt];
  const float tpr = d[kTpr], gpc = d[kGpc], v_op = d[kVop];
  const float bits = d[kBits], t_cyc = d[kTcyc], glb = d[kGlb];

  Child ch;
  ch.t_cyc = t_cyc;
  ch.gpc = gpc;
  ch.capacity = gpc * tpr * cpt;
  ch.cpw = ceilf(c.v[kWeightBits] / bits);
  ch.e_cell = v_op * v_op * c.v[kGAvg] * t_cyc * c.v[kMilli];
  // area_mm2
  const float n_tiles = gpc * tpr;
  const float n_xbars = n_tiles * cpt;
  const float xbar = rows * cols * c.v[kCellArea] + rows * c.v[kDriverArea] +
                     (cols / c.v[kAdcShare]) * c.v[kAdcArea];
  ch.area = (n_xbars * xbar + n_tiles * c.v[kTileBuf] +
             gpc * c.v[kRouterArea] + glb * c.v[kSramArea]) *
            c.v[kOverhead];
  ch.valid = s_vt[ix[kVop] * dm.Tc + ix[kTcyc]] != 0;
  ch.fi = (ix[kRows] * dm.C + ix[kCols]) * dm.Bc + ix[kBits];
  ch.fj = ix[kCols] * dm.Bc + ix[kBits];
  ch.glb = ix[kGlb];
  return ch;
}

// the table cost model of one child on workload w
__device__ __forceinline__ void cost(const Child& ch, const Tabs& t, int w,
                                     const Consts& c, float& energy,
                                     float& latency, bool& fits) {
  const float demand = t.dem[w * t.RCB + ch.fi];
  const float dac = t.dac[w * t.CB + ch.fj];
  const float spill = t.spill[w * t.Gn + ch.glb];
  const float sum_m = t.sums[0 * t.W + w];
  const float sum_bytes = t.sums[1 * t.W + w];
  const float sum_mkng = t.sums[2 * t.W + w];
  const float sum_mng = t.sums[3 * t.W + w];
  fits = demand <= ch.capacity;
  const float phases = c.v[kPhases];

  const float l_comp = sum_m * c.v[kCycPerVec] * ch.t_cyc;
  const float l_comm = sum_bytes / (ch.gpc * c.v[kFlit]) * ch.t_cyc;
  const float l_dram = spill / c.v[kDramBw];
  latency = l_comp + l_comm + l_dram;

  const float e_analog = sum_mkng * phases * ch.cpw * ch.e_cell;
  const float e_adc = sum_mng * phases * ch.cpw * c.v[kAdcE];
  const float e_dac = dac * phases * c.v[kDacE];
  const float e_route = sum_bytes * c.v[kRouterE];
  const float e_buf = sum_bytes * c.v[kBufE];
  const float e_dram = spill * c.v[kDramE];
  const float e_leak = c.v[kLeak] * ch.area * latency;
  energy = e_analog + e_adc + e_dac + e_route + e_buf + e_dram + e_leak;
}

// the indexed objective; infeasible designs score +inf
__device__ __forceinline__ float objective(long long kind, float e_max, float l_max,
                                           float area, bool fits, bool valid,
                                           float area_c) {
  const float s = kind == 0 ? e_max * l_max * area
                : kind == 1 ? e_max * l_max
                : kind == 2 ? e_max : l_max;
  return (fits && valid && (area <= area_c)) ? s : INFINITY;
}

// one compare-exchange of a bitonic stage between lanes i and i ^ j of a
// warp (j < 32), ascending on (key, index) where (i & k) == 0
__device__ __forceinline__ void exchange(int& key, int& idx, int i, int j, int k) {
  const int ok = __shfl_xor_sync(0xffffffffu, key, j);
  const int oi = __shfl_xor_sync(0xffffffffu, idx, j);
  const bool lower = (i & j) == 0;
  const bool ascending = (i & k) == 0;
  const bool mine_gt = key > ok || (key == ok && idx > oi);
  if ((lower == ascending) == mine_gt) {
    key = ok;
    idx = oi;
  }
}

// bitonic stages j = 16 .. 1 of merge width k on every element, in
// registers (k <= 32 runs every merge of width up to k)
__device__ __forceinline__ void warp_stages(int* s_key, int* s_idx, int N, int k) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < N / 32; g += kWarps) {
    const int i = g * 32 + lane;
    int key = s_key[i], idx = s_idx[i];
    for (int kk = k <= 32 ? 2 : k; kk <= k; kk <<= 1)
      for (int j = min(kk, 32) >> 1; j > 0; j >>= 1) exchange(key, idx, i, j, kk);
    s_key[i] = key;
    s_idx[i] = idx;
  }
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
    const long long* __restrict__ kind_g, // (B,)
    const float* __restrict__ area_g,     // (B,)
    float* __restrict__ new_pop_g,        // (B, P, 9)
    float* __restrict__ new_scores_g,     // (B, P)
    float* __restrict__ children_g,       // (B, P, 9)
    float* __restrict__ child_scores_g,   // (B, P)
    Dims dm, Consts c) {
  extern __shared__ __align__(16) float smem[];
  const int P = dm.P, W = dm.W;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const Block blk = block_layout(P);
  const int n_items = blk.n_pairs * kGenes;
  const int N = n_keys(P);
  const int RCB = dm.R * dm.C * dm.Bc;
  const int CB = dm.C * dm.Bc;

  const Layout lay = make_layout(dm);
  float* s_pop = smem + lay.pop;
  float* s_child = smem + lay.child;
  float* s_alls = smem + lay.alls;
  int* s_key = reinterpret_cast<int*>(smem + lay.key);
  int* s_idx = reinterpret_cast<int*>(smem + lay.idx);
  float* s_grids = smem + lay.grids;
  int* s_sizes = reinterpret_cast<int*>(smem + lay.sizes);
  uint8_t* s_vt = reinterpret_cast<uint8_t*>(smem + lay.vt);
  const Tabs tabs{smem + lay.dem, smem + lay.dac, smem + lay.spill, smem + lay.sums,
                  W, RCB, CB, dm.Gn};
  const float* u = u_g + (size_t)b * blk.tot;

  // ---- 0. stage everything the block reads more than once; the loads
  // into registers go first, so that nothing waits on another round trip
  const long long kind = kind_g[b];
  const float area_c = area_g[b];
  ItemU next = {};
  if (tid < n_items) next = load_item_u(u, blk, tid);
  stage(s_pop, pop_g + (size_t)b * P * kGenes, P * kGenes, tid);
  stage(s_alls, scores_g + (size_t)b * P, P, tid);
  stage(smem + lay.dem, demand_g + (size_t)b * W * RCB, W * RCB, tid);
  stage(smem + lay.dac, dac_g + (size_t)b * W * CB, W * CB, tid);
  stage(smem + lay.spill, spill_g + (size_t)b * W * dm.Gn, W * dm.Gn, tid);
  stage(smem + lay.sums + 0 * W, sum_m_g + (size_t)b * W, W, tid);
  stage(smem + lay.sums + 1 * W, sum_bytes_g + (size_t)b * W, W, tid);
  stage(smem + lay.sums + 2 * W, sum_mkng_g + (size_t)b * W, W, tid);
  stage(smem + lay.sums + 3 * W, sum_mng_g + (size_t)b * W, W, tid);
  stage(s_grids, grids_g, kGenes * dm.gmax, tid);
  stage(s_sizes, sizes_g, kGenes, tid);
  for (int i = tid; i < dm.V * dm.Tc; i += kThreads) s_vt[i] = vt_g[i];
  cp_async_wait_all();
  __syncthreads();

  // ---- 1. tournament + SBX + mutation, one thread per (pair, gene); the
  // parents' survival keys and the sort's pads on the side
  for (int i = tid; i < N; i += kThreads) {
    s_key[i] = i < P ? order_key(s_alls[i]) : INT_MAX;
    s_idx[i] = i;
  }
  for (int i = N + tid; i < up4(N); i += kThreads) s_key[i] = INT_MAX;
  for (int e = tid; e < n_items; e += kThreads) {
    const ItemU cu = next;
    if (e + kThreads < n_items) next = load_item_u(u, blk, e + kThreads);
    const int i = e / kGenes, j = e - i * kGenes;
    const float p1 = s_pop[pick(cu.a1, cu.b1, P, s_alls) * kGenes + j];
    const float p2 = s_pop[pick(cu.a2, cu.b2, P, s_alls) * kGenes + j];
    const float beta = (cu.ub <= 0.5f)
        ? pow_recip_eta1(2.0f * cu.ub)
        : pow_recip_eta1(1.0f / (2.0f * (1.0f - cu.ub)));
    const float c1 = 0.5f * ((1.0f + beta) * p1 + (1.0f - beta) * p2);
    const float c2 = 0.5f * ((1.0f - beta) * p1 + (1.0f + beta) * p2);
    const bool use = (cu.pair < c.v[kSbxProb]) && (cu.gene < 0.5f);
    const float gene_max = c.v[kGeneMax];
    const float y1 = mutate(clamp_gene(use ? c1 : p1, gene_max), cu.um1, cu.mu1, c);
    s_child[e] = y1;
    children_g[(size_t)b * P * kGenes + e] = y1;
    const int e2 = e + blk.n_pairs * kGenes;  // child row n_pairs + i
    if (e2 < P * kGenes) {
      const float y2 = mutate(clamp_gene(use ? c2 : p2, gene_max), cu.um2, cu.mu2, c);
      s_child[e2] = y2;
      children_g[(size_t)b * P * kGenes + e2] = y2;
    }
  }
  __syncthreads();

  // ---- 2. decode, table cost model, indexed objective
  for (int p = tid; p < P; p += kThreads) {
    const Child ch = decode(s_child + p * kGenes, s_grids, s_sizes, s_vt, dm, c);
    bool fits = true;
    float e_max = 0.0f, l_max = 0.0f;
    for (int w = 0; w < W; ++w) {
      float energy, latency;
      bool fw;
      cost(ch, tabs, w, c, energy, latency, fw);
      fits = fits && fw;
      e_max = w == 0 ? energy : nan_max(e_max, energy);
      l_max = w == 0 ? latency : nan_max(l_max, latency);
    }
    const float score = objective(kind, e_max, l_max, ch.area, fits, ch.valid, area_c);
    s_alls[P + p] = score;
    s_key[P + p] = order_key(score);
    child_scores_g[(size_t)b * P + p] = score;
  }
  __syncthreads();

  // ---- 3. survival: ascending on the unique (key, index)
  if (2 * P <= kRankMax) {
    // rank by counting; keys past 2P read INT_MAX and never count
    const int4* k4 = reinterpret_cast<const int4*>(s_key);
    for (int i = tid; i < N; i += kThreads) {
      const int ki = s_key[i];
      int r = 0;
      for (int q = 0; q < up4(N) / 4; ++q) {
        const int4 k = k4[q];
        const int j = 4 * q;
        r += (k.x < ki) | ((k.x == ki) & (j < i));
        r += (k.y < ki) | ((k.y == ki) & (j + 1 < i));
        r += (k.z < ki) | ((k.z == ki) & (j + 2 < i));
        r += (k.w < ki) | ((k.w == ki) & (j + 3 < i));
      }
      s_idx[r] = i;
    }
    __syncthreads();
  } else {
    // bitonic network; the pads (INT_MAX, index >= 2P) sort last
    warp_stages(s_key, s_idx, N, 32);
    __syncthreads();
    for (int k = 64; k <= N; k <<= 1) {
      for (int j = k >> 1; j >= 32; j >>= 1) {
        for (int t = tid; t < N / 2; t += kThreads) {
          const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit j clear
          const int l = i | j;
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
        __syncthreads();
      }
      warp_stages(s_key, s_idx, N, k);
      __syncthreads();
    }
  }

  // ---- 4. survivors
  for (int e = tid; e < P * kGenes; e += kThreads) {
    const int p = e / kGenes, j = e - p * kGenes;
    const int src = s_idx[p];
    new_pop_g[(size_t)b * P * kGenes + e] =
        src < P ? s_pop[src * kGenes + j] : s_child[(src - P) * kGenes + j];
  }
  for (int p = tid; p < P; p += kThreads)
    new_scores_g[(size_t)b * P + p] = s_alls[s_idx[p]];
}

// the kernel's dynamic shared memory opt-in, raised (never lowered) per
// device; the opt-in limit, queried once per device
std::mutex g_smem_mu;
int g_smem_set[kMaxDevices];
int g_smem_optin[kMaxDevices];

cudaError_t ensure_smem(int device, long long smem) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_smem_mu);
  if (g_smem_optin[device] == 0) {
    int optin = 0;
    const cudaError_t err =
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    g_smem_optin[device] = optin;
  }
  if (smem > g_smem_optin[device]) return cudaErrorInvalidConfiguration;
  if (smem > g_smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ga_gen_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    g_smem_set[device] = (int)smem;
  }
  return cudaSuccess;
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

// Dynamic shared memory the launch needs, in bytes (0 when P < 1).
extern "C" long long ga_gen_step_smem_bytes(int P, int W, int gmax, int R, int C,
                                            int Bc, int Gn, int V, int Tc) {
  if (P < 1) return 0;
  return 4LL * make_layout(Dims{P, W, gmax, R, C, Bc, Gn, V, Tc}).total;
}

// Most candidates (2P) that survival ranks by counting; above, bitonic.
extern "C" int ga_gen_step_rank_max() { return kRankMax; }

extern "C" int ga_gen_step_launch(
    const float* pop, const float* scores, const float* u,
    const float* demand, const float* dac, const float* spill,
    const float* sum_m, const float* sum_bytes, const float* sum_mkng,
    const float* sum_mng, const float* grids, const int* sizes,
    const uint8_t* vt_mask, const long long* kind, const float* area,
    float* new_pop, float* new_scores, float* children, float* child_scores,
    int B, int P, int W, int gmax, int R, int C, int Bc, int Gn, int V, int Tc,
    const float* consts_host, int n_consts, int device, void* stream) {
  if (n_consts != kNumConsts) return (int)cudaErrorInvalidValue;
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  const Dims dm{P, W, gmax, R, C, Bc, Gn, V, Tc};
  const long long smem = 4LL * make_layout(dm).total;
  const DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const cudaError_t err = ensure_smem(device, smem);
  if (err != cudaSuccess) return (int)err;
  Consts c;
  for (int i = 0; i < kNumConsts; ++i) c.v[i] = consts_host[i];
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
