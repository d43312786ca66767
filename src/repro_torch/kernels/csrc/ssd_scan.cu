// ssd_scan: the Mamba-2 SSD chunked scan for one B/C group (G = 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_pallas).  Plain version:
// repro_torch/kernels/ssd_scan/ref.py (ssd_chunked).
//
// Recurrence per (batch, head), scalar decay per head:
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T      h: (N, P)
//   y_t = C_t^T h_t                                  y: (P,)
// computed chunk by chunk (Q <= 128 rows): with cum the inclusive cumsum of
// dt A inside the chunk and total its last entry,
//   y    = (M o C B^T) (x dt) + exp(cum) (C h_in),  M_ij = exp(cum_i - cum_j), j <= i
//   h    = exp(total) h + (B exp(total - cum) dt)^T x
// M is masked before the exp (j > i never reaches expf).  The cumsum of a
// chunk is taken in sequence by one thread, in the order torch.cumsum takes
// a non-innermost dimension, so cum matches the plain version bit for bit.
//
// Mamba-2's own chunk-parallel phases (arXiv:2405.21060 sec. 6), for bf16
// (the serving path) and float32 inputs alike: four kernels launched back
// to back on the caller's stream, the first, third and fourth on a grid of
// (S/Q, H, B) blocks of 256 threads (384 blocks at S=1024, B=1, against 48
// for the first version of this file, one block per head walking the
// chunks in sequence):
//   1. ssd_scan_state_kernel: cum (written out) and the chunk's state
//      contribution s_c = (B o exp(total - cum) dt)^T x, (N, P) float32,
//      into a scratch of (B, H, S/Q, N, P);
//   2. ssd_scan_pass_kernel, grid (N*P/256, H, B): h_c = exp(total_c)
//      h_{c-1} + s_c, sequential over chunks, one thread per state element;
//      writes each chunk's entering state over s_c and the final state once;
//   3. ssd_scan_intra_kernel: the intra-chunk term (M o C B^T)(x dt),
//      float32, into a scratch of y's shape;
//   4. ssd_scan_out_kernel: y = y_intra + (C o exp(cum)) h_in, in y's type.
// Every product runs on the CUDA cores as one fmaf chain per output, in
// the order and association of the plain version (cuBLAS SGEMM's: one chain
// over the contracted index, from 0), with register tiles of 4 x 4 or 8 x 4
// outputs fed by float4 shared-memory loads.  That is what makes y agree
// with the plain version bit for bit, as long as torch's cuBLAS keeps that
// order (chip_smoke.py logs the versions).  mamba2-780m's 48 random-weight
// layers turn the bf16 rounding flips of any other summation order into
// prefill logits beyond the 0.05 that chip_smoke.py allows: the plain path
// itself lies 0.11-0.15 from the plain path with its SSD in float64.
// Tensor-core versions of this scan (mma.sync k-steps, every float32
// operand split into three bf16 terms) held every kernel tolerance and
// were as close to float64 as the plain version, yet missed that check
// whether the intra-chunk term or only the chunk states and C h_in ran on
// the tensor cores (PERF.md has the numbers).
//
// Bound: at mamba2's shapes (N=128, P=64, Q=128, bf16) the chunked
// algorithm does ~190 FLOPs per byte it must move, below the card's ~295
// FLOP/byte bf16 ridge, so the least time is set by the bytes.  These
// kernels run on the float32 CUDA cores (67 TFLOP/s), where the same work
// (~7.4 MFLOP per chunk and head) is bound by operations; the intra-chunk
// scores (the lower triangle of a Q x Q x N product per chunk and head)
// dominate.  They also move more than the bound counts: the chunk states
// are written by phase 1, read and rewritten by phase 2 and read by phase
// 4, and the intra-chunk term is written and read once (12.6 + 12.6 MB at
// S=1024, mostly in L2).
//
// ptxas (sm_90a, -O3, from the build log _build.py keeps beside the
// library), no spills, for both input types; dynamic shared memory per
// block at mamba2's N=128, P=64, Q=128 from the *_smem functions below:
//   ssd_scan_state_kernel: 59 registers, 99,840 bytes;
//   ssd_scan_pass_kernel: 32 registers, none;
//   ssd_scan_intra_kernel: 59 (bf16) or 64 (float32) registers, 166,400
//     (bf16) or 231,936 (float32) bytes, one block per SM;
//   ssd_scan_out_kernel: 64 registers, 100,864 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kChunkThreads = 256;  // 8 warps
constexpr int kMaxQ = 128;          // chunk rows
constexpr int kIB = 32;             // edge of a score block in the intra kernel

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ inline int round32(int v) { return (v + 31) & ~31; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes at p (16-byte aligned) as floats: 8 bf16 or 4 float32
__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h2[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float (&v)[8]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// Visit a (rows x cols) tile whose row r lies at src + r * gstride, as
// floats: fn(r, c, v, k) gets v[0 .. k) = elements (r, c .. c + k).  With
// ``vec`` (16-byte aligned rows, cols a multiple of 16 bytes) from 16-byte
// loads, otherwise one element at a time; a few loads in flight per thread.
template <typename T, typename F>
__device__ __forceinline__ void visit(const T* __restrict__ src, size_t gstride, int rows,
                                      int cols, bool vec, F fn) {
  if (vec) {
    constexpr int W = 16 / sizeof(T);
    const int cpr = cols / W;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
      const int r = e / cpr, c = (e - r * cpr) * W;
      float v[8];
      load16(src + (size_t)r * gstride + c, v);
      fn(r, c, v, W);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      float v[8];
      v[0] = to_f(src[(size_t)r * gstride + c]);
      fn(r, c, v, 1);
    }
  }
}

// v[0 .. k) times scale to dst[0 .. k), as float4 stores when k is 4 or 8
// (dst 16-byte aligned)
__device__ __forceinline__ void put(float* dst, const float* v, int k, float scale = 1.0f) {
  if (k >= 4) {
    for (int t = 0; t < k; t += 4)
      *reinterpret_cast<float4*>(dst + t) =
          make_float4(v[t] * scale, v[t + 1] * scale, v[t + 2] * scale, v[t + 3] * scale);
  } else {
    for (int t = 0; t < k; ++t) dst[t] = v[t] * scale;
  }
}

// zero columns [cols, ld) of rows [0, rows)
__device__ __forceinline__ void zero_pad(float* dst, int ld, int rows, int cols) {
  const int w = ld - cols;
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
    const int r = e / w;
    dst[r * ld + cols + (e - r * w)] = 0.0f;
  }
}

// acc[r][c] = fmaf(a[r], b[c], acc[r][c]) for an 8 x 4 register tile
__device__ __forceinline__ void fma_8x4(float (&acc)[8][4], const float4& a0, const float4& a1,
                                        const float4& b) {
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

// four outputs at dst (16-byte aligned when P % 4 == 0), columns p0.. < P
__device__ __forceinline__ void store4(float* dst, int p0, int P, const float (&v)[4]) {
  if (P % 4 == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int q = 0; q < 4; ++q)
      if (p0 + q < P) dst[q] = v[q];
  }
}
__device__ __forceinline__ void store4(bf16* dst, int p0, int P, const float (&v)[4]) {
  if (P % 4 == 0) {
    const __nv_bfloat162 o0 = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 o1 = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&o0),
                                                *reinterpret_cast<const uint32_t*>(&o1));
  } else {
    for (int q = 0; q < 4; ++q)
      if (p0 + q < P) dst[q] = __float2bfloat16_rn(v[q]);
  }
}

// Phase 1: per (chunk, head, batch), cum (written out) and the chunk's
// state contribution s_c[n][p] = sum_j Bw[j][n] x[j][p], Bw = B (exp(total -
// cum) dt), one fmaf chain over j per element.  A thread owns 8 n x 4 p.
__host__ __device__ inline size_t state_smem(int Q, int N, int P) {
  return sizeof(float) * ((size_t)Q * round8(N) + (size_t)Q * round4(P) + 3 * (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(kChunkThreads) ssd_scan_state_kernel(
    const T* __restrict__ x,       // (B, S, H, P)
    const float* __restrict__ dt,  // (B, S, H)
    const float* __restrict__ A,   // (H,)
    const T* __restrict__ Bm,      // (B, S, N)
    float* __restrict__ states,    // (B, H, nc, N, P) out: s_c
    float* __restrict__ cum_out,   // (B, H, nc, Q) out: cum
    int S, int H, int P, int N, int Q, int vec_x, int vec_b) {
  const int ldw = round8(N), ldx = round4(P);
  extern __shared__ __align__(16) float fsm[];
  float* bw = fsm;              // [Q][ldw]
  float* xs = bw + Q * ldw;     // [Q][ldx]
  float* cum = xs + Q * ldx;    // [Q]
  float* wdt = cum + Q;         // exp(total - cum) dt
  float* dts = wdt + Q;         // [Q]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int s0 = c * Q;
  const int tid = threadIdx.x;
  const size_t x_row = (size_t)H * P;
  const size_t bhc = ((size_t)b * H + h) * nc + c;

  for (int j = tid; j < Q; j += kChunkThreads) dts[j] = dt[((size_t)b * S + s0 + j) * H + h];
  visit(x + ((size_t)b * S + s0) * x_row + (size_t)h * P, x_row, Q, P, vec_x,
        [&](int j, int p, const float* v, int k) { put(xs + j * ldx + p, v, k); });
  zero_pad(xs, ldx, Q, P);
  __syncthreads();
  if (tid == 0) {  // in sequence, as torch.cumsum over a non-innermost dim
    const float a_h = A[h];
    float run = 0.0f;
#pragma unroll 8
    for (int j = 0; j < Q; ++j) {
      run = run + dts[j] * a_h;
      cum[j] = run;
    }
  }
  __syncthreads();
  const float total = cum[Q - 1];
  for (int j = tid; j < Q; j += kChunkThreads) {
    wdt[j] = expf(total - cum[j]) * dts[j];
    cum_out[bhc * Q + j] = cum[j];
  }
  __syncthreads();
  visit(Bm + ((size_t)b * S + s0) * N, N, Q, N, vec_b,
        [&](int j, int n, const float* v, int k) { put(bw + j * ldw + n, v, k, wdt[j]); });
  zero_pad(bw, ldw, Q, N);
  __syncthreads();

  float* st = states + bhc * (size_t)N * P;
  const int npg = ldx / 4;
  for (int it = tid; it < (ldw / 8) * npg; it += kChunkThreads) {
    const int n0 = 8 * (it / npg), p0 = 4 * (it % npg);
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    for (int j = 0; j < Q; ++j)
      fma_8x4(acc, lds4(bw + j * ldw + n0), lds4(bw + j * ldw + n0 + 4), lds4(xs + j * ldx + p0));
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (n0 + r >= N) break;
      store4(st + (size_t)(n0 + r) * P + p0, p0, P, acc[r]);
    }
  }
}

// Phase 2: the state pass over chunks, one thread per (n, p).
__global__ void __launch_bounds__(256) ssd_scan_pass_kernel(
    float* __restrict__ states,     // (B, H, nc, N, P): s_c in, entering state out
    const float* __restrict__ cum,  // (B, H, nc, Q)
    const float* __restrict__ h0,   // (B, H, N, P) or null
    float* __restrict__ h_out,      // (B, H, N, P)
    int H, int nc, int Q, int NP) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NP) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  float hv = h0 ? h0[bh * NP + e] : 0.0f;
  float* st = states + bh * nc * NP + e;
  const float* total = cum + bh * nc * Q + (Q - 1);
  constexpr int kAhead = 4;  // loads in flight before the dependent chain
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float s[kAhead], et[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = min(c0 + k, nc - 1);
      s[k] = st[(size_t)c * NP];
      et[k] = expf(total[(size_t)c * Q]);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k >= nc) break;
      st[(size_t)(c0 + k) * NP] = hv;
      hv = hv * et[k] + s[k];  // two roundings, as torch
    }
  }
  h_out[bh * NP + e] = hv;
}

// Phase 3: the intra-chunk term y_intra = (M o C B^T)(x dt), float32.
// The block builds M o scores for the whole chunk in shared memory, in
// 32 x 32 blocks on and below the diagonal (a thread owns 4 rows x 4
// columns; each score one fmaf chain over n, n read in pairs), then each
// output as one fmaf chain over j; a thread owns 4 p of two row groups,
// 4a.. and the mirror group from the end, so every thread's chains are
// equally long.  B and C rows are staged in their own type at an odd
// number of 32-bit words, so the 32 lanes reading 32 rows hit 32 banks.
template <typename T>
__host__ __device__ inline int intra_ld(int N) {
  int ld = N;
  while ((ld * (int)sizeof(T)) % 8 != 4) ++ld;
  return ld;
}

template <typename T>
__host__ __device__ inline size_t intra_floats_at(int Q, int N) {
  return (sizeof(T) * 2 * (size_t)Q * intra_ld<T>(N) + 15) & ~(size_t)15;
}

template <typename T>
__host__ __device__ inline size_t intra_smem(int Q, int N, int P) {
  const size_t q32 = round32(Q);
  return intra_floats_at<T>(Q, N) +
         sizeof(float) * (q32 * (q32 + 1) + (size_t)Q * round4(P) + 2 * (size_t)Q);
}

// two consecutive elements (p 4-byte aligned for bf16) as floats
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }

template <typename T>
__global__ void __launch_bounds__(kChunkThreads) ssd_scan_intra_kernel(
    const T* __restrict__ x,          // (B, S, H, P)
    const float* __restrict__ dt,     // (B, S, H)
    const T* __restrict__ Bm,         // (B, S, N)
    const T* __restrict__ Cm,         // (B, S, N)
    const float* __restrict__ cum_g,  // (B, H, nc, Q)
    float* __restrict__ y_intra,      // (B, S, H, P) out
    int S, int H, int P, int N, int Q, int vec_x, int vec_b) {
  const int ld = intra_ld<T>(N), ldx = round4(P), q32 = round32(Q), ldm = q32 + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = (T*)smem_raw;  // [Q][ld]
  T* bs = cs + Q * ld;   // [Q][ld]
  float* mg = (float*)(smem_raw + intra_floats_at<T>(Q, N));  // [q32][ldm]: M o scores
  float* xdt = mg + q32 * ldm;                                // [Q][ldx]: x dt
  float* cum = xdt + Q * ldx;                                 // [Q]
  float* dts = cum + Q;                                       // [Q]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int s0 = c * Q;
  const int tid = threadIdx.x;
  const size_t x_row = (size_t)H * P;
  const size_t bhc = ((size_t)b * H + h) * nc + c;

  const auto to_rows = [&](T* dst) {  // exact: the values came from T
    return [=](int j, int n, const float* v, int k) {
      for (int t = 0; t < k; ++t) dst[j * ld + n + t] = from_f<T>(v[t]);
    };
  };
  visit(Cm + ((size_t)b * S + s0) * N, N, Q, N, vec_b, to_rows(cs));
  visit(Bm + ((size_t)b * S + s0) * N, N, Q, N, vec_b, to_rows(bs));
  for (int j = tid; j < Q; j += kChunkThreads) {
    dts[j] = dt[((size_t)b * S + s0 + j) * H + h];
    cum[j] = cum_g[bhc * Q + j];
  }
  __syncthreads();
  visit(x + ((size_t)b * S + s0) * x_row + (size_t)h * P, x_row, Q, P, vec_x,
        [&](int j, int p, const float* v, int k) { put(xdt + j * ldx + p, v, k, dts[j]); });
  zero_pad(xdt, ldx, Q, P);

  // M o scores, block (bi, bj), bj <= bi; thread (tr, tc) of a 64-thread
  // unit: rows 4 tr + a, columns tc + 8 k
  const int qb = q32 / kIB, units = kChunkThreads / 64;
  const int unit = tid >> 6, tr = (tid & 63) >> 3, tc = tid & 7;
  const int n2 = N & ~1;
  for (int q = unit; q < qb * (qb + 1) / 2; q += units) {
    int bi = 0;
    while ((bi + 1) * (bi + 2) / 2 <= q) ++bi;
    const int bj = q - bi * (bi + 1) / 2;
    int ro[4], co[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ro[a] = min(kIB * bi + 4 * tr + a, Q - 1) * ld;
      co[a] = min(kIB * bj + tc + 8 * a, Q - 1) * ld;
    }
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[a][k] = 0.0f;
    for (int n = 0; n < n2; n += 2) {  // each chain n = 0, 1, 2, ... in order
      float2 cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        cv[a] = load2(cs + ro[a] + n);
        bv[a] = load2(bs + co[a] + n);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[a][k] = fmaf(cv[a].x, bv[k].x, acc[a][k]);
          acc[a][k] = fmaf(cv[a].y, bv[k].y, acc[a][k]);
        }
    }
    if (n2 < N) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[a][k] = fmaf(to_f(cs[ro[a] + n2]), to_f(bs[co[k] + n2]), acc[a][k]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = kIB * bi + 4 * tr + a;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = kIB * bj + tc + 8 * k;
        mg[i * ldm + j] = (i < Q && j <= i) ? expf(cum[i] - cum[j]) * acc[a][k] : 0.0f;
      }
    }
  }
  __syncthreads();

  const int ng = (Q + 3) / 4, npg = ldx / 4;
  for (int it = tid; it < ((ng + 1) / 2) * npg; it += kChunkThreads) {
    const int a = it / npg, p0 = 4 * (it % npg);
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int grp = half ? ng - 1 - a : a;
      if (half && grp == a) break;
      const int r0 = 4 * grp;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;
      // j past a row's own i meets M = 0, which leaves its chain unchanged
      const int jn = min(r0 + 4, Q);
      for (int j = 0; j < jn; ++j) {
        const float4 xv = lds4(xdt + j * ldx + p0);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float m = mg[(r0 + r) * ldm + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(m, xa[k], acc[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + r;
        if (i >= Q) break;
        store4(y_intra + ((size_t)b * S + s0 + i) * x_row + (size_t)h * P + p0, p0, P, acc[r]);
      }
    }
  }
}

// Phase 4: y = y_intra + (C o exp(cum)) h_in, one fmaf chain over n per
// output, rounded to y's type.  C o exp(cum) is staged transposed, so a
// thread's 8 rows are two float4 loads; a thread owns 8 i x 4 p.
__host__ __device__ inline size_t out_smem(int Q, int N, int P) {
  return sizeof(float) * ((size_t)N * (round8(Q) + 4) + (size_t)N * round4(P) + (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(kChunkThreads) ssd_scan_out_kernel(
    const T* __restrict__ Cm,           // (B, S, N)
    const float* __restrict__ h_in,     // (B, H, nc, N, P) entering states
    const float* __restrict__ cum_g,    // (B, H, nc, Q)
    const float* __restrict__ y_intra,  // (B, S, H, P)
    T* __restrict__ y,                  // (B, S, H, P)
    int S, int H, int P, int N, int Q, int vec_b) {
  const int ldq = round8(Q) + 4, ldx = round4(P);
  extern __shared__ __align__(16) float fsm[];
  float* ce = fsm;             // [N][ldq]: C[i][n] exp(cum_i)
  float* hs = ce + N * ldq;    // [N][ldx]
  float* ecum = hs + N * ldx;  // [Q]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int s0 = c * Q;
  const int tid = threadIdx.x;
  const size_t x_row = (size_t)H * P;
  const size_t bhc = ((size_t)b * H + h) * nc + c;

  for (int j = tid; j < Q; j += kChunkThreads) ecum[j] = expf(cum_g[bhc * Q + j]);
  const float* hc = h_in + bhc * (size_t)N * P;
  if (P % 4 == 0) {  // h_in is one contiguous (N, P) block
#pragma unroll 4
    for (int e = tid; e < N * P / 4; e += kChunkThreads)
      *reinterpret_cast<float4*>(hs + 4 * e) = *reinterpret_cast<const float4*>(hc + 4 * e);
  } else {
    for (int e = tid; e < N * ldx; e += kChunkThreads) {
      const int n = e / ldx, p = e - n * ldx;
      hs[e] = p < P ? hc[(size_t)n * P + p] : 0.0f;
    }
  }
  __syncthreads();
  // C o exp(cum), transposed: ce[n][i]; columns i >= Q are zero
  visit(Cm + ((size_t)b * S + s0) * N, N, Q, N, vec_b, [&](int i, int n, const float* v, int k) {
    for (int t = 0; t < k; ++t) ce[(n + t) * ldq + i] = v[t] * ecum[i];
  });
  zero_pad(ce, ldq, N, Q);
  __syncthreads();

  const int npg = ldx / 4;
  for (int it = tid; it < (round8(Q) / 8) * npg; it += kChunkThreads) {
    const int i0 = 8 * (it / npg), p0 = 4 * (it % npg);
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    for (int n = 0; n < N; ++n)
      fma_8x4(acc, lds4(ce + n * ldq + i0), lds4(ce + n * ldq + i0 + 4), lds4(hs + n * ldx + p0));
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + r;
      if (i >= Q) break;
      const size_t at = ((size_t)b * S + s0 + i) * x_row + (size_t)h * P + p0;
      float out[4];
      if (P % 4 == 0) {
        const float4 yi = lds4(y_intra + at);  // 16-byte aligned global row
        out[0] = yi.x + acc[r][0];
        out[1] = yi.y + acc[r][1];
        out[2] = yi.z + acc[r][2];
        out[3] = yi.w + acc[r][3];
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = p0 + q < P ? y_intra[at + q] + acc[r][q] : 0.0f;
      }
      store4(y + at, p0, P, out);
    }
  }
}

// Raise a kernel's dynamic shared memory opt-in to ``bytes`` unless it is
// already at least that (``configured`` records it).
int set_smem(const void* kernel, size_t bytes, size_t& configured) {
  if (bytes <= configured) return (int)cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) configured = bytes;
  return (int)e;
}

template <typename T>
size_t smem_bytes(int N, int P, int Q) {
  size_t most = state_smem(Q, N, P);
  if (intra_smem<T>(Q, N, P) > most) most = intra_smem<T>(Q, N, P);
  if (out_smem(Q, N, P) > most) most = out_smem(Q, N, P);
  return most;
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* h0, void* y, float* h_out, float* states, float* cum, float* y_intra,
           int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t s1 = state_smem(Q, N, P), s3 = intra_smem<T>(Q, N, P), s4 = out_smem(Q, N, P);
  static size_t conf1 = 0, conf3 = 0, conf4 = 0;  // per instantiation, as the kernels
  int rc = set_smem((const void*)ssd_scan_state_kernel<T>, s1, conf1);
  if (rc == 0) rc = set_smem((const void*)ssd_scan_intra_kernel<T>, s3, conf3);
  if (rc == 0) rc = set_smem((const void*)ssd_scan_out_kernel<T>, s4, conf4);
  if (rc != 0) return rc;
  constexpr int W = 16 / sizeof(T);  // elements per 16-byte load
  const int vec_x = P % W == 0 && ((uintptr_t)x & 15) == 0;
  const int vec_b = N % W == 0 && (((uintptr_t)Bm | (uintptr_t)Cm) & 15) == 0;
  const int nc = S / Q;
  const dim3 grid(nc, H, B);
  ssd_scan_state_kernel<T><<<grid, kChunkThreads, s1, stream>>>(
      (const T*)x, dt, A, (const T*)Bm, states, cum, S, H, P, N, Q, vec_x, vec_b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_scan_pass_kernel<<<dim3((N * P + 255) / 256, H, B), 256, 0, stream>>>(
      states, cum, h0, h_out, H, nc, Q, N * P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_scan_intra_kernel<T><<<grid, kChunkThreads, s3, stream>>>(
      (const T*)x, dt, (const T*)Bm, (const T*)Cm, cum, y_intra, S, H, P, N, Q, vec_x, vec_b);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_scan_out_kernel<T><<<grid, kChunkThreads, s4, stream>>>(
      (const T*)Cm, states, cum, y_intra, (T*)y, S, H, P, N, Q, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the largest block of the launch needs, in bytes (the
// wrapper checks it first); dtype 0 float32, 1 bfloat16.
extern "C" long long ssd_scan_smem_bytes(int N, int P, int Q, int dtype) {
  return (long long)(dtype == 1 ? smem_bytes<bf16>(N, P, Q) : smem_bytes<float>(N, P, Q));
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); dt, A, h0, h_out float32.
// ``states`` (B, H, S/Q, N, P), ``cum`` (B, H, S/Q, Q) and ``y_intra`` (B, S,
// H, P) are float32 scratch the caller allocates.  Returns a cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* Bm, const void* Cm, const float* h0,
                               void* y, float* h_out, float* states, float* cum,
                               float* y_intra, int B, int S, int H, int P, int N, int Q,
                               int dtype, int device, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (Q <= 0 || Q > kMaxQ || S % Q != 0 || P <= 0 || N <= 0 || !states || !cum || !y_intra)
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  // this library carries its own runtime: select the tensors' device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, h0, y, h_out, states, cum, y_intra, B, S, H, P, N, Q, s);
  if (dtype == 1)
    return launch<bf16>(x, dt, A, Bm, Cm, h0, y, h_out, states, cum, y_intra, B, S, H, P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
