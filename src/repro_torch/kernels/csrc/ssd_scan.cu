// ssd_scan: the Mamba-2 SSD chunked scan for one B/C group (G = 1), on
// Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_pallas).  Plain version:
// repro_torch/kernels/ssd_scan/ref.py (ssd_chunked).
//
// Recurrence per (batch, head), scalar decay per head:
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T      h: (N, P)
//   y_t = C_t^T h_t                                  y: (P,)
// computed chunk by chunk (Q <= 128 rows, every tile padded to 128), in
// Mamba-2's own decomposition (arXiv:2405.21060 sec. 6): with cum the
// inclusive cumsum of dt A inside the chunk and total its last entry,
//   h^T = (x o w)^T B,                 w_j = exp(total - cum_j) dt_j
//   y   = exp(cum) o (C h_in) + L x,   L_ij = (C B^T)_ij exp(cum_i - cum_j) dt_j, j <= i
// Three kernels, back to back on the caller's stream:
//   1. ssd_scan_chunk_state_kernel, grid (S/Q, H, B), one warpgroup (a
//      thread per row): cum (warp scans, then the warps, in a fixed order)
//      and the chunk's state h^T = (x o w)^T B, a (P x Q)(Q x N) product:
//      64 rows of P per tile at mamba2's N=128 (m64n128) and jamba's N=16
//      (m64n16) alike; the tile leaves through shared memory in 16-byte
//      stores;
//   2. ssd_scan_pass_kernel, one thread per state element: the state pass
//      over chunks in float32; it writes each chunk's entering state, split
//      into bf16 hi and lo terms, as the shared-memory image kernel 3 copies
//      as it is, and the final state once;
//   3. ssd_scan_chunk_out_kernel, grid (S/Q, ceil(H/3), B), two warpgroups
//      (rows 0-63 and 64-127 of the chunk): C B^T once per block (m64n128),
//      kept in registers for the block's three heads; per head C h_in
//      (m64n64) goes to the tensor cores first, L is built from the C B^T
//      fragments in registers meanwhile (2^(cum_i log2 e + log2 dt_j -
//      cum_j log2 e), masked only on the tiles that reach the diagonal,
//      zero past a warp's last row), the accumulator is scaled by
//      exp(cum_i), and L x (m64n64) adds into it with L as wgmma's register
//      operand (no trip through shared memory, the FA3 way); y leaves once,
//      in its type, through shared memory in 16-byte stores.  The next
//      head's image (cp.async) and x^T items (registers) are in flight
//      while a head computes, in a second buffer where it fits.
// Tiles sit in shared memory K-major without swizzle: core matrices of 8
// rows x 16 bytes, groups of 8 rows padded by 16 bytes, so the transposing
// stores of x^T and B^T meet no bank conflict.  C and B, and the images,
// are copied with cp.async; x^T and B^T go through registers.  At N=128 and
// N=16 every chain of wgmma is straight-line code on descriptors the
// compiler sees uniform (a branch between two wgmma, or a descriptor in a
// per-thread register, makes it wait for each one); other N run the same
// code with a loop, correct but serialized.
//
// Operands: bf16 x, B and C are exact.  A float32 operand (L, x o w and
// h_in; for float32 inputs also x, B and C) goes in as two bf16 terms, hi
// = bf16(v) and lo = bf16(v - hi), and a product of two split operands sums
// hi.hi + hi.lo + lo.hi in float32: each operand within 2^-17 of its value,
// each product within ~2^-16.  tests/test_torch_ssd.py emulates this
// arithmetic on the CPU: float32 inputs land ~1e-5 of the output's scale
// from the plain scan, inside the 1e-4 tolerance, where one bf16 term misses
// it fifty-fold; bf16 outputs read as the plain scan's against float64.
// Three terms would not fit a block's shared memory for float32 at N=128.
//
// Why not the plain version's bits: the kernels this file replaced summed
// every product as cuBLAS SGEMM's fmaf chain on the CUDA cores, to agree
// with the plain path bit for bit, because mamba2-780m's 48 random-weight
// layers amplify any one-ulp flip of a bf16 y past chip_smoke.py's 0.05
// logit check: the plain path lies 0.11-0.15 from itself with its SSD in
// float64, so that check could not tell a correct scan from a wrong one.
// chip_smoke.py now holds every scan call of a mamba2 or jamba prefill
// against the scan in float64 on its own inputs, and the whole model in
// float32 (no bf16 y to flip) against the plain path.
//
// Determinism: no atomics, and the tiling depends on (S, P, N, Q, dtype)
// only, never on B or H: a (batch row, head)'s bits do not depend on what
// else is in the call (chip_smoke.py's batch-invariance case).
//
// Bound: at mamba2's shapes (N=128, P=64, Q=128, bf16) the chunked
// algorithm does ~190 FLOPs per byte it must move, below the card's ~295
// FLOP/byte bf16 ridge, so the least time is set by the bytes (0.0044 ms at
// S=1024; jamba's 0.0103).  These kernels move more: the chunk states
// (float32) are written by kernel 1 and read by kernel 2, which writes the
// entering states' bf16 terms for kernel 3 (2 x 12.6 MB at mamba2's
// S=1024, partly in L2), and x is read twice.  Kernel 3 is bound by the
// latency of its per-head steps (one block of 8 warps per SM at ~230
// registers a thread), not by the tensor cores.
//
// ptxas (sm_90a, -O3, from the build log _build.py keeps beside the
// library), no spills: ssd_scan_chunk_out_kernel 230-232 registers (bf16),
// 244-250 (float32); ssd_scan_chunk_state_kernel 80-96 (bf16), 116
// (float32); ssd_scan_pass_kernel 32.  Dynamic shared memory per block,
// from state_smem / out_smem: mamba2 (N=128, P=64, bf16) 66,592 and
// 185,600 bytes (two head buffers, y staged), float32 99,616 and 199,168
// (one buffer); jamba (N=16) 37,696 and 70,912.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kQ = 128;               // chunk rows; every tile is padded to 128
constexpr int kStateThreads = 128;    // kernel 1: one warpgroup
constexpr int kOutThreads = 256;      // kernel 3: two warpgroups
constexpr int kHeadsPerBlock = 3;     // kernel 3: heads sharing one C B^T
constexpr int kPassThreads = 256;

// bf16 terms an input of type T goes in as
template <typename T> struct Terms { static constexpr int n = 2; };
template <> struct Terms<bf16> { static constexpr int n = 1; };

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ------------------------------------------------------------ tiles
// A tile of R rows x K columns of bf16 (R % 8 == 0, K % 16 == 0), K-major,
// as wgmma reads it without swizzle: core matrices of 8 rows x 8 columns,
// 128 contiguous bytes (row r at 16 r); core matrices along K 128 bytes
// apart (the descriptor's leading byte offset), groups of 8 rows K * 16 +
// 16 bytes apart (its stride byte offset).
__host__ __device__ inline int group_elems(int K) { return K * 8 + 8; }
__host__ __device__ inline int tile_elems(int R, int K) { return R / 8 * group_elems(K); }
__device__ __forceinline__ int tile_at(int r, int k, int K) {
  return (r >> 3) * group_elems(K) + (k >> 3) * 64 + (r & 7) * 8 + (k & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma's shared-memory matrix descriptor for the 64 (A) or n (B) rows and
// 16 columns of a tile of K columns starting at p (no swizzle)
__device__ __forceinline__ uint64_t desc(const bf16* p, int K) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((K * 16 + 16) >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of an accumulator across a wgmma
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// make this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to wgmma's async proxy; a barrier follows
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of one warpgroup's 128 threads (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// the bf16 terms of (a, b), hi (k = 0: bf16(v)) or lo (k = 1: bf16(v -
// bf16(v))), as one 32-bit word, a in the low half
__device__ __forceinline__ uint32_t term2(float a, float b, int k) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  if (k == 1) {
    const float2 f = __bfloat1622float2(t);
    t = __floats2bfloat162_rn(a - f.x, b - f.y);
  }
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, within 2 ulp
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// 8 consecutive elements of T as loaded: one or two 16-byte words
template <typename T>
struct Raw {
  uint4 u[sizeof(T) / 2];
};
template <typename T>
__device__ __forceinline__ void load_raw(Raw<T>& r, const T* p) {  // p 16-byte aligned
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}
__device__ __forceinline__ void to_floats(const Raw<bf16>& r, float (&v)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r.u[0]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h2[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void to_floats(const Raw<float>& r, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(&r.u[0]);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = f[k];
}

// Transposed staging.  Rows [0, rows) x columns [0, cols) of a row-major
// tile (row j at src + j * gstride) go TRANSPOSED into NT term tiles dst +
// t * tile_elems(Cp, kQ) of Cp rows (the columns) x kQ columns (the rows),
// each value times scale[j] (or 1) and split into its terms; everything
// outside the source is zero.  Item e: rows j, j+1 and 8 columns c0..; the
// lanes of a warp run over 4 row pairs, then 8 column groups, so their
// 32-bit stores fall on 32 banks (the groups are padded by 16 bytes).
// t_load issues an item's 16-byte loads (``vec``: 16-byte aligned rows,
// cols % 8 == 0); t_store converts and stores it, reading the edges
// element by element.
template <typename T>
struct TItem {
  const T* src;
  size_t gstride;
  int rows, cols, Cp;
  bool vec;
  __device__ __forceinline__ int items() const { return (kQ / 2) * (Cp / 8); }
  __device__ __forceinline__ void at(int e, int& j, int& c0) const {
    const int rest = e >> 2, cg = Cp / 8;
    c0 = (rest % cg) * 8;
    j = (rest / cg) * 8 + 2 * (e & 3);
  }
  __device__ __forceinline__ bool whole(int jj, int c0) const {
    return vec && jj < rows && c0 + 8 <= cols;
  }
  __device__ __forceinline__ void load(int e, Raw<T> (&r)[2]) const {
    int j, c0;
    at(e, j, c0);
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (whole(j + q, c0)) load_raw(r[q], src + (size_t)(j + q) * gstride + c0);
  }
  template <int NT>
  __device__ __forceinline__ void store(int e, const Raw<T> (&r)[2], bf16* dst,
                                        const float* scale) const {
    int j, c0;
    at(e, j, c0);
    if (sizeof(T) == 2 && NT == 1 && !scale && whole(j, c0) && whole(j + 1, c0)) {
      // bf16 values as they are: (row j, row j + 1) halves side by side
      const uint32_t* a = reinterpret_cast<const uint32_t*>(&r[0].u[0]);
      const uint32_t* b = reinterpret_cast<const uint32_t*>(&r[1].u[0]);
      uint32_t* out = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        out[tile_at(c0 + k, j, kQ) >> 1] = __byte_perm(a[k >> 1], b[k >> 1], (k & 1) ? 0x7632 : 0x5410);
      return;
    }
    float v[2][8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int jj = j + q;
      const float s = scale ? scale[jj] : 1.0f;
      if (whole(jj, c0)) {
        to_floats(r[q], v[q]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[q][k] = (jj < rows && c0 + k < cols) ? to_f(src[(size_t)jj * gstride + c0 + k]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) v[q][k] *= s;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      uint32_t* out = reinterpret_cast<uint32_t*>(dst + t * tile_elems(Cp, kQ));
#pragma unroll
      for (int k = 0; k < 8; ++k) out[tile_at(c0 + k, j, kQ) >> 1] = term2(v[0][k], v[1][k], t);
    }
  }
};

// A whole transposed staging by `nthreads` threads, four items a thread
// in flight at a time.
template <int NT, typename T>
__device__ __forceinline__ void stage_t(const TItem<T>& it, bf16* dst, const float* scale,
                                        int tid, int nthreads) {
  constexpr int U = 4;
  for (int e0 = tid; e0 < it.items(); e0 += U * nthreads) {
    Raw<T> r[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * nthreads < it.items()) it.load(e0 + u * nthreads, r[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * nthreads < it.items()) it.template store<NT>(e0 + u * nthreads, r[u], dst, scale);
  }
}

// Stage rows [0, rows) x columns [0, cols) of a row-major tile (row r at
// src + r * gstride) as it is into NT term tiles dst + t * tile_elems(R,
// Kp) of R rows x Kp columns; everything outside the source is zero.  An
// item is 8 columns of one row (one core-matrix row, 16 bytes); lanes run
// over 8 rows first.  bf16 with ``vec``: cp.async (the caller waits).
template <int NT, typename T>
__device__ __forceinline__ void stage_rows(bf16* dst, int R, int Kp, const T* __restrict__ src,
                                           size_t gstride, int rows, int cols, bool vec,
                                           int tid, int nthreads) {
  const int kg = Kp / 8, items = R * kg;
  for (int e = tid; e < items; e += nthreads) {
    const int r = (e & 7) + ((e >> 3) / kg) * 8, k0 = ((e >> 3) % kg) * 8;
    bf16* at = dst + tile_at(r, k0, Kp);
    const T* from = src + (size_t)r * gstride + k0;
    const bool full = r < rows && vec && k0 + 8 <= cols;
    if (sizeof(T) == 2 && full) {
      cp_async16(at, from);
      continue;
    }
    float v[8];
    if (full) {
      Raw<T> raw;
      load_raw(raw, from);
      to_floats(raw, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = (r < rows && k0 + k < cols) ? to_f(from[k]) : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *reinterpret_cast<uint4*>(at + t * tile_elems(R, Kp)) =
          make_uint4(term2(v[0], v[1], t), term2(v[2], v[3], t), term2(v[4], v[5], t),
                     term2(v[6], v[7], t));
  }
}

// 16-byte alignment of a row-major tile's rows: every row starting at base
// + r * gstride can be read 8 elements at a time
template <typename T>
__host__ __device__ inline bool rows_vec(const void* base, size_t gstride) {
  return (((uintptr_t)base & 15) == 0) && (gstride * sizeof(T)) % 16 == 0;
}

// two adjacent outputs (the second only if ``both``), in the output's type
__device__ __forceinline__ void store2(float* p, float a, float b, bool both) {
  if (both && ((uintptr_t)p & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}
__device__ __forceinline__ void store2(bf16* p, float a, float b, bool both) {
  if (both && ((uintptr_t)p & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (both) p[1] = __float2bfloat16_rn(b);
  }
}

// ------------------------------------------------------------ wgmma
// d (64 x 128) += A (64 x 16) B (16 x 128), A and B read from shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16) B (16 x 64), A and B read from shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 16) += A (64 x 16) B (16 x 16), A and B read from shared memory
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16, fragments a0..a3 of each warp, the m16n8k16
// layout) B (16 x 64, read from shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

template <int NT> struct StateMma;
template <> struct StateMma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    wgmma_ss_n128(d, a, b);
  }
};
template <> struct StateMma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    wgmma_ss_n64(d, a, b);
  }
};
template <> struct StateMma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b) {
    wgmma_ss_n16(d, a, b);
  }
};

// ------------------------------------------------------------ kernel 1
// Per (chunk, head, batch), one thread per row of the chunk: cum (written
// out) and the chunk's state contribution h^T = (x o w)^T B, (P, N)
// float32, into the scratch.  B is an exact operand for bf16 inputs, x o w
// goes in as two terms.  A tile is 64 rows of P x NT columns of N.
template <typename T>
__host__ __device__ inline size_t state_smem(int Pp, int Np) {
  return 2 * ((size_t)Terms<T>::n * tile_elems(Np, kQ) + 2 * (size_t)tile_elems(Pp, kQ)) +
         (kQ + 8) * sizeof(float);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kStateThreads) ssd_scan_chunk_state_kernel(
    const T* __restrict__ x,       // (B, S, H, P)
    const float* __restrict__ dt,  // (B, S, H)
    const float* __restrict__ A,   // (H,)
    const T* __restrict__ Bm,      // (B, S, N)
    float* __restrict__ states,    // (B, H, nc, P, N) out: h^T of the chunk alone
    float* __restrict__ cum_out,   // (B, H, nc, Q) out
    int S, int H, int P, int N, int Q, int Pp, int Np, int vec_x, int vec_b) {
  constexpr int KT = Terms<T>::n;
  static_assert(kStateThreads == kQ, "one thread per row of the chunk");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* bt = reinterpret_cast<bf16*>(smem_raw);  // KT x [Np][kQ]: B^T
  bf16* xw = bt + KT * tile_elems(Np, kQ);        // 2 x [Pp][kQ]: (x o w)^T
  float* w = reinterpret_cast<float*>(xw + 2 * tile_elems(Pp, kQ));  // [kQ]
  float* part = w + kQ;  // the warps' sums, then the chunk's total

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, s0 = c * Q, lane = tid & 31, warp = tid >> 5;
  const size_t bhc = ((size_t)b * H + h) * nc + c;

  const float dtj = tid < Q ? dt[((size_t)b * S + s0 + tid) * H + h] : 0.0f;
  stage_t<KT>(TItem<T>{Bm + ((size_t)b * S + s0) * N, (size_t)N, Q, N, Np, (bool)vec_b},
              bt, nullptr, tid, kStateThreads);
  // cum, the inclusive cumsum of dt A over the chunk's rows: a scan over
  // each warp's lanes, then over the warps, in a fixed order
  float run = dtj * A[h];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, run, o);
    if (lane >= o) run += up;
  }
  if (lane == 31) part[warp] = run;
  __syncthreads();
  for (int k = 0; k < warp; ++k) run += part[k];
  if (tid == Q - 1) part[4] = run;
  __syncthreads();
  const float total = part[4];
  w[tid] = tid < Q ? expf(total - run) * dtj : 0.0f;
  if (tid < Q) cum_out[bhc * Q + tid] = run;
  __syncthreads();
  stage_t<2>(TItem<T>{x + ((size_t)b * S + s0) * H * P + (size_t)h * P, (size_t)H * P, Q, P,
                      Pp, (bool)vec_x},
             xw, w, tid, kStateThreads);
  fence_async_smem();
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  float* st = states + bhc * (size_t)P * N;
#pragma unroll 1
  for (int p0 = 0; p0 < Pp; p0 += 64) {
#pragma unroll 1
    for (int n0 = 0; n0 < Np; n0 += NT) {
      float d[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) d[i] = 0.0f;
      reg_fence(d);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {  // rows past Q are zero
        const uint64_t a0 = desc(xw + tile_at(p0, kk * 16, kQ), kQ);
        const uint64_t b0 = desc(bt + tile_at(n0, kk * 16, kQ), kQ);
        StateMma<NT>::run(d, a0, b0);
        StateMma<NT>::run(d, desc(xw + tile_elems(Pp, kQ) + tile_at(p0, kk * 16, kQ), kQ), b0);
        if (KT == 2)
          StateMma<NT>::run(d, a0, desc(bt + tile_elems(Np, kQ) + tile_at(n0, kk * 16, kQ), kQ));
      }
      wg_commit();
      wg_wait();
      reg_fence(d);
      if (Pp == 64 && NT == Np && N % 4 == 0) {
        // the one tile: through shared memory (the operands are read), whole
        // rows of 16-byte stores
        float* stage = reinterpret_cast<float*>(smem_raw);  // [64][Np + 8]
        const int ld = Np + 8;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < NT / 8; ++i) {
          float* at = stage + (16 * warp + g) * ld + 8 * i + 2 * t4;
          store2(at, d[4 * i], d[4 * i + 1], true);
          store2(at + 8 * ld, d[4 * i + 2], d[4 * i + 3], true);
        }
        __syncthreads();
        const int per_row = N / 4;
        for (int q = tid; q < P * per_row; q += kStateThreads) {
          const int r = q / per_row, e = (q - r * per_row) * 4;
          *reinterpret_cast<float4*>(st + (size_t)r * N + e) =
              *reinterpret_cast<const float4*>(stage + r * ld + e);
        }
      } else {
#pragma unroll
        for (int i = 0; i < NT / 8; ++i) {
          const int p = p0 + 16 * warp + g, n = n0 + 8 * i + 2 * t4;
          if (n >= N) continue;
          if (p < P) store2(st + (size_t)p * N + n, d[4 * i], d[4 * i + 1], n + 1 < N);
          if (p + 8 < P)
            store2(st + (size_t)(p + 8) * N + n, d[4 * i + 2], d[4 * i + 3], n + 1 < N);
        }
      }
    }
  }
}

// ------------------------------------------------------------ kernel 2
// The state pass over chunks, one thread per element of the entering
// state's image: (Pp x Np) K-major tiles without the padding (groups of 8
// rows Np * 8 elements apart), hi and lo, as kernel 3 copies them.
__global__ void __launch_bounds__(kPassThreads) ssd_scan_pass_kernel(
    const float* __restrict__ states,  // (B, H, nc, P, N)
    const float* __restrict__ cum,     // (B, H, nc, Q)
    const float* __restrict__ h0,      // (B, H, N, P) or null
    bf16* __restrict__ h_img,          // (B, H, nc, 2, Pp * Np) out
    float* __restrict__ h_out,         // (B, H, N, P) out
    int H, int nc, int Q, int P, int N, int Pp, int Np) {
  const int img = Pp * Np;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= img) return;
  const int cm = o >> 6, kg = Np / 8;
  const int p = (cm / kg) * 8 + ((o >> 3) & 7), n = (cm % kg) * 8 + (o & 7);
  const bool real = p < P && n < N;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y, NP = (size_t)N * P;
  float hv = (real && h0) ? h0[bh * NP + (size_t)n * P + p] : 0.0f;
  const float* st = states + bh * nc * NP + (size_t)p * N + n;
  const float* total = cum + bh * nc * Q + (Q - 1);
  bf16* out = h_img + bh * nc * 2 * (size_t)img + o;
  constexpr int kAhead = 4;  // loads in flight before the dependent chain
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float s[kAhead], et[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = min(c0 + k, nc - 1);
      s[k] = real ? st[(size_t)c * NP] : 0.0f;
      et[k] = expf(total[(size_t)c * Q]);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k >= nc) break;
      const bf16 hi = __float2bfloat16_rn(hv);
      out[(size_t)(2 * (c0 + k)) * img] = hi;
      out[(size_t)(2 * (c0 + k) + 1) * img] = __float2bfloat16_rn(hv - __bfloat162float(hi));
      hv = hv * et[k] + s[k];  // two roundings, as torch
    }
  }
  if (real) h_out[bh * NP + (size_t)n * P + p] = hv;
}

// ------------------------------------------------------------ kernel 3
// Per (chunk, group of kHeadsPerBlock heads, batch), two warpgroups, rows
// m0 = 0 and 64 of the chunk: C B^T (64 x 128 a warpgroup) once, then per
// head y = exp(cum) o (C h_in) + L x for each 64 columns of P.  A head's
// tiles (x^T, the entering state's image, dt and cum log2 e) sit in one of
// `nbuf` buffers; with two, the next head's loads are in flight while this
// head computes.
template <typename T>
__host__ __device__ inline size_t out_buf_bytes(int Pp, int Np) {
  return 2 * ((size_t)Terms<T>::n * tile_elems(Pp, kQ) + 2 * (size_t)tile_elems(Pp, Np)) +
         2 * sizeof(float) * kQ;
}
constexpr int kYld = 72;  // a staged row of y: 64 columns and 8 of padding
template <typename T>
__host__ __device__ inline size_t out_smem(int Pp, int Np, int nbuf, bool stage_y) {
  return 2 * (2 * (size_t)Terms<T>::n * tile_elems(kQ, Np)) + nbuf * out_buf_bytes<T>(Pp, Np) +
         (stage_y ? sizeof(T) * kQ * kYld : 0);
}

template <typename T, int NK>
__global__ void __launch_bounds__(kOutThreads, 1) ssd_scan_chunk_out_kernel(
    const T* __restrict__ x,          // (B, S, H, P)
    const float* __restrict__ dt,     // (B, S, H)
    const T* __restrict__ Bm,         // (B, S, N)
    const T* __restrict__ Cm,         // (B, S, N)
    const float* __restrict__ cum_g,  // (B, H, nc, Q)
    const bf16* __restrict__ h_img,   // (B, H, nc, 2, Pp * Np)
    T* __restrict__ y,                // (B, S, H, P)
    int S, int H, int P, int N, int Q, int Pp, int Np, int vec_x, int vec_b, int nbuf,
    int stage_y) {
  constexpr int KT = Terms<T>::n;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tc = tile_elems(kQ, Np), tx = tile_elems(Pp, kQ), th = tile_elems(Pp, Np);
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // KT x [kQ][Np]: C
  bf16* bs = cs + KT * tc;                        // KT x [kQ][Np]: B
  unsigned char* bufs = reinterpret_cast<unsigned char*>(bs + KT * tc);
  const size_t buf_bytes = out_buf_bytes<T>(Pp, Np);
  // buffer k: KT x [Pp][kQ] x^T, 2 x [Pp][Np] h_in^T, [kQ] log2 dt - cum log2 e,
  // [kQ] cum log2 e
  const auto xt_of = [&](int k) { return reinterpret_cast<bf16*>(bufs + k * buf_bytes); };
  const auto hs_of = [&](int k) { return xt_of(k) + KT * tx; };
  const auto us_of = [&](int k) { return reinterpret_cast<float*>(hs_of(k) + 2 * th); };
  // with ``stage_y``: [kQ][kYld] y, each warpgroup's 64 rows staged for 16-byte stores
  T* ys = reinterpret_cast<T*>(bufs + nbuf * buf_bytes);

  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, s0 = c * Q;
  // this warpgroup's first row, broadcast from lane 0 so that the compiler
  // sees it uniform: the wgmma descriptors built from it then stay in uniform
  // registers (else every wgmma waits for the one before)
  const int m0 = __shfl_sync(0xffffffffu, (tid >> 7) * 64, 0);
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, t4 = tid & 3;
  const int i0 = m0 + 16 * warp + g, i1 = i0 + 8;  // this thread's rows
  const bool busy = m0 < Q;                        // uniform over the warpgroup
  const int h_first = blockIdx.y * kHeadsPerBlock, h_end = min(h_first + kHeadsPerBlock, H);
  const int nk = NK ? NK : Np / 16;  // k-slices of N

  // a head's loads: the image by cp.async, this thread's first kPre x^T
  // items and its row's dt and cum into registers; then stored
  constexpr int kPre = 2;
  Raw<T> pre[kPre][2];
  float pre_dt = 0.0f, pre_cum = 0.0f;
  const auto x_items = [&](int h) {
    return TItem<T>{x + ((size_t)b * S + s0) * H * P + (size_t)h * P, (size_t)H * P, Q, P, Pp,
                    (bool)vec_x};
  };
  const auto issue = [&](int h, int k) {
    const size_t bhc = ((size_t)b * H + h) * nc + c;
    const bf16* src = h_img + bhc * 2 * (size_t)Pp * Np;
    const int per_term = Pp * Np / 8;  // 16-byte pieces; Np of them a group of 8 rows
    for (int q = tid; q < 2 * per_term; q += kOutThreads) {
      const int t = q / per_term, r = q - t * per_term;
      cp_async16(hs_of(k) + t * th + (r / Np) * group_elems(Np) + (r % Np) * 8,
                 src + (size_t)q * 8);
    }
    const TItem<T> it = x_items(h);
#pragma unroll
    for (int u = 0; u < kPre; ++u)
      if (tid + u * kOutThreads < it.items()) it.load(tid + u * kOutThreads, pre[u]);
    if (tid < kQ) {
      pre_dt = tid < Q ? dt[((size_t)b * S + s0 + tid) * H + h] : 0.0f;
      pre_cum = cum_g[bhc * Q + min(tid, Q - 1)];
    }
  };
  const auto store = [&](int h, int k) {
    const TItem<T> it = x_items(h);
#pragma unroll
    for (int u = 0; u < kPre; ++u)
      if (tid + u * kOutThreads < it.items())
        it.template store<KT>(tid + u * kOutThreads, pre[u], xt_of(k), nullptr);
    for (int e = tid + kPre * kOutThreads; e < it.items(); e += kOutThreads) {
      Raw<T> r[2];
      it.load(e, r);
      it.template store<KT>(e, r, xt_of(k), nullptr);
    }
    if (tid < kQ) {  // log2 dt_j - cum_j log2 e (-inf where dt is 0), cum_j log2 e
      us_of(k)[tid] = log2f(pre_dt) - pre_cum * kLog2e;
      us_of(k)[kQ + tid] = pre_cum * kLog2e;
    }
  };

  stage_rows<KT>(cs, kQ, Np, Cm + ((size_t)b * S + s0) * N, (size_t)N, Q, N, vec_b, tid,
                 kOutThreads);
  stage_rows<KT>(bs, kQ, Np, Bm + ((size_t)b * S + s0) * N, (size_t)N, Q, N, vec_b, tid,
                 kOutThreads);
  cp_async_commit();
  issue(h_first, 0);
  cp_async_commit();
  cp_async_wait<1>();  // C and B are in; the first head's image may still be on its way
  fence_async_smem();
  __syncthreads();

  // C B^T: rows m0 .. m0 + 63, all kQ columns; the same for every head.
  // The first head's x^T is stored while the tensor cores run.
  float cb[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) cb[i] = 0.0f;
  if (busy) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < nk; ++kk) {
      const uint64_t a0 = desc(cs + tile_at(m0, kk * 16, Np), Np);
      const uint64_t b0 = desc(bs + tile_at(0, kk * 16, Np), Np);
      wgmma_ss_n128(cb, a0, b0);
      if (KT == 2) {
        wgmma_ss_n128(cb, a0, desc(bs + tc + tile_at(0, kk * 16, Np), Np));
        wgmma_ss_n128(cb, desc(cs + tc + tile_at(m0, kk * 16, Np), Np), b0);
      }
    }
    wg_commit();
  }
  store(h_first, 0);
  if (busy) {
    wg_wait();
    reg_fence(cb);
  }
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  for (int h = h_first, k = 0; h < h_end; ++h, k = (k + 1) % nbuf) {
    const bool next = h + 1 < h_end;
    if (next && nbuf == 2) issue(h + 1, k ^ 1);
    if (busy) {
      const bf16* xt = xt_of(k);
      const bf16* hs = hs_of(k);
      const float* u2 = us_of(k);  // log2 dt - cum log2 e
      const float* c2 = u2 + kQ;    // cum log2 e
      uint32_t lh[32], ll[32];
      float e0 = 0.0f, e1 = 0.0f;
      for (int p0 = 0; p0 < Pp; p0 += 64) {
        float d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.0f;
        reg_fence(d);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < nk; ++kk) {  // C h_in
          const uint64_t a0 = desc(cs + tile_at(m0, kk * 16, Np), Np);
          const uint64_t b0 = desc(hs + tile_at(p0, kk * 16, Np), Np);
          wgmma_ss_n64(d, a0, b0);
          wgmma_ss_n64(d, a0, desc(hs + th + tile_at(p0, kk * 16, Np), Np));
          if (KT == 2) wgmma_ss_n64(d, desc(cs + tc + tile_at(m0, kk * 16, Np), Np), b0);
        }
        wg_commit();
        if (p0 == 0) {
          // while the tensor cores run: L = C B^T o exp(cum_i - cum_j) o dt_j
          // (j <= i) = C B^T o 2^(cum_i log2 e + u_j), as A fragments of the
          // k-slices of j, the accumulator's n-tiles 2 kk and 2 kk + 1.
          // Warp-uniform: n-tiles past the warp's last row are zero, and only
          // those that reach its first row are masked
          const float ci0 = c2[i0], ci1 = c2[i1];
          const int row_lo = m0 + 16 * warp, row_hi = row_lo + 15;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int at = 4 * (nt >> 1) + 2 * (nt & 1);  // a0/a1 or a2/a3 of slice nt / 2
            if (8 * nt > row_hi) {
              lh[at] = lh[at + 1] = ll[at] = ll[at + 1] = 0u;
              continue;
            }
            const int j = 8 * nt + 2 * t4;  // this thread's columns j, j + 1
            const float2 uj = *reinterpret_cast<const float2*>(u2 + j);
            float v[4];
            v[0] = cb[4 * nt] * ex2(ci0 + uj.x);
            v[1] = cb[4 * nt + 1] * ex2(ci0 + uj.y);
            v[2] = cb[4 * nt + 2] * ex2(ci1 + uj.x);
            v[3] = cb[4 * nt + 3] * ex2(ci1 + uj.y);
            if (8 * nt + 7 > row_lo) {  // the tile reaches the diagonal
              v[0] = j <= i0 ? v[0] : 0.0f;
              v[1] = j + 1 <= i0 ? v[1] : 0.0f;
              v[2] = j <= i1 ? v[2] : 0.0f;
              v[3] = j + 1 <= i1 ? v[3] : 0.0f;
            }
            lh[at] = term2(v[0], v[1], 0);
            lh[at + 1] = term2(v[2], v[3], 0);
            ll[at] = term2(v[0], v[1], 1);
            ll[at + 1] = term2(v[2], v[3], 1);
          }
          e0 = ex2(ci0);
          e1 = ex2(ci1);
        }
        wg_wait();
        reg_fence(d);
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] *= (i & 2) ? e1 : e0;
        reg_fence(d);
        wg_fence();
        // + L x: rows 0-63 reach j < 64 only (L is zero past), rows 64-127
        // all of j; each a straight chain (a branch between two wgmma makes
        // the compiler wait for the first)
        const auto lx = [&](auto slices) {
#pragma unroll
          for (int kk = 0; kk < decltype(slices)::value; ++kk) {
            const uint64_t b0 = desc(xt + tile_at(p0, kk * 16, kQ), kQ);
            wgmma_rs_n64(d, lh[4 * kk], lh[4 * kk + 1], lh[4 * kk + 2], lh[4 * kk + 3], b0);
            wgmma_rs_n64(d, ll[4 * kk], ll[4 * kk + 1], ll[4 * kk + 2], ll[4 * kk + 3], b0);
            if (KT == 2)
              wgmma_rs_n64(d, lh[4 * kk], lh[4 * kk + 1], lh[4 * kk + 2], lh[4 * kk + 3],
                           desc(xt + tx + tile_at(p0, kk * 16, kQ), kQ));
          }
        };
        if (m0 == 0)
          lx(std::integral_constant<int, 4>{});
        else
          lx(std::integral_constant<int, 8>{});
        wg_commit();
        wg_wait();
        reg_fence(d);
        if (stage_y) {  // through shared memory, 16 bytes a thread
          const int wg = tid >> 7;
          T* yw = ys + wg * 64 * kYld;
          wg_bar(wg);  // this warpgroup's previous y is out
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            T* at = yw + (16 * warp + g) * kYld + 8 * nt + 2 * t4;
            store2(at, d[4 * nt], d[4 * nt + 1], true);
            store2(at + 8 * kYld, d[4 * nt + 2], d[4 * nt + 3], true);
          }
          wg_bar(wg);
          constexpr int E = 16 / sizeof(T);  // elements a 16-byte piece
          const int per_row = min(64, P - p0) / E, rows = min(64, Q - m0);
          T* out = y + ((size_t)b * S + s0 + m0) * H * P + (size_t)h * P + p0;
          for (int q = tid & 127; q < rows * per_row; q += 128) {
            const int r = q / per_row, e = (q - r * per_row) * E;
            *reinterpret_cast<uint4*>(out + (size_t)r * H * P + e) =
                *reinterpret_cast<const uint4*>(yw + r * kYld + e);
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int p = p0 + 8 * nt + 2 * t4;
            if (p >= P) continue;
            T* row0 = y + ((size_t)b * S + s0 + i0) * H * P + (size_t)h * P + p;
            if (i0 < Q) store2(row0, d[4 * nt], d[4 * nt + 1], p + 1 < P);
            if (i1 < Q) store2(row0 + (size_t)8 * H * P, d[4 * nt + 2], d[4 * nt + 3], p + 1 < P);
          }
        }
      }
    }
    if (next) {
      if (nbuf == 1) {  // the one buffer is free once every warp is done
        __syncthreads();
        issue(h + 1, 0);
      }
      store(h + 1, k ^ (nbuf - 1));
      cp_async_wait_all();
      fence_async_smem();
      __syncthreads();
    }
  }
}

// ------------------------------------------------------------ launch
constexpr int kMaxDevices = 64;
std::mutex g_smem_mu;

// Raise a kernel's dynamic shared memory opt-in on ``device`` (the current
// one) to ``bytes`` unless it is already at least that: once per (device,
// size), ``configured[device]`` recording it, under a lock.
int set_smem(const void* kernel, int device, size_t bytes, size_t (&configured)[kMaxDevices]) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_smem_mu);
  if (bytes <= configured[device]) return (int)cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) configured[device] = bytes;
  return (int)e;
}

inline int padded_p(int P) { return round_up(P, 64); }
inline int padded_n(int N) { return round_up(N, 16); }

// the scratch: cum, the chunk states, the entering states' images
inline size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }
inline size_t cum_bytes(int B, int H, int nc, int Q) { return align256(4ull * B * H * nc * Q); }
inline size_t states_bytes(int B, int H, int nc, int P, int N) {
  return align256(4ull * B * H * nc * P * N);
}
inline size_t img_bytes(int B, int H, int nc, int P, int N) {
  return align256(2ull * B * H * nc * 2 * padded_p(P) * padded_n(N));
}

// the card's shared memory a block can opt into (H100: 227 KB)
constexpr size_t kSmemLimit = 232448;

// kernel 3 double-buffers a head's tiles, and stages y, where they fit
template <typename T>
int out_buffers(int Pp, int Np) {
  return out_smem<T>(Pp, Np, 2, false) <= kSmemLimit ? 2 : 1;
}

template <typename T>
size_t smem_bytes(int N, int P) {
  const size_t a = state_smem<T>(padded_p(P), padded_n(N)),
               o = out_smem<T>(padded_p(P), padded_n(N), 1, false);
  return a > o ? a : o;
}

template <typename T, int NT>
int launch_state(const T* x, const float* dt, const float* A, const T* Bm, float* states,
                 float* cum, int B, int S, int H, int P, int N, int Q, int vec_x, int vec_b,
                 int device, cudaStream_t stream) {
  const int Pp = padded_p(P), Np = padded_n(N);
  const size_t bytes = state_smem<T>(Pp, Np);
  static size_t conf[kMaxDevices] = {};  // per instantiation, as the kernel
  const int rc =
      set_smem((const void*)ssd_scan_chunk_state_kernel<T, NT>, device, bytes, conf);
  if (rc != 0) return rc;
  ssd_scan_chunk_state_kernel<T, NT><<<dim3(S / Q, H, B), kStateThreads, bytes, stream>>>(
      x, dt, A, Bm, states, cum, S, H, P, N, Q, Pp, Np, vec_x, vec_b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x_, const float* dt, const float* A, const void* Bm_, const void* Cm_,
           const float* h0, void* y_, float* h_out, unsigned char* work, int B, int S, int H,
           int P, int N, int Q, int device, cudaStream_t stream) {
  const T* x = (const T*)x_;
  const T* Bm = (const T*)Bm_;
  const T* Cm = (const T*)Cm_;
  const int nc = S / Q, Pp = padded_p(P), Np = padded_n(N);
  float* cum = (float*)work;
  float* states = (float*)(work + cum_bytes(B, H, nc, Q));
  bf16* img = (bf16*)(work + cum_bytes(B, H, nc, Q) + states_bytes(B, H, nc, P, N));
  const int vec_x = P % 8 == 0 && rows_vec<T>(x, (size_t)H * P);
  const int vec_b = N % 8 == 0 && rows_vec<T>(Bm, N) && rows_vec<T>(Cm, N);
  int rc = Np % 128 == 0  ? launch_state<T, 128>(x, dt, A, Bm, states, cum, B, S, H, P, N, Q,
                                                 vec_x, vec_b, device, stream)
           : Np % 64 == 0 ? launch_state<T, 64>(x, dt, A, Bm, states, cum, B, S, H, P, N, Q,
                                                vec_x, vec_b, device, stream)
                          : launch_state<T, 16>(x, dt, A, Bm, states, cum, B, S, H, P, N, Q,
                                                vec_x, vec_b, device, stream);
  if (rc != 0) return rc;
  ssd_scan_pass_kernel<<<dim3((Pp * Np + kPassThreads - 1) / kPassThreads, H, B), kPassThreads,
                         0, stream>>>(states, cum, h0, img, h_out, H, nc, Q, P, N, Pp, Np);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int nbuf = out_buffers<T>(Pp, Np);
  const int stage_y = out_smem<T>(Pp, Np, nbuf, true) <= kSmemLimit;
  const int vec_y = P % 8 == 0 && rows_vec<T>(y_, (size_t)H * P);
  const size_t bytes = out_smem<T>(Pp, Np, nbuf, stage_y && vec_y);
  // straight-line k chains at mamba2's N=128 and jamba's N=16, a loop otherwise
  const auto kernel = Np == 128  ? ssd_scan_chunk_out_kernel<T, 8>
                      : Np == 16 ? ssd_scan_chunk_out_kernel<T, 1>
                                 : ssd_scan_chunk_out_kernel<T, 0>;
  static size_t conf[3][kMaxDevices] = {};  // per instantiation, as the kernels
  rc = set_smem((const void*)kernel, device, bytes, conf[Np == 128 ? 0 : Np == 16 ? 1 : 2]);
  if (rc != 0) return rc;
  const dim3 grid(nc, (H + kHeadsPerBlock - 1) / kHeadsPerBlock, B);
  kernel<<<grid, kOutThreads, bytes, stream>>>(x, dt, Bm, Cm, cum, img, (T*)y_, S, H, P, N, Q,
                                               Pp, Np, vec_x, vec_b, nbuf, stage_y && vec_y);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the largest block of the launch needs, in bytes (the
// wrapper checks it first); dtype 0 float32, 1 bfloat16.
extern "C" long long ssd_scan_smem_bytes(int N, int P, int Q, int dtype) {
  (void)Q;  // every tile is padded to 128 rows of the chunk
  return (long long)(dtype == 1 ? smem_bytes<bf16>(N, P) : smem_bytes<float>(N, P));
}

// Bytes of scratch the launch needs (the caller allocates it, 256-byte
// aligned).
extern "C" long long ssd_scan_work_bytes(int B, int S, int H, int P, int N, int Q) {
  const int nc = S / Q;
  return (long long)(cum_bytes(B, H, nc, Q) + states_bytes(B, H, nc, P, N) +
                     img_bytes(B, H, nc, P, N));
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); dt, A, h0, h_out float32.
// ``work``: ssd_scan_work_bytes of scratch.  Returns a cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* Bm, const void* Cm, const float* h0,
                               void* y, float* h_out, void* work, int B, int S, int H, int P,
                               int N, int Q, int dtype, int device, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (Q <= 0 || Q > kQ || S % Q != 0 || P <= 0 || N <= 0 || !work)
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  // this library carries its own runtime: select the tensors' device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* w = (unsigned char*)work;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, h0, y, h_out, w, B, S, H, P, N, Q, device, s);
  if (dtype == 1)
    return launch<bf16>(x, dt, A, Bm, Cm, h0, y, h_out, w, B, S, H, P, N, Q, device, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
