// flash_attention: blockwise online-softmax attention with grouped KV heads,
// causal and sliding-window masks and a query position offset.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel, launched by flash_attention_pallas).  Plain version:
// repro_torch/models/attention.py (attention_reference).
//
// Layout: the model's own (B, S, H, D) tensors, no head-major copy.  One
// block per (64-query tile, query head, batch), grid (ceil(Sq/64), H, B),
// the tiles with the longest causal rows first.  On the TPU the sequential
// KV grid axis carried (m, l, acc) in VMEM scratch; here a loop inside the
// block walks the KV tiles of its KV head (h / (H/KV)) with the carry in
// registers.  Two kernels, chosen by dtype:
//
// * bf16 (the serving path): flash_attention_mma_kernel, FA2-style on
//   mma.sync.m16n8k16 (bf16 inputs, float32 accumulators), 4 warps of 16
//   query rows.  Each warp loads its Q fragments once with ldmatrix and
//   keeps them in registers; q is multiplied by D**-0.5 in float32 and
//   rounded to bf16 there, as the plain version computes q * D**-0.5 in
//   q's dtype, so the scores see the same operand at every D (80 too).  K
//   and V tiles of 64 keys stay bf16 in shared memory, double-buffered with
//   cp.async (tile t+1 is in flight while tile t is computed), rows padded
//   by 16 bytes so every ldmatrix (.trans for V) is free of bank conflicts;
//   D is padded to a multiple of 16 with zero columns.  S = Q K^T runs on
//   the tensor cores; the online softmax runs on the accumulator fragments
//   (row max and sum over the 4 lanes of a quad, two __shfl_xor_sync); p is
//   rounded to bf16 in registers and is the A operand of P V directly (the
//   m16n8k16 C layout is its A layout), while the running sum adds the
//   unrounded p.  Only tiles that cross the causal diagonal, the window
//   edge or Skv are masked element by element.
// * float32: flash_attention_f32_kernel, the first (CUDA-core) version:
//   float32 FMAs from shared memory.  In float32 q, k and v are not exact in
//   bf16, and the 2e-5 tolerance against the plain version leaves no room
//   for TF32 or bf16 operands, so it stays on the CUDA cores.
//
// Numerics kept from the TPU kernel by both: masked scores are the -1e30
// sentinel (not -inf), so a tile that is fully masked for a row whose
// running max is still the sentinel gives p = 1 and is wiped by the
// correction exp(m - m') = 0 once a real score arrives, and never gives
// NaN; p is rounded to v's dtype before the P.V product while the running
// sum adds the unrounded p; out = acc / max(l, 1e-30) in q's dtype.  Keys
// at positions >= Skv (the ragged tail of the last tile) take no part at
// all.  KV tiles that are fully masked for every row of the block (past
// the causal diagonal, or before the window) are skipped, which is exact
// whenever every row of the block has at least one valid key; otherwise
// no tile is skipped, so a row with no valid key averages v uniformly, as
// the reference's softmax does.
//
// Bound: causal attention does 4*D FLOPs per unmasked (query, key) pair
// against 2 bytes per element of q, k, v and out: ~410 FLOP/byte for
// llama's 1024-token prefill, above the card's ~295 FLOP/byte bf16 ridge,
// so long prompts are bound by tensor-core operations (a 128-token one by
// bytes).  The bf16 kernel issues both products on the tensor cores from
// operands that never leave bf16; what it leaves on the table is the
// mma.sync issue rate (wgmma with TMA and warp specialisation is the step
// after) and the exponentials on the CUDA cores.
//
// ptxas (sm_90a, -O3, from the build log _build.py keeps beside the
// library), no spills in any instantiation:
//   flash_attention_mma_kernel<DK>: 92, 113, 118, 128, 149, 156, 164, 190
//     registers for DK = 1..8 (D = 16, 32, ..., 128; llama's D=64 is DK=4),
//     dynamic shared memory (64 + 4 * 64) * (16 DK + 8) * 2 bytes: 46,080
//     at D=64, 87,040 at D=128;
//   flash_attention_f32_kernel<8 | 16>: 123 | 168 registers, dynamic shared
//     memory 4 * (192 (D + 1) + 64 * 65) bytes: 66,560 at D=64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Warp-level tensor-core helpers: cp.async staging, ldmatrix and
// mma.sync.m16n8k16 (bf16 inputs, float32 accumulators).
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row major), 4 regs of 2 bf16: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, cols 2t..), a2 (row g, cols 2t+8..), a3 (row g+8, 2t+8..)
//   B (16x8, k x n), 2 regs: b0 (rows k 2t, 2t+1, col g), b1 (rows 2t+8.., g)
//   C (16x8 float32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, ...)
// so an accumulator pair of n-tiles (2j, 2j+1), rounded to bf16 pairs, is
// the A fragment of k-slice j of the next product, without shared memory.
// Within a pair of bf16 values the lower column sits in the low 16 bits.
namespace hmma {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; the 16 bytes are zero-filled when !valid
// (src-size 0: the source is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a * b on one 16x8 tile, k = 16
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// Row-ragged tile staging: rows [0, rows) of a bf16 tile whose row r lies
// at src + r * gstride, columns [0, cols), go to dst[r * ld + c]; rows in
// [valid, rows) are zero.  ``vec`` (cols % 8 == 0 and 16-byte aligned rows)
// copies 16 bytes at a time with cp.async (the caller commits and waits);
// otherwise element by element.  Columns >= cols are not touched.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, size_t gstride,
                                           int rows, int valid, int cols, bool vec) {
  if (vec) {
    const int cpr = cols >> 3;
    for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
      const int r = e / cpr, c = (e - r * cpr) << 3;
      const bool ok = r < valid;
      cp_async16(dst + r * ld + c, src + (ok ? (size_t)r * gstride + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      dst[r * ld + c] = r < valid ? src[(size_t)r * gstride + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// zero columns [cols, colsp) of rows [0, rows)
__device__ __forceinline__ void zero_cols(bf16* dst, int ld, int rows, int cols, int colsp) {
  const int w = colsp - cols;
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
    const int r = e / w;
    dst[r * ld + cols + (e - r * w)] = __float2bfloat16_rn(0.0f);
  }
}

}  // namespace hmma

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------ bf16: tensor cores
constexpr int kMmaBQ = 64;             // query rows per block: 4 warps x 16
constexpr int kMmaBK = 64;             // keys per KV tile
constexpr int kMmaThreads = 128;
constexpr int kNT = kMmaBK / 8;        // score n-tiles of 8 keys
constexpr float kLog2e = 1.4426950408889634f;

using hmma::bf16;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// DK: head dim padded to 16 * DK
template <int DK>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(
    const bf16* __restrict__ q,  // (B, Sq, H, D)
    const bf16* __restrict__ k,  // (B, Skv, KV, D)
    const bf16* __restrict__ v,  // (B, Skv, KV, D)
    bf16* __restrict__ out,      // (B, Sq, H, D)
    int Sq, int Skv, int H, int KV, int D, float scale, int causal, int window,
    int q_offset, int vec) {
  constexpr int DP = 16 * DK;
  constexpr int LD = DP + 8;  // row stride: 4 mod 8 words, ldmatrix conflict-free
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = (bf16*)smem_raw;       // [kMmaBQ][LD]
  bf16* Ks = Qs + kMmaBQ * LD;      // [2][kMmaBK][LD]
  bf16* Vs = Ks + 2 * kMmaBK * LD;  // [2][kMmaBK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int q0 = qt * kMmaBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)KV * D;
  const bf16* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const bf16* kb = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * Skv * kv_row + (size_t)hk * D;
  bf16* ob = out + (size_t)b * Sq * q_row + (size_t)h * D;

  // the KV range this block must visit
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + kMmaBQ, Sq) - 1;
  int kv_begin = 0, kv_end = Skv;
  const bool every_row_has_key = window <= 0 || qpos_hi <= Skv + window - 2;
  if (every_row_has_key) {
    if (causal) kv_end = min(Skv, qpos_hi + 1);
    if (window > 0) kv_begin = max(0, qpos_lo - window + 1);
  }
  kv_begin = (kv_begin / kMmaBK) * kMmaBK;

  // padded head-dim columns are zero in every tile; the copies below
  // write only columns < D
  if (DP > D) hmma::zero_cols(Qs, LD, kMmaBQ + 4 * kMmaBK, D, DP);
  hmma::stage_rows(Qs, LD, qb + (size_t)q0 * q_row, q_row, kMmaBQ, Sq - q0, D, vec);
  hmma::stage_rows(Ks, LD, kb + (size_t)kv_begin * kv_row, kv_row, kMmaBK, Skv - kv_begin, D,
                   vec);
  hmma::stage_rows(Vs, LD, vb + (size_t)kv_begin * kv_row, kv_row, kMmaBK, Skv - kv_begin, D,
                   vec);
  hmma::cp_async_commit();

  uint32_t qf[DK][4];
  float acc[2 * DK][4];
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int qrow0 = q0 + 16 * warp;  // this warp's first query row

  int buf = 0;
  for (int t0 = kv_begin; t0 < kv_end; t0 += kMmaBK, buf ^= 1) {
    const int t1 = t0 + kMmaBK;
    if (t1 < kv_end) {  // next tile in flight while this one is computed
      bf16* kn = Ks + (buf ^ 1) * kMmaBK * LD;
      bf16* vn = Vs + (buf ^ 1) * kMmaBK * LD;
      hmma::stage_rows(kn, LD, kb + (size_t)t1 * kv_row, kv_row, kMmaBK, Skv - t1, D, vec);
      hmma::stage_rows(vn, LD, vb + (size_t)t1 * kv_row, kv_row, kMmaBK, Skv - t1, D, vec);
      hmma::cp_async_commit();
      hmma::cp_async_wait<1>();
    } else {
      hmma::cp_async_wait<0>();
    }
    __syncthreads();
    if (t0 == kv_begin) {
      // Q fragments, q * scale rounded to bf16 as the plain version does
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        hmma::ldsm_x4(qf[kk], Qs + (16 * warp + (lane & 15)) * LD + 16 * kk + (lane >> 4) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = hmma::unpack(qf[kk][e]);
          qf[kk][e] = hmma::pack(f.x * scale, f.y * scale);
        }
      }
    }
    const bf16* Kt = Ks + buf * kMmaBK * LD;
    const bf16* Vt = Vs + buf * kMmaBK * LD;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t bk[4];
        hmma::ldsm_x4(bk, Kt + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * LD + 16 * kk +
                              ((lane >> 3) & 1) * 8);
        hmma::mma(s[2 * jp], qf[kk], bk[0], bk[1]);
        hmma::mma(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
      }
    }

    const bool need_mask = t1 > Skv || (causal && t1 - 1 > qpos_lo) ||
                           (window > 0 && qpos_hi - t0 >= window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = t0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = q_offset + qrow0 + g + 8 * (e >> 1);
          if (kp >= Skv) {
            s[j][e] = -INFINITY;  // past the end: no part in max, sum or P.V
          } else {
            bool ok = true;
            if (causal) ok = qp >= kp;
            if (window > 0) ok = ok && (qp - kp) < window;
            if (!ok) s[j][e] = kNegInf;
          }
        }
    }

    // online softmax on the fragments: rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = quad_max(mx);
      const float m_new = fmaxf(m[r], mx);
      // (x - m_new) first: the sentinel minus itself is exactly 0
      const float corr = ex2((m[r] - m_new) * kLog2e);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = ex2((s[j][2 * r + c] - m_new) * kLog2e);
          s[j][2 * r + c] = p;
          rs += p;
        }
      rs = quad_sum(rs);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < 2 * DK; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t pa[4] = {hmma::pack(s[2 * kk][0], s[2 * kk][1]),
                              hmma::pack(s[2 * kk][2], s[2 * kk][3]),
                              hmma::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              hmma::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DK; ++dp) {
        uint32_t bv[4];
        hmma::ldsm_x4_t(bv, Vt + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                16 * dp + (lane >> 4) * 8);
        hmma::mma(acc[2 * dp], pa, bv[0], bv[1]);
        hmma::mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }
  hmma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_row = qrow0 + g + 8 * r;
    if (s_row >= Sq) continue;
    const float lm = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + (size_t)s_row * q_row;
#pragma unroll
    for (int n = 0; n < 2 * DK; ++n) {
      const int d = 8 * n + 2 * t4;
      const float o0 = acc[n][2 * r] / lm, o1 = acc[n][2 * r + 1] / lm;
      if ((D & 1) == 0 && d + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(o0, o1);
      } else {
        if (d < D) orow[d] = __float2bfloat16_rn(o0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16_rn(o1);
      }
    }
  }
}

size_t mma_smem_bytes(int DK) {
  return sizeof(bf16) * (size_t)(kMmaBQ + 4 * kMmaBK) * (16 * DK + 8);
}

template <int DK>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
               int Skv, int H, int KV, int D, float scale, int causal, int window,
               int q_offset, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes(DK);
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_mma_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int vec = D % 8 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, H, B);
  flash_attention_mma_kernel<DK><<<grid, kMmaThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Sq, Skv, H, KV, D, scale,
      causal, window, q_offset, vec);
  return (int)cudaGetLastError();
}

// ------------------------------------------- float32: CUDA cores
// One block per (64-query tile, head, batch), 128 threads.  The block
// stages its query tile (scaled by D**-0.5) in shared memory and each
// 64-key tile as float32; thread (rg, cg) owns query rows 4rg..4rg+3 and,
// in the score tile, key columns cg, cg+8, ..., cg+56; in the output,
// head-dim columns cg, cg+8, ...; the 8 threads of a row group reduce a
// row's max and sum with warp shuffles.  Explicit fmaf: the library is
// built with -fmad=false.
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kThreads = 128;
constexpr int kColGroups = 8;    // threads sharing one row group
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = kBK / kColGroups;  // score columns per thread

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// DJ: head-dim columns per thread (D <= 8 * DJ)
template <int DJ>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q,  // (B, Sq, H, D)
    const float* __restrict__ k,  // (B, Skv, KV, D)
    const float* __restrict__ v,  // (B, Skv, KV, D)
    float* __restrict__ out,      // (B, Sq, H, D)
    int Sq, int Skv, int H, int KV, int D, float scale, int causal,
    int window, int q_offset) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // odd row stride: conflict-free column reads
  const int ldp = kBK + 1;
  float* Qs = smem;            // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;   // [kBK][ld]
  float* Vs = Ks + kBK * ld;   // [kBK][ld]
  float* Ps = Vs + kBK * ld;   // [kBQ][ldp]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int rg = tid / kColGroups;
  const int cg = tid % kColGroups;

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)KV * D;
  const float* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const float* vb = v + (size_t)b * Skv * kv_row + (size_t)hk * D;
  float* ob = out + (size_t)b * Sq * q_row + (size_t)h * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - (e / D) * D;
    const int s = q0 + r;
    Qs[r * ld + c] = s < Sq ? qb[(size_t)s * q_row + c] * scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // the KV range this block must visit
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  int kv_begin = 0, kv_end = Skv;
  const bool every_row_has_key = window <= 0 || qpos_hi <= Skv + window - 2;
  if (every_row_has_key) {
    if (causal) kv_end = min(Skv, qpos_hi + 1);
    if (window > 0) kv_begin = max(0, qpos_lo - window + 1);
  }
  kv_begin = (kv_begin / kBK) * kBK;

  for (int t0 = kv_begin; t0 < kv_end; t0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with Ks, Vs, Ps
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e - (e / D) * D;
      const int s = t0 + r;
      const bool in = s < Skv;
      Ks[r * ld + c] = in ? kb[(size_t)s * kv_row + c] : 0.0f;
      Vs[r * ld + c] = in ? vb[(size_t)s * kv_row + c] : 0.0f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(rg * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(cg + kColGroups * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = rg * kRows + i;
      const int qp = q_offset + q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = t0 + cg + kColGroups * j;
        if (kp >= Skv) {
          sc[i][j] = -INFINITY;  // past the end: no part in max, sum or P.V
        } else {
          bool ok = true;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && (qp - kp) < window;
          if (!ok) sc[i][j] = kNegInf;
        }
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[row * ldp + cg + kColGroups * j] = p;
      }
      rs = group8_sum(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const int kk_end = min(kBK, Skv - t0);
    for (int kk = 0; kk < kk_end; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(rg * kRows + i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = cg + kColGroups * j;
        if (d < D) {
          const float vv = Vs[kk * ld + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + rg * kRows + i;
    if (s >= Sq) continue;
    const float inv_l = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = cg + kColGroups * j;
      if (d < D) ob[(size_t)s * q_row + d] = acc[i][j] / inv_l;
    }
  }
}

size_t f32_smem_bytes(int D) {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) + (size_t)kBQ * (kBK + 1));
}

template <int DJ>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq,
               int Skv, int H, int KV, int D, float scale, int causal, int window,
               int q_offset, cudaStream_t stream) {
  const size_t bytes = f32_smem_bytes(D);
  static size_t configured = 0;  // per instantiation
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32_kernel<DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_f32_kernel<DJ><<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Skv, H, KV, D,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (CUDA-core kernel), 1 bfloat16 (tensor-core kernel).
// Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Skv, int H,
                                      int KV, int D, float scale, int causal,
                                      int window, int q_offset, int dtype,
                                      int device, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Skv <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D > 128)
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  // this library carries its own runtime: select the tensors' device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return D <= 64 ? launch_f32<8>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset, s)
                   : launch_f32<16>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define FA_MMA(DK) \
  return launch_mma<DK>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset, s)
  switch ((D + 15) / 16) {
    case 1: FA_MMA(1);
    case 2: FA_MMA(2);
    case 3: FA_MMA(3);
    case 4: FA_MMA(4);
    case 5: FA_MMA(5);
    case 6: FA_MMA(6);
    case 7: FA_MMA(7);
    default: FA_MMA(8);
  }
#undef FA_MMA
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
