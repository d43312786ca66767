// flash_attention: blockwise online-softmax attention with grouped KV heads,
// causal and sliding-window masks and a query position offset.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel, launched by flash_attention_pallas).  Plain version:
// repro_torch/models/attention.py (attention_reference).
//
// Layout: the model's own (B, S, H, D) tensors, no head-major copy.  One
// block per (64-query tile, query head, batch), grid (ceil(Sq/64), H, B),
// 128 threads.  The block stages its query tile (scaled by D**-0.5 in
// float32) in shared memory and walks the KV tiles of its KV head
// (h / (H/KV)) in 64-row steps, each staged in shared memory as float32.
// Thread (rg, cg) owns query rows 4rg..4rg+3 and, in the score tile, key
// columns cg, cg+8, ..., cg+56; in the output, head-dim columns cg,
// cg+8, ...  The running max, the running sum and the output accumulator
// stay in registers in float32; the 8 threads of a row group reduce a
// row's max and sum with warp shuffles.  On the TPU the sequential KV grid
// axis carried (m, l, acc) in VMEM scratch; here the loop inside the block
// takes its place.
//
// Numerics kept from the TPU kernel: masked scores are the -1e30 sentinel
// (not -inf), so a tile that is fully masked for a row whose running max is
// still the sentinel gives p = 1 and is wiped by the correction exp(m - m')
// = 0 once a real score arrives, and never gives NaN; p is rounded to v's
// dtype before the P.V product while the running sum adds the unrounded p;
// out = acc / max(l, 1e-30) in q's dtype.  Keys at positions >= Skv (the
// ragged tail of the last tile) take no part at all.  KV tiles that are
// fully masked for every row of the block (past the causal diagonal, or
// before the window) are skipped, which is exact whenever every row of the
// block has at least one valid key; otherwise no tile is skipped, so a row
// with no valid key averages v uniformly, as the reference's softmax does.
//
// Bound: causal attention does 4*D FLOPs per unmasked (query, key) pair
// against 2 bytes per element of q, k, v and out: ~410 FLOP/byte for
// llama's 1024-token prefill, above the card's ~295 FLOP/byte bf16 ridge,
// so long prompts are bound by operations (a 128-token one by bytes).
// This first version runs on the CUDA cores (float32 FMAs, explicit fmaf
// since the library is built with -fmad=false), not on the tensor cores;
// the roofline is the bf16 tensor-core peak, which a later mma/wgmma
// version goes after.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kThreads = 128;
constexpr int kColGroups = 8;    // threads sharing one row group
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = kBK / kColGroups;  // score columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,  // (B, Sq, H, D)
    const T* __restrict__ k,  // (B, Skv, KV, D)
    const T* __restrict__ v,  // (B, Skv, KV, D)
    T* __restrict__ out,      // (B, Sq, H, D)
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
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * kv_row + (size_t)hk * D;
  T* ob = out + (size_t)b * Sq * q_row + (size_t)h * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - (e / D) * D;
    const int s = q0 + r;
    Qs[r * ld + c] = s < Sq ? to_f(qb[(size_t)s * q_row + c]) * scale : 0.0f;
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
      Ks[r * ld + c] = in ? to_f(kb[(size_t)s * kv_row + c]) : 0.0f;
      Vs[r * ld + c] = in ? to_f(vb[(size_t)s * kv_row + c]) : 0.0f;
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
        Ps[row * ldp + cg + kColGroups * j] = to_f(from_f<T>(p));
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
      if (d < D) ob[(size_t)s * q_row + d] = from_f<T>(acc[i][j] / inv_l);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) + (size_t)kBQ * (kBK + 1));
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Skv, int H, int KV, int D, float scale, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  static size_t configured = 0;  // per instantiation
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DJ><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, H, KV, D, scale,
      causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t.
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
  const bool small = D <= 64;
  if (dtype == 0)
    return small ? launch<float, 8>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset, s)
                 : launch<float, 16>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset, s);
  if (dtype == 1)
    return small ? launch<__nv_bfloat16, 8>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset, s)
                 : launch<__nv_bfloat16, 16>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
