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
//   y    = (M o C B^T) (x dt) + exp(cum) (C h),   M_ij = exp(cum_i - cum_j), j <= i
//   h    = exp(total) h + (B exp(total - cum) dt)^T x
// M is masked before the exp (j > i never reaches expf).
//
// Layout: one block per (head, batch), grid (H, B), 256 threads.  The block
// walks its chunks in order with the (N, P) float32 state in shared memory
// (on the TPU the sequential chunk grid axis carried it in VMEM scratch).
// Per chunk it stages x (Q, P), B and C (Q, N) in the input dtype and dt in
// float32 in shared memory; B and C are read from the (B, S, N) group
// tensors directly, so nothing is repeated per head in device memory.  The
// intra-chunk scores are built 32 query rows at a time into a (32, Q)
// float32 tile.  At N=128, P=64, Q=128 in bf16 this is ~133 KB of dynamic
// shared memory (~215 KB for float32 inputs), set with
// cudaFuncSetAttribute.  The final state is written once.
//
// The chunk's cumsum is taken sequentially by one thread, in the order
// torch.cumsum takes a non-innermost dimension, so cum matches the plain
// version bit for bit; exp(cum_i - cum_j) of near-diagonal pairs then
// carries no extra rounding.
//
// Bound: at mamba2's shapes (N=128, P=64, Q=128, bf16) the chunked
// algorithm does ~190 FLOPs per byte it must move, below the card's ~295
// FLOP/byte ridge for bf16 tensor cores, so the least time is set by bytes;
// on the float32 CUDA cores, where this version runs from shared memory,
// it is bound by operations.  At B=1 its grid is H = 48 blocks on 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;  // chunk rows: score columns jj + 32 m, m < 4
constexpr int kRT = 32;     // query rows per score tile
constexpr int kYRows = 8;   // output rows per thread in the y pass
constexpr int kHN = 16;     // state rows per thread in the state pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Layout {  // offsets in bytes into dynamic shared memory
  size_t h, g, cum, ecum, wdt, dt, x, b, c, total;
};

__host__ __device__ inline Layout layout(int Q, int N, int P, int ldn, int elem) {
  Layout L;
  size_t o = 0;
  L.h = o;    o += sizeof(float) * (size_t)N * P;
  L.g = o;    o += sizeof(float) * (size_t)kRT * (Q + 1);
  L.cum = o;  o += sizeof(float) * (size_t)Q;
  L.ecum = o; o += sizeof(float) * (size_t)Q;
  L.wdt = o;  o += sizeof(float) * (size_t)Q;
  L.dt = o;   o += sizeof(float) * (size_t)Q;
  L.x = o;    o += (size_t)elem * Q * P;
  o = (o + 15) & ~(size_t)15;
  L.b = o;    o += (size_t)elem * Q * ldn;
  o = (o + 15) & ~(size_t)15;
  L.c = o;    o += (size_t)elem * Q * ldn;
  L.total = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x,       // (B, S, H, P)
    const float* __restrict__ dt,  // (B, S, H)
    const float* __restrict__ A,   // (H,)
    const T* __restrict__ Bm,      // (B, S, N)
    const T* __restrict__ Cm,      // (B, S, N)
    const float* __restrict__ h0,  // (B, H, N, P) or null
    T* __restrict__ y,             // (B, S, H, P)
    float* __restrict__ h_out,     // (B, H, N, P)
    int S, int H, int P, int N, int Q, int ldn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(Q, N, P, ldn, (int)sizeof(T));
  float* hs = (float*)(smem + L.h);      // [N][P]
  float* gs = (float*)(smem + L.g);      // [kRT][Q + 1]
  float* cum = (float*)(smem + L.cum);   // [Q]
  float* ecum = (float*)(smem + L.ecum); // exp(cum)
  float* wdt = (float*)(smem + L.wdt);   // exp(total - cum) * dt
  float* dts = (float*)(smem + L.dt);    // [Q]
  T* xs = (T*)(smem + L.x);              // [Q][P]
  T* bs = (T*)(smem + L.b);              // [Q][ldn]
  T* cs = (T*)(smem + L.c);              // [Q][ldn]
  const int ldg = Q + 1;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const size_t x_row = (size_t)H * P;

  const size_t hoff = ((size_t)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) hs[e] = h0 ? h0[hoff + e] : 0.0f;

  const int n_chunks = S / Q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * Q;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P, p = e - (e / P) * P;
      xs[e] = x[((size_t)b * S + s0 + j) * x_row + (size_t)h * P + p];
    }
    const T* brow = Bm + ((size_t)b * S + s0) * N;
    const T* crow = Cm + ((size_t)b * S + s0) * N;
    for (int e = tid; e < Q * N; e += kThreads) {
      const int j = e / N, n = e - (e / N) * N;
      bs[j * ldn + n] = brow[e];
      cs[j * ldn + n] = crow[e];
    }
    for (int j = tid; j < Q; j += kThreads)
      dts[j] = dt[((size_t)b * S + s0 + j) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int j = 0; j < Q; ++j) {
        run = run + dts[j] * a_h;
        cum[j] = run;
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
      ecum[j] = expf(cum[j]);
      wdt[j] = expf(total - cum[j]) * dts[j];
    }
    __syncthreads();

    for (int i0 = 0; i0 < Q; i0 += kRT) {
      // scores: gs[ii][j] = M_ij * (C_i . B_j) for j <= i, else 0
      {
        const int jj = tid % 32, ig = tid / 32;  // rows 4 ig + a, cols jj + 32 m
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) acc[a][mm] = 0.0f;
        const int i_max = min(i0 + kRT, Q) - 1;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = min(i0 + 4 * ig + a, Q - 1);
            cv[a] = to_f(cs[i * ldn + n]);
          }
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            const int j = min(jj + 32 * mm, i_max);
            bv[mm] = to_f(bs[j * ldn + n]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int mm = 0; mm < 4; ++mm) acc[a][mm] = fmaf(cv[a], bv[mm], acc[a][mm]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ii = 4 * ig + a;
          const int i = i0 + ii;
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            const int j = jj + 32 * mm;
            if (ii < kRT && j < Q) {
              gs[ii * ldg + j] =
                  (i < Q && j <= i) ? expf(cum[i] - cum[j]) * acc[a][mm] : 0.0f;
            }
          }
        }
      }
      __syncthreads();
      // y rows i0 .. i0 + kRT: intra-chunk term plus exp(cum) (C h_in)
      for (int e = tid; e < (kRT / kYRows) * P; e += kThreads) {
        const int rq = e / P, p = e - (e / P) * P;
        const int r0 = rq * kYRows;
        float yi[kYRows], yc[kYRows];
#pragma unroll
        for (int a = 0; a < kYRows; ++a) { yi[a] = 0.0f; yc[a] = 0.0f; }
        const int j_end = min(i0 + r0 + kYRows, Q);
        for (int j = 0; j < j_end; ++j) {
          const float xdt = to_f(xs[j * P + p]) * dts[j];
#pragma unroll
          for (int a = 0; a < kYRows; ++a) yi[a] = fmaf(gs[(r0 + a) * ldg + j], xdt, yi[a]);
        }
        for (int n = 0; n < N; ++n) {
          const float hv = hs[n * P + p];
#pragma unroll
          for (int a = 0; a < kYRows; ++a) {
            const int i = min(i0 + r0 + a, Q - 1);
            yc[a] = fmaf(to_f(cs[i * ldn + n]), hv, yc[a]);
          }
        }
#pragma unroll
        for (int a = 0; a < kYRows; ++a) {
          const int i = i0 + r0 + a;
          if (i < Q) {
            y[((size_t)b * S + s0 + i) * x_row + (size_t)h * P + p] =
                from_f<T>(yi[a] + ecum[i] * yc[a]);
          }
        }
      }
      __syncthreads();
    }

    // state: h = exp(total) h + sum_j (B_j wdt_j) x_j^T
    const float et = expf(total);
    for (int e = tid; e < ((N + kHN - 1) / kHN) * P; e += kThreads) {
      const int ng = e / P, p = e - (e / P) * P;
      const int n0 = ng * kHN;
      float acc[kHN];
#pragma unroll
      for (int a = 0; a < kHN; ++a) acc[a] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        const float xv = to_f(xs[j * P + p]);
        const float w = wdt[j];
#pragma unroll
        for (int a = 0; a < kHN; ++a) {
          const int n = min(n0 + a, N - 1);
          acc[a] = fmaf(to_f(bs[j * ldn + n]) * w, xv, acc[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < kHN; ++a) {
        const int n = n0 + a;
        if (n < N) hs[n * P + p] = hs[n * P + p] * et + acc[a];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * P; e += kThreads) h_out[hoff + e] = hs[e];
}

int row_stride(int N, int elem) {
  // elements per staged B/C row: a whole, odd number of 32-bit words, so
  // the 32 lanes reading 32 different rows hit 32 different banks
  int ld = N;
  while ((ld * elem) % 4 != 0 || ((ld * elem / 4) % 2) == 0) ++ld;
  return ld;
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* h_out, int B, int S,
           int H, int P, int N, int Q, cudaStream_t stream) {
  const int ldn = row_stride(N, (int)sizeof(T));
  const size_t bytes = layout(Q, N, P, ldn, (int)sizeof(T)).total;
  static size_t configured = 0;  // per instantiation
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  const dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, h0, (T*)y, h_out, S, H, P,
      N, Q, ldn);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the launch needs, in bytes (the wrapper checks it first).
extern "C" long long ssd_scan_smem_bytes(int N, int P, int Q, int dtype) {
  const int elem = dtype == 1 ? 2 : 4;
  return (long long)layout(Q, N, P, row_stride(N, elem), elem).total;
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); dt, A, h0, h_out float32.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* Bm, const void* Cm, const float* h0,
                               void* y, float* h_out, int B, int S, int H, int P,
                               int N, int Q, int dtype, int device, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (Q <= 0 || Q > kMaxQ || S % Q != 0 || P <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  // this library carries its own runtime: select the tensors' device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, dt, A, Bm, Cm, h0, y, h_out, B, S, H, P, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, h_out, B, S, H, P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
