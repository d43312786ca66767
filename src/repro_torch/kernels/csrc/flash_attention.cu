// flash_attention: blockwise online-softmax attention with grouped KV heads,
// causal and sliding-window masks and a query position offset.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel, launched by flash_attention_pallas).  Plain version:
// repro_torch/models/attention.py (attention_reference).
//
// Layout: the model's own (B, S, H, D) tensors, no head-major copy.  On the
// TPU the sequential KV grid axis carried (m, l, acc) in VMEM scratch; here
// a loop inside the block walks the KV tiles of its KV head with the carry
// in registers.  Head dims 1..256 (gemma's 256 is the largest of any
// config).  Two kernels, chosen by dtype:
//
// * bf16 (the serving path): flash_attention_wgmma_kernel<DP>, FA3-style on
//   Hopper's wgmma and TMA, DP = 64, 128 or 256 (D padded up to it).
//   - A block serves all g = H / KV query heads of one KV head (more than
//     128: a divisor hb of g a block), so each K/V tile is loaded once for g
//     heads: the g heads are packed into the M dimension (FA3's PackGQA).  A
//     4-D TMA box over q's (D, heads, positions, batch) lands 128 / hb
//     positions x hb heads as rows in (position, head) order: row r is query
//     head h0 + r % hb at position q0 + r / hb, for the causal and window
//     masks.  (The alternative, a head per consumer warpgroup, serves two
//     heads a block: for g = 1 it has no second head on the same K/V, and
//     for g > 2 it loads each K/V tile g / 2 times; it was not measured.)
//     A block takes one query tile, the longest causal rows first;
//     a causal call of more tiles than the card has SMs pairs tile nq-1-x
//     with tile x in block x (even work per block, half the blocks, and the
//     second tile's loads overlap the first's tail).
//   - 384 threads: warpgroups 0 and 1 are consumers (64 rows each), warp 8
//     of warpgroup 2 the producer.  The producer gives registers back
//     (setmaxnreg 24), the consumers take them (240).  It loads Q per query
//     tile and keeps rings of K and V tiles in flight with TMA
//     (cp.async.bulk.tensor), each tile completing on its own mbarrier; the
//     consumers hand a K stage back once its scores are in and a V stage
//     once its P V is, through "empty" mbarriers.
//   - Tiles are 128-byte-swizzled TMA boxes of 64 bf16 columns.  A D that is
//     not a multiple of 64 (16, 80) pads itself: TMA fills everything out of
//     bounds with zeros.  Keys per tile, ring stages and shared memory by
//     tier: DP=64 128 keys, 4 stages, 145 KB; DP=128 128, 3, 225 KB; DP=256
//     80, 2, 225 KB (the O accumulator alone is 128 float32 registers a
//     thread there; 80 keys, not 64, cut the score product's shared-memory
//     reads per FLOP and the tiles a row walks).
//   - S = Q K^T on wgmma from shared memory: K's rows are D-contiguous, so K
//     is K-major for the B operand.  P V on wgmma with P as the register A
//     operand: the float32 S accumulator becomes bf16 pairs in place (its
//     layout is the A layout), and V is read MN-major through the
//     instruction's transpose bit, never transposed in memory.  Each chain
//     is straight-line code on descriptors every thread computes alike
//     (ptxas would otherwise wait after each wgmma).
//   - Within a warpgroup, tile i's scores are issued with tile i-1's P V
//     behind them, and tile i's softmax runs while that P V is on the tensor
//     cores.  Between the warpgroups (ping-pong), named barriers make them
//     take turns to issue, so one's softmax (the exponentials on MUFU, as
//     costly as the products at D=64) runs under the other's products.
//   - q arrives unscaled: each consumer warpgroup multiplies its rows by
//     D**-0.5 in float32, rounds them to bf16 in shared memory (as the
//     plain version computes q * D**-0.5 in q's dtype) and fences the async
//     proxy before its first wgmma reads them.
//   - O leaves through shared memory (Q's tiles, swizzled like them) in TMA
//     stores, which clip rows at or past Sq and columns at or past D.
//   TMA needs 16-byte aligned bases and row strides (H D 2 and KV D 2
//   bytes); the wrapper pads D to a multiple of 8 where they are not.
// * float32: flash_attention_f32_kernel<DJ>, one block per (64-query tile,
//   head, batch) on the CUDA cores: float32 FMAs from shared memory.  In
//   float32 q, k and v are not exact in bf16, and the 2e-5 tolerance against
//   the plain version leaves no room for TF32 or bf16 operands.
//
// Numerics kept from the TPU kernel by both: masked scores are the -1e30
// sentinel (not -inf), so a tile that is fully masked for a row whose
// running max is still the sentinel gives p = 1 and is wiped by the
// correction exp(m - m') = 0 once a real score arrives, and never gives
// NaN; p is rounded to v's dtype before the P.V product while the running
// sum adds the unrounded p; out = acc / max(l, 1e-30) in q's dtype.  Keys
// at positions >= Skv (the ragged tail of the last tile, zeros from TMA)
// take no part at all: they are masked by position.  KV tiles that are
// fully masked for every row of the block (past the causal diagonal, or
// before the window) are skipped, which is exact whenever every row of the
// block has at least one valid key; otherwise no tile is skipped, so a row
// with no valid key averages v uniformly, as the reference's softmax does.
//
// Bound: causal attention does 4*D FLOPs per unmasked (query, key) pair
// against 2 bytes per element of q, k, v and out: ~410 FLOP/byte for
// llama's 1024-token prefill, above the card's ~295 FLOP/byte bf16 ridge,
// so long prompts are bound by tensor-core operations (a 128-token one by
// bytes).  What the bound does not count: one exponential per pair on MUFU
// (16 a clock per SM: at D=64 as long as the products), the masked half of
// the diagonal tiles, and each block's fixed cost (Q's load and scaling, the
// pipeline's fill, O's store), which short prompts pay in full.  At DP=256
// the score product's m64n80 instructions read A and B from shared memory
// at close to its full rate.
//
// ptxas (sm_90a, -O3, from the build log _build.py keeps beside the
// library), no spills in any instantiation:
//   flash_attention_wgmma_kernel<64 | 128 | 256>: 168 registers at entry
//     (384 threads, one block an SM), 240 for the consumers after
//     setmaxnreg, 24 for the producer; 6 named barriers;
//   flash_attention_f32_kernel<8 | 16 | 32>: 123 | 168 | 240 registers,
//     dynamic shared memory 4 * (192 (D + 1) + 64 * 65) bytes: 66,560 at
//     D=64, 214,016 at D=256.
#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>
#include <mutex>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// ------------------------------------------------ bf16: wgmma and TMA
constexpr int kBM = 128;           // rows a block: two consumer warpgroups of 64
constexpr int kWgThreads = 384;    // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kConsumers = 256;
constexpr int kRowBytes = 128;     // a swizzled row: 64 bf16 columns

template <int DP> struct Tier;
template <> struct Tier<64> { static constexpr int kBN = 128, kStages = 4; };
template <> struct Tier<128> { static constexpr int kBN = 128, kStages = 3; };
template <> struct Tier<256> { static constexpr int kBN = 80, kStages = 2; };

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows): Q (then O) as DP / 64 chunks of kBM rows x 128
// bytes; the K ring and the V ring, each stage DP / 64 chunks of kBN rows;
// the mbarriers.  At most 227 KB (DP=128: 230,512 bytes; DP=256: 230,480).
template <int DP>
struct Smem {
  static constexpr int kNC = DP / 64;
  static constexpr int kBN = Tier<DP>::kBN, kStages = Tier<DP>::kStages;
  static constexpr int kQChunk = kBM * kRowBytes;
  static constexpr int kKVChunk = kBN * kRowBytes;
  static constexpr int kKVTile = kNC * kKVChunk;
  static constexpr int kK = kNC * kQChunk;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBars = kV + kStages * kKVTile;
  // Q full, Q empty; per stage K full, V full, K empty, V empty
  static constexpr int kNumBars = 2 + 4 * kStages;
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block can opt into");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait for the phase of parity ``parity`` to complete.  A plain spin: a
// clock64 watchdog with __trap in it kept ptxas from giving the consumers
// the registers setmaxnreg grants (168, spilling, instead of 240).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// TMA: box {c0, c1, c2, c3} of a 4-D tensor map into shared memory,
// completing on ``bar``; shared memory back to the tensor
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of wgmma's registers across a wait
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}
// make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma, TMA stores); a barrier follows
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// named barrier of N threads (ids 1, 2: a warpgroup; 3: both consumers;
// 4, 5: the turn of consumer warpgroup 0, 1 to issue its products)
template <int ID, int N>
__device__ __forceinline__ void named_bar() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}
template <int ID, int N>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

// Ping-pong (FA3): the two consumer warpgroups take turns to issue their
// products, so one's softmax (on the CUDA cores and MUFU) runs while the
// other's products hold the tensor cores.  Warpgroup w waits for its turn
// on barrier 4 + w, issues, and hands the turn over on the other's.
__device__ __forceinline__ void wait_turn(int wg) {
  if (wg == 0) named_bar<4, kConsumers>(); else named_bar<5, kConsumers>();
}
__device__ __forceinline__ void pass_turn(int wg) {
  if (wg == 0) named_arrive<5, kConsumers>(); else named_arrive<4, kConsumers>();
}

// d (64 x 64) (+)= A (64 x 16) B (16 x 64), A and B K-major in shared
// memory (128-byte swizzle); ``acc`` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 80) (+)= A (64 x 16) B (16 x 80), A and B K-major in shared
// memory (128-byte swizzle); ``acc`` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39}"
      ", %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 128) (+)= A (64 x 16) B (16 x 128), A and B K-major in shared
// memory (128-byte swizzle); ``acc`` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
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
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64) += A (64 x 16 in registers, each warp's 16 rows in the
// m16n8k16 A layout) B (16 x 64, MN-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 16 in registers, each warp's 16 rows in the
// m16n8k16 A layout) B (16 x 128, MN-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256) += A (64 x 16 in registers, each warp's 16 rows in the
// m16n8k16 A layout) B (16 x 256, MN-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BN> struct ScoreMma;
template <> struct ScoreMma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    wgmma_ss_n64(d, a, b, acc);
  }
};
template <> struct ScoreMma<80> {
  static __device__ __forceinline__ void run(float (&d)[40], uint64_t a, uint64_t b, int acc) {
    wgmma_ss_n80(d, a, b, acc);
  }
};
template <> struct ScoreMma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_ss_n128(d, a, b, acc);
  }
};
template <int DP> struct ValueMma;
template <> struct ValueMma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <> struct ValueMma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};
template <> struct ValueMma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_n256(d, a, b);
  }
};

// ---- the consumers' steps on one KV tile (warpgroup-wide; accumulator
// element (j, e) of a thread: row row0 + 8 (e >> 1), column 8 j + 2 t4 +
// (e & 1))

// S = Q K^T: DP / 64 chunks x 4 slices of 16 columns, from shared memory
template <int DP, int BN>
__device__ __forceinline__ void issue_scores(float (&sc)[BN / 2], uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ScoreMma<BN>::run(sc, sdesc(qa + c * kBM * kRowBytes + 32 * ks, 16, 1024),
                        sdesc(kt + c * BN * kRowBytes + 32 * ks, 16, 1024), c + ks > 0);
  wg_commit();
}

// O += P V: P (bf16 pairs) as the register operand, V MN-major, k-slices
// of 16 keys
template <int DP, int BN>
__device__ __forceinline__ void issue_values(float (&o)[DP / 2], const uint32_t (&pa)[BN / 16][4],
                                             uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    ValueMma<DP>::run(o, pa[kk], sdesc(vt + kk * 16 * kRowBytes, BN * kRowBytes, 1024));
  wg_commit();
}

// The tile's mask and online softmax, in place: sc becomes p, (m, l) move
// on, corr is what the accumulator must be scaled by before this tile's
// P V adds into it.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int t0, bool need_mask,
                                             const int (&qpos)[2], int Skv, int causal,
                                             int window, int t4) {
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = t0 + 8 * j + 2 * t4 + (e & 1);
        const int qp = qpos[e >> 1];
        if (kp >= Skv) {
          sc[4 * j + e] = -INFINITY;  // past the end: no part in max, sum or P.V
        } else {
          bool ok = true;
          if (causal) ok = qp >= kp;
          if (window > 0) ok = ok && (qp - kp) < window;
          if (!ok) sc[4 * j + e] = kNegInf;
        }
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = quad_max(mx);
    const float m_new = fmaxf(m[r], mx);
    // (x - m_new) first: the sentinel minus itself is exactly 0
    corr[r] = ex2((m[r] - m_new) * kLog2e);
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = ex2((sc[4 * j + 2 * r + c] - m_new) * kLog2e);
        sc[4 * j + 2 * r + c] = p;
        rs += p;
      }
    rs = quad_sum(rs);
    l[r] = l[r] * corr[r] + rs;
    m[r] = m_new;
  }
}

template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
}

// p rounded to bf16 pairs: the m64 x k16 register operand of each k-slice
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

// DP: head dim padded to 64, 128 or 256.  Block (x, y, z): heads [y hb,
// y hb + hb) (of KV head y hb / g), batch z, and one or two query tiles of P
// positions: tile nq - 1 - x alone, or, with ``paired`` (causal calls of
// more tiles than the card has SMs), tiles nq - 1 - x and x, the longest
// causal rows with the shortest, so the blocks carry even work.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,  // q (B, Sq, H, D): box 64 x hb x P x 1
    const __grid_constant__ CUtensorMap tk,  // k (B, Skv, KV, D): box 64 x 1 x kBN x 1
    const __grid_constant__ CUtensorMap tv,  // v, as k
    const __grid_constant__ CUtensorMap to,  // out, as q
    int Sq, int Skv, int g, int hb, int P, float scale, int causal, int window,
    int q_offset, int paired) {
  using L = Smem<DP>;
  constexpr int NC = L::kNC, BN = L::kBN, NS = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV;
  // mbarriers: Q full, Q empty (O stored), then per stage s K full, V
  // full, K empty, V empty
  const uint32_t q_full = base + L::kBars, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8 * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + NS + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (2 + 2 * NS + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (2 + 3 * NS + s); };

  const int tid = threadIdx.x;
  const int nq = (Sq + P - 1) / P;
  const int x = blockIdx.x;
  const int n_items = paired && x != nq - 1 - x ? 2 : 1;
  const int h0 = blockIdx.y * hb;
  const int hk = h0 / g;
  const int b = blockIdx.z;
  const int R = P * hb;  // rows the block holds: (position, head) pairs

  // Item it (query tile nq - 1 - x, then x): its first position, its rows'
  // positions and the KV tiles it must visit, [kv_begin, kv_begin +
  // n_tiles BN)
  struct Item {
    int q0, qpos_lo, qpos_hi, kv_begin, n_tiles;
  };
  auto item = [&](int it) {
    Item r;
    r.q0 = (it == 0 ? nq - 1 - x : x) * P;
    r.qpos_lo = q_offset + r.q0;
    r.qpos_hi = q_offset + min(r.q0 + P, Sq) - 1;
    int kv_begin = 0, kv_end = Skv;
    const bool every_row_has_key = window <= 0 || r.qpos_hi <= Skv + window - 2;
    if (every_row_has_key) {
      if (causal) kv_end = min(Skv, r.qpos_hi + 1);
      if (window > 0) kv_begin = max(0, r.qpos_lo - window + 1);
    }
    r.kv_begin = (kv_begin / BN) * BN;
    r.n_tiles = (kv_end - r.kv_begin + BN - 1) / BN;
    return r;
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 1);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival per consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warpgroup: warp 8 loads, warps 9-11 only give their
    // registers back.  The K/V ring runs on across the items: tile n of the
    // block uses stage n % NS.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      int n = 0;
      for (int it = 0; it < n_items; ++it) {
        const Item w = item(it);
        if (it > 0) mbar_wait(q_empty, 0);  // the first item's O has left
        mbar_expect_tx(q_full, NC * R * kRowBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sQ + c * L::kQChunk, &tq, q_full, 64 * c, h0, w.q0, b);
        for (int i = 0; i < w.n_tiles; ++i, ++n) {
          const int s = n % NS, t0 = w.kv_begin + i * BN;
          const uint32_t free_parity = ((n / NS) & 1) ^ 1;
          mbar_wait(k_empty(s), free_parity);
          mbar_expect_tx(k_full(s), L::kKVTile);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load(sK + s * L::kKVTile + c * L::kKVChunk, &tk, k_full(s), 64 * c, hk, t0, b);
          mbar_wait(v_empty(s), free_parity);
          mbar_expect_tx(v_full(s), L::kKVTile);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load(sV + s * L::kKVTile + c * L::kKVChunk, &tv, v_full(s), 64 * c, hk, t0, b);
        }
      }
    }
  } else {
    // ---- the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // uniform: descriptors stay uniform
    const int warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
    const int row0 = 64 * wg + 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
    const uint32_t qa = sQ + 64 * wg * kRowBytes;
    int n = 0;  // the block's KV tiles so far
    for (int it = 0; it < n_items; ++it) {
      const Item w = item(it);
      const int qpos[2] = {q_offset + w.q0 + row0 / hb, q_offset + w.q0 + (row0 + 8) / hb};

      // q * scale rounded to bf16, in place, for this warpgroup's 64 rows
      // of every chunk; rows past R (no (position, head) of the block) are
      // zero
      mbar_wait(q_full, it & 1);
      for (int e = tid & 127; e < NC * 64 * 8; e += 128) {
        const int c = e >> 9, rest = e & 511, row = 64 * wg + (rest >> 3);
        uint4* p =
            reinterpret_cast<uint4*>(smem + c * L::kQChunk + 64 * wg * kRowBytes + rest * 16);
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (row < R) {
          u = *p;
          uint32_t* wd = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&wd[k]));
            wd[k] = pack_bf16(f.x * scale, f.y * scale);
          }
        }
        *p = u;
      }
      fence_async_smem();
      if (wg == 0) named_bar<1, 128>(); else named_bar<2, 128>();

      float o[DP / 2], sc[BN / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, corr[2];
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.0f;
      auto masked = [&](int t0) {
        return t0 + BN > Skv || (causal && t0 + BN - 1 > w.qpos_lo) ||
               (window > 0 && w.qpos_hi - t0 >= window);
      };

      // Tile i's scores are issued with tile i - 1's P V behind them, and
      // tile i's softmax runs while that P V is on the tensor cores; a K
      // stage is handed back once its scores are in, a V stage once its
      // P V is.  The n_tiles + 1 issue rounds alternate between the
      // warpgroups, warpgroup 0 first; warpgroup 1 hands over n_tiles + 1
      // turns in all (one up front, none after its last round), so every
      // arrival is waited for.
      const int nt = w.n_tiles;
      if (wg == 1) pass_turn(1);
      if (nt > 0) {
        const int s = n % NS;
        mbar_wait(k_full(s), (n / NS) & 1);
        wait_turn(wg);
        wg_fence();
        issue_scores<DP, BN>(sc, qa, sK + s * L::kKVTile);
        pass_turn(wg);
        wg_wait<0>();
        reg_fence(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty(s));
        softmax_tile<BN>(sc, m, l, corr, w.kv_begin, masked(w.kv_begin), qpos, Skv, causal,
                         window, t4);
        pack_p<BN>(sc, pa);
      }
      for (int i = 1; i < nt; ++i) {
        const int c = n + i, s = c % NS, sp = (c - 1) % NS, t0 = w.kv_begin + i * BN;
        mbar_wait(k_full(s), (c / NS) & 1);
        mbar_wait(v_full(sp), ((c - 1) / NS) & 1);
        wait_turn(wg);
        wg_fence();
        issue_scores<DP, BN>(sc, qa, sK + s * L::kKVTile);
        issue_values<DP, BN>(o, pa, sV + sp * L::kKVTile);
        pass_turn(wg);
        wg_wait<1>();  // the scores are in; P V runs on
        reg_fence(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty(s));
        softmax_tile<BN>(sc, m, l, corr, t0, masked(t0), qpos, Skv, causal, window, t4);
        wg_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty(sp));
        rescale<DP>(o, corr);
        pack_p<BN>(sc, pa);
      }
      if (nt > 0) {
        const int c = n + nt - 1, sp = c % NS;
        mbar_wait(v_full(sp), (c / NS) & 1);
        wait_turn(wg);
        wg_fence();
        issue_values<DP, BN>(o, pa, sV + sp * L::kKVTile);
        if (wg == 0) pass_turn(0);
        wg_wait<0>();
        reg_fence(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty(sp));
      } else if (wg == 0) {
        wait_turn(0);  // warpgroup 1's turn handed over up front
      }
      n += nt;

      // O = acc / max(l, 1e-30) in bf16 into this warpgroup's rows of Q's
      // tiles (swizzled as TMA wrote them), then out through TMA stores;
      // Q's tiles are free for the next item once the stores have read them
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lm = fmaxf(l[r], 1e-30f);
        const int row = row0 + 8 * r;
        unsigned char* rowp = smem + row * kRowBytes + 4 * t4;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
          *reinterpret_cast<uint32_t*>(rowp + (j >> 3) * L::kQChunk +
                                       (((j & 7) ^ (row & 7)) << 4)) =
              pack_bf16(o[4 * j + 2 * r] / lm, o[4 * j + 2 * r + 1] / lm);
      }
      fence_async_smem();
      named_bar<3, kConsumers>();
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < NC; ++c) tma_store(&to, sQ + c * L::kQChunk, 64 * c, h0, w.q0, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        if (it + 1 < n_items) mbar_arrive(q_empty);
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry
// point query (the library links no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn load_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                         cudaEnableDefault, &found);
#else
  const cudaError_t e =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiledFn)fn : nullptr;
}

// The 4-D map of a bf16 (B, S, heads, D) tensor: dims (D, heads, S, B),
// boxes of 64 columns x box_heads x box_rows x 1, 128-byte swizzle, zeros
// out of bounds.  Needs 16-byte aligned ptr and D % 8 == 0.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int box_heads,
           int box_rows) {
  static const EncodeTiledFn fn = load_encoder();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads, 2ull * D * heads * S};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// heads a block serves: g, or the largest divisor of g that fits kBM rows
inline int heads_per_block(int g) {
  int hb = g < kBM ? g : kBM;
  while (g % hb != 0) --hb;
  return hb;
}

// the four maps of one call
int encode_all(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
               const void* out, int B, int Sq, int Skv, int H, int KV, int D, int bn) {
  const int hb = heads_per_block(H / KV), P = kBM / hb;
  int rc = encode(&maps[0], q, B, Sq, H, D, hb, P);
  if (rc == 0) rc = encode(&maps[1], k, B, Skv, KV, D, 1, bn);
  if (rc == 0) rc = encode(&maps[2], v, B, Skv, KV, D, 1, bn);
  if (rc == 0) rc = encode(&maps[3], out, B, Sq, H, D, hb, P);
  return rc;
}

// SMs of ``device`` (cached per device, under the lock)
int sm_count(int device) {
  static int count[kMaxDevices] = {};
  std::lock_guard<std::mutex> lock(g_smem_mu);
  if (count[device] == 0 &&
      cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    count[device] = 0;
  return count[device];
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                 int H, int KV, int D, float scale, int causal, int window, int q_offset,
                 int device, cudaStream_t stream) {
  using L = Smem<DP>;
  CUtensorMap maps[4];
  int rc = encode_all(maps, q, k, v, out, B, Sq, Skv, H, KV, D, L::kBN);
  if (rc != 0) return rc;
  static size_t conf[kMaxDevices] = {};  // per instantiation, as the kernel
  rc = set_smem((const void*)flash_attention_wgmma_kernel<DP>, device, L::kBytes, conf);
  if (rc != 0) return rc;
  const int g = H / KV, hb = heads_per_block(g), P = kBM / hb;
  const int nq = (Sq + P - 1) / P;
  // pair the causal query tiles when there are more of them than SMs
  const int paired = causal && (long long)nq * (H / hb) * B > sm_count(device);
  const dim3 grid(paired ? (nq + 1) / 2 : nq, H / hb, B);
  flash_attention_wgmma_kernel<DP><<<grid, kWgThreads, L::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], Sq, Skv, g, hb, P, scale, causal, window, q_offset,
      paired);
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
               int q_offset, int device, cudaStream_t stream) {
  const size_t bytes = f32_smem_bytes(D);
  static size_t conf[kMaxDevices] = {};  // per instantiation, as the kernel
  const int rc = set_smem((const void*)flash_attention_f32_kernel<DJ>, device, bytes, conf);
  if (rc != 0) return rc;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_f32_kernel<DJ><<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Skv, H, KV, D,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (CUDA-core kernel), 1 bfloat16 (wgmma kernel: D % 8 == 0
// and 16-byte aligned q, k, v, out, which the wrapper ensures).  Returns a
// cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Skv, int H,
                                      int KV, int D, float scale, int causal,
                                      int window, int q_offset, int dtype,
                                      int device, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Skv <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  // this library carries its own runtime: select the tensors' device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (D <= 64)
      return launch_f32<8>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset,
                           device, s);
    if (D <= 128)
      return launch_f32<16>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window,
                            q_offset, device, s);
    return launch_f32<32>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset,
                          device, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D % 8 != 0 || (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (D <= 64)
    return launch_wgmma<64>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset,
                            device, s);
  if (D <= 128)
    return launch_wgmma<128>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window,
                             q_offset, device, s);
  return launch_wgmma<256>(q, k, v, out, B, Sq, Skv, H, KV, D, scale, causal, window, q_offset,
                           device, s);
}

// Host microseconds to encode one call's four tensor maps (q, k, v, out),
// the mean over ``iters`` encodings at the given shape (bf16); -1 if the
// encoder is missing or refuses the shape.  Nothing is launched: the
// addresses are only encoded.  It exists only for chip_smoke.py's kernels
// line (``encode_us``); nothing in the port calls it.
extern "C" double flash_attention_encode_us(int B, int Sq, int Skv, int H, int KV, int D,
                                            int iters) {
  const int bn = D <= 64 ? Smem<64>::kBN : D <= 128 ? Smem<128>::kBN : Smem<256>::kBN;
  const void* p = (const void*)(uintptr_t)0x10000;
  CUtensorMap maps[4];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (encode_all(maps, p, p, p, p, B, Sq, Skv, H, KV, D, bn) != 0) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / (iters > 0 ? iters : 1);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
