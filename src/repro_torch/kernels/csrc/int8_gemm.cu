// INT8 x INT8 -> INT32 GEMM with the per-token x per-channel rescale,
// hand-written for Hopper (sm_90a): TMA loads into a ring of shared-memory
// stages, s8 wgmma from shared memory, swap-AB at decode.
//
// Replaces src/repro/kernels/int8_gemm/int8_gemm.py: int8_matmul_pallas
// (body _kernel):
//     out[m, n] = (float(sum_k x_q[m, k] * w_q[k, n]) * x_scale[m]) * w_scale[n]
// cast to f32 or bf16, with x_q (M, K) int8 row-major, w_q (K, N) int8
// stored K-major (the transposed view of a contiguous (N, K) tensor: this is
// the layout the port's quantizer stores), x_scale (M,) and w_scale (N,) f32.
//
// What bounds it on an H100: at decode M (8 rows) the weight bytes, K*N
// over 3.35 TB/s at ~0.5 operations per byte; at prefill M (hundreds of
// rows) the int8 tensor-core operations, 2*M*N*K over 1,979 TOP/s.
//
// What the design does about it:
// * Both operands K-major, as wgmma wants 8-bit operands (the PTX ISA has no
//   transpose for them): x_q is (M, K) row-major and the weight is stored
//   (N, K). TMA copies 128-byte-wide K slices of both with the 128-byte
//   swizzle straight into the layout the wgmma descriptors read, so no
//   thread touches an operand byte; TMA zero-fills boxes past M, N or K, so
//   the main loop has no tail masks.
// * A ring of 4-8 stages with full and empty mbarriers: one producer warp
//   issues the TMA loads STAGES deep, the consumer warpgroups run
//   wgmma.m64nNk32.s32.s8.s8 (int32 accumulators in registers) and release
//   each stage once the next stage's products are issued, so copies
//   overlap products.
// * Prefill (M > 64): 128 x 256 or 128 x 128 output tiles over two consumer
//   warpgroups, the width chosen per shape against wave quantization on the
//   card's SMs (int8_gemm_plan); for a short K loop, 128 x 128 tiles with
//   three stages, so that two blocks share an SM and one's epilogue (the f32
//   output is up to 92 MB at the served shapes) overlaps the other's
//   products. Tiles walk M fastest, so the blocks that run together share
//   their weight tile in L2.
// * Decode (M <= 64) runs swap-AB, out^T = W x^T: 64 rows of N are wgmma's
//   A operand and the M tokens, padded to n = 8/16/32/64, its B operand;
//   the epilogue writes out[m, n] from the transposed fragments. K is split
//   until about two blocks per SM stream weight tiles, 6-8 stages of 8 KB
//   each: a few MB in flight across the card, what its memory latency
//   needs at full rate.
// * The K splits of one output tile run as one thread-block cluster (at most
//   8): each leaves its int32 sums in its own shared memory and the cluster
//   adds them through distributed shared memory before the epilogue. One
//   launch and no workspace; the integer sums are exact in any order.
// * The epilogue multiplies in the reference's order, (acc * x_scale) *
//   w_scale, each in f32 round-to-nearest, so the f32 output equals the
//   plain version's bit for bit. It reads the tile's scales from shared
//   memory, where the producer warp's idle lanes put them during the main
//   loop: read from global memory between the output stores, each load
//   waits out the stores before it, and the epilogue rivals the main loop.
// * TMA needs 16-byte-aligned bases and row pitches: K % 16 == 0 and both
//   pointers 16-byte aligned. The wrapper pads anything else (kernels/
//   int8_gemm/ops.py); int8_gemm refuses it.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 128;           // K bytes a stage: one swizzled 128-byte row
constexpr int kSwapMaxM = 64;      // decode (swap-AB) up to this many rows
constexpr int kDecodeBlocksPerSM = 2;
constexpr int kShortK = 16;        // prefill K blocks of the short-K variant
constexpr int kMaxCluster = 8;     // blocks in a portable cluster
constexpr int kEncodeError = 1000;  // + CUresult of a failed tensor-map encode

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 2-D tensor map (coordinates: K byte, row) into shared memory,
// completing its bytes on the barrier.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows in
// the 128-byte swizzle: start address, leading offset (unused for this
// layout), 1024 bytes between 8-row groups, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving uses of an accumulator register across
// the wgmma fences and waits.
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x N, int32, the wgmma accumulator fragment) += A (64 x 32) * B^T
// (N x 32), both int8 K-major in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void run(int (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void run(int (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void run(int (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void run(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void run(int (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ float rescale(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

__device__ __forceinline__ void store_out(void* out, int out_bf16, size_t i,
                                          float v) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// The epilogue of two neighbouring accumulator registers: row pr of the P
// tile at columns qc and qc + 1 of the Q tile, with the scales sp of row pr
// and sq0, sq1 of the columns. Without SWAP they are out[pr, qc] and out[pr,
// qc + 1], written as one 8-byte (4 for bf16) store where aligned; with
// SWAP out[qc, pr] and out[qc + 1, pr].
template <bool SWAP>
__device__ __forceinline__ void store_pair(void* out, int out_bf16, int M,
                                           int N, int pr, int qc, int a0,
                                           int a1, float sp, float sq0,
                                           float sq1) {
  const int m0 = SWAP ? qc : pr, n0 = SWAP ? pr : qc;
  const int m1 = SWAP ? qc + 1 : pr, n1 = SWAP ? pr : qc + 1;
  const bool ok0 = m0 < M && n0 < N, ok1 = m1 < M && n1 < N;
  const size_t i0 = (size_t)m0 * N + n0, i1 = (size_t)m1 * N + n1;
  const float v0 = SWAP ? rescale(a0, sq0, sp) : rescale(a0, sp, sq0);
  const float v1 = SWAP ? rescale(a1, sq1, sp) : rescale(a1, sp, sq1);
  if (!SWAP && ok0 && ok1 && i0 % 2 == 0) {
    if (out_bf16)
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                         i0) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(out) + i0) =
          make_float2(v0, v1);
    return;
  }
  if (ok0) store_out(out, out_bf16, i0, v0);
  if (ok1) store_out(out, out_bf16, i1, v1);
}

// One block computes a BP x BQ tile of D[p, q] = sum_k P[p, k] * Q[q, k]
// over its split of K, one 128-byte K slice of both a stage: P is x_q and Q
// the weight (out = D), or, with SWAP, P the weight and Q x_q (out = D^T).
// Warps 0 .. 4 * BP / 64 - 1 are the consumer warpgroups (64 rows of P
// each); the last warp is the producer. The K splits of a tile (gridDim.z
// of them) form one thread-block cluster: each stashes its int32 sums in
// its own shared memory, and the cluster adds them through distributed
// shared memory.
template <int BP, int BQ, int STAGES, bool SWAP>
__global__ void __launch_bounds__(BP / 64 * 128 + 32, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_p,
                 const __grid_constant__ CUtensorMap map_q,
                 const float* __restrict__ xs, const float* __restrict__ wsc,
                 void* __restrict__ out, int M, int N, int k_blocks,
                 int kb_per_split, int out_bf16) {
  constexpr int kConsumerWarps = BP / 64 * 4, kConsumers = kConsumerWarps * 32;
  constexpr int kAcc = BQ / 2;
  constexpr uint32_t kPBytes = BP * kBK, kStageBytes = (BP + BQ) * kBK;
  static_assert(kAcc * kConsumers * 4 <= STAGES * kStageBytes,
                "the split sums are stashed in the stage ring");
  extern __shared__ uint8_t smem_raw[];
  // Stages start on a 1024-byte boundary: the swizzle repeats every 8 rows
  // of 128 bytes, and the descriptors assume tiles aligned to it.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * kStageBytes;   // STAGES x 8 bytes
  const uint32_t empty = full + STAGES * 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * BP, q0 = blockIdx.y * BQ;
  const int splits = gridDim.z;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nk = min(k_blocks, kb0 + kb_per_split) - kb0;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  // The scales of the tile's P rows and Q rows (x_scale and w_scale, or
  // with SWAP the other way round), 0 past M or N. The idle lanes of the
  // producer warp load them while the products run; from shared memory the
  // epilogue reads them without waiting on global loads between its stores.
  __shared__ float scale_p[BP], scale_q[BQ];
  // Split sums: registers 4j .. 4j + 3 of consumer thread tid as one int4
  // at [j * kConsumers + tid].
  int4* stash =
      reinterpret_cast<int4*>(smem_raw + (base - smem_u32(smem_raw)));

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_p)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_q)) : "memory");
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Accumulator register 4j + v: row 16 * (warp % 4) + g (+ 8 for v >= 2)
  // of the warpgroup's 64, column 8j + 2t + (v & 1).
  const int g = lane / 4, t = lane % 4;
  const int prow = p0 + warp / 4 * 64 + (warp % 4) * 16 + g;
  if (warp == kConsumerWarps) {          // producer
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        const uint32_t stage = base + s * kStageBytes;
        const int k = (kb0 + i) * kBK;
        mbar_expect_tx(full + 8 * s, kStageBytes);
        tma_load(&map_p, stage, full + 8 * s, k, p0);
        tma_load(&map_q, stage + kPBytes, full + 8 * s, k, q0);
      }
    } else {
      const int p_rows = SWAP ? N : M, q_rows = SWAP ? M : N;
      const float* p_scale = SWAP ? wsc : xs;
      const float* q_scale = SWAP ? xs : wsc;
      for (int r = lane - 1; r < BP + BQ; r += 31) {
        if (r < BP)
          scale_p[r] = p0 + r < p_rows ? p_scale[p0 + r] : 0.f;
        else
          scale_q[r - BP] = q0 + r - BP < q_rows ? q_scale[q0 + r - BP] : 0.f;
      }
    }
    __syncwarp();
    asm volatile("bar.arrive 2, %0;\n" ::"n"(kConsumers + 32) : "memory");
  } else {                               // consumers
    int acc[kAcc];
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      acc[r] = 0;
      fence_operand(acc[r]);
    }
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      const uint32_t a = base + s * kStageBytes + warp / 4 * 64 * kBK;
      const uint32_t b = base + s * kStageBytes + kPBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        Wgmma<BQ>::run(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));
      wgmma_commit();
      // The products of stage i - 1 are done: hand it back to the producer.
      wgmma_wait<1>();
      if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) fence_operand(acc[r]);
    asm volatile("bar.sync 2, %0;\n" ::"n"(kConsumers + 32) : "memory");
    if (splits == 1) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair<SWAP>(out, out_bf16, M, N, prow + 8 * h,
                           q0 + 8 * j + 2 * t, acc[4 * j + 2 * h],
                           acc[4 * j + 2 * h + 1], scale_p[prow - p0 + 8 * h],
                           scale_q[8 * j + 2 * t], scale_q[8 * j + 2 * t + 1]);
    } else {
      // Once every consumer warpgroup's products are done (each has seen
      // every load into this block land), the ring is free.
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
        stash[j * kConsumers + tid] = make_int4(
            acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  if (splits == 1) return;

  cluster.sync();
  if (warp < kConsumerWarps) {
    // Split z adds the sums of all the tile's splits for the column groups
    // j with j % splits == z (all loads in flight at once) and writes them.
    // Integer addition is exact, so the order does not matter.
    for (int j = (int)cluster.block_rank(); j < BQ / 8; j += splits) {
      int4 part[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < splits)
          part[c] = cluster.map_shared_rank(stash, c)[j * kConsumers + tid];
      int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < splits) {
          sum.x += part[c].x;
          sum.y += part[c].y;
          sum.z += part[c].z;
          sum.w += part[c].w;
        }
      const float sq0 = scale_q[8 * j + 2 * t], sq1 = scale_q[8 * j + 2 * t + 1];
      store_pair<SWAP>(out, out_bf16, M, N, prow, q0 + 8 * j + 2 * t, sum.x,
                       sum.y, scale_p[prow - p0], sq0, sq1);
      store_pair<SWAP>(out, out_bf16, M, N, prow + 8, q0 + 8 * j + 2 * t,
                       sum.z, sum.w, scale_p[prow - p0 + 8], sq0, sq1);
    }
  }
  // No block leaves while another may still read its shared memory.
  cluster.sync();
}

// The epilogue of an empty sum (K = 0): out[m, n] = (0 * x_scale[m]) *
// w_scale[n].
__global__ void int8_gemm_zero_k(const float* __restrict__ xs,
                                 const float* __restrict__ wsc,
                                 void* __restrict__ out, int M, int N,
                                 int out_bf16) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x)
    store_out(out, out_bf16, i, rescale(0, xs[i / N], wsc[i % N]));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPoint), so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Tensor map of a row-major (rows, K) int8 matrix in boxes of `box_rows`
// rows x 128 K bytes, 128-byte swizzled; out-of-bounds bytes read as zero.
int encode(CUtensorMap* map, const void* base, int rows, int K,
           int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

struct Plan {
  int kind;          // index into the kernel variants of int8_gemm
  int swap_ab, tile_m, tile_n, splits, kb_per_split, stages;
};

// Kernel variants: {BP, BQ, STAGES, SWAP}. The prefill stages fill ~192 KB
// of shared memory (one block per SM) but for the short-K variant (two, so
// that one block's epilogue overlaps the other's products); the decode
// stages ~96 KB (two or three blocks per SM).
constexpr int kVariants[7][4] = {
    {128, 256, 4, 0},        // prefill, wide
    {128, 128, 6, 0},        // prefill
    {128, 128, 3, 0},        // prefill, short K
    {64, 8, 8, 1},           // decode, M <= 8
    {64, 16, 8, 1},          // decode, M <= 16
    {64, 32, 8, 1},          // decode, M <= 32
    {64, 64, 6, 1}};         // decode, M <= 64

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Decode: the smallest n tile that holds M. Prefill: up to kShortK K blocks
// the short-K variant; else the tile width whose waves over n_sm SMs take
// least time (a wave of 128-wide tiles takes half as long), the wider one on
// a tie. Split K where the tiles alone would leave SMs idle -- at decode
// until about kDecodeBlocksPerSM blocks per SM, at prefill while the blocks
// still fit one wave -- into at most kMaxCluster (one cluster), a power of
// two (on an H100, clusters of 3 blocks that each fill an SM gained nothing
// over no split, clusters of 2 did), and never into an empty split.
Plan make_plan(int M, int N, int K, int n_sm) {
  Plan p;
  long long tiles, want;
  if (M <= kSwapMaxM) {
    p.kind = M <= 8 ? 3 : M <= 16 ? 4 : M <= 32 ? 5 : 6;
    tiles = cdiv(N, 64);
    want = cdiv((long long)kDecodeBlocksPerSM * n_sm, tiles);
  } else {
    const long long t256 = cdiv(M, 128) * cdiv(N, 256);
    const long long t128 = cdiv(M, 128) * cdiv(N, 128);
    if (cdiv(K, kBK) <= kShortK)
      p.kind = 2;
    else
      p.kind = cdiv(t128, n_sm) < 2 * cdiv(t256, n_sm) ? 1 : 0;
    tiles = p.kind == 0 ? t256 : t128;
    want = n_sm / tiles;
  }
  const int* v = kVariants[p.kind];
  p.swap_ab = v[3];
  p.tile_m = p.swap_ab ? v[1] : v[0];
  p.tile_n = p.swap_ab ? v[0] : v[1];
  p.stages = v[2];
  const long long k_blocks = cdiv(K, kBK);
  want = want < k_blocks ? want : k_blocks;
  want = want < kMaxCluster ? want : kMaxCluster;
  want = want > 1 ? want : 1;
  while (want & (want - 1)) want &= want - 1;   // a power of two
  p.kb_per_split = (int)cdiv(k_blocks, want);
  p.splits = p.kb_per_split ? (int)cdiv(k_blocks, p.kb_per_split) : 1;
  return p;
}

// Launches kernel variant I of kVariants, the K splits of each tile as one
// cluster.
template <int I>
int launch(const Plan& p, const void* xq, const void* wq, const void* xs,
           const void* wsc, void* out, int M, int N, int K, int out_bf16,
           cudaStream_t stream) {
  constexpr int BP = kVariants[I][0], BQ = kVariants[I][1];
  constexpr int STAGES = kVariants[I][2];
  constexpr bool SWAP = kVariants[I][3] != 0;
  CUtensorMap map_p, map_q;
  int rc = encode(&map_p, SWAP ? wq : xq, SWAP ? N : M, K, BP);
  if (rc == 0) rc = encode(&map_q, SWAP ? xq : wq, SWAP ? M : N, K, BQ);
  if (rc != 0) return rc;
  constexpr size_t smem = STAGES * (size_t)(BP + BQ) * kBK + 16 * STAGES + 1024;
  auto kernel = int8_gemm_kernel<BP, BQ, STAGES, SWAP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = p.splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cdiv(SWAP ? N : M, BP),
                     (unsigned)cdiv(SWAP ? M : N, BQ), p.splits);
  cfg.blockDim = dim3(BP / 64 * 128 + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = p.splits > 1;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, map_p, map_q, static_cast<const float*>(xs),
      static_cast<const float*>(wsc), out, M, N, (int)cdiv(K, kBK),
      p.kb_per_split, out_bf16);
}

}  // namespace

extern "C" {

// The launch plan of an (M, K) x (K, N) product on a card with n_sm SMs:
// plan[0] = 1 for swap-AB (decode), plan[1] x plan[2] = the output tile
// (M x N), plan[3] = K splits (one cluster of blocks per tile), plan[4] = K
// blocks per split, plan[5] = K bytes per block (one pipeline stage),
// plan[6] = pipeline stages.
void int8_gemm_plan(int M, int N, int K, int n_sm, int* plan) {
  const Plan p = make_plan(M, N, K, n_sm);
  plan[0] = p.swap_ab;
  plan[1] = p.tile_m;
  plan[2] = p.tile_n;
  plan[3] = p.splits;
  plan[4] = p.kb_per_split;
  plan[5] = kBK;
  plan[6] = p.stages;
}

// x_q (M, K) int8 row-major; w_kn the weight's (N, K) int8 row-major
// storage (w_q = its transpose); both 16-byte aligned with K % 16 == 0;
// x_scale (M,), w_scale (N,) f32; out (M, N) f32 (out_bf16 = 0) or bf16
// (1). One launch. Returns 0, the CUDA error of the launch, or 1000 + the
// CUresult of a failed tensor-map encode.
int int8_gemm(const void* xq, const void* w_kn, const void* xs,
              const void* wsc, void* out, int M, int N, int K, int n_sm,
              int out_bf16, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  if (K == 0) {
    const size_t blocks = ((size_t)M * N + 255) / 256;
    int8_gemm_zero_k<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                       stream>>>(static_cast<const float*>(xs),
                                 static_cast<const float*>(wsc), out, M, N,
                                 out_bf16);
    return (int)cudaGetLastError();
  }
  if (K % 16 != 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w_kn) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, N, K, n_sm);
  switch (p.kind) {
    case 0: return launch<0>(p, xq, w_kn, xs, wsc, out, M, N, K, out_bf16,
                             stream);
    case 1: return launch<1>(p, xq, w_kn, xs, wsc, out, M, N, K, out_bf16,
                             stream);
    case 2: return launch<2>(p, xq, w_kn, xs, wsc, out, M, N, K, out_bf16,
                             stream);
    case 3: return launch<3>(p, xq, w_kn, xs, wsc, out, M, N, K, out_bf16,
                             stream);
    case 4: return launch<4>(p, xq, w_kn, xs, wsc, out, M, N, K, out_bf16,
                             stream);
    case 5: return launch<5>(p, xq, w_kn, xs, wsc, out, M, N, K, out_bf16,
                             stream);
    default: return launch<6>(p, xq, w_kn, xs, wsc, out, M, N, K, out_bf16,
                              stream);
  }
}

}  // extern "C"
