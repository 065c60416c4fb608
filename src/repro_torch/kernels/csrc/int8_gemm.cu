// INT8 x INT8 -> INT32 GEMM with the per-token x per-channel rescale,
// hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/int8_gemm/int8_gemm.py: int8_matmul_pallas
// (body _kernel):
//     out[m, n] = (float(sum_k x_q[m, k] * w_q[k, n]) * x_scale[m]) * w_scale[n]
// cast to f32 or bf16, with x_q (M, K) and w_q (K, N) row-major int8 (the
// JAX layout), x_scale (M,) and w_scale (N,) f32.
//
// What bounds it on an H100: at decode M (8 rows) the weight bytes: K*N
// bytes over 3.35 TB/s, ~0.5 operations per byte. At prefill M (hundreds
// of rows) the int8 tensor-core operations: 2*M*N*K over 1,979 TOP/s.
//
// What the design does about it:
// * Tensor cores through mma.sync.m16n8k32.s8 with an int32 accumulator in
//   registers. The TPU grid carries the accumulator across its sequential
//   K axis in VMEM; here each block loops over K itself. wgmma and TMA are
//   later work.
// * mma wants B with K contiguous for each column n, but w_q is (K, N)
//   row-major, and ldmatrix.trans does not take 8-bit elements. Each thread
//   loads a 4 (k) x 4 (n) byte block as four 32-bit words (four rows of w_q,
//   neighbouring threads on neighbouring n, so each row read is coalesced),
//   transposes it in registers with __byte_perm and stores four words of
//   4 k each into the transposed shared tile Bs[n][k].
// * Two tile shapes. Decode (M <= 32) takes 16 x 64 tiles: m16 is the
//   smallest mma row count, so M = 8 fills half of it, and narrow N tiles
//   give more blocks. Prefill takes 64 x 128 tiles.
// * Split K across blocks (gridDim.z) when the M x N tiles alone would not
//   fill the card (decode, and narrow N such as wkv_a's 576). Each split
//   adds its int32 partial sums atomically into a zeroed int32 workspace
//   and a second pass applies the epilogue. Integer addition is exact and
//   associative, so the result does not depend on the order of the splits.
// * Ragged M, N and K tails are masked: out-of-range A and B bytes load as
//   zero and out-of-range outputs are not written; nothing is halved to
//   divide the shape.
// * The epilogue multiplies in the reference's order, (acc * x_scale) *
//   w_scale, each in f32 round-to-nearest, so the f32 output equals the
//   plain version's bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // four warps
constexpr int kBK = 64;                  // k bytes per tile (two mma k-steps)
// Tile shapes (BM x BN, warps along M): decode for M <= kSmallM, else
// prefill.
constexpr int kSmallM = 32;
constexpr int kSmallBM = 16, kSmallBN = 64, kSmallWarpsM = 1;
constexpr int kLargeBM = 64, kLargeBN = 128, kLargeWarpsM = 2;
// Split K until the grid has about this many blocks per SM.
constexpr int kBlocksPerSM = 2;
// Row pitch of the A tile in shared memory: 80 bytes keeps rows 16-byte
// aligned for the 16-byte stores, and the eight rows a fragment load
// touches fall in distinct banks.
constexpr int kAPitch = kBK + 16;
// Row pitch of the transposed B tile: 68 bytes (17 words) makes the
// transposing stores at most 4-way and the fragment loads at most 2-way
// bank-conflicted.
constexpr int kBPitch = kBK + 4;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(void* out, int out_bf16, size_t i,
                                          float v) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

__device__ __forceinline__ float rescale(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// BM x BN output tile per block, WARPS_M x (4 / WARPS_M) warps, each warp
// MI x NI mma tiles of 16 x 8. a_vec: K % 16 == 0 and x_q 16-byte aligned.
// b_vec: N % 4 == 0 and w_q 4-byte aligned. partial == null: one split,
// write the epilogue; else add int32 sums into partial (M, N).
template <int BM, int BN, int WARPS_M>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ xs, const float* __restrict__ wsc,
                 void* __restrict__ out, int* __restrict__ partial, int M,
                 int N, int K, int tiles_per_split, int out_bf16, int a_vec,
                 int b_vec) {
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(MI >= 1 && NI >= 1 && WM % 16 == 0 && WN % 8 == 0, "tile");
  __shared__ __align__(16) int8_t As[BM * kAPitch];
  __shared__ __align__(16) int8_t Bs[BN * kBPitch];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(k_tiles, kt0 + tiles_per_split);

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    // A tile: BM rows x 64 k, as in x_q.
    if (a_vec) {
      for (int c = tid; c < BM * (kBK / 16); c += kThreads) {
        const int r = c / (kBK / 16), kc = (c % (kBK / 16)) * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M && k0 + kc < K)
          v = *reinterpret_cast<const uint4*>(xq + (size_t)(m0 + r) * K + k0 + kc);
        *reinterpret_cast<uint4*>(As + r * kAPitch + kc) = v;
      }
    } else {
      for (int c = tid; c < BM * kBK; c += kThreads) {
        const int r = c / kBK, kk = c % kBK;
        As[r * kAPitch + kk] = (m0 + r < M && k0 + kk < K)
                                   ? xq[(size_t)(m0 + r) * K + k0 + kk]
                                   : (int8_t)0;
      }
    }
    // B tile: 64 k x BN n, stored transposed as Bs[n][k].
    for (int blk = tid; blk < (kBK / 4) * (BN / 4); blk += kThreads) {
      const int nb = blk % (BN / 4), kb = blk / (BN / 4);
      const int n = n0 + nb * 4, k = k0 + kb * 4;
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t w = 0u;
        if (k + i < K) {
          const int8_t* src = wq + (size_t)(k + i) * N + n;
          if (b_vec) {
            if (n < N) w = *reinterpret_cast<const uint32_t*>(src);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < N) w |= (uint32_t)(uint8_t)src[j] << (8 * j);
          }
        }
        r[i] = w;            // byte j: w_q[k + i, n + j]
      }
      // 4x4 byte transpose: t0 = [k0n0 k1n0 k0n1 k1n1], t1 = [k0n2 k1n2
      // k0n3 k1n3], t2/t3 the same for k2, k3; then column j = [k0..k3 of n+j].
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      int8_t* dst = Bs + (nb * 4) * kBPitch + kb * 4;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + kBPitch) = __byte_perm(t0, t2, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kBPitch) = __byte_perm(t1, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kBPitch) = __byte_perm(t1, t3, 0x7632);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // Fragments of mma.m16n8k32 (PTX ISA): A register 0/1/2/3 holds row
      // g / g+8 / g / g+8, k tig*4..+3 (+16 for registers 2, 3); B register
      // 0/1 holds column g, k tig*4..+3 (+16 for register 1).
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = As + (wm * WM + i * 16 + g) * kAPitch + kk + tig * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kAPitch);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kAPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* p = Bs + (wn * WN + j * 8 + g) * kBPitch + kk + tig * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // Accumulator register v of tile (i, j): row g (v < 2) or g+8, column
  // tig*2 + (v & 1).
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int row = m0 + wm * WM + i * 16 + g + (v >= 2 ? 8 : 0);
        const int col = n0 + wn * WN + j * 8 + tig * 2 + (v & 1);
        if (row >= M || col >= N) continue;
        const size_t idx = (size_t)row * N + col;
        if (partial != nullptr)
          atomicAdd(partial + idx, acc[i][j][v]);
        else
          store_out(out, out_bf16, idx, rescale(acc[i][j][v], xs[row], wsc[col]));
      }
    }
  }
}

__global__ void int8_gemm_epilogue(const int* __restrict__ partial,
                                   const float* __restrict__ xs,
                                   const float* __restrict__ wsc,
                                   void* __restrict__ out, int M, int N,
                                   int out_bf16) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(i / N), col = (int)(i % N);
    store_out(out, out_bf16, i, rescale(partial[i], xs[row], wsc[col]));
  }
}

template <int BM, int BN, int WARPS_M>
int launch(const void* xq, const void* wq, const void* xs, const void* wsc,
           void* out, void* partial, int M, int N, int K, int splits,
           int tiles_per_split, int out_bf16, int a_vec, int b_vec,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_gemm_kernel<BM, BN, WARPS_M><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(xs), static_cast<const float*>(wsc), out,
      splits > 1 ? static_cast<int*>(partial) : nullptr, M, N, K,
      tiles_per_split, out_bf16, a_vec, b_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 4096
                               ? (total + threads - 1) / threads : 4096);
  int8_gemm_epilogue<<<blocks, threads, 0, stream>>>(
      static_cast<const int*>(partial), static_cast<const float*>(xs),
      static_cast<const float*>(wsc), out, M, N, out_bf16);
  return (int)cudaGetLastError();
}

struct Plan {
  int small, splits, tiles_per_split;
};

// Split K only as far as needed for about kBlocksPerSM blocks per SM, and
// never into an empty split.
Plan make_plan(int M, int N, int K, int n_sm) {
  Plan p;
  p.small = M <= kSmallM;
  const long long bm = p.small ? kSmallBM : kLargeBM;
  const long long bn = p.small ? kSmallBN : kLargeBN;
  const long long blocks = ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  const long long k_tiles = (K + kBK - 1) / kBK;
  const long long room = blocks > 0 ? blocks : 1;
  long long want = ((long long)kBlocksPerSM * n_sm + room - 1) / room;
  want = want < k_tiles ? want : k_tiles;
  want = want > 1 ? want : 1;
  p.tiles_per_split = (int)(k_tiles ? (k_tiles + want - 1) / want : 0);
  p.splits = p.tiles_per_split
                 ? (int)((k_tiles + p.tiles_per_split - 1) / p.tiles_per_split)
                 : 1;
  return p;
}

}  // namespace

extern "C" {

// The launch plan of an (M, K) x (K, N) product on a card with n_sm SMs:
// plan[0] = 1 for the decode tile shape, plan[1] = the number of K splits
// (more than 1 needs int8_gemm's workspace), plan[2] = K tiles per split,
// plan[3] = K bytes per tile.
void int8_gemm_plan(int M, int N, int K, int n_sm, int* plan) {
  const Plan p = make_plan(M, N, K, n_sm);
  plan[0] = p.small;
  plan[1] = p.splits;
  plan[2] = p.tiles_per_split;
  plan[3] = kBK;
}

// x_q (M, K), w_q (K, N) int8 row-major; x_scale (M,), w_scale (N,) f32;
// out (M, N) f32 (out_bf16 = 0) or bf16 (1). When int8_gemm_plan splits K,
// partial must be a zeroed int32 (M, N) workspace. Returns the CUDA error
// of the launches (0 on success).
int int8_gemm(const void* xq, const void* wq, const void* xs, const void* wsc,
              void* out, void* partial, int M, int N, int K, int n_sm,
              int out_bf16, int a_vec, int b_vec, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  const Plan p = make_plan(M, N, K, n_sm);
  if (p.splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  if (p.small)
    return launch<kSmallBM, kSmallBN, kSmallWarpsM>(
        xq, wq, xs, wsc, out, partial, M, N, K, p.splits, p.tiles_per_split,
        out_bf16, a_vec, b_vec, stream);
  return launch<kLargeBM, kLargeBN, kLargeWarpsM>(
      xq, wq, xs, wsc, out, partial, M, N, K, p.splits, p.tiles_per_split,
      out_bf16, a_vec, b_vec, stream);
}

}  // extern "C"
