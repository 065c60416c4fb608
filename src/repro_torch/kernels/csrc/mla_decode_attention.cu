// Absorbed-MLA decode attention (flash decoding) for Hopper, sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/mla_attention/mla_attention.py:69
//   mla_decode_attention_pallas (its pl.pallas_call at :83).
//
// For each request b and head h, one new query attends to the latent cache:
//   s[t]  = (q_lat[b,h,:] . cache[b,t,:R] + q_rope[b,h,:] . cache[b,t,R:]) * scale
//   o_lat = softmax(s[0..n_b-1]) . cache[b,0..n_b-1,:R],   n_b = min(cache_len[b], S-1) + 1
//   lse   = log sum_t exp(s[t])                  (optional, in the scores' scale)
// q_lat (B,H,R), q_rope (B,H,Dr), cache (B,S,R+Dr), out (B,H,R), lse (B,H):
// float32, contiguous; cache_len (B,) int32. Position cache_len[b] is included
// (the new entry is already written there); cache_len[b] == S, a
// capacity-frozen slot, attends to the whole cache. A negative cache_len[b]
// is an empty row (n_b = 0): o = 0 and lse = -inf. A cache sharded on its
// sequence gives each rank's block such rows (its bound cache_len - v0 lies
// before the block's first position v0), and the ranks' (o, lse) merge as
// the merge pass below merges pieces.
//
// Bound on this card. The function reads B*n*(R+Dr)*4 bytes and does
// 2*B*H*n*(2R+Dr) operations (n = mean valid length): at H=128, R=512, Dr=64
// ~121 FLOP per byte. Both products run on the tensor cores in 3xTF32 (three
// TF32 passes), so the bound is those operations at a third of the 495 TFLOP/s
// TF32 rate, ~0.0105 ms at the R1 serve's lengths, against ~0.0043 ms for the
// bytes: operations bound it.
//
// Design. One latent row serves all H heads, so the heads are the M dimension
// of the products and each block takes kHeads = 32 of them: every cache tile
// passes through shared memory H/32 = 4 times per request.
//   * The cut (plan.py mirrors it). The valid 32-position tiles of the whole
//     batch, row after row, are cut into n_pieces pieces at floor(p*T/P), so
//     no piece is more than one tile longer than another whatever the rows'
//     lengths. Every block computes the cut from cache_len in shared memory
//     (a warp scan over B), so the host never reads cache_len. A piece may
//     span rows; each (piece, row) overlap is a segment, whose partial
//     (m, l, acc) goes to slot piece + row of n_pieces + B - 1 (unique: both
//     grow along the sequence). The grid is (head groups, pieces), one wave
//     of one block per SM by default: the 4 head groups of a piece are
//     neighbours, so their reads of the same tiles meet in L2.
//   * The ring. Warp 0 copies each tile's valid rows (32 x 576 floats) into
//     a 2-stage ring with the TMA engine: one bulk copy (cp.async.bulk) of a
//     row per lane, completing on the stage's mbarrier, so the next tile's
//     bytes are in flight while the current one is multiplied and no thread
//     spends issue slots on copies (per-thread cp.async ran 14 % slower at
//     full rows on an H100). The ring starts zeroed, so rows past a ragged
//     tail hold finite values, which P V weighs 0. Two stages of 74.75 KB,
//     the partial scores (41 KB) and P (4.6 KB) take 195 KB of the 227 KB a
//     block may use; a third stage does not fit.
//   * Scores, S = Q K^T (32 heads x 32 positions, K = 576). Each of the 8
//     warps takes 72 of the 576 channels (split K), keeps its Q fragments in
//     registers for the whole segment (72 floats a thread, loaded once per
//     row), and reads each K element from shared memory once. The 8 partial
//     32 x 32 tiles meet in shared memory; one pass sums them, scales, masks
//     the ragged tail to -inf and runs the online softmax (a head per 8
//     lanes, m and l in those lanes' registers), writing P and each head's
//     rescale factor.
//   * O += P V (32 heads x 512 channels, K = 32 positions). Each warp owns
//     64 channels: a 32 x 64 f32 accumulator, 64 registers a thread. A
//     tile's product is summed from zero on the tensor cores (32 channels
//     at a time) and added to O by one IEEE fmaf with the rescale, so O's
//     error does not grow with the piece's length (accumulated in place by
//     the tensor cores, whose f32 sums round at the running sum's scale, a
//     1000-position piece drifted to 1.7e-5).
//   * Tensor cores: mma.sync.m16n8k8 in TF32, hand-loaded fragments. Each
//     operand is split into a TF32 high part and the exact rest (split_tf32,
//     as ssd_scan.cu does), and hi.hi + hi.lo + lo.hi is accumulated in f32:
//     only lo.lo and the tensor core's truncation of lo (~2^-21 of a
//     product) are lost, where one TF32 pass keeps ~3 decimal digits.
//     wgmma is not used: in TF32 it reads B from shared memory only K-major,
//     and P V's B (positions x channels, as the cache lays it out) is
//     N-major; its M is 64, so 32 heads would waste half of it, and Q for 64
//     heads in registers (288 a thread at 128 threads) or, split, in shared
//     memory (295 KB) does not fit; and it reads operands from shared memory
//     as they are, so 3xTF32 would need hi and lo copies of every tile (two
//     more 74 KB stages, past the budget). mma.sync splits in registers as
//     it loads.
//   * Shared-memory strides, every fragment load free of bank conflicts:
//     cache rows of 584 floats (8 mod 32). In the scores the MMA's k = t and
//     t + 4 are channels 2t and 2t + 1 of the k-step in both operands, so a
//     lane loads its Q pair once per row as a float2 and its K pair
//     (position g) as one 8-byte shared load; in P V the V fragment
//     (positions t and t + 4, channel g) and the P fragment (P rows of 36,
//     4 mod 32) are 4-byte loads. Partial-score rows of 40 (8 mod 32),
//     written as float2.
//   * The merge pass, a second kernel launched as the first one's
//     programmatic dependent (its blocks start as the first kernel's end,
//     and wait for its results): per (head, row), the pieces from the one
//     holding the row's first tile to the one holding its last, each
//     weighted by exp(m - max m); an empty piece (more pieces than tiles)
//     wrote nothing and weighs 0. The row's lse, max m + log(sum w l), goes
//     beside o_lat when asked for; an empty row (no tile) writes o = 0 and
//     lse = -inf and reads no piece. Merging in the first kernel instead, by
//     the block that finished a row's last segment, ran 10-26 % slower on an
//     H100: a merging block stalls its own tiles.
// Registers: Q fragments 72, P V accumulator 64, score accumulator 32 (or
// the P V tile's 32) and the split fragments: 237 at one block of 256
// threads per SM, no spills (ptxas -v in the build log; the chip smoke run
// fails on a spill). A 512-thread form (16 heads x 72 channels a warp, the
// small TF32 terms summed apart) held 128 registers only with spills and ran
// 10-14 % slower.
//
// Tolerance against the plain PyTorch version (kernels/mla_attention/ref.py):
// both float32 up to the 3xTF32 products' ~2^-21, the tensor cores' f32
// sums and another summation order, so they agree to rtol = atol = 3e-5,
// the tolerance the repository's kernel tests use (max |diff| 4e-6 to 8e-6
// at R1's widths on an H100; ref.py's mla_decode_attention_3xtf32 shows
// the products' part on the CPU).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 32;                 // heads per block: two m16 tiles
constexpr int kTile = 32;                  // cache positions per ring stage
constexpr int kStages = 2;                 // ring depth
constexpr int kMaxW = 576;                 // most R + Dr
constexpr int kKSteps = kMaxW / 8 / kWarps;  // score k-steps of 8 per warp
constexpr int kPvCols = 64;                // P V channels per warp
constexpr int kLdKV = kMaxW + 8;           // cache tile row stride (8 mod 32)
constexpr int kLdS = kTile + 8;            // partial scores row stride (8 mod 32)
constexpr int kLdP = kTile + 4;            // P row stride (4 mod 32)
constexpr int kMaxPieces = 1024;
constexpr int kCombineThreads = 128;

constexpr int kSmemFloats = kStages * kTile * kLdKV    // ring
                          + kWarps * kHeads * kLdS     // partial scores
                          + kHeads * kLdP              // P
                          + kHeads                     // rescale factors
                          + 2 * kStages;               // the ring's mbarriers

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

// A bulk copy (the TMA engine, no tensor map) of `bytes` (a multiple of 16,
// both addresses 16-byte aligned) into shared memory, completing its bytes
// on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// f = hi + lo: hi is f rounded to TF32 (10 mantissa bits; adding half a
// TF32 ulp to the bits, then clearing the 13 below it), lo the exact rest,
// passed as it is: the tensor core reads a TF32 operand's top 19 bits and
// so truncates lo.
__device__ __forceinline__ void split_tf32(float f, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(f) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(f - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ int piece_start(int p, int total, int n_pieces) {
  return static_cast<int>(static_cast<long long>(p) * total / n_pieces);
}

// The piece that holds tile `g`: the largest p with piece_start(p) <= g.
__device__ __forceinline__ int piece_of(int g, int total, int n_pieces) {
  return static_cast<int>(
      ((static_cast<long long>(g) + 1) * n_pieces - 1) / total);
}

// Valid positions of each row (nval[b]) and the prefix sums of their tile
// counts (start[0..B]), by warp 0; the caller synchronises.
__device__ void plan_rows(const int* __restrict__ cache_len, int B, int S,
                          int* start, int* nval) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int carry = 0;
  for (int base = 0; base < B; base += 32) {
    const int b = base + lane;
    int n = 0, tiles = 0;
    if (b < B) {
      // A negative bound is an empty row: no position, no tile (a rank's
      // block of a sequence-sharded cache that lies past the row's end).
      n = cache_len[b] < 0 ? 0 : min(cache_len[b], S - 1) + 1;
      tiles = (n + kTile - 1) / kTile;
      nval[b] = n;
    }
    int incl = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (b < B) start[b] = carry + incl - tiles;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) start[B] = carry;
}

constexpr int kAccCols = kPvCols / 8;      // n8 tiles of a warp's P V part

// This warp's Q fragments for `row`, as the scores' A operand with the
// MMA's k = t and t + 4 at channels k0 + 2t and k0 + 2t + 1 (k0 =
// (warp * kKSteps + ks) * 8): heads h0 + 16i + g (+8 in [1], [3]), one
// float2 per head and k-step; 0 past H and W.
__device__ __forceinline__ void load_q(float (&qf)[2][kKSteps][4],
                                       const float* __restrict__ q_lat,
                                       const float* __restrict__ q_rope,
                                       int row, int h0, int H, int R, int Dr) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        const int h = h0 + 16 * i + g + 8 * r8;
        const int c = (warp * kKSteps + ks) * 8 + 2 * t;
        const size_t qr = static_cast<size_t>(row) * H + h;
        float2 v = make_float2(0.f, 0.f);
        if (h < H && c < R + Dr)   // R and Dr even: c, c + 1 on one side
          v = *reinterpret_cast<const float2*>(
              c < R ? q_lat + qr * R + c : q_rope + qr * Dr + c - R);
        qf[i][ks][r8] = v.x;
        qf[i][ks][r8 + 2] = v.y;
      }
}

// A segment's partial (m, l, acc) to `slot`; then zeroes for the next one.
// acc holds heads h0 + 16i + g (+8 in [2], [3]) x channels
// warp * kPvCols + 8j + 2t (+1 in [1], [3]); (m, l) are head h0 + tid / 8's.
__device__ __forceinline__ void flush_segment(
    float (&acc)[2][kAccCols][4], float& m_run, float& l_run,
    float* __restrict__ part_acc, float* __restrict__ part_ml, size_t slot,
    int h0, int H, int R) {
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2,
            t = tid & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) {
      const int col = warp * kPvCols + 8 * j + 2 * t;
      const int h = h0 + 16 * i + g;
      if (col < R) {
        if (h < H)
          *reinterpret_cast<float2*>(part_acc + (slot * H + h) * R + col) =
              make_float2(acc[i][j][0], acc[i][j][1]);
        if (h + 8 < H)
          *reinterpret_cast<float2*>(part_acc + (slot * H + h + 8) * R + col) =
              make_float2(acc[i][j][2], acc[i][j][3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
    }
  const int hh = h0 + (tid >> 3);
  if ((tid & 7) == 0 && hh < H) {
    part_ml[(slot * H + hh) * 2] = m_run;
    part_ml[(slot * H + hh) * 2 + 1] = l_run;
  }
  m_run = -INFINITY;
  l_run = 0.f;
}

__global__ void __launch_bounds__(kThreads, 1)
mla_split_kernel(const float* __restrict__ q_lat,
                 const float* __restrict__ q_rope,
                 const float* __restrict__ cache,
                 const int* __restrict__ cache_len,
                 float* __restrict__ part_acc,   // (n_pieces + B - 1, H, R)
                 float* __restrict__ part_ml,    // (n_pieces + B - 1, H, 2)
                 int* __restrict__ plan,         // (B + 1,) tile starts
                 int B, int H, int S, int R, int Dr, int n_pieces,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* kv_s = reinterpret_cast<float*>(smem4);        // [kStages][kTile][kLdKV]
  float* ps_s = kv_s + kStages * kTile * kLdKV;          // [kWarps][kHeads][kLdS]
  float* p_s = ps_s + kWarps * kHeads * kLdS;            // [kHeads][kLdP]
  float* alpha_s = p_s + kHeads * kLdP;                  // [kHeads]
  const uint32_t full = smem_u32(alpha_s + kHeads);      // kStages mbarriers
  int* start_s = reinterpret_cast<int*>(alpha_s + kHeads + 2 * kStages);  // [B + 1]
  int* nval_s = start_s + B + 1;                            // [B]

  const int W = R + Dr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = blockIdx.x * kHeads;
  const int piece = blockIdx.y;

  // The ring starts at zero: a ragged tile leaves the rows past its end as
  // they were, and P V reads them at weight 0, so they must be finite.
  for (int i = tid; i < kStages * kTile * kLdKV / 4; i += kThreads)
    reinterpret_cast<float4*>(kv_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  plan_rows(cache_len, B, S, start_s, nval_s);
  __syncthreads();
  const int total = start_s[B];
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = tid; i <= B; i += kThreads) plan[i] = start_s[i];
  const int c0 = piece_start(piece, total, n_pieces);
  const int c1 = piece_start(piece + 1, total, n_pieces);
  if (c0 >= c1) return;                           // an empty piece

  // The loader runs kStages - 1 tiles ahead of the compute, with its own
  // row cursor: warp 0 copies a tile's valid rows, one bulk copy of W
  // floats a lane, onto its stage's barrier.
  int ld_gt = c0, ld_row = 0;
  auto issue = [&]() {
    if (warp == 0 && ld_gt < c1) {
      while (start_s[ld_row + 1] <= ld_gt) ++ld_row;
      const int t0 = (ld_gt - start_s[ld_row]) * kTile;
      const int nt = min(kTile, nval_s[ld_row] - t0);
      const int stage = (ld_gt - c0) % kStages;
      const uint32_t bar = full + 8 * stage;
      if (lane == 0) mbar_expect_tx(bar, nt * W * 4);
      if (lane < nt)
        bulk_load(smem_u32(kv_s + (stage * kTile + lane) * kLdKV),
                  cache + (static_cast<size_t>(ld_row) * S + t0 + lane) * W,
                  W * 4, bar);
    }
    ++ld_gt;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();

  float qf[2][kKSteps][4];     // this warp's Q fragments (its 72 channels)
  float acc[2][kAccCols][4];  // O: heads 16i+g(+8) x channels 64w+8j+2t(+1)
  // The softmax lanes: head sm_h, positions sm_c..sm_c+3 of each tile.
  const int sm_h = tid >> 3, sm_c = (tid & 7) * 4;
  float m_run = -INFINITY, l_run = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kAccCols; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  int row = 0;               // the first row's Q loads while its tile lands
  while (start_s[row + 1] <= c0) ++row;
  load_q(qf, q_lat, q_rope, row, h0, H, R, Dr);
  for (int gt = c0; gt < c1; ++gt) {
    mbar_wait(full + 8 * ((gt - c0) % kStages), ((gt - c0) / kStages) & 1);
    __syncthreads();      // tile gt - 1 is done with, so its stage takes
    issue();              // tile gt + kStages - 1

    if (start_s[row + 1] <= gt) {                 // the piece enters a row
      flush_segment(acc, m_run, l_run, part_acc, part_ml,
                    static_cast<size_t>(piece) + row, h0, H, R);
      while (start_s[row + 1] <= gt) ++row;
      load_q(qf, q_lat, q_rope, row, h0, H, R, Dr);
    }
    const int nt = min(kTile, nval_s[row] - (gt - start_s[row]) * kTile);
    const float* kv = kv_s + ((gt - c0) % kStages) * kTile * kLdKV;

    {  // this warp's 72 channels of S = Q K^T: heads x positions
      float sc[2][kTile / 8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[i][j][k] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int k0 = (warp * kKSteps + ks) * 8;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) split_tf32(qf[i][ks][k], ah[i][k], al[i][k]);
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          // k = t and t + 4 are channels k0 + 2t and k0 + 2t + 1.
          const float2 kk = *reinterpret_cast<const float2*>(
              kv + (8 * j + g) * kLdKV + k0 + 2 * t);
          uint32_t bh[2], bl[2];
          split_tf32(kk.x, bh[0], bl[0]);
          split_tf32(kk.y, bh[1], bl[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_3xtf32(sc[i][j], ah[i], al[i], bh, bl);
        }
      }
      float* mine = ps_s + warp * kHeads * kLdS;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          float* p = mine + (16 * i + g) * kLdS + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(p) = make_float2(sc[i][j][0], sc[i][j][1]);
          *reinterpret_cast<float2*>(p + 8 * kLdS) =
              make_float2(sc[i][j][2], sc[i][j][3]);
        }
    }
    __syncthreads();

    {  // sum the warps' parts, scale, mask; online softmax, 8 lanes a head
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(
            ps_s + (w * kHeads + sm_h) * kLdS + sm_c);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      float v[4] = {s.x * scale, s.y * scale, s.z * scale, s.w * scale};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (sm_c + k >= nt) v[k] = -INFINITY;
      float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);   // finite: position 0 is valid
      float e[4], sum = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        e[k] = sm_c + k < nt ? expf(v[k] - m_new) : 0.f;
        sum += e[k];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m_run - m_new);  // 0 on a segment's first tile
      l_run = l_run * alpha + sum;
      m_run = m_new;
      *reinterpret_cast<float4*>(p_s + sm_h * kLdP + sm_c) =
          make_float4(e[0], e[1], e[2], e[3]);
      if ((tid & 7) == 0) alpha_s[sm_h] = alpha;
    }
    __syncthreads();

    // O = O * alpha + P V over this warp's 64 channels, in two halves of
    // 32: each half's tile product is summed from zero by the tensor cores,
    // then added to O by one IEEE fmaf, so O takes one rounding a tile
    // whatever the piece's length (the tensor core's own f32 accumulation
    // of 12 products a tile into a long-running O drifted with it).
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmp[2][kAccCols / 2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kAccCols / 2; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) tmp[i][j][k] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kTile / 8; ++ks) {
        if (8 * ks >= nt) break;                  // past the ragged tail
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* p = p_s + (16 * i + g) * kLdP + 8 * ks + t;
          split_tf32(p[0], ah[i][0], al[i][0]);
          split_tf32(p[8 * kLdP], ah[i][1], al[i][1]);
          split_tf32(p[4], ah[i][2], al[i][2]);
          split_tf32(p[8 * kLdP + 4], ah[i][3], al[i][3]);
        }
        const float* vrow = kv + (8 * ks + t) * kLdKV + warp * kPvCols +
                            half * (kPvCols / 2) + g;
#pragma unroll
        for (int j = 0; j < kAccCols / 2; ++j) {
          uint32_t bh[2], bl[2];
          split_tf32(vrow[8 * j], bh[0], bl[0]);
          split_tf32(vrow[8 * j + 4 * kLdKV], bh[1], bl[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_3xtf32(tmp[i][j], ah[i], al[i], bh, bl);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float a0 = alpha_s[16 * i + g], a1 = alpha_s[16 * i + g + 8];
#pragma unroll
        for (int j = 0; j < kAccCols / 2; ++j) {
          const int jj = half * (kAccCols / 2) + j;
          acc[i][jj][0] = fmaf(acc[i][jj][0], a0, tmp[i][j][0]);
          acc[i][jj][1] = fmaf(acc[i][jj][1], a0, tmp[i][j][1]);
          acc[i][jj][2] = fmaf(acc[i][jj][2], a1, tmp[i][j][2]);
          acc[i][jj][3] = fmaf(acc[i][jj][3], a1, tmp[i][j][3]);
        }
      }
    }
  }
  // Every block is running by now: the merge pass may launch (it waits for
  // this grid's end before it reads).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  flush_segment(acc, m_run, l_run, part_acc, part_ml,
                static_cast<size_t>(piece) + row, h0, H, R);
}

__global__ void __launch_bounds__(kCombineThreads)
mla_combine_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   const int* __restrict__ plan,
                   float* __restrict__ out, float* __restrict__ lse, int B,
                   int H, int R, int n_pieces) {
  // Launched as the split kernel's programmatic dependent: wait for it.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  __shared__ float w_s[kMaxPieces];
  __shared__ float inv_l;
  __shared__ int p_lo, p_hi;
  if (threadIdx.x < 32 && plan[b] == plan[b + 1]) {
    // An empty row (no tile; the total may be 0): no piece to read, so the
    // loop below writes o = 0; its lse is -inf.
    if (threadIdx.x == 0) {
      inv_l = 0.f;
      p_lo = 0;
      p_hi = -1;
      if (lse != nullptr) lse[static_cast<size_t>(b) * H + h] = -INFINITY;
    }
  } else if (threadIdx.x < 32) {   // warp 0: a piece per lane, (m, l) as a float2
    const int lane = threadIdx.x;
    const int total = plan[B];
    const int lo = piece_of(plan[b], total, n_pieces);
    const int hi = piece_of(plan[b + 1] - 1, total, n_pieces);
    float m_max = -INFINITY;
    for (int p = lo + lane; p <= hi; p += 32)
      if (piece_start(p, total, n_pieces) < piece_start(p + 1, total, n_pieces))
        m_max = fmaxf(m_max, part_ml[((static_cast<size_t>(p) + b) * H + h) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, o));
    float l_sum = 0.f;
    for (int p = lo + lane; p <= hi; p += 32) {
      float w = 0.f;                              // an empty piece: 0
      if (piece_start(p, total, n_pieces) < piece_start(p + 1, total, n_pieces)) {
        const float2 ml = *reinterpret_cast<const float2*>(
            part_ml + ((static_cast<size_t>(p) + b) * H + h) * 2);
        w = ml.y > 0.f ? expf(ml.x - m_max) : 0.f;
        l_sum += w * ml.y;
      }
      w_s[p - lo] = w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l_sum += __shfl_xor_sync(0xffffffffu, l_sum, o);
    if (lane == 0) {
      inv_l = 1.f / l_sum;
      p_lo = lo;
      p_hi = hi;
      if (lse != nullptr) lse[static_cast<size_t>(b) * H + h] = m_max + logf(l_sum);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x * 4; c < R; c += kCombineThreads * 4) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p0 = p_lo; p0 <= p_hi; p0 += 4) {   // four pieces' loads at once
      float4 v[4];
      float w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + k;
        w[k] = p <= p_hi ? w_s[p - p_lo] : 0.f;
        v[k] = w[k] != 0.f
            ? *reinterpret_cast<const float4*>(
                  part_acc + ((static_cast<size_t>(p) + b) * H + h) * R + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o.x = fmaf(w[k], v[k].x, o.x); o.y = fmaf(w[k], v[k].y, o.y);
        o.z = fmaf(w[k], v[k].z, o.z); o.w = fmaf(w[k], v[k].w, o.w);
      }
    }
    o.x *= inv_l; o.y *= inv_l; o.z *= inv_l; o.w *= inv_l;
    *reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * H + h) * R + c) = o;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes the split kernel needs for a batch of B rows.
int mla_decode_attention_smem_bytes(int B) {
  return kSmemFloats * static_cast<int>(sizeof(float)) +
         (2 * B + 1) * static_cast<int>(sizeof(int));
}

// Launches both passes on `stream`; returns cudaGetLastError() (0 = launched).
// The caller checks the shape limits (R % 4 == 0, R <= 512, Dr % 4 == 0,
// R + Dr <= 576, 1 <= n_pieces <= 1024) and allocates the partial buffers,
// (n_pieces + B - 1) slots, and the (B + 1,) int32 plan. `lse` (B, H) may be
// null: the default call writes o_lat alone.
int mla_decode_attention_f32(const float* q_lat, const float* q_rope,
                             const float* cache, const int* cache_len,
                             float* out, float* lse, float* part_acc,
                             float* part_ml,
                             int* plan, int B, int H, int S, int R, int Dr,
                             int n_pieces, float scale, cudaStream_t stream) {
  const int smem = mla_decode_attention_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(
      mla_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kHeads - 1) / kHeads, n_pieces);
  mla_split_kernel<<<grid, kThreads, smem, stream>>>(
      q_lat, q_rope, cache, cache_len, part_acc, part_ml, plan, B, H, S, R, Dr,
      n_pieces, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // The merge pass as a programmatic dependent launch: its blocks are
  // launched as the split kernel's blocks end, and wait for its results.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mla_combine_kernel, part_acc,
                           static_cast<const float*>(part_ml),
                           static_cast<const int*>(plan), out, lse, B, H, R,
                           n_pieces);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
