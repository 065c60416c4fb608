// Mamba2 SSD (state-space duality) chunked scan, hand-written for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan/ssd_scan.py: ssd_scan_pallas (body
// _kernel). Inputs x (B,S,H,P), dt (B,S,H), a_log (H,), B and C (B,S,N), all
// f32 and contiguous; outputs y (B,S,H,P) and the final state h (B,H,P,N).
// With cum = cumsum over the chunk of dt * -exp(a_log[h]), chunk c of Q rows
// gives
//     y[t] = exp(cum_t) C_t . h_{c-1}                             (inter-chunk)
//          + sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s    (intra-chunk)
//     h_c  = exp(cum_last) h_{c-1} + s_c,
//     s_c  = sum_s exp(cum_last - cum_s) dt_s x_s (x) B_s           (chunk state)
// from h_{-1} = 0 (arXiv:2405.21060 section 6). Two differences from the TPU
// kernel, both by design: the last chunk may be ragged (rows past S read as
// dt = 0, x = B = C = 0, so they add nothing to y, cum_last or the state, and
// the state written is the one after the last valid row), where the TPU
// wrapper halves the chunk until it divides S; and W is masked before the
// exponential, so exp of a positive difference above the diagonal is never
// taken.
//
// What bounds it on an H100: operations. The function needs C.B^T once per
// (batch, chunk), since every head shares B and C, and W.x, C.h and the
// chunk state per head; C.B^T and W.x only on and below the diagonal (y_t
// reads rows s <= t), C.h not for the first chunk (its entering state is
// zero): ~1.9 GFLOP at S = 1019 against ~28 MB of inputs and outputs. In
// 3xTF32 on the tensor cores that is three TF32 passes, 0.012 ms at the
// data-sheet rate, against 0.008 ms for the bytes.
//
// What the design does about it. The TPU grid (B, H, chunks) runs the chunk
// axis in order with the (P, N) state in VMEM. Only the state recurrence
// across chunks must be sequential, and it is elementwise over (P, N). So
// the scan is four stages, launched in order on one stream:
//   1. cb_kernel: C.B^T of every (batch, chunk), once, into a (B, nc, Q, Q)
//      scratch (512 KB at S = 1019; it stays in L2 for stage 4). Tiles of
//      64 x 64 on or below the diagonal only.
//   2. states_kernel, per (batch, chunk, head) and tile of (P, N): cum by a
//      warp scan (written to a (B, nc, H, Q) scratch), u = exp(cum_last -
//      cum) dt x in shared memory, and the chunk's own state s_c = u^T B
//      into a (B, nc, H, P, N) scratch. Every chunk at once.
//   3. pass_kernel, per (batch, head) and 1024 elements of (P, N): walks
//      the chunks, writes the state that enters each one in place of s_c,
//      and the last state to h. The only serial loop, ~25 MB through L2.
//   4. output_kernel, per (batch, chunk, head) and 64 columns of P: y =
//      exp(cum_t) C.h_{c-1} (skipped for chunk 0), then W = mask(C.B^T) *
//      exp(cum_t - cum_s) * dt_s in shared memory and y += W.x over the
//      columns s <= t only.
// Every product (C.B^T, u^T.B, C.h, W.x) runs on the tensor cores through
// mma.sync.m16n8k8 in 3xTF32: each operand is split into a TF32 high part
// and a remainder, and hi.hi + hi.lo + lo.hi is accumulated in f32, so only
// lo.lo and the truncation of lo (~2^-21 of the product) are lost; one TF32
// pass would keep ~3 decimal digits. The split is integer arithmetic on the
// bits (split_tf32), cheaper than cvt.rna.tf32. cum, the exponentials and
// the masks stay in f32. Tiles
// reach shared memory by cp.async, 16 bytes a copy where the row allows it
// (4 bytes otherwise), zero-filled past the chunk's valid rows and past P
// and N, at row strides that make every fragment load conflict-free. The
// scratch shapes depend on Q and the number of chunks alone, so the wrapper
// computes them; of the tile shapes it needs only kQ, which
// ssd_scan_max_chunk gives it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block, every stage
constexpr int kQ = 128;        // most rows in a chunk
constexpr int kCBT = 64;       // C.B^T: rows and columns of a block's tile
constexpr int kCBK = 64;       // C.B^T: N slice per shared-memory load
constexpr int kPT = 64;        // P columns per block (chunk states, output)
constexpr int kNT = 128;       // N columns per block (chunk states); the N
                               // slice per load of the output stage
constexpr int kPassVec = 4;    // state-pass elements per thread

// Shared-memory row strides (floats). A fragment load of mma.m16n8k8 reads
// rows g = 0..7 at k = 0..3: where k runs along a row the stride is 4 mod
// 32, where it runs across rows 8 mod 32, so the 32 lanes hit 32 banks.
constexpr int kLdCB = kCBK + 4;  // C and B slices of the C.B^T stage
constexpr int kLdN = kNT + 4;    // C and h slices of the output stage
constexpr int kLdQ = kQ + 4;     // C.B^T, then W, in the output stage
constexpr int kLdP = kPT + 8;    // x tiles (k = row)
constexpr int kLdB = kNT + 8;    // B tile of the chunk-states stage (k = row)

enum Stage { kStageCB = 0, kStageStates, kStagePass, kStageOutput, kStages };

struct Plan {
  int q, nc;                 // rows per chunk, chunks
  int cb_tiles;              // lower-triangular kCBT tiles of a chunk's C.B^T
  int p_tiles, n_tiles;      // kPT and kNT tiles of P and N
  int pass_blocks;           // state-pass blocks per (batch, head)
  long long grid[kStages];   // blocks of each stage (1-D grids)
  int smem[kStages];         // dynamic shared memory of each stage, bytes
};

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

inline Plan make_plan(int batch, int S, int H, int P, int N, int chunk) {
  Plan p{};
  p.q = chunk < S ? chunk : S;
  if (p.q < 1) p.q = 1;
  p.nc = cdiv(S, p.q);
  const int t = cdiv(p.q, kCBT);
  p.cb_tiles = t * (t + 1) / 2;
  p.p_tiles = cdiv(P, kPT);
  p.n_tiles = cdiv(N, kNT);
  p.pass_blocks = cdiv((long long)P * N, (long long)kThreads * kPassVec);
  const long long bc = (long long)batch * p.nc;
  p.grid[kStageCB] = bc * p.cb_tiles;
  p.grid[kStageStates] = bc * H * p.p_tiles * p.n_tiles;
  p.grid[kStagePass] = (long long)batch * H * p.pass_blocks;
  p.grid[kStageOutput] = bc * H * p.p_tiles;
  p.smem[kStageCB] = 4 * 2 * kCBT * kLdCB;
  p.smem[kStageStates] = 4 * (kQ * kLdP + kQ * kLdB + 2 * kQ);
  const int phase1 = kQ * kLdN + kPT * kLdN;     // C, h
  const int phase2 = kQ * kLdQ + kQ * kLdP;      // C.B^T then W, x
  p.smem[kStageOutput] = 4 * ((phase1 > phase2 ? phase1 : phase2) + 2 * kQ);
  p.smem[kStagePass] = 0;
  return p;
}

// cp.async (sm_80+): `bytes` (0..16) of 16 from global to shared memory,
// the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of rows [0, rows) x columns [0, cols) of the row-major
// global matrix g (row stride gld floats) into shared memory s (row stride
// sld) and writes zeros to the rest of the R x C extent. vec: 16-byte
// copies, which need g 16-byte aligned and gld % 4 == 0.
template <int R, int C>
__device__ __forceinline__ void load_tile(float* s, int sld, const float* g,
                                          long long gld, int rows, int cols,
                                          bool vec) {
  if (vec) {
    constexpr int C4 = C / 4;
    for (int i = threadIdx.x; i < R * C4; i += kThreads) {
      const int r = i / C4, c = (i - r * C4) * 4;
      const int n = r < rows ? min(max(cols - c, 0), 4) : 0;
      float* d = s + r * sld + c;
      if (n > 0)
        cp_async16(d, g + r * gld + c, 4 * n);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      float* d = s + r * sld + c;
      if (r < rows && c < cols)
        cp_async4(d, g + r * gld + c);
      else
        *d = 0.0f;
    }
  }
}

// f = hi + lo: hi is f rounded to TF32 (10 mantissa bits; adding half a
// TF32 ulp to the bits, then clearing the 13 below it), lo the exact rest,
// passed as it is: the tensor core reads a TF32 operand's top 19 bits and
// so truncates lo, which costs ~2^-21 of the product.
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

// One warp: acc[MI][NI] (tiles of 16 x 8) += A.B over `ksteps` steps of 8
// along k, in 3xTF32 (the small terms first). A(m, k) = a[m*AM + k*AK] from
// the warp's first row, B(k, n) = b[k*BK + n*BN] from its first column, both
// in shared memory. Fragments of mma.m16n8k8 (PTX ISA), g = lane / 4, t =
// lane % 4: A holds (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (t, g), (t+4,
// g); the accumulator of tile (i, j) rows 16i + g (+8 in [2], [3]) and
// columns 8j + 2t (+1 in [1], [3]).
template <int MI, int NI, int AM, int AK, int BK, int BN>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4],
                                         const float* a, const float* b,
                                         int ksteps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  a += g * AM + t * AK;
  b += t * BK + g * BN;
  for (int ks = 0; ks < ksteps; ++ks, a += 8 * AK, b += 8 * BK) {
    uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const float* p = a + 16 * i * AM;
      split_tf32(p[0], ah[i][0], al[i][0]);
      split_tf32(p[8 * AM], ah[i][1], al[i][1]);
      split_tf32(p[4 * AK], ah[i][2], al[i][2]);
      split_tf32(p[8 * AM + 4 * AK], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const float* p = b + 8 * j * BN;
      split_tf32(p[0], bh[j][0], bl[j][0]);
      split_tf32(p[4 * BK], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        mma_tf32(acc[i][j], al[i], bh[j]);
        mma_tf32(acc[i][j], ah[i], bl[j]);
        mma_tf32(acc[i][j], ah[i], bh[j]);
      }
  }
}

// The warp's accumulator to out[m*ld + n] (m, n from its first row and
// column) for m < rows and n < cols.
template <int MI, int NI>
__device__ __forceinline__ void store_acc(const float (&acc)[MI][NI][4],
                                          float* out, long long ld, int rows,
                                          int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * i + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
        if (m < rows && n < cols) out[m * ld + n] = acc[i][j][e];
      }
}

// Warp 0: dt of the chunk's rows 4*lane .. 4*lane+3 (0 from row L on) into
// d, and cum, the inclusive prefix sum of dt * a over the chunk, into v.
__device__ __forceinline__ void chunk_scan(const float* dtp, int H, int L,
                                           float a, float (&d)[4],
                                           float (&v)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
    d[j] = t < L ? dtp[(long long)t * H] : 0.0f;
    v[j] = d[j] * a;
  }
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  float incl = v[3];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] += excl;
}

// Stage 1: C.B^T of each (batch, chunk), once for every head, into cb
// (batch, nc, Q, Q). A block computes one kCBT x kCBT tile on or below the
// diagonal (stage 4 reads nothing above it), over N in slices of kCBK.
__global__ void __launch_bounds__(kThreads)
cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
          float* __restrict__ cb, int S, int N, int Q, int nc, int tiles,
          bool vec) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);   // [kCBT][kLdCB] rows of C
  float* bs = cs + kCBT * kLdCB;                 // [kCBT][kLdCB] rows of B
  const int tile = blockIdx.x % tiles;
  const int c = (blockIdx.x / tiles) % nc;
  const int b = blockIdx.x / tiles / nc;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int r0 = ti * kCBT, s0 = (tile - ti * (ti + 1) / 2) * kCBT;
  const int L = min(Q, S - c * Q);
  const long long row = (long long)b * S + (long long)c * Q;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;  // 4 x 2 warps

  float acc[1][4][4] = {};
  for (int k0 = 0; k0 < N; k0 += kCBK) {
    load_tile<kCBT, kCBK>(cs, kLdCB, cm + (row + r0) * N + k0, N, L - r0,
                          N - k0, vec);
    load_tile<kCBT, kCBK>(bs, kLdCB, bm + (row + s0) * N + k0, N, L - s0,
                          N - k0, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    warp_mma<1, 4, kLdCB, 1, 1, kLdCB>(acc, cs + m0 * kLdCB, bs + n0 * kLdCB,
                                       (min(kCBK, N - k0) + 7) / 8);
    __syncthreads();
  }
  store_acc(acc, cb + ((long long)b * nc + c) * Q * Q + (long long)(r0 + m0) * Q
                     + s0 + n0, Q, Q - r0 - m0, Q - s0 - n0);
}

// Stage 2: each chunk's own state from a zero state, s_c = u^T.B with u_t =
// exp(cum_last - cum_t) dt_t x_t, into st (batch, nc, H, P, N), and cum into
// cum (batch, nc, H, Q). A block owns one (batch, chunk, head) and a kPT x
// kNT tile of (P, N); every chunk is computed at once.
__global__ void __launch_bounds__(kThreads, 2)
states_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a_log, const float* __restrict__ bm,
              float* __restrict__ cum, float* __restrict__ st, int S, int H,
              int P, int N, int Q, int nc, int p_tiles, int n_tiles,
              bool xvec, bool bvec) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [kQ][kLdP] x, then u
  float* bs = xs + kQ * kLdP;                    // [kQ][kLdB] B
  float* cs = bs + kQ * kLdB;                    // [kQ] cum
  float* us = cs + kQ;                           // [kQ] exp(cum_last-cum) dt
  int i = blockIdx.x;
  const int nt = i % n_tiles;
  i /= n_tiles;
  const int pt = i % p_tiles;
  i /= p_tiles;
  const int h = i % H;
  i /= H;
  const int c = i % nc, b = i / nc;
  const int L = min(Q, S - c * Q), p0 = pt * kPT, n0 = nt * kNT;
  const long long row = (long long)b * S + (long long)c * Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_tile<kQ, kPT>(xs, kLdP, x + (row * H + h) * P + p0, (long long)H * P,
                     L, P - p0, xvec);
  load_tile<kQ, kNT>(bs, kLdB, bm + row * N + n0, N, L, N - n0, bvec);
  cp_async_commit();
  if (warp == 0) {                  // the scan overlaps the copies
    float d[4], v[4];
    chunk_scan(dt + row * H + h, H, L, -expf(a_log[h]), d, v);
    const float last = __shfl_sync(0xffffffffu, v[3], 31);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cs[4 * lane + j] = v[j];
      us[4 * lane + j] = expf(last - v[j]) * d[j];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (pt == 0 && nt == 0) {
    float* out = cum + (((long long)b * nc + c) * H + h) * Q;
    for (int t = threadIdx.x; t < Q; t += kThreads) out[t] = cs[t];
  }
  for (int k = threadIdx.x; k < kQ * kPT; k += kThreads) {
    const int t = k / kPT;
    xs[t * kLdP + (k - t * kPT)] *= us[t];
  }
  __syncthreads();

  const int m0 = (warp >> 2) * 32, w0 = (warp & 3) * 32;   // 2 x 4 warps
  float acc[2][4][4] = {};
  warp_mma<2, 4, 1, kLdP, kLdB, 1>(acc, xs + m0, bs + w0, (L + 7) / 8);
  store_acc(acc, st + ((((long long)b * nc + c) * H + h) * P + p0 + m0) * N
                     + n0 + w0, N, P - p0 - m0, N - n0 - w0);
}

// Stage 3, the only one that walks the chunks in order: the state entering
// each chunk, h_{c-1}, in place of s_c in st, with h_c = exp(cum_last,c)
// h_{c-1} + s_c from h_{-1} = 0; the last h_c to hf (batch, H, P, N). A
// thread owns kPassVec consecutive elements of one (batch, head)'s (P, N).
__global__ void __launch_bounds__(kThreads)
pass_kernel(const float* __restrict__ cum, float* __restrict__ st,
            float* __restrict__ hf, int H, int PN, int Q, int nc, int blocks,
            bool vec) {
  const int j = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int b = bh / H, h = bh - b * H;
  const int e0 = (j * kThreads + threadIdx.x) * kPassVec;
  if (e0 >= PN) return;
  const long long step = (long long)H * PN;           // one chunk of st
  float* s = st + ((long long)b * nc * H + h) * PN + e0;
  const float* last = cum + ((long long)b * nc * H + h) * Q + Q - 1;
  const long long cstep = (long long)H * Q;           // one chunk of cum
  float* out = hf + (long long)bh * PN + e0;
  float hv[kPassVec] = {};
  float d = expf(last[0]);
  if (vec) {                // s_c and its decay loaded a chunk ahead of use
    float4 v = *reinterpret_cast<const float4*>(s);
    for (int c = 0; c < nc; ++c) {
      float4* sp = reinterpret_cast<float4*>(s + c * step);
      float4 vn = v;
      float dn = d;
      if (c + 1 < nc) {
        vn = *reinterpret_cast<const float4*>(s + (c + 1) * step);
        dn = expf(last[(c + 1) * cstep]);
      }
      *sp = make_float4(hv[0], hv[1], hv[2], hv[3]);
      hv[0] = fmaf(d, hv[0], v.x);
      hv[1] = fmaf(d, hv[1], v.y);
      hv[2] = fmaf(d, hv[2], v.z);
      hv[3] = fmaf(d, hv[3], v.w);
      v = vn;
      d = dn;
    }
    *reinterpret_cast<float4*>(out) = make_float4(hv[0], hv[1], hv[2], hv[3]);
  } else {
    const int n = min(kPassVec, PN - e0);
    for (int c = 0; c < nc; ++c) {
      float* sp = s + c * step;
      d = expf(last[c * cstep]);
#pragma unroll
      for (int k = 0; k < kPassVec; ++k)   // predicated: hv stays in registers
        if (k < n) {
          const float v = sp[k];
          sp[k] = hv[k];
          hv[k] = fmaf(d, hv[k], v);
        }
    }
#pragma unroll
    for (int k = 0; k < kPassVec; ++k)
      if (k < n) out[k] = hv[k];
  }
}

// Stage 4: y of one (batch, chunk, head) and kPT columns of P:
//   y_t = exp(cum_t) C_t.h_{c-1} + sum_{s<=t} C.B^T[t,s] exp(cum_t-cum_s) dt_s x_s,
// h_{c-1} from stage 3 (chunk 0 starts from zero and skips the first term),
// C.B^T from stage 1, cum from stage 2. Phase 1 (C and h) and phase 2
// (C.B^T, then W, and x) share one region of shared memory.
__global__ void __launch_bounds__(kThreads, 2)
output_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ cm, const float* __restrict__ cum,
              const float* __restrict__ cb, const float* __restrict__ st,
              float* __restrict__ y, int S, int H, int P, int N, int Q,
              int nc, int p_tiles, bool xvec, bool cvec, bool cbvec,
              bool hvec) {
  extern __shared__ float4 smem4[];
  float* cums = reinterpret_cast<float*>(smem4);  // [kQ] cum
  float* dts = cums + kQ;                         // [kQ] dt, 0 from row L on
  float* cs = dts + kQ;                           // phase 1: [kQ][kLdN] C
  float* hs = cs + kQ * kLdN;                     //          [kPT][kLdN] h
  float* ws = dts + kQ;                           // phase 2: [kQ][kLdQ] W
  float* xs = ws + kQ * kLdQ;                     //          [kQ][kLdP] x
  int i = blockIdx.x;
  const int pt = i % p_tiles;
  i /= p_tiles;
  const int h = i % H;
  i /= H;
  const int c = i % nc, b = i / nc;
  const int L = min(Q, S - c * Q), p0 = pt * kPT;
  const long long row = (long long)b * S + (long long)c * Q;
  const long long bch = ((long long)b * nc + c) * H + h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int m0 = (warp >> 1) * 32, w0 = (warp & 1) * 32;   // 4 x 2 warps

  for (int t = threadIdx.x; t < kQ; t += kThreads) {
    cums[t] = cum[bch * Q + min(t, Q - 1)];
    dts[t] = t < L ? dt[(row + t) * H + h] : 0.0f;
  }
  float acc[2][4][4] = {};
  if (c > 0) {
    for (int k0 = 0; k0 < N; k0 += kNT) {
      load_tile<kQ, kNT>(cs, kLdN, cm + row * N + k0, N, L, N - k0, cvec);
      load_tile<kPT, kNT>(hs, kLdN, st + (bch * P + p0) * N + k0, N, P - p0,
                          N - k0, hvec);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      warp_mma<2, 4, kLdN, 1, 1, kLdN>(acc, cs + m0 * kLdN, hs + w0 * kLdN,
                                       (min(kNT, N - k0) + 7) / 8);
      __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float e = expf(cums[m0 + 16 * mi + 8 * half + g]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[mi][j][2 * half] *= e;
          acc[mi][j][2 * half + 1] *= e;
        }
      }
  }

  load_tile<kQ, kQ>(ws, kLdQ, cb + ((long long)b * nc + c) * Q * Q, Q, Q, Q,
                    cbvec);
  load_tile<kQ, kPT>(xs, kLdP, x + (row * H + h) * P + p0, (long long)H * P,
                     L, P - p0, xvec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // W, masked before the exponential: above the diagonal cum_t - cum_s > 0.
  for (int k = threadIdx.x; k < kQ * kQ; k += kThreads) {
    const int t = k / kQ, s = k - t * kQ;
    float* w = ws + t * kLdQ + s;
    *w = s <= t ? *w * expf(cums[t] - cums[s]) * dts[s] : 0.0f;
  }
  __syncthreads();
  // Columns s <= t < m0 + 32 and s < L only.
  warp_mma<2, 4, kLdQ, 1, kLdP, 1>(
      acc, ws + m0 * kLdQ, xs + w0, m0 < L ? (min(m0 + 32, L) + 7) / 8 : 0);
  store_acc(acc, y + ((row + m0) * H + h) * P + p0 + w0, (long long)H * P,
            L - m0, P - p0 - w0);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Raises the dynamic shared-memory limit of each stage's kernel, once per
// device (a host call, kept off the launch path after the first scan).
int prepare(const Plan& p) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  const void* kernels[] = {(const void*)cb_kernel, (const void*)states_kernel,
                           nullptr, (const void*)output_kernel};
  for (int stage = 0; stage < kStages; ++stage) {
    if (kernels[stage] == nullptr) continue;
    err = cudaFuncSetAttribute(kernels[stage],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem[stage]);
    if (err != cudaSuccess) return (int)err;
  }
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

int launch_stage(int stage, const Plan& p, const float* x, const float* dt,
                 const float* a_log, const float* bm, const float* cm,
                 float* y, float* hf, float* cum, float* cb, float* st,
                 int S, int H, int P, int N, cudaStream_t stream) {
  if (p.grid[stage] == 0) return 0;
  const dim3 grid((unsigned)p.grid[stage]);
  const bool bcvec = N % 4 == 0 && aligned16(bm) && aligned16(cm);
  const bool xvec = P % 4 == 0 && aligned16(x);
  const int err = prepare(p);
  if (err != 0) return err;
  switch (stage) {
    case kStageCB:
      cb_kernel<<<grid, kThreads, p.smem[stage], stream>>>(
          bm, cm, cb, S, N, p.q, p.nc, p.cb_tiles, bcvec);
      break;
    case kStageStates:
      states_kernel<<<grid, kThreads, p.smem[stage], stream>>>(
          x, dt, a_log, bm, cum, st, S, H, P, N, p.q, p.nc, p.p_tiles,
          p.n_tiles, xvec, bcvec);
      break;
    case kStagePass:
      pass_kernel<<<grid, kThreads, 0, stream>>>(
          cum, st, hf, H, P * N, p.q, p.nc, p.pass_blocks,
          (P * N) % 4 == 0 && aligned16(st) && aligned16(hf));
      break;
    case kStageOutput:
      output_kernel<<<grid, kThreads, p.smem[stage], stream>>>(
          x, dt, cm, cum, cb, st, y, S, H, P, N, p.q, p.nc, p.p_tiles, xvec,
          bcvec, p.q % 4 == 0 && aligned16(cb),
          N % 4 == 0 && aligned16(st));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most rows a chunk may hold.
int ssd_scan_max_chunk(void) { return kQ; }

// Launches one stage (0: C.B^T, 1: chunk states and cum, 2: state passing,
// 3: output) on `stream`; returns the CUDA error code (0 = launched). The
// scratch is cum (batch, nc, H, q), cb (batch, nc, q, q) and st (batch, nc,
// H, P, N), with q = min(chunk, S) and nc = ceil(S / q). The wrapper
// checks shapes, types, contiguity, 1 <= chunk <= kQ, and launches nothing
// for an empty input.
int ssd_scan_stage(int stage, const float* x, const float* dt,
                   const float* a_log, const float* bm, const float* cm,
                   float* y, float* hf, float* cum, float* cb, float* st,
                   int batch, int S, int H, int P, int N, int chunk,
                   void* stream) {
  const Plan p = make_plan(batch, S, H, P, N, chunk);
  return launch_stage(stage, p, x, dt, a_log, bm, cm, y, hf, cum, cb, st, S,
                      H, P, N, (cudaStream_t)stream);
}

// The whole scan: every stage in order on `stream`; returns the first CUDA
// error code (0 = all launched).
int ssd_scan_f32(const float* x, const float* dt, const float* a_log,
                 const float* bm, const float* cm, float* y, float* hf,
                 float* cum, float* cb, float* st, int batch, int S, int H,
                 int P, int N, int chunk, void* stream) {
  const Plan p = make_plan(batch, S, H, P, N, chunk);
  for (int stage = 0; stage < kStages; ++stage) {
    const int rc = launch_stage(stage, p, x, dt, a_log, bm, cm, y, hf, cum,
                                cb, st, S, H, P, N, (cudaStream_t)stream);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
