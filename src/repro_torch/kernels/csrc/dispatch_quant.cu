// Per-row INT8 quantization for the expert-parallel dispatch, hand-written
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/dispatch_quant/dispatch_quant.py:
// dispatch_quantize_pallas (body _kernel). For each row of x (T, D), f32 or
// bf16:
//     scale = max(max|x|, 1e-8) / 127
//     q     = clip(round_half_even(x / scale), -127, 127)   (int8)
// With `pack`, the row is written as the final (D + 4)-byte dispatch row:
// the D codes followed by the 4 bytes of the f32 scale, the layout that
// src/repro/core/lep.py bitcasts into the payload tail (lep.py:176-178),
// so the producer emits what the all-to-all sends.
//
// What bounds it on an H100: bytes. It does a few operations per element
// against 3 bytes moved (2 read as bf16, 1 written); the least time is
// T*D*2 + T*(D+4) bytes over 3.35 TB/s. What keeps a kernel from it: a
// row's reduction must end before its first code, so loads and arithmetic
// have to overlap across rows, and the arithmetic must stay small enough to
// hide behind the bytes.
//
// What the design does about it (the launch plan is chosen on the host by
// kernels/dispatch_quant/plan.py and passed in):
// * ring: a persistent grid of one wave, four blocks of 8 warps an SM
//   (three for f32 rows). A block takes its rows in turn, all its threads
//   on one row, and keeps the next row in flight in a 2-stage ring of whole
//   rows in shared memory, in the input's own type, filled by TMA bulk
//   copies (cp.async.bulk, completing on one mbarrier a stage) and
//   refilled by thread 0 at the next row's barrier. Four rows per SM in
//   hand and four in flight overlap one block's arithmetic with the
//   others' loads; deeper rings in fewer blocks, L2 bulk prefetch and
//   holding the row in registers between the passes all read slower on an
//   H100 (PERF.md). Codes leave as 8-byte stores over the
//   8-byte-aligned body of the row (a warp writes 256 contiguous bytes a
//   store) and 4-byte words for the head, the tail and the packed scale (a
//   packed row starts at r * (D + 4), 4-byte aligned). An all-zero row (an
//   empty capacity slot) skips the arithmetic: codes 0, scale 1e-8/127,
//   exactly as computed.
// * rows: the same loop without the ring, with plain element loads, for
//   rows a bulk copy cannot take (an odd width, a misaligned pointer, rows
//   longer than two stages): the row is read once to reduce and again,
//   from L2, to quantize. It takes any D.
// * split: T at most half the SMs. A row is cut over a thread-block
//   cluster of up to 8 blocks (16, a non-portable size, read no faster at
//   T = 1 or 8 on an H100): each reduces its slice, the maxima meet
//   through distributed shared memory behind a cluster barrier, and each
//   block quantizes its own slice (read again from L1).
//
// Exact rounding without a divide per element: the exact product p = x *
// fl(1/scale) (inside an FFMA) is rounded instead of x / scale. |x| <=
// absmax bounds |x / scale| below 127.00001, so p lies within 2^-17 of the
// true ratio and the IEEE quotient within 2^-18 of it: where p is 2^-15 or
// more away from every half-integer, all three round (half to even) to one
// integer. Only a ring quad of values with one nearer rounds the IEEE
// quotient __fdiv_rn(x, scale), the plain version's own arithmetic, for
// its 4 values; the split and rows paths settle such a value by
// quotient_code, which finds the IEEE quotient's code exactly with an FFMA
// and two compares. The same bound keeps every code within +-127, so no
// clamp is needed. The CPU tests hold this rule, modelled in
// ref.codes_by_reciprocal and ref.quotient_codes, against the divided
// codes of the plain version for every bf16 value at 128 mantissas of
// absmax, for f32 values planted next to the boundaries and for random
// bf16 rows. scale itself is __fdiv_rn(max, 127.0f), and this file is not
// built with --use_fast_math, so codes and scales equal the plain
// version's bit for bit.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;     // ring and rows blocks: up to 8 warps
constexpr int kSplitThreads = 128;   // split blocks
constexpr int kMaxCluster = 8;      // a portable cluster
constexpr int kSmemLimit = 232448;
constexpr int kStaticSmem = 2 * (kMaxThreads / 32) * 4;   // dq_rows_kernel's warp_m
// |p - rint(p)| above this: p = x * inv lies within 2^-15 of a
// half-integer (ref.NEAR_WINDOW), and the code comes from the quotient.
constexpr float kNearHalf = 0.5f - 0x1p-15f;

enum Kind { kNone = 0, kRing = 1, kRows = 2, kSplit = 3 };

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

// One row by a bulk copy (the TMA engine, no tensor map) of `bytes` (a
// multiple of 16, both addresses 16-byte aligned) into shared memory,
// completing on the stage's barrier.
__device__ __forceinline__ void fetch_row(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// max|x| over one 16-byte unit of input: 4 f32 or 8 bf16 values.
__device__ __forceinline__ float absmax16(float m, uint4 u) {
  const float4 a = *reinterpret_cast<const float4*>(&u);
  return fmaxf(fmaxf(m, fmaxf(fabsf(a.x), fabsf(a.y))),
               fmaxf(fabsf(a.z), fabsf(a.w)));
}
__device__ __forceinline__ __nv_bfloat162 absmax16(__nv_bfloat162 m, uint4 u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  // Packed pairs: max of |x| is exact in bf16.
  return __hmax2(__hmax2(m, __hmax2(__habs2(h[0]), __habs2(h[1]))),
                 __hmax2(__habs2(h[2]), __habs2(h[3])));
}
__device__ __forceinline__ float finish_max(float m) { return m; }
__device__ __forceinline__ float finish_max(__nv_bfloat162 m) {
  return fmaxf(__low2float(m), __high2float(m));
}
template <typename T> struct MaxAcc { using type = float; };
template <> struct MaxAcc<__nv_bfloat16> { using type = __nv_bfloat162; };

struct Scale {
  float scale, inv;
};

__device__ __forceinline__ Scale row_scale(float m) {
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  return {s, __frcp_rn(s)};
}

// 1.5 * 2^23. For |p| < 2^22, fma(x, inv, kMagic) = rint(p) + kMagic with
// p = x * inv exact (the fused add rounds once, half to even, as rintf
// does), and it holds rint(p) in its low mantissa bits: its low byte is the
// int8 code. A code costs two FFMA, one FADD and a compare, and no
// conversion instruction (F2I and FRND run at a quarter of the FP32 rate
// on sm_90).
constexpr float kMagic = 12582912.0f;

// rint(x * inv) + kMagic; sets `near` if x * inv lies within 2^-15 of a
// half-integer (|x * inv - rint| > kNearHalf, the difference rounded once).
__device__ __forceinline__ float magic_code(float x, float inv, bool& near) {
  const float m = __fmaf_rn(x, inv, kMagic);
  near |= fabsf(__fmaf_rn(x, inv, -__fsub_rn(m, kMagic))) > kNearHalf;
  return m;
}

// rint(RN(x / scale)) + kMagic for |x| <= absmax, without a division.
// With k = floor(|x| * inv) and h = k + 1/2: h has a short mantissa whose
// last bit is 0, so RN(|x| / scale) = h exactly for |x| / scale within half
// the f32 spacing below (lo) or above (hi) h, where a tie rounds to h; below
// that it rounds under h (code k), above over it (code k + 1), and at h the
// code is whichever of k, k + 1 is even. d = |x| - h * scale by one FFMA is
// exact where it matters: near h it is a multiple of 2^(E - 25) (E: the
// exponent of scale) under 2^(E - 13), so 13 bits. The bounds (lo / 2) *
// scale and (hi / 2) * scale are exact too (lo and hi are powers of two).
// Far from h only d's sign counts, and an FFMA keeps the sign.
__device__ __forceinline__ float quotient_code(float x, Scale s) {
  const float a = fabsf(x);
  const float k = floorf(__fmul_rn(a, s.inv));
  const float h = k + 0.5f;
  const float lo = h - __uint_as_float(__float_as_uint(h) - 1u);
  const float hi = __uint_as_float(__float_as_uint(h) + 1u) - h;
  const float d = __fmaf_rn(-h, s.scale, a);
  const float c = d < -__fmul_rn(0.5f * lo, s.scale)  ? k
                : d > __fmul_rn(0.5f * hi, s.scale)   ? k + 1.0f
                : ((int)k & 1) == 0                   ? k
                                                      : k + 1.0f;
  return (x < 0.0f ? -c : c) + kMagic;
}

// One value's code (as a magic sum), for the split and rows paths: a value
// near a half-integer takes quotient_code, which, unlike __fdiv_rn, has no
// slow-path call (whose saved registers spilled in the split kernel).
__device__ __forceinline__ float code1(float v, Scale s) {
  bool near = false;
  const float m = magic_code(v, s.inv, near);
  return near ? quotient_code(v, s) : m;
}

__device__ __forceinline__ int8_t code_byte(float v, Scale s) {
  return (int8_t)(__float_as_uint(code1(v, s)) & 0xffu);
}

// The low bytes of four magic sums, little-endian.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return __byte_perm(__byte_perm(__float_as_uint(a), __float_as_uint(b), 0x0040),
                     __byte_perm(__float_as_uint(c), __float_as_uint(d), 0x0040),
                     0x5410);
}

// Exact codes of N values (a multiple of 4), little-endian in N/4 words. A
// quad with a value near a half-integer rounds the IEEE quotients of its 4
// values. On random bf16 rows 0.3-0.4 % of values lie near a half-integer
// (the scale's own rounding leaves many ratios within 2^-17 of one), so a
// warp takes that branch for some lane often: per quad, in about 40 % of
// its steps; per 16 values it would be about 90 % (computed), and the
// quads read 3 % faster on the fully filled buffer (H100, PERF.md).
template <int N>
__device__ __forceinline__ void codes(const float* v, Scale s, uint32_t* w) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    float m[4];
    bool near = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = magic_code(v[4 * q + j], s.inv, near);
    if (near) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m[j] = __fadd_rn(__fdiv_rn(v[4 * q + j], s.scale), kMagic);
    }
    w[q] = pack4(m[0], m[1], m[2], m[3]);
  }
}

// The values of one 16-byte unit of input.
__device__ __forceinline__ void unpack16(uint4 u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(uint4 u, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(&u);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// Blocks an SM the ring and rows kernel is built for (plan.BLOCKS_PER_SM).
template <typename T> constexpr int kRingBlocks = sizeof(T) == 2 ? 4 : 3;

// Four values from an 8-byte (bf16) or 16-byte (f32) aligned address.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// Eight values; kWide: bf16 from a 16-byte aligned address in one load.
template <bool kWide>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  if (kWide) {
    float (&w)[8] = *reinterpret_cast<float(*)[8]>(v);
    unpack16(*reinterpret_cast<const uint4*>(p), w);
  } else {
    load4(p, v);
    load4(p + 4, v + 4);
  }
}
template <bool kWide>
__device__ __forceinline__ void load8(const float* p, float* v) {
  load4(p, v);
  load4(p + 4, v + 4);
}

// The codes of one row held in shared memory by the n threads of a block
// (this one is i): interleaved groups of 8 over the 8-byte-aligned body of
// the code row, two groups a step.
template <typename T, bool kWide>
__device__ __forceinline__ void body_codes(const T* p, uint2* out, int nb,
                                           Scale sc, int g, int n) {
  for (; g + n < nb; g += 2 * n) {
    float v[16];
    load8<kWide>(p + 8 * g, v);
    load8<kWide>(p + 8 * (g + n), v + 8);
    uint32_t w[4];
    codes<16>(v, sc, w);
    out[g] = make_uint2(w[0], w[1]);
    out[g + n] = make_uint2(w[2], w[3]);
  }
  if (g < nb) {
    float v[8];
    load8<kWide>(p + 8 * g, v);
    uint32_t w[2];
    codes<8>(v, sc, w);
    out[g] = make_uint2(w[0], w[1]);
  }
}

// The body as above, then 4-byte words for the head (thread 0) and the
// tail (thread 1), of 0 or 4 codes each: D * sizeof(T) % 16 == 0 and qr is
// 4-byte aligned. A zero row stores zeros.
template <typename T>
__device__ __forceinline__ void row_codes(const T* row, int8_t* qr, int d,
                                          Scale sc, bool zero, int i, int n) {
  const int head = min((int)((8u - (uint32_t)(uintptr_t)qr) & 7u), d);
  const int nb = (d - head) >> 3;
  const int tail = head + 8 * nb;
  uint2* body = reinterpret_cast<uint2*>(qr + head);
  if (zero) {
    for (int g = i; g < nb; g += n) body[g] = make_uint2(0u, 0u);
  } else if (head == 0) {
    body_codes<T, true>(row, body, nb, sc, i, n);
  } else {
    body_codes<T, false>(row + head, body, nb, sc, i, n);
  }
  const int at = i == 0 ? 0 : tail;
  if ((i == 0 && head > 0) || (i == 1 && tail < d)) {
    uint32_t w[1] = {0u};
    if (!zero) {
      float v[4];
      load4(row + at, v);
      codes<4>(v, sc, w);
    }
    *reinterpret_cast<uint32_t*>(qr + at) = w[0];
  }
}

// ring (kUseRing) and rows: a persistent grid; a block takes rows
// blockIdx.x, blockIdx.x + gridDim.x, ... in turn, all its threads on one
// row. With the ring, thread 0 keeps the block's next rows in flight by
// bulk copies into a ring of `stages` whole rows in shared memory,
// refilling a stage at the next row's barrier, when every thread is done
// with it.
template <typename T, bool kUseRing>
__global__ void __launch_bounds__(kMaxThreads, kRingBlocks<T>)
dq_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
               float* __restrict__ scale_out, int t, int d,
               long long q_stride, int pack, int stages) {
  extern __shared__ float4 smem4[];
  __shared__ float warp_m[2][kMaxThreads / 32];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockDim.x, warps = n >> 5;
  const uint32_t row_bytes = (uint32_t)d * sizeof(T);
  const T* ring = reinterpret_cast<const T*>(smem);
  const uint32_t full = smem_u32(smem + (size_t)stages * row_bytes);

  if (kUseRing && tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < stages; ++s) {
      const long long r = blockIdx.x + (long long)s * gridDim.x;
      if (r >= t) break;
      fetch_row(smem_u32(ring + (size_t)s * d), x + r * d, row_bytes,
                full + 8 * s);
    }
  }
  if (kUseRing) __syncthreads();
  for (int j = 0;; ++j) {
    const long long r = blockIdx.x + (long long)j * gridDim.x;
    if (r >= t) break;
    const int s = kUseRing ? j % stages : 0;
    const T* row;
    float m;
    if (kUseRing) {
      mbar_wait(full + 8 * s, (uint32_t)(j / stages) & 1u);
      row = ring + (size_t)s * d;
      const uint4* ru = reinterpret_cast<const uint4*>(row);
      const int units = (int)(row_bytes / 16);
      typename MaxAcc<T>::type m0{}, m1{};
      int i = tid;
      for (; i + n < units; i += 2 * n) {
        m0 = absmax16(m0, ru[i]);
        m1 = absmax16(m1, ru[i + n]);
      }
      if (i < units) m0 = absmax16(m0, ru[i]);
      m = fmaxf(finish_max(m0), finish_max(m1));
    } else {
      row = x + r * d;
      m = 0.0f;
      for (int i = tid; i < d; i += n) m = fmaxf(m, fabsf(to_f32(row[i])));
    }
    m = warp_max(m);
    if (lane == 0) warp_m[j & 1][warp] = m;
    // Also: every thread is done with row j - 1, so its stage is free.
    __syncthreads();
    m = warp_m[j & 1][0];
    for (int w = 1; w < warps; ++w) m = fmaxf(m, warp_m[j & 1][w]);
    if (kUseRing && tid == 0 && j > 0) {
      const long long next = r + (long long)(stages - 1) * gridDim.x;
      if (next < t) {
        const int free_s = (j - 1) % stages;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch_row(smem_u32(ring + (size_t)free_s * d), x + next * d,
                  row_bytes, full + 8 * free_s);
      }
    }
    const Scale sc = row_scale(m);
    int8_t* qr = q + r * q_stride;
    if (kUseRing) {
      row_codes(row, qr, d, sc, m == 0.0f, tid, n);
      if (tid == 2 && pack) *reinterpret_cast<float*>(qr + d) = sc.scale;
    } else {
      for (int i = tid; i < d; i += n) qr[i] = code_byte(to_f32(row[i]), sc);
      if (tid < 4 && pack)
        qr[d + tid] = (int8_t)((__float_as_uint(sc.scale) >> (8 * tid)) & 0xffu);
    }
    if (tid == 0 && scale_out != nullptr) scale_out[r] = sc.scale;
  }
}

// split: one row over a cluster of blocks, `slice` elements a block.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kSplitThreads)
dq_split_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale_out, int d, long long q_stride,
                int pack, int slice) {
  __shared__ float warp_m[kSplitThreads / 32];
  __shared__ float block_m;
  constexpr int kPer = kVec ? 16 / sizeof(T) : 1;   // values a step
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31;
  const long long r = blockIdx.x / csize;
  const int lo = rank * slice, hi = min(d, lo + slice);
  const T* xr = x + r * d;
  int8_t* qr = q + r * q_stride;

  float m = 0.0f;
  for (int i = lo + kPer * tid; i < hi; i += kPer * kSplitThreads) {
    if constexpr (kVec) {
      typename MaxAcc<T>::type a{};
      m = fmaxf(m, finish_max(absmax16(a, *reinterpret_cast<const uint4*>(
                                              xr + i))));
    } else {
      m = fmaxf(m, fabsf(to_f32(xr[i])));
    }
  }
  m = warp_max(m);
  if (lane == 0) warp_m[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    float b = warp_m[0];
#pragma unroll
    for (int w = 1; w < kSplitThreads / 32; ++w) b = fmaxf(b, warp_m[w]);
    block_m = b;
  }
  cluster.sync();                       // every block's block_m is set
  m = 0.0f;
  for (int c = 0; c < csize; ++c)
    m = fmaxf(m, *cluster.map_shared_rank(&block_m, c));
  // Done reading the others' shared memory; wait for theirs before exit.
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  const Scale sc = row_scale(m);

  for (int i = lo + kPer * tid; i < hi; i += kPer * kSplitThreads) {
    if constexpr (kVec) {
      float v[kPer];
      unpack16(*reinterpret_cast<const uint4*>(xr + i), v);
#pragma unroll
      for (int k = 0; k < kPer / 4; ++k)
        reinterpret_cast<uint32_t*>(qr + i)[k] =
            pack4(code1(v[4 * k], sc), code1(v[4 * k + 1], sc),
                  code1(v[4 * k + 2], sc), code1(v[4 * k + 3], sc));
    } else {
      qr[i] = code_byte(to_f32(xr[i]), sc);
    }
  }
  if (rank == 0 && tid == 0) {
    if (scale_out != nullptr) scale_out[r] = sc.scale;
    if (pack) {
      const uint32_t bits = __float_as_uint(sc.scale);
#pragma unroll
      for (int j = 0; j < 4; ++j) qr[d + j] = (int8_t)((bits >> (8 * j)) & 0xffu);
    }
  }
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <typename T, bool kUseRing>
int launch_rows(const void* x, void* q, void* scale, int t, int d,
                long long q_stride, int pack, int grid, int warps, int stages,
                int smem, cudaStream_t stream) {
  auto kernel = dq_rows_kernel<T, kUseRing>;
  if (kUseRing) {
    // All the shared memory a block may have, less the kernel's own.
    static const cudaError_t attr = [kernel] {
      cudaFuncAttributes a;
      const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
      if (err != cudaSuccess) return err;
      return cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemLimit - (int)a.sharedSizeBytes);
    }();
    if (attr != cudaSuccess) return (int)attr;
  }
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), t, d, q_stride, pack, stages);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int launch_split(const void* x, void* q, void* scale, int t, int d,
                 long long q_stride, int pack, int cluster, int slice,
                 cudaStream_t stream) {
  auto kernel = dq_split_kernel<T, kVec>;
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = (unsigned)cluster;
  dims.val.clusterDim.y = 1;
  dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(t * cluster));
  cfg.blockDim = dim3(kSplitThreads);
  cfg.stream = stream;
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), d, q_stride, pack, slice);
}

template <typename T>
int launch(int kind, const void* x, void* q, void* scale, int t, int d,
           long long q_stride, int pack, int grid, int warps, int stages,
           int cluster, int slice, int vec, int smem, cudaStream_t stream) {
  switch (kind) {
    case kRing:
      if (stages < 2 || ((size_t)d * sizeof(T)) % 16 != 0)
        return (int)cudaErrorInvalidValue;
      return launch_rows<T, true>(x, q, scale, t, d, q_stride, pack, grid,
                                  warps, stages, smem, stream);
    case kRows:
      return launch_rows<T, false>(x, q, scale, t, d, q_stride, pack, grid,
                                   warps, 1, 0, stream);
    case kSplit:
      if (cluster < 1 || cluster > kMaxCluster || grid != t * cluster)
        return (int)cudaErrorInvalidValue;
      return vec ? launch_split<T, true>(x, q, scale, t, d, q_stride, pack,
                                         cluster, slice, stream)
                 : launch_split<T, false>(x, q, scale, t, d, q_stride, pack,
                                          cluster, slice, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: (t, d) contiguous, f32 (x_is_bf16 = 0) or bf16 (1). q: rows of
// q_stride bytes (d, or d + 4 with pack). scale: (t,) f32 or null. The
// rest is the launch plan of kernels/dispatch_quant/plan.py, whose
// conditions the caller has checked: kind (0 none, 1 ring, 2 rows, 3
// split), grid, warps a block, ring stages (ring), cluster size and slice
// (split), 16-byte loads (split), dynamic shared memory (ring). Returns the
// CUDA error of the launch (0 on success).
int dispatch_quantize(const void* x, int x_is_bf16, void* q, void* scale,
                      int t, int d, long long q_stride, int pack, int kind,
                      int grid, int warps, int stages, int cluster,
                      int slice, int vec, int smem, cudaStream_t stream) {
  if (kind == kNone || t == 0) return 0;
  if (warps < 1 || 32 * warps > kMaxThreads || grid < 1 ||
      smem + kStaticSmem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (x_is_bf16)
    return launch<__nv_bfloat16>(kind, x, q, scale, t, d, q_stride, pack,
                                 grid, warps, stages, cluster, slice, vec,
                                 smem, stream);
  return launch<float>(kind, x, q, scale, t, d, q_stride, pack, grid, warps,
                       stages, cluster, slice, vec, smem, stream);
}

}  // extern "C"
