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
// What bounds it on an H100: bytes. It does ~3 operations per element
// against 3 bytes moved (2 read as bf16, 1 written), far below the card's
// ~300 operations per byte; the least time is T*D*2 + T*(D+4) bytes over
// 3.35 TB/s.
//
// What the design does about it: one block per row reads the row from
// device memory exactly once (16-byte loads where the row allows),
// keeping it in shared memory as f32 while the block reduces |x|, then
// writes the codes as 4-byte words. The TPU kernel's 256-row tile becomes
// a grid of T blocks, so a ragged T needs no halving of the tile. Division
// is IEEE (__fdiv_rn, and this file is not built with --use_fast_math), by
// 127.0f and not by its reciprocal, and rounding is rintf (half to even, as
// jnp.round and torch.round do), so the codes equal the plain version's
// bit for bit. An all-zero row (an empty capacity slot of the dispatch
// buffer) gives scale 1e-8/127 and codes 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Eight consecutive elements from a 16-byte-aligned address.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ int code(float v, float scale) {
  const float c = rintf(__fdiv_rn(v, scale));
  return __float2int_rn(fminf(fmaxf(c, -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d,
                                          float scale) {
  return (uint32_t)(uint8_t)code(a, scale)
       | ((uint32_t)(uint8_t)code(b, scale) << 8)
       | ((uint32_t)(uint8_t)code(c, scale) << 16)
       | ((uint32_t)(uint8_t)code(d, scale) << 24);
}

// kVec: D % 8 == 0, x 16-byte aligned, q and its row stride 4-byte aligned.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dispatch_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale_out, int d,
                         long long q_stride, int pack) {
  extern __shared__ float4 smem4[];
  float* row = reinterpret_cast<float*>(smem4);      // d floats
  // The wrapper's STATIC_SMEM counts these bytes.
  __shared__ float warp_max[kThreads / 32];

  const long long r = blockIdx.x;
  const T* xr = x + r * (long long)d;
  float m = 0.0f;
  if (kVec) {
    for (int i = threadIdx.x; i < d / 8; i += kThreads) {
      float v[8];
      load8(xr + 8 * i, v);
      smem4[2 * i] = make_float4(v[0], v[1], v[2], v[3]);
      smem4[2 * i + 1] = make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = to_f32(xr[i]);
      row[i] = v;
      m = fmaxf(m, fabsf(v));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();                      // also publishes `row`
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
  const float scale = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);

  int8_t* qr = q + r * q_stride;
  if (kVec) {
    uint32_t* qw = reinterpret_cast<uint32_t*>(qr);
    for (int i = threadIdx.x; i < d / 8; i += kThreads) {
      const float4 a = smem4[2 * i], b = smem4[2 * i + 1];
      qw[2 * i] = pack4(a.x, a.y, a.z, a.w, scale);
      qw[2 * i + 1] = pack4(b.x, b.y, b.z, b.w, scale);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      qr[i] = (int8_t)code(row[i], scale);
  }
  if (threadIdx.x == 0) {
    if (scale_out != nullptr) scale_out[r] = scale;
    if (pack) {
      const uint32_t bits = __float_as_uint(scale);
#pragma unroll
      for (int j = 0; j < 4; ++j) qr[d + j] = (int8_t)((bits >> (8 * j)) & 0xffu);
    }
  }
}

template <typename T, bool kVec>
int launch(const void* x, void* q, void* scale, int t, int d,
           long long q_stride, int pack, cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  auto kernel = dispatch_quantize_kernel<T, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<t, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), d, q_stride, pack);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (t, d) contiguous, f32 (x_is_bf16 = 0) or bf16 (1). q: rows of
// q_stride bytes (d, or d + 4 with pack). scale: (t,) f32 or null.
// vec: the caller has checked kVec's conditions. Returns the CUDA error of
// the launch (0 on success).
int dispatch_quantize(const void* x, int x_is_bf16, void* q, void* scale,
                      int t, int d, long long q_stride, int pack, int vec,
                      cudaStream_t stream) {
  if (t == 0) return 0;
  if (x_is_bf16)
    return vec ? launch<__nv_bfloat16, true>(x, q, scale, t, d, q_stride, pack, stream)
               : launch<__nv_bfloat16, false>(x, q, scale, t, d, q_stride, pack, stream);
  return vec ? launch<float, true>(x, q, scale, t, d, q_stride, pack, stream)
             : launch<float, false>(x, q, scale, t, d, q_stride, pack, stream);
}

}  // extern "C"
