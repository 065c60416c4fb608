// Absorbed-MLA decode attention (flash decoding) for Hopper, sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/mla_attention/mla_attention.py:69
//   mla_decode_attention_pallas (its pl.pallas_call at :83).
//
// For each request b and head h, one new query attends to the latent cache:
//   s[t]  = (q_lat[b,h,:] . cache[b,t,:R] + q_rope[b,h,:] . cache[b,t,R:]) * scale
//   o_lat = softmax(s[0..n_b-1]) . cache[b,0..n_b-1,:R],   n_b = min(cache_len[b], S-1) + 1
// q_lat (B,H,R), q_rope (B,H,Dr), cache (B,S,R+Dr), out (B,H,R): float32,
// contiguous; cache_len (B,) int32. Position cache_len[b] is included (the new
// entry is already written there); cache_len[b] == S, a capacity-frozen slot,
// attends to the whole cache.
//
// Bound on this card. The function reads B*n*(R+Dr)*4 bytes and does
// 2*B*H*n*(2R+Dr) float operations (n = mean valid length). At H=128, R=512,
// Dr=64 that is ~121 FLOP per byte, far above the H100 SXM's 67 TFLOP/s FP32
// over 3.35 TB/s (~20 FLOP/byte): the kernel is bound by FP32 operations on
// the CUDA cores, not by HBM. Tensor cores are not used, so the result keeps
// full float32 accuracy.
//
// Design. The TPU grid (B, seq-blocks) runs in order on one core and carries
// (m, l, acc) in VMEM scratch across sequence blocks. Hopper runs blocks in
// parallel, and with B=8 a per-request grid would fill 8 of 132 SMs, so:
//   * pass 1 splits each request's valid range into n_split pieces (flash
//     decoding). A block owns 16 heads of one request and one piece, keeps
//     its 16 query rows in shared memory, streams 32-position cache tiles
//     into shared memory with cp.async (all of a tile's 16-byte copies in
//     flight at once), and runs the online softmax over them. Its
//     accumulator is 16 x R floats in registers (32 per thread at R=512):
//     a whole request's H x R accumulator (256 KB at R1) would not fit in the
//     227 KB of shared memory a block may use. The 8 head blocks of one
//     (request, piece) read the same tiles; they are launched next to each
//     other (head block is the fastest grid index), so the repeats hit L2.
//   * pass 2 merges the n_split partial (m, l, acc) per (request, head).
// Ranges are computed per row from cache_len on the device, so the ragged
// tail is masked in place; nothing is halved until it divides S, as the TPU
// wrapper does (mla_attention.py:76-78).
//
// Tolerance against the plain PyTorch version (kernels/mla_attention/ref.py):
// both are float32 with a different summation order, so they agree to
// rtol = atol = 3e-5, the tolerance the repository's kernel tests use.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHeadsPerBlock = 16;
constexpr int kTile = 32;          // cache positions per shared-memory tile
constexpr int kThreads = 256;
constexpr int kPvCols = 2;         // float4 column groups per thread: R <= 512
constexpr int kMaxSplit = 64;
constexpr int kCombineThreads = 128;

// cp.async (sm_80+): copy `src_bytes` (0 or 16) from global to shared memory
// without staging through registers; the rest of the 16 bytes is zeroed.
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* src,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
mla_split_kernel(const float* __restrict__ q_lat,
                 const float* __restrict__ q_rope,
                 const float* __restrict__ cache,
                 const int* __restrict__ cache_len,
                 float* __restrict__ part_acc,   // (B, n_split, H, R)
                 float* __restrict__ part_ml,    // (B, n_split, H, 2)
                 int H, int S, int R, int Dr, int n_split, float scale) {
  const int W = R + Dr;
  const int W4 = W / 4;
  const int WP = W + 4;            // padded row: 8 rows cover 32 banks
  const int h0 = blockIdx.x * kHeadsPerBlock;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);      // [16][W]
  float* kv_s = q_s + kHeadsPerBlock * W;             // [32][WP]
  float* p_s = kv_s + kTile * WP;                     // [16][32]
  float* m_s = p_s + kHeadsPerBlock * kTile;          // [16]
  float* l_s = m_s + kHeadsPerBlock;                  // [16]
  float* a_s = l_s + kHeadsPerBlock;                  // [16]

  // This piece's positions [start, end) of the row's valid range.
  const int cl = cache_len[b];
  const int n_valid = min(max(cl, 0), S - 1) + 1;
  const int n_tiles = (n_valid + kTile - 1) / kTile;
  const int tiles_per = (n_tiles + n_split - 1) / n_split;
  const int start = split * tiles_per * kTile;
  const int end = min(start + tiles_per * kTile, n_valid);

  for (int i = tid; i < kHeadsPerBlock * W4; i += kThreads) {
    const int h = i / W4;
    const int c = (i % W4) * 4;
    const size_t row = static_cast<size_t>(b) * H + h0 + h;
    const float4 v = c < R
        ? *reinterpret_cast<const float4*>(q_lat + row * R + c)
        : *reinterpret_cast<const float4*>(q_rope + row * Dr + (c - R));
    *reinterpret_cast<float4*>(q_s + h * W + c) = v;
  }
  if (tid < kHeadsPerBlock) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // Score mapping: one head, positions t and t+16 of the tile.
  const int sc_h = tid / 16;
  const int sc_t = tid % 16;
  // PV mapping: 4 heads x float4 columns pv_c + 64*j.
  const int pv_h = (tid / 64) * 4;
  const int pv_c = tid % 64;
  float acc[4][kPvCols][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kPvCols; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  __syncthreads();
  for (int t0 = start; t0 < end; t0 += kTile) {
    const int nt = min(kTile, end - t0);
    // Asynchronous 16-byte copies straight into shared memory: every copy
    // of the tile is in flight at once, and rows past the valid range are
    // zero-filled (source size 0) instead of read.
    const float* src = cache + (static_cast<size_t>(b) * S + t0) * W;
    for (int i = tid; i < kTile * W4; i += kThreads) {
      const int t = i / W4;
      const int c = (i % W4) * 4;
      cp_async16(kv_s + t * WP + c, src + (t < nt ? t * W + c : 0),
                 t < nt ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    {  // scores of this tile, scaled; masked tail to -inf
      const float* qh = q_s + sc_h * W;
      const float* k0 = kv_s + sc_t * WP;
      const float* k1 = kv_s + (sc_t + 16) * WP;
      float s0 = 0.f, s1 = 0.f;
      for (int c = 0; c < W; c += 4) {
        const float4 q = *reinterpret_cast<const float4*>(qh + c);
        const float4 a = *reinterpret_cast<const float4*>(k0 + c);
        const float4 e = *reinterpret_cast<const float4*>(k1 + c);
        s0 = fmaf(q.x, a.x, s0); s0 = fmaf(q.y, a.y, s0);
        s0 = fmaf(q.z, a.z, s0); s0 = fmaf(q.w, a.w, s0);
        s1 = fmaf(q.x, e.x, s1); s1 = fmaf(q.y, e.y, s1);
        s1 = fmaf(q.z, e.z, s1); s1 = fmaf(q.w, e.w, s1);
      }
      p_s[sc_h * kTile + sc_t] = sc_t < nt ? s0 * scale : -INFINITY;
      p_s[sc_h * kTile + sc_t + 16] = sc_t + 16 < nt ? s1 * scale : -INFINITY;
    }
    __syncthreads();

    {  // online softmax: a half-warp per head, two positions per lane
      const int h = tid / 16;
      const int j = tid % 16;
      const float v0 = p_s[h * kTile + j];
      const float v1 = p_s[h * kTile + j + 16];
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);   // finite: position t0 is valid
      const float e0 = j < nt ? expf(v0 - m_new) : 0.f;
      const float e1 = j + 16 < nt ? expf(v1 - m_new) : 0.f;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[h * kTile + j] = e0;
      p_s[h * kTile + j + 16] = e1;
      if (j == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        a_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    {  // acc = acc * alpha + p . c_kv
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float alpha = a_s[pv_h + i];
#pragma unroll
        for (int j = 0; j < kPvCols; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j][k] *= alpha;
      }
      for (int t = 0; t < nt; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = p_s[(pv_h + i) * kTile + t];
#pragma unroll
        for (int j = 0; j < kPvCols; ++j) {
          const int c4 = pv_c + 64 * j;
          if (c4 * 4 < R) {
            const float4 v = *reinterpret_cast<const float4*>(kv_s + t * WP + c4 * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][j][0] = fmaf(p[i], v.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(p[i], v.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(p[i], v.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(p[i], v.w, acc[i][j][3]);
            }
          }
        }
      }
    }
    __syncthreads();   // the next tile overwrites kv_s and p_s
  }

  const size_t part_row = (static_cast<size_t>(b) * n_split + split) * H + h0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kPvCols; ++j) {
      const int c4 = pv_c + 64 * j;
      if (c4 * 4 < R)
        *reinterpret_cast<float4*>(part_acc + (part_row + pv_h + i) * R + c4 * 4) =
            make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
    }
  if (tid < kHeadsPerBlock) {
    part_ml[(part_row + tid) * 2] = m_s[tid];
    part_ml[(part_row + tid) * 2 + 1] = l_s[tid];
  }
}

__global__ void __launch_bounds__(kCombineThreads)
mla_combine_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   float* __restrict__ out, int H, int R, int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  __shared__ float w_s[kMaxSplit];
  __shared__ float inv_l;
  if (threadIdx.x == 0) {
    float m_max = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      m_max = fmaxf(m_max, part_ml[((static_cast<size_t>(b) * n_split + s) * H + h) * 2]);
    float l_sum = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t i = ((static_cast<size_t>(b) * n_split + s) * H + h) * 2;
      const float l = part_ml[i + 1];
      const float w = l > 0.f ? expf(part_ml[i] - m_max) : 0.f;  // empty piece: 0
      w_s[s] = w;
      l_sum += w * l;
    }
    inv_l = 1.f / l_sum;
  }
  __syncthreads();
  for (int c = threadIdx.x * 4; c < R; c += kCombineThreads * 4) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      const float w = w_s[s];
      if (w == 0.f) continue;
      const float4 a = *reinterpret_cast<const float4*>(
          part_acc + ((static_cast<size_t>(b) * n_split + s) * H + h) * R + c);
      o.x = fmaf(w, a.x, o.x); o.y = fmaf(w, a.y, o.y);
      o.z = fmaf(w, a.z, o.z); o.w = fmaf(w, a.w, o.w);
    }
    o.x *= inv_l; o.y *= inv_l; o.z *= inv_l; o.w *= inv_l;
    *reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * H + h) * R + c) = o;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes pass 1 needs for rows of width W = R + Dr.
int mla_decode_attention_smem_bytes(int R, int Dr) {
  const int W = R + Dr;
  return (kHeadsPerBlock * W + kTile * (W + 4) + kHeadsPerBlock * kTile +
          3 * kHeadsPerBlock) * static_cast<int>(sizeof(float));
}

// Launches both passes on `stream`; returns cudaGetLastError() (0 = launched).
// The caller checks the shape limits (H % 16 == 0, R % 4 == 0, R <= 512,
// Dr % 4 == 0, 1 <= n_split <= 64) and allocates the partial buffers.
int mla_decode_attention_f32(const float* q_lat, const float* q_rope,
                             const float* cache, const int* cache_len,
                             float* out, float* part_acc, float* part_ml,
                             int B, int H, int S, int R, int Dr, int n_split,
                             float scale, cudaStream_t stream) {
  const int smem = mla_decode_attention_smem_bytes(R, Dr);
  cudaError_t err = cudaFuncSetAttribute(
      mla_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_split_kernel<<<dim3(H / kHeadsPerBlock, n_split, B), kThreads, smem, stream>>>(
      q_lat, q_rope, cache, cache_len, part_acc, part_ml, H, S, R, Dr, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_combine_kernel<<<dim3(H, B), kCombineThreads, 0, stream>>>(
      part_acc, part_ml, out, H, R, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
