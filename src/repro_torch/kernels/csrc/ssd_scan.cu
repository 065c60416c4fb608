// Mamba2 SSD (state-space duality) chunked scan, hand-written for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan/ssd_scan.py: ssd_scan_pallas (body
// _kernel). Inputs x (B,S,H,P), dt (B,S,H), a_log (H,), B and C (B,S,N), all
// f32 and contiguous; outputs y (B,S,H,P) and the final state h (B,H,P,N).
// With cum = cumsum over the chunk of dt * -exp(a_log[h]), each chunk of Q
// rows computes
//     y[t]  = exp(cum_t) C_t . h                                (inter-chunk)
//           + sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s (intra-chunk)
//     h    <- exp(cum_last) h + sum_s exp(cum_last - cum_s) dt_s x_s (x) B_s
// from h = 0. Two differences from the TPU kernel, both by design: the last
// chunk may be ragged (rows past S are masked: they read as dt = 0, x = B =
// C = 0, so they add nothing to y, to cum_last or to the state, and the
// state written is the one after the last valid row), where the TPU wrapper
// halves the chunk until it divides S; and every exponential is taken only
// where it is used (s <= t), so exp of a positive difference above the
// diagonal can neither overflow nor make inf * 0 = NaN.
//
// What bounds it on an H100: FP32 operations. Per chunk and head the
// algorithm does about 2Q(QN + QP + 2NP) operations (C.B^T, W.x, C.h, the
// state update) against 4Q(2P + 2N) bytes; at Q = N = 128, P = 64 that is
// ~100 operations per byte, and the kernel uses no tensor cores.
//
// What the design does about it. The TPU grid (B, H, chunks) runs its chunk
// axis in order with the (P, N) state in VMEM. Here a block owns one (b, h)
// and a 32-column tile of P and walks the chunks itself, keeping its slice
// of the state in shared memory; splitting P doubles the blocks (96 at
// B = 1, H = 48) at the cost of computing C.B^T once per tile. Per chunk:
//   1. load dt, B^T, C^T (transposed, odd row stride: conflict-free) and the
//      x tile into shared memory; rows past the chunk read as zero;
//   2. cum by a warp scan;
//   3. C.B^T (Q x Q) in registers, 8 x 8 per thread; y = exp(cum) C.h^T,
//      4 x 4 per thread;
//   4. W = mask(C.B^T * exp(cum_t - cum_s) * dt_s) over C^T's shared memory;
//      y += W.x, stored;
//   5. u = exp(cum_last - cum) dt x in place of x; h = exp(cum_last) h + u^T.B.
// At N = 128 a block takes 162 KB of shared memory, so one block per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;        // most rows in a chunk (the wrapper's MAX_CHUNK)
constexpr int kQS = kQ + 1;    // row stride of B^T and C^T: odd, so stores
                               // along n hit distinct banks
constexpr int kWS = kQ + 1;    // row stride of W
constexpr int kPT = 32;        // P columns per block

__host__ __device__ inline long long smem_floats(int n) {
  const long long ct = (long long)n * kQS;
  const long long w = (long long)kQ * kWS;
  return (long long)kQ * kPT      // x tile, then u
       + (long long)n * kPT       // state^T [n][p]
       + 2LL * kQ                 // cum, dt
       + ct                       // B^T
       + (ct > w ? ct : w);       // C^T, then W
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ hf, int S, int H, int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [kQ][kPT]
  float* hs = xs + kQ * kPT;                     // [N][kPT]
  float* cum = hs + N * kPT;                     // [kQ]
  float* dts = cum + kQ;                         // [kQ]
  float* bt = dts + kQ;                          // [N][kQS]
  float* ctw = bt + N * kQS;                     // [N][kQS], then [kQ][kWS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int p0 = blockIdx.y * kPT;
  const float a = -expf(a_log[h]);
  const long long row0 = (long long)b * S;       // first row of batch b

  for (int i = tid; i < N * kPT; i += kThreads) hs[i] = 0.0f;

  // Thread tiles: C.B^T rows ty + 16i, columns tx + 16j (8 x 8); y and the
  // state rows tg + 32i (t or n), P columns 4pg..4pg+3 (4 x 4).
  const int tx = tid & 15, ty = tid >> 4;
  const int pg = tid & 7, tg = tid >> 3;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int L = min(Q, S - t0);

    // 1. Load the chunk; rows L..kQ-1 read as zero.
    for (int t = tid; t < kQ; t += kThreads) {
      const float d = t < L ? dt[(row0 + t0 + t) * H + h] : 0.0f;
      dts[t] = d;
      cum[t] = d * a;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      float bv = 0.0f, cv = 0.0f;
      if (t < L) {
        const long long g = (row0 + t0 + t) * N + n;
        bv = bm[g];
        cv = cm[g];
      }
      bt[n * kQS + t] = bv;
      ctw[n * kQS + t] = cv;
    }
    for (int i = tid; i < kQ * kPT; i += kThreads) {
      const int t = i / kPT, p = i - t * kPT;
      xs[i] = (t < L && p0 + p < P)
                  ? x[((row0 + t0 + t) * H + h) * P + p0 + p] : 0.0f;
    }
    __syncthreads();

    // 2. cum: inclusive scan of dt * a, four rows per lane of warp 0.
    if (warp == 0) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = cum[4 * lane + j];
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
      for (int j = 0; j < 4; ++j) cum[4 * lane + j] = v[j] + excl;
    }
    __syncthreads();
    const float cum_last = cum[L - 1];

    // 3. C.B^T in registers, and the inter-chunk term from the old state.
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int n = 0; n < N; ++n) {
      const float* cr = ctw + n * kQS;
      const float* br = bt + n * kQS;
      float cv[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) cv[i] = cr[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = br[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
    float yv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yv[i][j] = 0.0f;
    for (int n = 0; n < N; ++n) {
      const float4 hv = *reinterpret_cast<const float4*>(hs + n * kPT + 4 * pg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float c = ctw[n * kQS + tg + 32 * i];
        yv[i][0] = fmaf(c, hv.x, yv[i][0]);
        yv[i][1] = fmaf(c, hv.y, yv[i][1]);
        yv[i][2] = fmaf(c, hv.z, yv[i][2]);
        yv[i][3] = fmaf(c, hv.w, yv[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = expf(cum[tg + 32 * i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) yv[i][j] *= e;
    }
    __syncthreads();                    // C^T is read for the last time

    // 4. W over C^T's space, masked before the exponential; then y += W.x.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      const float ct = cum[t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = tx + 16 * j;
        float w = 0.0f;
        if (s <= t && t < L) w = acc[i][j] * expf(ct - cum[s]) * dts[s];
        ctw[t * kWS + s] = w;
      }
    }
    __syncthreads();
    for (int s = 0; s < L; ++s) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + s * kPT + 4 * pg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = ctw[(tg + 32 * i) * kWS + s];
        yv[i][0] = fmaf(w, xv.x, yv[i][0]);
        yv[i][1] = fmaf(w, xv.y, yv[i][1]);
        yv[i][2] = fmaf(w, xv.z, yv[i][2]);
        yv[i][3] = fmaf(w, xv.w, yv[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tg + 32 * i;
      if (t >= L) continue;
      float* yr = y + ((row0 + t0 + t) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + 4 * pg + j;
        if (p < P) yr[p] = yv[i][j];
      }
    }
    __syncthreads();                    // x is read for the last time

    // 5. u = exp(cum_last - cum_s) dt_s x_s in place of x, then the state.
    for (int i = tid; i < kQ * kPT; i += kThreads) {
      const int s = i / kPT;
      xs[i] *= s < L ? expf(cum_last - cum[s]) * dts[s] : 0.0f;
    }
    __syncthreads();
    const float decay = expf(cum_last);
    for (int nb = 0; nb < N; nb += kQ) {
      float hv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[i][j] = 0.0f;
      for (int s = 0; s < L; ++s) {
        const float4 uv = *reinterpret_cast<const float4*>(xs + s * kPT + 4 * pg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = nb + tg + 32 * i;
          const float bv = n < N ? bt[n * kQS + s] : 0.0f;
          hv[i][0] = fmaf(uv.x, bv, hv[i][0]);
          hv[i][1] = fmaf(uv.y, bv, hv[i][1]);
          hv[i][2] = fmaf(uv.z, bv, hv[i][2]);
          hv[i][3] = fmaf(uv.w, bv, hv[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nb + tg + 32 * i;
        if (n >= N) continue;
        float4* hp = reinterpret_cast<float4*>(hs + n * kPT + 4 * pg);
        float4 o = *hp;
        o.x = o.x * decay + hv[i][0];
        o.y = o.y * decay + hv[i][1];
        o.z = o.z * decay + hv[i][2];
        o.w = o.w * decay + hv[i][3];
        *hp = o;
      }
    }
    __syncthreads();                    // before the next chunk's loads
  }

  // The state after the last valid row, (P, N) row-major per (b, h).
  float* out = hf + ((long long)b * H + h) * P * (long long)N;
  for (int i = tid; i < kPT * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    if (p0 + p < P) out[(long long)(p0 + p) * N + n] = hs[n * kPT + p];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for state width N.
long long ssd_scan_smem_bytes(int n) { return 4 * smem_floats(n); }

// Launches the scan on `stream`; returns the CUDA error code (0 = launched).
// The wrapper checks shapes, types, contiguity, 1 <= Q <= kQ and the
// shared-memory size, and launches nothing for an empty input.
int ssd_scan_f32(const float* x, const float* dt, const float* a_log,
                 const float* bm, const float* cm, float* y, float* hf,
                 int batch, int S, int H, int P, int N, int Q, void* stream) {
  const long long smem = ssd_scan_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * H, (P + kPT - 1) / kPT);
  ssd_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, dt, a_log, bm, cm, y, hf, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
