// Chunked RWKV-6 WKV forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv_wkv/kernel.py::wkv_pallas.
// Same function: r, k, v, lw (B, S, H, D) float32, u (H, D), state
// (B, H, D, D) -> y (B, S, H, D) and the final state, by the chunk-parallel
// form of the recurrence (chunk 16; ref.py's docstring):
//   per chunk, with L_t the inclusive cumulative sum of lw,
//   y_t  = (r_t e^{L_{t-1}}) S0 + sum_{s<t} (r_t . e^{L_{t-1}-L_s} k_s) v_s
//          + (r_t . u k_t) v_t
//   S_C  = e^{L_C} S0 + sum_s (e^{L_C-L_s} k_s) v_s^T
//
// What bounds it on this card: bytes.  At the serving shape (8, 64, 40, 64)
// a launch reads 21 MB of r/k/v/lw and 5.2 MB of state and writes 5.2 MB of
// y and 5.2 MB of state against ~0.4 GFLOP: ~11 FLOP a byte, below the ~20
// at which the fp32 rate outside the tensor cores would set the limit.
//
// Design.  The TPU kernel walks the chunks as the inner, sequential grid
// axis and carries the (D x D) state in VMEM from one grid step to the next.
// CUDA blocks run in no order, so here one block owns one (b, h) and loops
// over the chunks itself; the state stays in shared memory (16 KB at
// D = 64) for the whole sequence and touches device memory once in, once
// out.  The inputs are read strided from the (B, S, H, D) layout, one
// D-float row per token, with D unpadded (the TPU's 128-lane padding and
// its per-batch tiling of u are not carried over: u is read as u[h]).  A
// chunk's r, k, v and lw tiles go to shared memory (rows padded by one
// float, so the score loop's column reads hit distinct banks); positions
// past S are loaded as lw = 0 and r = k = v = 0, which the reference's
// padding makes exact.  The cumulative decay is a serial prefix sum per
// channel (the TPU's triangular ones-matmul is a lane trick).  The output
// and state products hold four outputs a thread in registers, so each
// shared word read feeds four FMAs.
//
// Numerics: fp32 throughout, IEEE expf (build without --use_fast_math);
// chunk 16 keeps |dL| <= 80 < 88.  The state is formed as
// e^{L_C} S0 + sum kd v: on a row whose chunk has lw = 0 and k = 0 (a
// masked prefix) that is 1 * S0 + 0, so the state comes back bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;
constexpr int kMaxD = 64;
constexpr int kLd = kMaxD + 1;  // padded row stride of the chunk tiles
constexpr int kTile = 4;        // outputs a thread keeps in registers
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
wkv_chunked_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   float* __restrict__ y, float* __restrict__ s_out, int S,
                   int H, int D) {
  __shared__ float st[kMaxD * kMaxD];    // running state [d][e], stride D
  __shared__ float rq[kChunk * kLd];     // r, then qd = r e^{L_{t-1} - L_C}
  __shared__ float kd[kChunk * kLd];     // k, then kd = k e^{L_C - L_t}
  __shared__ float vt[kChunk * kLd];     // v
  __shared__ float lq[kChunk * kLd];     // lw, then q = r e^{L_{t-1}}
  __shared__ float cum[kChunk * kLd];    // L_t, inclusive
  __shared__ float tot[kMaxD];           // L_C
  __shared__ float diag[kChunk];         // r_t . (u k_t)
  __shared__ float sc[kChunk * kChunk];  // strictly causal scores [t][s]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const long long tok_stride = (long long)H * D;
  const long long base = (long long)b * S * tok_stride + (long long)h * D;
  const float* ub = u + (long long)h * D;

  for (int i = tid; i < D * D; i += kThreads)
    st[i] = s0[(long long)bh * D * D + i];

  const int n_chunks = (S + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int t = i / D, d = i % D, j = t * kLd + d;
      float rv = 0.f, kv = 0.f, vv = 0.f, lv = 0.f;
      if (t0 + t < S) {
        const long long off = base + (long long)(t0 + t) * tok_stride + d;
        rv = r[off];
        kv = k[off];
        vv = v[off];
        lv = lw[off];
      }
      rq[j] = rv;
      kd[j] = kv;
      vt[j] = vv;
      lq[j] = lv;
    }
    __syncthreads();

    // Cumulative log decay, one channel a thread; the bonus diagonal, one
    // token a thread (another warp).
    if (tid < D) {
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        acc += lq[t * kLd + tid];
        cum[t * kLd + tid] = acc;
      }
      tot[tid] = acc;
    } else if (tid >= kMaxD && tid < kMaxD + kChunk) {
      const int t = tid - kMaxD;
      float acc = 0.f;
      for (int d = 0; d < D; ++d)
        acc += rq[t * kLd + d] * ub[d] * kd[t * kLd + d];
      diag[t] = acc;
    }
    __syncthreads();

    // Decay-weighted operands, in place.
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int t = i / D, d = i % D, j = t * kLd + d;
      const float L = cum[j];
      const float Lp = L - lq[j];  // L_{t-1}, formed as the reference does
      const float LC = tot[d];
      const float rv = rq[j];
      lq[j] = rv * expf(Lp);
      rq[j] = rv * expf(Lp - LC);
      kd[j] = kd[j] * expf(LC - L);
    }
    __syncthreads();

    // scores[t][s] = qd_t . kd_s for s < t, else 0.
    for (int i = tid; i < kChunk * kChunk; i += kThreads) {
      const int t = i / kChunk, s = i % kChunk;
      float acc = 0.f;
      if (s < t)
        for (int d = 0; d < D; ++d) acc += rq[t * kLd + d] * kd[s * kLd + d];
      sc[i] = acc;
    }
    __syncthreads();

    // y for kTile consecutive tokens of one column e a thread.
    for (int i = tid; i < (kChunk / kTile) * D; i += kThreads) {
      const int e = i % D, tb = (i / D) * kTile;
      float inter[kTile] = {}, intra[kTile] = {};
      for (int d = 0; d < D; ++d) {
        const float sde = st[d * D + e];
#pragma unroll
        for (int j = 0; j < kTile; ++j) inter[j] += lq[(tb + j) * kLd + d] * sde;
      }
      for (int s = 0; s < tb + kTile - 1; ++s) {  // sc is 0 for s >= t
        const float vse = vt[s * kLd + e];
#pragma unroll
        for (int j = 0; j < kTile; ++j) intra[j] += sc[(tb + j) * kChunk + s] * vse;
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int t = tb + j;
        if (t0 + t < S)
          y[base + (long long)(t0 + t) * tok_stride + e] =
              inter[j] + intra[j] + diag[t] * vt[t * kLd + e];
      }
    }
    __syncthreads();

    // S <- e^{L_C} S + sum_s kd_s v_s^T, kTile rows d of one column e a
    // thread.
    for (int i = tid; i < ((D + kTile - 1) / kTile) * D; i += kThreads) {
      const int e = i % D, db = (i / D) * kTile;
      float acc[kTile] = {};
      for (int s = 0; s < kChunk; ++s) {
        const float vse = vt[s * kLd + e];
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          if (db + j < D) acc[j] += kd[s * kLd + db + j] * vse;
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (db + j < D) {
          const int idx = (db + j) * D + e;
          st[idx] = expf(tot[db + j]) * st[idx] + acc[j];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < D * D; i += kThreads)
    s_out[(long long)bh * D * D + i] = st[i];
}

}  // namespace

// One launch over all (b, h); returns the cudaError of the launch.  D in
// 1..wkv_max_head_dim().
extern "C" int wkv_chunked_forward(const float* r, const float* k,
                                   const float* v, const float* lw,
                                   const float* u, const float* s0, float* y,
                                   float* s_out, int B, int S, int H, int D,
                                   void* stream) {
  if (B < 1 || H < 1 || S < 0 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  wkv_chunked_kernel<<<B * H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, lw, u, s0, y, s_out, S, H, D);
  return (int)cudaGetLastError();
}

extern "C" int wkv_max_head_dim() { return kMaxD; }

extern "C" int wkv_chunk() { return kChunk; }
