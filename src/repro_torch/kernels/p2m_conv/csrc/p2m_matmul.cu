// Patch-level P2M product, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/p2m_conv/kernel.py::p2m_matmul_pallas (_p2m_kernel).
// Same function: x (M, K) in [0, 1], signed weights w (K, N), BN shift (N,)
//   raw[m, n] = sum_k sum_ij a_ij x[m,k]^j sign(w[k,n]) |w[k,n]|^i
//   out = epilogue(raw, shift)   (raw | relu | quant), raw optional,
// accumulated in fp32.
//
// What bounds it on this card: bytes.  At the benchmark's shape (M =
// 100,352 patches of 8 images at 112 x 112, K = 75, N = 8) one launch reads
// 30.1 MB of x and writes 3.2 MB against 0.36 GFLOP of premixed products:
// about 11 FLOP per byte, below the ~20 at which the fp32 rate would bound.
//
// Design for that: x is read from device memory once, and no powered
// operand exists outside the block.  The TPU kernel forms dw*dx products
// of powered tiles in VMEM; here each block stages a (block_k x N-tile)
// slab of w in shared memory and premixes it there, once, into
//   W~_j = sum_i a_ij sign(w) |w|^i,   j = 1..dx,
// so a row costs dx products instead of dw*dx.  That computes the same
// function in another order (not the TPU's block-by-block layout).  One
// thread owns one row of x and all outputs of the block's N tile (<= 32,
// eight at a time in float4 pairs from shared memory, where every thread of
// a warp reads the same word).  The block's rows of x are staged through
// shared memory a K tile at a time, so the device-memory reads are
// coalesced along K, with rows padded by one float against bank conflicts.
//
// The quant epilogue divides (no reciprocal) and rounds half to even
// (rintf), like jnp.round; build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDeg = 4;         // dw and dx, compile-time max
constexpr int kChunk = 8;          // outputs read as two float4 at a time
constexpr int kMaxTileChunks = 4;  // a thread keeps <= 32 outputs live
constexpr int kMaxThreads = 256;   // rows (threads) a block takes

enum Mode { kRaw = 0, kRelu = 1, kQuant = 2 };

struct Coeffs {
  float a[kMaxDeg * kMaxDeg];  // a[i * kMaxDeg + j] multiplies w^(i+1) x^(j+1)
};

__device__ __forceinline__ float epilogue(float raw, float shift, int mode,
                                          float v_lsb, float max_count,
                                          float full_scale) {
  if (mode == kRaw) return raw + shift;
  if (mode == kRelu) return fminf(fmaxf(raw + shift, 0.0f), full_scale);
  const float counts = rintf(raw / v_lsb) + rintf(shift / v_lsb);
  return fminf(fmaxf(counts, 0.0f), max_count) * v_lsb;
}

template <int DX, int NCH>
__global__ void __launch_bounds__(kMaxThreads)
p2m_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ shift, float* __restrict__ out,
                  float* __restrict__ raw_out, long long M, int K, int N,
                  int dw, Coeffs co, int block_k, int mode, float v_lsb,
                  float max_count, float full_scale) {
  constexpr int kTile = NCH * kChunk;
  extern __shared__ float4 smem4[];
  const int xld = block_k + 1;
  float* xs = reinterpret_cast<float*>(smem4);  // block rows x xld
  float* ws = xs + (blockDim.x * xld + 3) / 4 * 4;  // DX x block_k x kTile
  const long long m0 = (long long)blockIdx.x * blockDim.x;
  const int n0 = blockIdx.y * kTile;
  const int n_end = min(kTile, N - n0);
  const int rows_here = (int)min((long long)blockDim.x, M - m0);
  const bool live = (int)threadIdx.x < rows_here;

  float acc[kTile];
#pragma unroll
  for (int q = 0; q < kTile; ++q) acc[q] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += block_k) {
    const int kt = min(block_k, K - k0);
    // The block's rows of x for this K tile, coalesced along K.
    for (int idx = threadIdx.x; idx < rows_here * kt; idx += blockDim.x) {
      const int r = idx / kt;
      const int e = idx - r * kt;
      xs[r * xld + e] = x[(m0 + r) * K + k0 + e];
    }
    // The K tile of w, premixed; columns past N are zero.
    for (int idx = threadIdx.x; idx < kt * kTile; idx += blockDim.x) {
      const int e = idx / kTile;
      const int c = idx - e * kTile;
      const float wv = c < n_end ? w[(long long)(k0 + e) * N + n0 + c] : 0.0f;
      const float sg = wv > 0.0f ? 1.0f : (wv < 0.0f ? -1.0f : 0.0f);
      const float aw = fabsf(wv);
      float mix[DX];
#pragma unroll
      for (int j = 0; j < DX; ++j) mix[j] = 0.0f;
      float wp = aw;  // |w|^(i+1)
#pragma unroll
      for (int i = 0; i < kMaxDeg; ++i) {
        if (i < dw) {
          const float pw = sg * wp;
#pragma unroll
          for (int j = 0; j < DX; ++j)
            mix[j] = fmaf(co.a[i * kMaxDeg + j], pw, mix[j]);
          wp *= aw;
        }
      }
#pragma unroll
      for (int j = 0; j < DX; ++j) ws[(j * block_k + e) * kTile + c] = mix[j];
    }
    __syncthreads();
    if (live) {
      const float* xr = xs + threadIdx.x * xld;
      for (int e = 0; e < kt; ++e) {
        const float xv = xr[e];
        float xpow = xv;
#pragma unroll
        for (int j = 0; j < DX; ++j) {
          const float* wj = ws + (j * block_k + e) * kTile;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            const float4* wv =
                reinterpret_cast<const float4*>(wj + ch * kChunk);
            const float4 w0 = wv[0];
            const float4 w1 = wv[1];
            float* a = acc + ch * kChunk;
            a[0] = fmaf(xpow, w0.x, a[0]);
            a[1] = fmaf(xpow, w0.y, a[1]);
            a[2] = fmaf(xpow, w0.z, a[2]);
            a[3] = fmaf(xpow, w0.w, a[3]);
            a[4] = fmaf(xpow, w1.x, a[4]);
            a[5] = fmaf(xpow, w1.y, a[5]);
            a[6] = fmaf(xpow, w1.z, a[6]);
            a[7] = fmaf(xpow, w1.w, a[7]);
          }
          xpow *= xv;
        }
      }
    }
    __syncthreads();  // the tiles are read before the next are staged
  }

  if (!live) return;
  const long long o = (m0 + threadIdx.x) * N + n0;
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    if (q < n_end) {
      if (raw_out != nullptr) raw_out[o + q] = acc[q];
      out[o + q] = epilogue(acc[q], shift[n0 + q], mode, v_lsb, max_count,
                            full_scale);
    }
  }
}

// Shared memory of one block, in bytes (the wrapper computes the same).
size_t matmul_smem(int block_m, int block_k, int dx, int n_tile) {
  const size_t xs = ((size_t)block_m * (block_k + 1) + 3) / 4 * 4;
  const int tile = (n_tile + kChunk - 1) / kChunk * kChunk;
  return sizeof(float) * (xs + (size_t)dx * block_k * tile);
}

template <int DX, int NCH>
cudaError_t launch(const float* x, const float* w, const float* shift,
                   float* out, float* raw, long long M, int K, int N, int dw,
                   const Coeffs& co, int block_m, int block_k, int mode,
                   float v_lsb, int max_count, float full_scale,
                   cudaStream_t stream) {
  const size_t smem = matmul_smem(block_m, block_k, DX, NCH * kChunk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        p2m_matmul_kernel<DX, NCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((M + block_m - 1) / block_m),
                  (unsigned)((N + NCH * kChunk - 1) / (NCH * kChunk)), 1u);
  p2m_matmul_kernel<DX, NCH><<<grid, block_m, smem, stream>>>(
      x, w, shift, out, raw, M, K, N, dw, co, block_k, mode, v_lsb,
      (float)max_count, full_scale);
  return cudaGetLastError();
}

template <int DX>
cudaError_t dispatch_chunks(int nch, const float* x, const float* w,
                            const float* shift, float* out, float* raw,
                            long long M, int K, int N, int dw,
                            const Coeffs& co, int block_m, int block_k,
                            int mode, float v_lsb, int max_count,
                            float full_scale, cudaStream_t st) {
  switch (nch) {
    case 1:
      return launch<DX, 1>(x, w, shift, out, raw, M, K, N, dw, co, block_m,
                           block_k, mode, v_lsb, max_count, full_scale, st);
    case 2:
      return launch<DX, 2>(x, w, shift, out, raw, M, K, N, dw, co, block_m,
                           block_k, mode, v_lsb, max_count, full_scale, st);
    case 3:
      return launch<DX, 3>(x, w, shift, out, raw, M, K, N, dw, co, block_m,
                           block_k, mode, v_lsb, max_count, full_scale, st);
    case kMaxTileChunks:
      return launch<DX, kMaxTileChunks>(x, w, shift, out, raw, M, K, N, dw,
                                        co, block_m, block_k, mode, v_lsb,
                                        max_count, full_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  x (M, K), w (K, N), shift (N,), out
// and raw (M, N) are device pointers of contiguous fp32 tensors; raw may be
// null.  coeffs holds dw x dx floats, row-major, on the host (a_ij
// multiplies w^(i+1) x^(j+1)).  block_m rows (threads) a block, n_tile
// (<= 32) outputs a block, block_k rows of K staged at a time.  Allocates
// nothing, launches on `stream`, does not synchronise.  Returns the
// launch's cudaError_t.
extern "C" int p2m_matmul_forward(const float* x, const float* w,
                                  const float* shift, float* out, float* raw,
                                  long long M, int K, int N, int dw, int dx,
                                  const float* coeffs, int block_m,
                                  int n_tile, int block_k, int mode,
                                  float v_lsb, int max_count,
                                  float full_scale, void* stream) {
  if (M < 1 || K < 1 || N < 1 || dw < 1 || dw > kMaxDeg || block_m < 1 ||
      block_m > kMaxThreads || block_k < 1 || n_tile < 1 ||
      n_tile > kMaxTileChunks * kChunk || mode < kRaw || mode > kQuant) {
    return (int)cudaErrorInvalidValue;
  }
  Coeffs co{};
  for (int i = 0; i < dw; ++i)
    for (int j = 0; j < dx && j < kMaxDeg; ++j)
      co.a[i * kMaxDeg + j] = coeffs[i * dx + j];
  const int nch = (n_tile + kChunk - 1) / kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dx) {
    case 1:
      return (int)dispatch_chunks<1>(nch, x, w, shift, out, raw, M, K, N, dw,
                                     co, block_m, block_k, mode, v_lsb,
                                     max_count, full_scale, st);
    case 2:
      return (int)dispatch_chunks<2>(nch, x, w, shift, out, raw, M, K, N, dw,
                                     co, block_m, block_k, mode, v_lsb,
                                     max_count, full_scale, st);
    case 3:
      return (int)dispatch_chunks<3>(nch, x, w, shift, out, raw, M, K, N, dw,
                                     co, block_m, block_k, mode, v_lsb,
                                     max_count, full_scale, st);
    case kMaxDeg:
      return (int)dispatch_chunks<kMaxDeg>(nch, x, w, shift, out, raw, M, K,
                                           N, dw, co, block_m, block_k, mode,
                                           v_lsb, max_count, full_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Largest dw and dx the kernel is compiled for; the wrapper checks them.
extern "C" int p2m_matmul_max_degree() { return kMaxDeg; }
