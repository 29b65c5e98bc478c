// Fused implicit-im2col P2M convolution, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/p2m_conv/conv.py::p2m_conv_pallas
// on its grid path (_conv_kernel_fast for s == k, _conv_kernel_general for
// s < k).  Same function: NHWC images (B, H, W, C), premixed weights
// W~ (k, dx*kC, N) with rows ordered (j, kw, c), BN shift (N,)
//   raw[m, n] = sum_ki sum_{j, e} x[m, ki, e]^(j+1) * W~[ki, j*kC + e, n]
//   out = epilogue(raw, shift)   (raw | relu | quant), raw optional,
// accumulated in fp32 with kernel row ki ascending, as the reference does.
//
// What bounds it on this card: bytes.  At the serving shape (8 x 560 x 560 x 3
// images, k = s = 5, N = 8) one launch reads 30.1 MB of images and writes
// 3.2 MB of output against 361 MFLOP: about 11 FLOP per byte, below the
// ~20 FLOP per byte at which the fp32 rate outside the tensor cores, and not
// the memory, would set the limit.
//
// Design for that: every image byte is read from device memory once and no
// patch tensor exists.  One thread owns one output pixel and all N outputs
// of its block's N range, eight at a time in registers.  A patch row is k*C
// contiguous floats of the NHWC image at any stride, so s == k and s < k are
// one code path; at s == k neighbouring threads read neighbouring segments.
// The block stages its N range of W~ in shared memory once (7.2 KB at the
// serving shape), where all threads of a warp read the same word
// (broadcast).  The TPU kernel's padding of N to 128 lanes and its 2048-row
// tiles are not carried over: at N = 8 they would be 16x wasted work here.
//
// The quant epilogue divides (no reciprocal) and rounds half to even
// (rintf), like jnp.round; build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDx = 4;     // pixel-model degree in x, compile-time max
constexpr int kChunk = 8;     // outputs held in registers at a time
constexpr int kThreads = 256;

enum Mode { kRaw = 0, kRelu = 1, kQuant = 2 };

__device__ __forceinline__ float epilogue(float raw, float shift, int mode,
                                          float v_lsb, float max_count,
                                          float full_scale) {
  if (mode == kRaw) return raw + shift;
  if (mode == kRelu) return fminf(fmaxf(raw + shift, 0.0f), full_scale);
  const float counts = rintf(raw / v_lsb) + rintf(shift / v_lsb);
  return fminf(fmaxf(counts, 0.0f), max_count) * v_lsb;
}

template <int DX>
__global__ void __launch_bounds__(kThreads)
p2m_conv_kernel(const float* __restrict__ images,
                const float* __restrict__ wrows,
                const float* __restrict__ shift,
                float* __restrict__ out, float* __restrict__ raw_out,
                int H, int W, int C, int k, int s, int Ho, int Wo, int N,
                int n_tile, long long M, int mode, float v_lsb,
                float max_count, float full_scale) {
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  const int kc = k * C;
  const int rows = k * DX * kc;
  const int stride_n = (n_tile + kChunk - 1) / kChunk * kChunk;
  const int n0 = blockIdx.y * n_tile;

  // Stage this block's N range of W~, zero-padded to whole chunks.
  for (int idx = threadIdx.x; idx < rows * stride_n; idx += blockDim.x) {
    const int r = idx / stride_n;
    const int c = idx - r * stride_n;
    const int n = n0 + c;
    wsm[idx] = (c < n_tile && n < N) ? wrows[(long long)r * N + n] : 0.0f;
  }
  __syncthreads();

  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int ow = (int)(m % Wo);
  const long long bo = m / Wo;
  const int oh = (int)(bo % Ho);
  const long long b = bo / Ho;
  const long long row_stride = (long long)W * C;
  const float* base =
      images + ((b * H + (long long)oh * s) * W + (long long)ow * s) * C;
  const int n_end = min(n_tile, N - n0);

  for (int c0 = 0; c0 < n_end; c0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) acc[q] = 0.0f;

    for (int ki = 0; ki < k; ++ki) {
      const float* xp = base + ki * row_stride;
      const float* wk = wsm + (long long)ki * DX * kc * stride_n + c0;
      float part[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) part[q] = 0.0f;
      for (int e = 0; e < kc; ++e) {
        const float x = __ldg(xp + e);
        float xpow = x;
#pragma unroll
        for (int j = 0; j < DX; ++j) {
          const float4* wv =
              reinterpret_cast<const float4*>(wk + (j * kc + e) * stride_n);
          const float4 w0 = wv[0];
          const float4 w1 = wv[1];
          part[0] = fmaf(xpow, w0.x, part[0]);
          part[1] = fmaf(xpow, w0.y, part[1]);
          part[2] = fmaf(xpow, w0.z, part[2]);
          part[3] = fmaf(xpow, w0.w, part[3]);
          part[4] = fmaf(xpow, w1.x, part[4]);
          part[5] = fmaf(xpow, w1.y, part[5]);
          part[6] = fmaf(xpow, w1.z, part[6]);
          part[7] = fmaf(xpow, w1.w, part[7]);
          xpow *= x;  // x^(j+2), the order _power_concat uses
        }
      }
#pragma unroll
      for (int q = 0; q < kChunk; ++q) acc[q] += part[q];
    }

    const long long o = m * N + n0 + c0;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (c0 + q < n_end) {
        if (raw_out != nullptr) raw_out[o + q] = acc[q];
        out[o + q] = epilogue(acc[q], shift[n0 + c0 + q], mode, v_lsb,
                              max_count, full_scale);
      }
    }
  }
}

template <int DX>
cudaError_t launch(const float* images, const float* wrows,
                   const float* shift, float* out, float* raw, int B, int H,
                   int W, int C, int k, int s, int N, int n_tile, int mode,
                   float v_lsb, int max_count, float full_scale,
                   cudaStream_t stream) {
  const int Ho = (H - k) / s + 1;
  const int Wo = (W - k) / s + 1;
  const long long M = (long long)B * Ho * Wo;
  const int stride_n = (n_tile + kChunk - 1) / kChunk * kChunk;
  const size_t smem = sizeof(float) * (size_t)k * DX * k * C * stride_n;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        p2m_conv_kernel<DX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((M + kThreads - 1) / kThreads),
                  (unsigned)((N + n_tile - 1) / n_tile));
  p2m_conv_kernel<DX><<<grid, kThreads, smem, stream>>>(
      images, wrows, shift, out, raw, H, W, C, k, s, Ho, Wo, N, n_tile, M,
      mode, v_lsb, (float)max_count, full_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes.  All pointers are device pointers of
// contiguous fp32 tensors; raw may be null.  Allocates nothing, launches on
// `stream`, does not synchronise.  Returns the launch's cudaError_t.
extern "C" int p2m_conv_forward(const float* images, const float* wrows,
                                const float* shift, float* out, float* raw,
                                int B, int H, int W, int C, int k, int s,
                                int N, int dx, int n_tile, int mode,
                                float v_lsb, int max_count, float full_scale,
                                void* stream) {
  if (B < 1 || C < 1 || k < 1 || s < 1 || H < k || W < k || N < 1 ||
      n_tile < 1 || mode < kRaw || mode > kQuant) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dx) {
    case 1: return (int)launch<1>(images, wrows, shift, out, raw, B, H, W, C,
                                  k, s, N, n_tile, mode, v_lsb, max_count,
                                  full_scale, st);
    case 2: return (int)launch<2>(images, wrows, shift, out, raw, B, H, W, C,
                                  k, s, N, n_tile, mode, v_lsb, max_count,
                                  full_scale, st);
    case 3: return (int)launch<3>(images, wrows, shift, out, raw, B, H, W, C,
                                  k, s, N, n_tile, mode, v_lsb, max_count,
                                  full_scale, st);
    case kMaxDx: return (int)launch<kMaxDx>(images, wrows, shift, out, raw, B,
                                            H, W, C, k, s, N, n_tile, mode,
                                            v_lsb, max_count, full_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Largest dx the kernel is compiled for; the wrapper checks against it.
extern "C" int p2m_conv_max_dx() { return kMaxDx; }
