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
//
// The delta-gated stem (p2m_conv_gated_forward) replaces the TPU kernel
// src/repro/kernels/p2m_conv/gated.py::p2m_conv_pallas_gated: B1 where
// rerun[b] != 0, else a copy of cached[b], in one launch.  It is the same
// kernel body instantiated with kGated = true, so a computed pixel runs
// B1's arithmetic in B1's order and the result equals B1 followed by
// where(rerun, ., cached) bit for bit.  Its grid puts the image on
// blockIdx.z and tiles only that image's Ho*Wo pixels on blockIdx.x, so a
// block never straddles two images (the part the reference's
// aligned_block_h plays) and is all re-run or all skip.  A skipped block
// stages no weights, reads no image byte and copies its pixels' N range
// of the cache, coalesced.  At the stream shape (4 x 560 x 560 x 3, N = 8)
// it moves 16.7 MB with every slot re-run and 3.2 MB with none: bytes
// bound, and near launch latency either way.
//
// The pipelined conv (p2m_conv_pipelined_forward, B2) replaces the TPU
// kernel src/repro/kernels/p2m_conv/conv.py::p2m_conv_pallas with
// pipeline_depth >= 2: _pipelined_body driving
// _conv_kernel_fast_pipelined (s == k) and _conv_kernel_general_pipelined
// (s < k).  Same function as B1, bit for bit, raw included.  A block covers
// block_h rows of the flattened (B*Ho) output axis times all Wo pixels, one
// thread a pixel, and one N tile of at most 32 outputs, all of them live in
// the thread's registers across the kernel rows (B1 instead loops over N
// chunks outside its kernel-row loop).  A ring of min(depth, k) shared-memory
// slots holds, per kernel row ki, the block's image band (block_h rows of
// ((Wo-1)*s + k)*C contiguous floats: the window of every pixel of the row,
// at any stride) and that row's dx*kC x n_tile slab of W~.  The ring is
// filled with cp.async (16-byte copies when the rows are 16-byte aligned,
// 4-byte copies otherwise), one commit group per kernel row; slot ki % nbuf
// is refilled with row ki + nbuf once every thread has drained it, as
// _pipelined_body does.  Per pixel the arithmetic is B1's in B1's order
// (e ascending, j inner, a per-row part, then acc += part with ki
// ascending), so B2 equals B1 bit for bit; tiling does not enter a pixel's
// arithmetic.  Bytes bound like B1: the ring makes each image byte one
// coalesced copy into shared memory instead of B1's per-thread 60-byte
// reads, and overlaps the next rows' copies with this row's FMAs.
#include <cuda_runtime.h>

#include <cstdint>

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

template <int DX, bool kGated>
__global__ void __launch_bounds__(kThreads)
p2m_conv_kernel(const float* __restrict__ images,
                const float* __restrict__ wrows,
                const float* __restrict__ shift,
                const float* __restrict__ cached,
                const int* __restrict__ rerun,
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

  // This thread's output pixel m (a row of the (B*Ho*Wo, N) output) and
  // the end of its block's pixels.
  long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long m_end = M;
  if constexpr (kGated) {
    const long long hw = (long long)Ho * Wo;
    const long long first =
        blockIdx.z * hw + (long long)blockIdx.x * blockDim.x;
    m = first + threadIdx.x;
    m_end = min(first + (long long)blockDim.x, (blockIdx.z + 1) * hw);
    if (rerun[blockIdx.z] == 0) {  // skipped image: copy the cache
      const int n_end = min(n_tile, N - n0);
      const long long count = (m_end - first) * n_end;
      for (long long idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const long long o = (first + idx / n_end) * N + n0 + idx % n_end;
        out[o] = cached[o];
      }
      return;  // the whole block: no barrier follows for it
    }
  }

  // Stage this block's N range of W~, zero-padded to whole chunks.
  for (int idx = threadIdx.x; idx < rows * stride_n; idx += blockDim.x) {
    const int r = idx / stride_n;
    const int c = idx - r * stride_n;
    const int n = n0 + c;
    wsm[idx] = (c < n_tile && n < N) ? wrows[(long long)r * N + n] : 0.0f;
  }
  __syncthreads();

  if (m >= m_end) return;
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

// One launch's arguments, shared by both entry points.
struct Args {
  const float* images;
  const float* wrows;
  const float* shift;
  const float* cached;  // gated only
  const int* rerun;     // gated only
  float* out;
  float* raw;  // may be null
  int B, H, W, C, k, s, N, n_tile, mode;
  float v_lsb;
  int max_count;
  float full_scale;
};

template <int DX, bool kGated>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int Ho = (a.H - a.k) / a.s + 1;
  const int Wo = (a.W - a.k) / a.s + 1;
  const long long M = (long long)a.B * Ho * Wo;
  const int stride_n = (a.n_tile + kChunk - 1) / kChunk * kChunk;
  const size_t smem =
      sizeof(float) * (size_t)a.k * DX * a.k * a.C * stride_n;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        p2m_conv_kernel<DX, kGated>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // Gated: one image per blockIdx.z, its pixels tiled on blockIdx.x.
  const long long pixels = kGated ? (long long)Ho * Wo : M;
  const dim3 grid((unsigned)((pixels + kThreads - 1) / kThreads),
                  (unsigned)((a.N + a.n_tile - 1) / a.n_tile),
                  kGated ? (unsigned)a.B : 1u);
  p2m_conv_kernel<DX, kGated><<<grid, kThreads, smem, stream>>>(
      a.images, a.wrows, a.shift, a.cached, a.rerun, a.out, a.raw, a.H, a.W,
      a.C, a.k, a.s, Ho, Wo, a.N, a.n_tile, M, a.mode, a.v_lsb,
      (float)a.max_count, a.full_scale);
  return cudaGetLastError();
}

template <bool kGated>
int dispatch(const Args& a, int dx, void* stream) {
  if (a.B < 1 || a.C < 1 || a.k < 1 || a.s < 1 || a.H < a.k || a.W < a.k ||
      a.N < 1 || a.n_tile < 1 || a.mode < kRaw || a.mode > kQuant ||
      (kGated && a.B > 65535)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dx) {
    case 1: return (int)launch<1, kGated>(a, st);
    case 2: return (int)launch<2, kGated>(a, st);
    case 3: return (int)launch<3, kGated>(a, st);
    case kMaxDx: return (int)launch<kMaxDx, kGated>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- B2

constexpr int kPipeThreads = 512;  // most threads (pixels) a B2 block has
constexpr int kMaxTileChunks = 4;  // a B2 thread keeps <= 32 outputs live

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's commit groups are in
// flight.  wait_group takes an immediate: above 7 it waits for more
// groups than needed, which is correct, only less overlapped.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

template <int DX, int NCH>
__global__ void __launch_bounds__(kPipeThreads)
p2m_conv_pipelined_kernel(const float* __restrict__ images,
                          const float* __restrict__ wrows,
                          const float* __restrict__ shift,
                          float* __restrict__ out, float* __restrict__ raw_out,
                          int H, int W, int C, int k, int s, int Ho, int Wo,
                          int N, int block_h, int nbuf, long long rows_total,
                          int vec16, int mode, float v_lsb, float max_count,
                          float full_scale) {
  constexpr int kTile = NCH * kChunk;  // this block's N tile, padded
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kc = k * C;
  const int band = ((Wo - 1) * s + k) * C;  // floats of one band row
  const int band_ld = (band + 3) & ~3;      // rows start 16-byte aligned
  const int x_floats = block_h * band_ld;
  const int slot_floats = x_floats + DX * kc * kTile;
  const int n0 = blockIdx.y * kTile;
  const int n_end = min(kTile, N - n0);
  const long long row0 = (long long)blockIdx.x * block_h;
  const int rows_here = (int)min((long long)block_h, rows_total - row0);

  // W~ columns past N stay zero in every slot: the copies never write them.
  const int pad = kTile - n_end;
  for (int idx = threadIdx.x; idx < nbuf * DX * kc * pad;
       idx += blockDim.x) {
    const int slot = idx / (DX * kc * pad);
    const int rem = idx - slot * DX * kc * pad;
    const int r = rem / pad;
    smem[slot * slot_floats + x_floats + r * kTile + n_end + rem - r * pad] =
        0.0f;
  }

  // Start the copies of kernel row ki into ring slot `slot`.
  auto stage = [&](int slot, int ki) {
    float* xs = smem + slot * slot_floats;
    float* ws = xs + x_floats;
    const int units = vec16 ? band / 4 : band;
    for (int idx = threadIdx.x; idx < rows_here * units;
         idx += blockDim.x) {
      const int r = idx / units;
      const int u = idx - r * units;
      const long long row = row0 + r;
      const long long b = row / Ho;
      const int oh = (int)(row - b * Ho);
      const float* src =
          images + ((b * H + (long long)oh * s + ki) * W) * C;
      if (vec16) {
        cp_async16(xs + r * band_ld + 4 * u, src + 4 * u);
      } else {
        cp_async4(xs + r * band_ld + u, src + u);
      }
    }
    const float* wk = wrows + (long long)ki * DX * kc * N + n0;
    for (int idx = threadIdx.x; idx < DX * kc * n_end; idx += blockDim.x) {
      const int r = idx / n_end;
      const int c = idx - r * n_end;
      cp_async4(ws + r * kTile + c, wk + (long long)r * N + c);
    }
  };

  for (int ki = 0; ki < nbuf; ++ki) {  // fill the ring
    stage(ki, ki);
    cp_async_commit();
  }

  const int r = threadIdx.x / Wo;  // this thread's row of the block
  const int ow = threadIdx.x - r * Wo;
  const bool live = r < rows_here;
  float acc[kTile];
#pragma unroll
  for (int q = 0; q < kTile; ++q) acc[q] = 0.0f;

  for (int ki = 0; ki < k; ++ki) {
    const int slot = ki % nbuf;
    cp_async_wait_pending(min(k - ki - 1, nbuf - 1));  // row ki has landed
    __syncthreads();
    if (live) {
      const float* xp = smem + slot * slot_floats + r * band_ld + ow * s * C;
      const float* wk = smem + slot * slot_floats + x_floats;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float part[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q) part[q] = 0.0f;
        for (int e = 0; e < kc; ++e) {
          const float x = xp[e];
          float xpow = x;
#pragma unroll
          for (int j = 0; j < DX; ++j) {
            const float4* wv = reinterpret_cast<const float4*>(
                wk + (j * kc + e) * kTile + ch * kChunk);
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
            xpow *= x;
          }
        }
#pragma unroll
        for (int q = 0; q < kChunk; ++q) acc[ch * kChunk + q] += part[q];
      }
    }
    __syncthreads();  // every thread is done with the slot: refill it
    if (ki + nbuf < k) {
      stage(slot, ki + nbuf);
      cp_async_commit();
    }
  }

  if (!live) return;
  const long long o = ((row0 + r) * Wo + ow) * N + n0;
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    if (q < n_end) {
      if (raw_out != nullptr) raw_out[o + q] = acc[q];
      out[o + q] = epilogue(acc[q], shift[n0 + q], mode, v_lsb, max_count,
                            full_scale);
    }
  }
}

// Shared memory of one B2 block, in bytes (the wrapper computes the same).
size_t pipelined_smem(int Wo, int C, int k, int s, int dx, int block_h,
                      int n_tile, int nbuf) {
  const int band_ld = ((((Wo - 1) * s + k) * C) + 3) & ~3;
  const int tile = (n_tile + kChunk - 1) / kChunk * kChunk;
  return sizeof(float) * (size_t)nbuf *
         ((size_t)block_h * band_ld + (size_t)dx * k * C * tile);
}

template <int DX, int NCH>
cudaError_t launch_pipelined(const Args& a, int block_h, int nbuf,
                             cudaStream_t stream) {
  const int Ho = (a.H - a.k) / a.s + 1;
  const int Wo = (a.W - a.k) / a.s + 1;
  const long long rows = (long long)a.B * Ho;
  const int threads = (block_h * Wo + 31) / 32 * 32;
  const int band = ((Wo - 1) * a.s + a.k) * a.C;
  const int vec16 = (reinterpret_cast<uintptr_t>(a.images) % 16 == 0) &&
                    (a.W * a.C) % 4 == 0 && band % 4 == 0;
  const size_t smem =
      pipelined_smem(Wo, a.C, a.k, a.s, DX, block_h, NCH * kChunk, nbuf);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        p2m_conv_pipelined_kernel<DX, NCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((rows + block_h - 1) / block_h),
                  (unsigned)((a.N + NCH * kChunk - 1) / (NCH * kChunk)), 1u);
  p2m_conv_pipelined_kernel<DX, NCH><<<grid, threads, smem, stream>>>(
      a.images, a.wrows, a.shift, a.out, a.raw, a.H, a.W, a.C, a.k, a.s, Ho,
      Wo, a.N, block_h, nbuf, rows, vec16, a.mode, a.v_lsb,
      (float)a.max_count, a.full_scale);
  return cudaGetLastError();
}

template <int DX>
cudaError_t dispatch_chunks(const Args& a, int block_h, int nbuf,
                            cudaStream_t st) {
  switch ((a.n_tile + kChunk - 1) / kChunk) {
    case 1: return launch_pipelined<DX, 1>(a, block_h, nbuf, st);
    case 2: return launch_pipelined<DX, 2>(a, block_h, nbuf, st);
    case 3: return launch_pipelined<DX, 3>(a, block_h, nbuf, st);
    case kMaxTileChunks:
      return launch_pipelined<DX, kMaxTileChunks>(a, block_h, nbuf, st);
    default: return cudaErrorInvalidValue;
  }
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
  const Args a{images, wrows, shift, nullptr, nullptr, out, raw, B, H, W, C,
               k, s, N, n_tile, mode, v_lsb, max_count, full_scale};
  return dispatch<false>(a, dx, stream);
}

// The delta-gated stem: out[b] = B1(images[b]) where rerun[b] != 0, else
// cached[b] (B, Ho, Wo, N).  rerun is int32 per image, on the device.
// Same conventions as p2m_conv_forward; no raw output.
extern "C" int p2m_conv_gated_forward(const float* images, const float* wrows,
                                      const float* shift, const float* cached,
                                      const int* rerun, float* out, int B,
                                      int H, int W, int C, int k, int s,
                                      int N, int dx, int n_tile, int mode,
                                      float v_lsb, int max_count,
                                      float full_scale, void* stream) {
  const Args a{images, wrows, shift, cached, rerun, out, nullptr, B, H, W, C,
               k, s, N, n_tile, mode, v_lsb, max_count, full_scale};
  return dispatch<true>(a, dx, stream);
}

// The pipelined conv (B2): B1's function through a cp.async ring of
// nbuf = min(depth, k) slots over the kernel rows, block_h rows of B*Ho a
// block, n_tile (<= 32) outputs a block.  Same conventions as
// p2m_conv_forward.  block_h * Wo <= kPipeThreads, n_tile <= 32 (the
// wrapper's PIPE_THREADS and PIPE_MAX_TILE).
extern "C" int p2m_conv_pipelined_forward(
    const float* images, const float* wrows, const float* shift, float* out,
    float* raw, int B, int H, int W, int C, int k, int s, int N, int dx,
    int n_tile, int block_h, int nbuf, int mode, float v_lsb, int max_count,
    float full_scale, void* stream) {
  const Args a{images, wrows, shift, nullptr, nullptr, out, raw, B, H, W, C,
               k, s, N, n_tile, mode, v_lsb, max_count, full_scale};
  const int Wo = (W - k) / s + 1;
  if (B < 1 || C < 1 || k < 1 || s < 1 || H < k || W < k || N < 1 ||
      n_tile < 1 || n_tile > kMaxTileChunks * kChunk || block_h < 1 ||
      (long long)block_h * Wo > kPipeThreads || nbuf < 1 || nbuf > k ||
      mode < kRaw || mode > kQuant) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dx) {
    case 1: return (int)dispatch_chunks<1>(a, block_h, nbuf, st);
    case 2: return (int)dispatch_chunks<2>(a, block_h, nbuf, st);
    case 3: return (int)dispatch_chunks<3>(a, block_h, nbuf, st);
    case kMaxDx: return (int)dispatch_chunks<kMaxDx>(a, block_h, nbuf, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Largest dx the kernel is compiled for; the wrapper checks against it.
extern "C" int p2m_conv_max_dx() { return kMaxDx; }
