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
// The delta-gated stem (p2m_conv_gated_forward, B5) replaces the TPU
// kernel src/repro/kernels/p2m_conv/gated.py::p2m_conv_pallas_gated: B1
// where rerun[b] != 0, else a copy of cached[b], in one launch.  It has two
// bodies, chosen by the caller's blocks as p2m_conv_fused chooses between
// B1 and B2: the gated instance of B2's ring (nbuf >= 1, what the stream
// engine runs at the tuner's blocks) and of B1's body (nbuf = 0: tuning
// off, or blocks the ring does not take).  Each runs its dense body's
// arithmetic in B1's order for a computed pixel, so the result equals B1
// followed by where(rerun, ., cached) bit for bit.  No block straddles two
// images: the ring's block_h divides Ho (the reference's aligned_block_h),
// and B1's gated grid puts the image on blockIdx.z and tiles only its
// Ho*Wo pixels on blockIdx.x.  So a block is all re-run or all skip, and
// reads its image's flag before anything else.  A skipped block stages
// nothing, reads no image byte and copies its pixels' N range of the
// cache, in 16-byte units where alignment allows, each thread's loads
// issued before its stores.  At the stream shape (4 x 560 x 560 x 3,
// N = 8) it moves 16.7 MB with every slot re-run and 3.2 MB with none:
// bytes bound.  B1's body made each thread wait on its ~75 image loads
// one after another, with about 3 warps a scheduler to hide them, so
// skipping half the slots saved 5 % of its time; the ring stages the
// bands in coalesced cp.async copies before any arithmetic.
//
// The pipelined conv (p2m_conv_pipelined_forward, B2) replaces the TPU
// kernel src/repro/kernels/p2m_conv/conv.py::p2m_conv_pallas with
// pipeline_depth >= 2: _pipelined_body driving
// _conv_kernel_fast_pipelined (s == k) and _conv_kernel_general_pipelined
// (s < k).  Same function as B1, bit for bit, raw included.  Bytes bound it
// as they bound B1: 33.3 MB a launch at the serving shape (30.1 MB of
// images read, 3.2 MB of outputs written) against 361 MFLOP.
//
// Design.  A block covers block_h rows of the flattened (B*Ho) output axis
// times all Wo pixels and one N tile of at most 32 outputs.  A ring of
// min(depth, k) shared-memory slots holds, per kernel row ki, the block's
// image band (block_h rows of ((Wo-1)*s + k)*C contiguous floats: the
// window of every pixel of the row, at any stride) and that row's
// dx*kC x n_tile slab of W~.  The ring is filled with cp.async, one commit
// group per kernel row, 16-byte copies where the rows are 16-byte aligned
// and 4-byte copies elsewhere; slot ki % nbuf is refilled with row
// ki + nbuf once every thread has drained it, as _pipelined_body does.
// So every image byte leaves device memory once, in coalesced copies that
// overlap the arithmetic of the rows before.
//
// Several pixels a thread.  A thread computes P = kPipePixels = 2 of its
// block's pixels (at an N tile of 8; one at wider tiles, so that at most
// 32 sums stay live), all outputs of the tile for each, so each W~ value
// it loads from shared memory feeds P pixels' FMAs.  A warp reads W~ with
// broadcast loads, every lane the same address, but each lane still takes
// its own copy; at one pixel a thread that is 4 bytes of W~ for every FMA.
// The block's pixels are dealt to threads T apart, not P adjacent ones a
// thread, so that a warp's x loads hit neighbouring windows.  P = 2 was
// chosen by timing P = 1, 2 and 4 at the serving, stream and training
// shapes (b2_probe.py --pixels; times in PERF.md).  A block is one thread
// for each P of its pixels, in whole warps, and __launch_bounds__ is the
// most that can be: 512 pixels over P.  The band rows' copies find their
// source once a band row, not once a copy, and a pixel's outputs leave in
// 16-byte stores where N % 4 == 0 (the stem's 8 outputs: one 32-byte
// sector a pixel).
//
// W~ stays in the ring rather than being staged once for all k rows: that
// would take 64.8 KB a block at k = 15, where the tuner must still find a
// B2 block within a 16 KB budget.  Staging it once at the stem's k = 5
// (7.2 KB at N = 8) has not been timed against the ring.
//
// Why not the tensor cores.  An mma sums a pixel's 1,800 products in
// another order and rounds it differently.  B2 keeps B1's order per pixel
// (e ascending, j inner, x^(j+1) by repeated multiplication, a per-row
// part, then acc += part with ki ascending, the same epilogue), so it
// equals B1 bit for bit, and B5, whose bodies are B1's and B2's, stays
// equal to B1 + where; how pixels are tiled over threads does not enter a
// pixel's sum.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

constexpr int kCopyUnroll = 4;  // loads a thread issues before its stores

// A skipped block of the gated stem: copies `pixels` consecutive pixels'
// outputs [n0, n0 + n_end) of cached, rows of N floats from pixel `first`,
// into out, in units of V (one or four floats).  Units are counted in 32
// bits (a block has at most 512 pixels): unit i of the block lies `gap`
// units further on for each pixel before its own, i / len; where the N
// range covers N the span is contiguous (gap 0) and no division is made.
template <typename V>
__device__ __forceinline__ void copy_units(const float* __restrict__ cached,
                                           float* __restrict__ out,
                                           long long first, int pixels,
                                           int N, int n0, int n_end) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const long long base = first * N + n0;
  const V* src = reinterpret_cast<const V*>(cached + base);
  V* dst = reinterpret_cast<V*>(out + base);
  const int len = n_end / kW;  // units a pixel
  const int gap = N / kW - len;  // units between two pixels' ranges
  const int count = pixels * len;
  for (int i0 = threadIdx.x; i0 < count; i0 += kCopyUnroll * blockDim.x) {
    V v[kCopyUnroll];
    int at[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      at[u] = gap == 0 ? i : i + i / len * gap;
      if (i < count) v[u] = src[at[u]];
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      if (i0 + u * blockDim.x < count) dst[at[u]] = v[u];
    }
  }
}

// The copy in 16-byte units where N, n0 and n_end are multiples of 4 and
// both tensors 16-byte aligned (the stem's N = 8), else in 4-byte ones.
__device__ __forceinline__ void copy_cached(const float* __restrict__ cached,
                                            float* __restrict__ out,
                                            long long first, int pixels,
                                            int N, int n0, int n_end) {
  const bool vec = N % 4 == 0 && n0 % 4 == 0 && n_end % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(cached) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    copy_units<float4>(cached, out, first, pixels, N, n0, n_end);
  } else {
    copy_units<float>(cached, out, first, pixels, N, n0, n_end);
  }
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
      copy_cached(cached, out, first, (int)(m_end - first), N, n0,
                  min(n_tile, N - n0));
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

constexpr int kPipeThreads = 512;  // most pixels a B2 block has
constexpr int kMaxTileChunks = 4;  // a B2 block computes <= 32 outputs
// Pixels a B2 thread computes at an N tile of one register chunk (the
// stem's N = 8): every W~ value the thread loads feeds this many pixels.
constexpr int kPipePixels = 2;

// Pixels a B2 thread computes at an N tile of NCH register chunks:
// kPipePixels at one chunk, fewer at more, so that a thread keeps at most
// 32 sums live.
template <int NCH>
__host__ __device__ constexpr int pipe_pixels() {
  return kPipePixels / NCH > 1 ? kPipePixels / NCH : 1;
}

// Most threads a B2 block launches: its most pixels over pixels a thread.
template <int NCH>
__host__ __device__ constexpr int pipe_max_threads() {
  return kPipeThreads / pipe_pixels<NCH>();
}

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

// One B2 block: block_h rows of the flattened (B*Ho) output axis times all
// Wo pixels, and one N tile of NCH register chunks.  The block's pixels,
// row-major, are i = t + p*T for thread t < T = ceil(block_h*Wo / P) and
// p < P: at block_h 1 a thread's P pixels lie in one row, T apart.  The
// lanes of a warp so read x from neighbouring windows, s*C floats apart
// (15, odd, at the stem's shape: no bank conflict), where P adjacent
// pixels a lane would put P*s*C floats between lanes (30: a 2-way
// conflict).  A pixel past the block's (a thread past T, a row past B*Ho)
// is computed on the slot's first window and not stored.
//
// Gated (kGated, the delta-gated stem B5): block_h divides Ho, so a
// block's rows are one image's.  The block reads that image's rerun flag
// first; a skipped block stages nothing, reads no image byte, copies its
// pixels' N range of `cached` and returns whole, before any barrier.  A
// re-run block runs the body below unchanged (raw_out is null).
template <int DX, int NCH, bool kGated>
__global__ void __launch_bounds__(pipe_max_threads<NCH>())
p2m_conv_pipelined_kernel(const float* __restrict__ images,
                          const float* __restrict__ wrows,
                          const float* __restrict__ shift,
                          const float* __restrict__ cached,
                          const int* __restrict__ rerun,
                          float* __restrict__ out, float* __restrict__ raw_out,
                          int H, int W, int C, int k, int s, int Ho, int Wo,
                          int N, int block_h, int nbuf, long long rows_total,
                          int vec16, int wvec16, int mode, float v_lsb,
                          float max_count, float full_scale) {
  constexpr int kTile = NCH * kChunk;  // this block's N tile, padded
  constexpr int P = pipe_pixels<NCH>();
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
  if constexpr (kGated) {
    if (rerun[row0 / Ho] == 0) {  // skipped image: copy the cache
      copy_cached(cached, out, row0 * Wo, rows_here * Wo, N, n0, n_end);
      return;  // the whole block: no barrier follows for it
    }
  }

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

  // Start the copies of kernel row ki into ring slot `slot`: the block's
  // image band, one band row at a time (its source found once, not per
  // copy), and that row's DX*kc x n_end slab of W~.
  auto stage = [&](int slot, int ki) {
    float* xs = smem + slot * slot_floats;
    float* ws = xs + x_floats;
    for (int r = 0; r < rows_here; ++r) {
      const long long row = row0 + r;
      const long long b = row / Ho;
      const int oh = (int)(row - b * Ho);
      const float* src =
          images + ((b * H + (long long)oh * s + ki) * W) * C;
      float* dst = xs + r * band_ld;
      if (vec16) {
        for (int u = 4 * threadIdx.x; u < band; u += 4 * blockDim.x) {
          cp_async16(dst + u, src + u);
        }
      } else {
        for (int u = threadIdx.x; u < band; u += blockDim.x) {
          cp_async4(dst + u, src + u);
        }
      }
    }
    const float* wk = wrows + (long long)ki * DX * kc * N + n0;
    const int wunits = wvec16 ? n_end / 4 : n_end;
    for (int idx = threadIdx.x; idx < DX * kc * wunits; idx += blockDim.x) {
      const int r = idx / wunits;
      const int u = idx - r * wunits;
      if (wvec16) {
        cp_async16(ws + r * kTile + 4 * u, wk + (long long)r * N + 4 * u);
      } else {
        cp_async4(ws + r * kTile + u, wk + (long long)r * N + u);
      }
    }
  };

  for (int ki = 0; ki < nbuf; ++ki) {  // fill the ring
    stage(ki, ki);
    cp_async_commit();
  }

  const int T = (block_h * Wo + P - 1) / P;  // threads with pixels
  int xoff[P];  // each pixel's window in a ring slot's bands
  bool mine[P];  // whether the pixel is one of the block's
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = threadIdx.x + p * T;
    const int r = i / Wo;
    mine[p] = threadIdx.x < T && r < rows_here;
    xoff[p] = mine[p] ? r * band_ld + (i - r * Wo) * s * C : 0;
  }
  const bool live = mine[0];  // a thread's later pixels come after it
  float acc[P][kTile];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[p][q] = 0.0f;
  }

  for (int ki = 0; ki < k; ++ki) {
    const int slot = ki % nbuf;
    cp_async_wait_pending(min(k - ki - 1, nbuf - 1));  // row ki has landed
    __syncthreads();
    if (live) {
      const float* xr = smem + slot * slot_floats;
      const float* wk = xr + x_floats;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float part[P][kChunk];
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int q = 0; q < kChunk; ++q) part[p][q] = 0.0f;
        }
        for (int e = 0; e < kc; ++e) {
          float x[P], xpow[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            x[p] = xr[xoff[p] + e];
            xpow[p] = x[p];
          }
#pragma unroll
          for (int j = 0; j < DX; ++j) {
            const float4* wv = reinterpret_cast<const float4*>(
                wk + (j * kc + e) * kTile + ch * kChunk);
            const float4 w0 = wv[0];
            const float4 w1 = wv[1];
#pragma unroll
            for (int p = 0; p < P; ++p) {  // B1's FMAs, for P pixels
              part[p][0] = fmaf(xpow[p], w0.x, part[p][0]);
              part[p][1] = fmaf(xpow[p], w0.y, part[p][1]);
              part[p][2] = fmaf(xpow[p], w0.z, part[p][2]);
              part[p][3] = fmaf(xpow[p], w0.w, part[p][3]);
              part[p][4] = fmaf(xpow[p], w1.x, part[p][4]);
              part[p][5] = fmaf(xpow[p], w1.y, part[p][5]);
              part[p][6] = fmaf(xpow[p], w1.z, part[p][6]);
              part[p][7] = fmaf(xpow[p], w1.w, part[p][7]);
              xpow[p] *= x[p];
            }
          }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int q = 0; q < kChunk; ++q) {
            acc[p][ch * kChunk + q] += part[p][q];
          }
        }
      }
    }
    __syncthreads();  // every thread is done with the slot: refill it
    if (ki + nbuf < k) {
      stage(slot, ki + nbuf);
      cp_async_commit();
    }
  }

  // 16-byte stores where N and both outputs allow them (at the stem's
  // N = 8 a pixel's outputs are one 32-byte sector), else 4-byte ones.
  const bool vec_out = N % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(raw_out) % 16 == 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!mine[p]) continue;
    const long long o = (row0 * Wo + threadIdx.x + p * T) * N + n0;
    if (vec_out) {  // n_end is a multiple of 4 too
#pragma unroll
      for (int q = 0; q < kTile; q += 4) {
        if (q >= n_end) continue;
        if (raw_out != nullptr) {
          *reinterpret_cast<float4*>(raw_out + o + q) = make_float4(
              acc[p][q], acc[p][q + 1], acc[p][q + 2], acc[p][q + 3]);
        }
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = epilogue(acc[p][q + i], shift[n0 + q + i], mode, v_lsb,
                          max_count, full_scale);
        }
        *reinterpret_cast<float4*>(out + o + q) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        if (q < n_end) {
          if (raw_out != nullptr) raw_out[o + q] = acc[p][q];
          out[o + q] = epilogue(acc[p][q], shift[n0 + q], mode, v_lsb,
                                max_count, full_scale);
        }
      }
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

// B2's one launch rule: a block for each block_h rows of B*Ho and each N
// tile, a thread for each P of its pixels, threads rounded up to whole
// warps.
struct PipeLaunch {
  dim3 grid;
  int threads;
  size_t smem;
};

template <int DX, int NCH>
PipeLaunch pipe_launch(const Args& a, int block_h, int nbuf) {
  const int Ho = (a.H - a.k) / a.s + 1;
  const int Wo = (a.W - a.k) / a.s + 1;
  const long long rows = (long long)a.B * Ho;
  const int with_pixels =
      (block_h * Wo + pipe_pixels<NCH>() - 1) / pipe_pixels<NCH>();
  return {dim3((unsigned)((rows + block_h - 1) / block_h),
               (unsigned)((a.N + NCH * kChunk - 1) / (NCH * kChunk)), 1u),
          (with_pixels + 31) / 32 * 32,
          pipelined_smem(Wo, a.C, a.k, a.s, DX, block_h, NCH * kChunk, nbuf)};
}

template <int DX, int NCH, bool kGated>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(p2m_conv_pipelined_kernel<DX, NCH, kGated>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DX, int NCH, bool kGated>
cudaError_t launch_pipelined(const Args& a, int block_h, int nbuf,
                             cudaStream_t stream) {
  const PipeLaunch l = pipe_launch<DX, NCH>(a, block_h, nbuf);
  const cudaError_t err = allow_smem<DX, NCH, kGated>(l.smem);
  if (err != cudaSuccess) return err;
  const int Ho = (a.H - a.k) / a.s + 1;
  const int Wo = (a.W - a.k) / a.s + 1;
  const int band = ((Wo - 1) * a.s + a.k) * a.C;
  const int vec16 = (reinterpret_cast<uintptr_t>(a.images) % 16 == 0) &&
                    (a.W * a.C) % 4 == 0 && band % 4 == 0;
  const int wvec16 =
      (reinterpret_cast<uintptr_t>(a.wrows) % 16 == 0) && a.N % 4 == 0;
  p2m_conv_pipelined_kernel<DX, NCH, kGated>
      <<<l.grid, l.threads, l.smem, stream>>>(
      a.images, a.wrows, a.shift, a.cached, a.rerun, a.out, a.raw, a.H, a.W,
      a.C, a.k, a.s, Ho,
      Wo, a.N, block_h, nbuf, (long long)a.B * Ho, vec16, wvec16, a.mode,
      a.v_lsb, (float)a.max_count, a.full_scale);
  return cudaGetLastError();
}

// What launch_pipelined would launch, and what the card makes of it.
template <int DX, int NCH, bool kGated>
cudaError_t report_pipelined(const Args& a, int block_h, int nbuf,
                             int* geometry) {
  const PipeLaunch l = pipe_launch<DX, NCH>(a, block_h, nbuf);
  cudaError_t err = allow_smem<DX, NCH, kGated>(l.smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr,
                                p2m_conv_pipelined_kernel<DX, NCH, kGated>);
  }
  int blocks_per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, p2m_conv_pipelined_kernel<DX, NCH, kGated>,
        l.threads, l.smem);
  }
  const int report[] = {(int)l.grid.x,          (int)l.grid.y,
                        l.threads,              (int)l.smem,
                        pipe_pixels<NCH>(),     attr.numRegs,
                        (int)attr.localSizeBytes, blocks_per_sm};
  for (int i = 0; i < 8; ++i) geometry[i] = report[i];
  return err;
}

// Calls f(dx, chunks) with both as compile-time constants, for the
// instantiation a launch of dx powers and an N tile of n_tile outputs
// takes.
template <class F>
cudaError_t with_pipelined(int dx, int n_tile, F&& f) {
  using std::integral_constant;
  auto chunks = [&](auto d) -> cudaError_t {
    switch ((n_tile + kChunk - 1) / kChunk) {
      case 1: return f(d, integral_constant<int, 1>{});
      case 2: return f(d, integral_constant<int, 2>{});
      case 3: return f(d, integral_constant<int, 3>{});
      case kMaxTileChunks:
        return f(d, integral_constant<int, kMaxTileChunks>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (dx) {
    case 1: return chunks(integral_constant<int, 1>{});
    case 2: return chunks(integral_constant<int, 2>{});
    case 3: return chunks(integral_constant<int, 3>{});
    case kMaxDx: return chunks(integral_constant<int, kMaxDx>{});
    default: return cudaErrorInvalidValue;
  }
}

// What B2 takes: block_h * Wo <= kPipeThreads pixels, n_tile <= 32,
// 1 <= nbuf <= k.
bool pipelined_takes(const Args& a, int block_h, int nbuf) {
  const int Wo = (a.W - a.k) / a.s + 1;
  return a.B >= 1 && a.C >= 1 && a.k >= 1 && a.s >= 1 && a.H >= a.k &&
         a.W >= a.k && a.N >= 1 && a.n_tile >= 1 &&
         a.n_tile <= kMaxTileChunks * kChunk && block_h >= 1 &&
         (long long)block_h * Wo <= kPipeThreads && nbuf >= 1 &&
         nbuf <= a.k && a.mode >= kRaw && a.mode <= kQuant;
}

// What the gated ring takes: what B2 takes, and block_h dividing Ho, so
// that no block straddles two images.
bool gated_pipelined_takes(const Args& a, int block_h, int nbuf) {
  const int Ho = (a.H - a.k) / a.s + 1;
  return pipelined_takes(a, block_h, nbuf) && Ho % block_h == 0;
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

// The delta-gated stem (B5): out[b] = B1(images[b]) where rerun[b] != 0,
// else cached[b] (B, Ho, Wo, N).  rerun is int32 per image, on the device.
// nbuf = 0 runs B1's gated body (its own tiling; block_h is not read);
// nbuf >= 1 runs the gated instance of B2's ring with block_h rows of B*Ho
// a block, block_h dividing Ho, as p2m_conv_pipelined_forward takes its
// blocks.  Same conventions as p2m_conv_forward; no raw output.
extern "C" int p2m_conv_gated_forward(const float* images, const float* wrows,
                                      const float* shift, const float* cached,
                                      const int* rerun, float* out, int B,
                                      int H, int W, int C, int k, int s,
                                      int N, int dx, int n_tile, int block_h,
                                      int nbuf, int mode, float v_lsb,
                                      int max_count, float full_scale,
                                      void* stream) {
  const Args a{images, wrows, shift, cached, rerun, out, nullptr, B, H, W, C,
               k, s, N, n_tile, mode, v_lsb, max_count, full_scale};
  if (nbuf == 0) return dispatch<true>(a, dx, stream);
  if (!gated_pipelined_takes(a, block_h, nbuf)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_pipelined(dx, n_tile, [&](auto d, auto nch) {
    return launch_pipelined<decltype(d)::value, decltype(nch)::value, true>(
        a, block_h, nbuf, st);
  });
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
  if (!pipelined_takes(a, block_h, nbuf)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_pipelined(dx, n_tile, [&](auto d, auto nch) {
    return launch_pipelined<decltype(d)::value, decltype(nch)::value, false>(
        a, block_h, nbuf, st);
  });
}

// The launch p2m_conv_pipelined_forward (gated = 0) or the ring of
// p2m_conv_gated_forward (gated = 1) makes with these arguments, into
// geometry[8]: blocks in x and y, threads a block, dynamic shared memory
// (bytes), pixels a thread, registers a thread, local memory a thread
// (bytes: spills and stack), and blocks an SM as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them.  Launches
// nothing.  Returns a cudaError_t.
extern "C" int p2m_conv_pipelined_geometry(int B, int H, int W, int C, int k,
                                           int s, int N, int dx, int n_tile,
                                           int block_h, int nbuf, int gated,
                                           int* geometry) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               B, H, W, C, k, s, N, n_tile, kRaw, 1.0f, 0, 0.0f};
  if (!(gated ? gated_pipelined_takes(a, block_h, nbuf)
              : pipelined_takes(a, block_h, nbuf))) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)with_pipelined(dx, n_tile, [&](auto d, auto nch) {
    constexpr int kDx = decltype(d)::value, kNch = decltype(nch)::value;
    return gated ? report_pipelined<kDx, kNch, true>(a, block_h, nbuf,
                                                     geometry)
                 : report_pipelined<kDx, kNch, false>(a, block_h, nbuf,
                                                      geometry);
  });
}

// Largest dx the kernel is compiled for; the wrapper checks against it.
extern "C" int p2m_conv_max_dx() { return kMaxDx; }
