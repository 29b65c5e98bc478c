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
// Design for that (B1): every image byte is read from device memory once,
// in copies that are in flight while the block computes, and no patch
// tensor exists.  A persistent grid of one wave (conv.b1_tiling, the one
// launch rule, from the shape alone): a tile is a span of the pixels of
// one output row, so it never straddles two images; each block walks a
// contiguous run of tiles, the first tiles % blocks of them one more, so
// blocks differ by at most one tile, and the longer runs, on the lowest
// block indices, which the card places first, one an SM, fall on
// different SMs (at the serving shape 896 tiles on 264 blocks: 104 runs
// of 4 and 160 of 3, at most 7 tiles an SM against 6.8 on average).  A
// tile's band, the k image rows of its pixels' windows, goes into one of
// two shared-memory slots while the block computes the tile before from
// the other.  At s = k and W = Wo*s a tile is a whole output row and its
// band k whole image rows, one contiguous span (33,600 B at the serving
// shape): one thread copies it with one bulk copy (cp.async.bulk) that
// completes the slot's mbarrier, whose phase flips each use.  Elsewhere
// (s < k with W > (Wo-1)*s + k, a row cut into several tiles, an
// unaligned view) every thread copies the k band rows with cp.async, 16
// bytes where source and length allow, else 4; both give the same bits.
// The block stages its N range of W~ once, for all of its tiles (7.2 KB
// at the serving shape), where all threads of a warp read the same word
// (broadcast).  Two slots and W~ take 74,400 B at the serving shape.
//
// The block is a row group of threads for each kernel row (at most 5; 5
// groups of 64 threads at the stem): a group computes its row's part of
// every pixel of the tile, a thread all 8 outputs of 2 pixels dealt 56
// apart, so each 16-byte W~ load feeds 8 FMAs, and a warp's lanes read
// windows s*C floats apart (15, odd, at the stem's shape: no bank
// conflict).  The parts go into the band row the group has just read;
// then every thread sums four outputs of a pixel.  Each pixel is summed
// in the parent's order, which B2 and B5 are held to bit for bit: e
// ascending, j inner, x^(j+1) by repeated multiplication, one part a
// kernel row, acc = 0, acc += part with ki ascending, then the epilogue.
// The launch bounds keep two blocks an SM (at most 102 registers a
// thread; 90 at the stem, none spilled): 20 warps.  What was tried and
// timed (PERF.md §6): one thread two pixels of every kernel row, 6
// warps an SM, ran slower than the kernel it replaced; 4 pixels by 4
// outputs a thread, and the kernel row's loop unrolled at k * C = 15,
// spilled at the 64 registers of three blocks an SM and ran slower;
// three blocks an SM at 64 registers ran no faster than two.  The TPU
// kernel's padding of N to 128 lanes and its 2048-row tiles are not
// carried over: at N = 8 they would be 16x wasted work here.
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
// followed by where(rerun, ., cached) bit for bit.  No block or tile
// straddles two images: the ring's block_h divides Ho (the reference's
// aligned_block_h), and B1's tiles lie in one output row.  So a ring
// block is all re-run or all skip, and reads its image's flag before
// anything else; B1's body reads it once a tile.  A skipped block or tile
// stages nothing, reads no image byte and copies its pixels' N range of
// the cache, in 16-byte units where alignment allows, each thread's loads
// issued before its stores.  At the stream shape (4 x 560 x 560 x 3,
// N = 8) it moves 16.7 MB with every slot re-run and 3.2 MB with none:
// bytes bound.
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

// ---------------------------------------------------------------- copies

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
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

// An mbarrier in shared memory that one arrival and the bytes of one
// bulk copy complete: B1's band slots.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One thread: arrive on `bar` expecting `bytes`, and copy them from
// global `src` to shared `dst` (both 16-byte aligned, bytes a multiple of
// 16) with one bulk copy whose completion the barrier counts.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until `bar` has completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------- B1

constexpr int kB1Pixels = 2;       // pixels a B1 thread computes
constexpr int kB1Groups = 5;       // row groups a B1 block has at most
constexpr int kB1GroupThreads = 64;  // threads a row group has at most
constexpr int kB1MaxThreads = kB1Groups * kB1GroupThreads;
constexpr int kB1Slots = 2;        // band slots a B1 block has

// Floats of one kernel row of a B1 band slot: the windows of tile_px
// pixels of one output row, (tile_px - 1) * s + k pixels of C floats,
// padded to 16 bytes.  A slot holds k such rows.
__host__ __device__ inline int b1_row_floats(int tile_px, int C, int k,
                                             int s) {
  return (((tile_px - 1) * s + k) * C + 3) & ~3;
}

// Whether a kernel row's parts (tile_px pixels x kChunk floats) go into
// that row of the band slot, once its row group has read it: at one
// register chunk, where the row is wide enough.  Else they go into a
// buffer of k rows of tile_px * kChunk floats after W~.
__host__ __device__ inline bool b1_parts_in_band(int tile_px, int C, int k,
                                                 int s, int stride_n) {
  return stride_n == kChunk &&
         b1_row_floats(tile_px, C, k, s) >= tile_px * kChunk;
}

// Row groups of a B1 block: one a kernel row, at most kB1Groups.
__host__ __device__ inline int b1_groups(int k) {
  return k < kB1Groups ? k : kB1Groups;
}

// Wait at named barrier `id` for `threads` threads (a row group).
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// B1 (and, kGated, B5 on B1's body): a persistent block walks its share
// of the output tiles, tile_px pixels of one output row each, for one N
// tile of n_tile outputs.  Tile t is piece t % pieces of output row
// t / pieces of the flattened (B*Ho) axis; the grid's blocks take
// contiguous runs of tiles, the first tiles % gridDim.x of them one more.
// Two shared-memory slots hold the tiles' bands (k image rows of the
// tile's windows); while the block computes one, the next tile's band is
// in flight into the other.  Where the band is k whole image rows of a
// 16-byte-aligned image (bulk != 0: a tile is a whole output row and
// W == (Wo - 1) * s + k, W * C % 4 == 0) one thread copies it with one
// bulk copy, completed on the slot's mbarrier; elsewhere every thread
// copies per band row with cp.async, 16 bytes where source and length
// allow (vec16), else 4, one commit group a tile.  W~'s N tile is staged
// once a block.
//
// The block is b1_groups(k) row groups of T threads (T = ceil(tile_px /
// kB1Pixels) in whole warps); group g computes kernel rows g, g + G, ...
// of every pixel of the tile, a thread kB1Pixels pixels dealt
// ceil(tile_px / kB1Pixels) apart, each row's part in B1's order (e
// ascending, j inner, x^(j+1) by repeated multiplication) into shared
// memory: into the band row it has just read, once its group has read
// it, where b1_parts_in_band, else into a buffer.  After a barrier every
// thread sums four outputs of a pixel, acc = 0, acc += part with ki
// ascending, and stores them through the epilogue: the parent's sum, bit
// for bit.
//
// Gated: a tile lies in one output row, so in one image.  A tile of an
// image whose rerun flag is 0 issues no copy and copies its pixels' N
// range of `cached` instead.
template <int DX, bool kGated>
__global__ void __launch_bounds__(kB1MaxThreads, 2)
p2m_conv_kernel(const float* __restrict__ images,
                const float* __restrict__ wrows,
                const float* __restrict__ shift,
                const float* __restrict__ cached,
                const int* __restrict__ rerun,
                float* __restrict__ out, float* __restrict__ raw_out,
                int H, int W, int C, int k, int s, int Ho, int Wo, int N,
                int n_tile, int tile_px, int pieces, long long tiles,
                int bulk, int vec16, int mode, float v_lsb, float max_count,
                float full_scale) {
  constexpr int P = kB1Pixels;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[kB1Slots];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kc = k * C;
  const int xld = b1_row_floats(tile_px, C, k, s);
  const int slot_floats = k * xld;
  float* wsm = smem + kB1Slots * slot_floats;
  const int rows = k * DX * kc;
  const int stride_n = (n_tile + kChunk - 1) / kChunk * kChunk;
  const bool in_band = b1_parts_in_band(tile_px, C, k, s, stride_n);
  const int pld = tile_px * kChunk;  // floats of one row's parts
  float* pbuf = wsm + rows * stride_n;  // the parts where not in the band
  const int n0 = blockIdx.y * n_tile;
  const int n_end = min(n_tile, N - n0);
  const int G = b1_groups(k);
  const int Tu = (tile_px + P - 1) / P;  // a group's threads with pixels
  const int T = blockDim.x / G;          // a group's threads
  const int g = threadIdx.x / T;
  const int lt = threadIdx.x - g * T;

  // This block's tiles [t0, t1).
  const long long per = tiles / gridDim.x;
  const long long extra = tiles - per * gridDim.x;
  const long long t0 =
      blockIdx.x * per + min((long long)blockIdx.x, extra);
  const long long t1 = t0 + per + (blockIdx.x < extra ? 1 : 0);

  auto computed = [&](long long t) {  // whether tile t is computed
    if constexpr (kGated) return rerun[t / pieces / Ho] != 0;
    return true;
  };
  auto next_computed = [&](long long t) {
    while (t < t1 && !computed(t)) ++t;
    return t;
  };
  // Start the copy of tile t's band into `slot`.
  auto stage = [&](long long t, int slot) {
    const long long row = t / pieces;
    const int ow0 = (int)(t - row * pieces) * tile_px;
    const long long b = row / Ho;
    const int oh = (int)(row - b * Ho);
    const long long first = ((b * H + (long long)oh * s) * W + ow0 * s) * C;
    float* dst = smem + slot * slot_floats;
    if (bulk) {
      if (threadIdx.x == 0) {
        // the slot's last parts were generic stores: order them first
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_copy(dst, images + first, (unsigned)(4 * k * W * C),
                  &bars[slot]);
      }
      return;
    }
    const int tp = min(tile_px, Wo - ow0);
    const int band = ((tp - 1) * s + k) * C;
    for (int ki = 0; ki < k; ++ki) {
      const long long at = first + (long long)ki * W * C;
      float* d = dst + ki * xld;
      if (vec16 && at % 4 == 0 && band % 4 == 0) {
        for (int u = 4 * threadIdx.x; u < band; u += 4 * blockDim.x) {
          cp_async16(d + u, images + at + u);
        }
      } else {
        for (int u = threadIdx.x; u < band; u += blockDim.x) {
          cp_async4(d + u, images + at + u);
        }
      }
    }
  };

  long long t = next_computed(t0);
  if (bulk && threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (t < t1) stage(t, 0);  // the first band, before W~
  if (!bulk) cp_async_commit();

  // This block's N range of W~, zero-padded to whole chunks: one copy of
  // wrows where the range is all of N in whole chunks.
  if (n_tile == N && N % kChunk == 0 &&
      reinterpret_cast<uintptr_t>(wrows) % 16 == 0) {
    const float4* src = reinterpret_cast<const float4*>(wrows);
    for (int u = threadIdx.x; u < rows * N / 4; u += blockDim.x) {
      smem4[(kB1Slots * slot_floats) / 4 + u] = src[u];
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * stride_n; idx += blockDim.x) {
      const int r = idx / stride_n;
      const int c = idx - r * stride_n;
      const int n = n0 + c;
      wsm[idx] = (c < n_tile && n < N) ? wrows[(long long)r * N + n] : 0.0f;
    }
  }
  __syncthreads();  // W~ and the barriers' initialisation are visible

  const bool vec_out = N % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(raw_out) % 16 == 0;
  int xoff[P];  // each of this thread's pixels' windows in a band row
  bool mine[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = lt + p * Tu;
    mine[p] = lt < Tu && i < tile_px;
    xoff[p] = mine[p] ? i * s * C : 0;
  }
  int used = 0;  // bands consumed: tile of band u is in slot u % 2
  for (long long tt = t0; tt < t1; ++tt) {
    const long long row = tt / pieces;
    const int ow0 = (int)(tt - row * pieces) * tile_px;
    const int tp = min(tile_px, Wo - ow0);
    const long long first = row * Wo + ow0;  // the tile's first pixel
    if (!computed(tt)) {  // skipped image: copy the cache
      copy_cached(cached, out, first, tp, N, n0, n_end);
      continue;
    }
    const int slot = used & 1;
    const long long next = next_computed(tt + 1);
    if (next < t1) stage(next, slot ^ 1);  // freed at the last barrier
    if (bulk) {
      mbar_wait(&bars[slot], (used >> 1) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<1>();  // this tile's band has landed, the next flies
      __syncthreads();
    }
    float* xs = smem + slot * slot_floats;
    // A pixel past the tile's (p of a partial tile) is computed on the
    // slot's rows and not stored.
    for (int c0 = 0; c0 < n_end; c0 += kChunk) {
      for (int ki = g; ki < k; ki += G) {
        const float* xr = xs + ki * xld;
        const float* wk = wsm + ki * DX * kc * stride_n + c0;
        float part[P][kChunk];
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int q = 0; q < kChunk; ++q) part[p][q] = 0.0f;
        }
        if (mine[0]) {  // a thread's later pixels come after its first
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
                  wk + (j * kc + e) * stride_n);
              const float4 w0 = wv[0];
              const float4 w1 = wv[1];
#pragma unroll
              for (int p = 0; p < P; ++p) {
                part[p][0] = fmaf(xpow[p], w0.x, part[p][0]);
                part[p][1] = fmaf(xpow[p], w0.y, part[p][1]);
                part[p][2] = fmaf(xpow[p], w0.z, part[p][2]);
                part[p][3] = fmaf(xpow[p], w0.w, part[p][3]);
                part[p][4] = fmaf(xpow[p], w1.x, part[p][4]);
                part[p][5] = fmaf(xpow[p], w1.y, part[p][5]);
                part[p][6] = fmaf(xpow[p], w1.z, part[p][6]);
                part[p][7] = fmaf(xpow[p], w1.w, part[p][7]);
                xpow[p] *= x[p];  // x^(j+2), the order _power_concat uses
              }
            }
          }
        }
        float* pr;
        if (in_band) {
          pr = xs + ki * xld;
          group_sync(1 + g, T);  // the group has read the row
        } else {
          pr = pbuf + ki * pld;
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (!mine[p]) continue;
          float4* dst = reinterpret_cast<float4*>(pr + (lt + p * Tu) * kChunk);
          dst[0] = make_float4(part[p][0], part[p][1], part[p][2],
                               part[p][3]);
          dst[1] = make_float4(part[p][4], part[p][5], part[p][6],
                               part[p][7]);
        }
      }
      __syncthreads();  // every row's parts are in
      // Four outputs of a pixel a thread: acc = 0, acc += part, ki
      // ascending, then the epilogue.
      for (int u = threadIdx.x; u < 2 * tp; u += blockDim.x) {
        const int i = u >> 1;
        const int q0 = (u & 1) * 4;
        if (c0 + q0 >= n_end) continue;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int ki = 0; ki < k; ++ki) {
          const float* pr = in_band ? xs + ki * xld : pbuf + ki * pld;
          const float4 v =
              *reinterpret_cast<const float4*>(pr + i * kChunk + q0);
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
        const float a[4] = {acc.x, acc.y, acc.z, acc.w};
        const long long o = (first + i) * N + n0 + c0 + q0;
        const int nq = min(4, n_end - c0 - q0);
        if (vec_out) {  // n_end is a multiple of 4 too
          if (raw_out != nullptr) {
            *reinterpret_cast<float4*>(raw_out + o) = acc;
          }
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[q] = epilogue(a[q], shift[n0 + c0 + q0 + q], mode, v_lsb,
                            max_count, full_scale);
          }
          *reinterpret_cast<float4*>(out + o) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
          for (int q = 0; q < nq; ++q) {
            if (raw_out != nullptr) raw_out[o + q] = a[q];
            out[o + q] = epilogue(a[q], shift[n0 + c0 + q0 + q], mode,
                                  v_lsb, max_count, full_scale);
          }
        }
      }
      __syncthreads();  // the parts are read: the slot (or buffer) is free
    }
    ++used;
  }
}

// One launch's arguments, shared by all entry points.
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

// B1's launch from its tiling (conv.b1_tiling): tile_px pixels a tile,
// grid_x blocks in x, an N tile of n_tile outputs a block in y, a row
// group for each kernel row (at most kB1Groups) of a thread for each
// kB1Pixels pixels of a tile in whole warps; two band slots, the N tile
// of W~ and, where they do not go into the band, the parts in dynamic
// shared memory.
struct B1Launch {
  dim3 grid;
  int threads;
  size_t smem;
  int pieces;
  long long tiles;
};

B1Launch b1_launch(const Args& a, int dx, int tile_px, int grid_x) {
  const int Ho = (a.H - a.k) / a.s + 1;
  const int Wo = (a.W - a.k) / a.s + 1;
  const int pieces = (Wo + tile_px - 1) / tile_px;
  const int stride_n = (a.n_tile + kChunk - 1) / kChunk * kChunk;
  const int with_pixels = (tile_px + kB1Pixels - 1) / kB1Pixels;
  const size_t parts =
      b1_parts_in_band(tile_px, a.C, a.k, a.s, stride_n)
          ? 0
          : (size_t)a.k * tile_px * kChunk;
  const size_t smem =
      sizeof(float) *
      ((size_t)kB1Slots * a.k * b1_row_floats(tile_px, a.C, a.k, a.s) +
       (size_t)a.k * dx * a.k * a.C * stride_n + parts);
  return {dim3((unsigned)grid_x, (unsigned)((a.N + a.n_tile - 1) / a.n_tile),
               1u),
          b1_groups(a.k) * ((with_pixels + 31) / 32 * 32), smem, pieces,
          (long long)a.B * Ho * pieces};
}

// What B1 takes: its tiling within the output row and the block.
bool b1_takes(const Args& a, int tile_px, int grid_x) {
  if (a.B < 1 || a.C < 1 || a.k < 1 || a.s < 1 || a.H < a.k || a.W < a.k ||
      a.N < 1 || a.n_tile < 1 || a.mode < kRaw || a.mode > kQuant) {
    return false;
  }
  const int Wo = (a.W - a.k) / a.s + 1;
  return tile_px >= 1 && tile_px <= Wo &&
         tile_px <= kB1GroupThreads * kB1Pixels && grid_x >= 1;
}

template <int DX, bool kGated>
cudaError_t b1_allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(p2m_conv_kernel<DX, kGated>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DX, bool kGated>
cudaError_t launch(const Args& a, int tile_px, int grid_x,
                   cudaStream_t stream) {
  const B1Launch l = b1_launch(a, DX, tile_px, grid_x);
  const cudaError_t err = b1_allow_smem<DX, kGated>(l.smem);
  if (err != cudaSuccess) return err;
  const int Ho = (a.H - a.k) / a.s + 1;
  const int Wo = (a.W - a.k) / a.s + 1;
  const bool aligned = reinterpret_cast<uintptr_t>(a.images) % 16 == 0;
  const int bulk = aligned && l.pieces == 1 &&
                   a.W == (Wo - 1) * a.s + a.k && (a.W * a.C) % 4 == 0;
  const int vec16 = aligned && (a.W * a.C) % 4 == 0;
  p2m_conv_kernel<DX, kGated><<<l.grid, l.threads, l.smem, stream>>>(
      a.images, a.wrows, a.shift, a.cached, a.rerun, a.out, a.raw, a.H, a.W,
      a.C, a.k, a.s, Ho, Wo, a.N, a.n_tile, tile_px, l.pieces, l.tiles, bulk,
      vec16, a.mode, a.v_lsb, (float)a.max_count, a.full_scale);
  return cudaGetLastError();
}

// Calls f(dx) with dx as a compile-time constant.
template <class F>
cudaError_t with_dx(int dx, F&& f) {
  using std::integral_constant;
  switch (dx) {
    case 1: return f(integral_constant<int, 1>{});
    case 2: return f(integral_constant<int, 2>{});
    case 3: return f(integral_constant<int, 3>{});
    case kMaxDx: return f(integral_constant<int, kMaxDx>{});
    default: return cudaErrorInvalidValue;
  }
}

template <bool kGated>
int dispatch(const Args& a, int dx, int tile_px, int grid_x, void* stream) {
  if (!b1_takes(a, tile_px, grid_x)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_dx(dx, [&](auto d) {
    return launch<decltype(d)::value, kGated>(a, tile_px, grid_x, st);
  });
}

// What launch would launch, and what the card makes of it, into
// geometry[8] (the order of p2m_conv_b1_geometry).
template <int DX, bool kGated>
cudaError_t report_b1(const Args& a, int tile_px, int grid_x,
                      int* geometry) {
  const B1Launch l = b1_launch(a, DX, tile_px, grid_x);
  cudaError_t err = b1_allow_smem<DX, kGated>(l.smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, p2m_conv_kernel<DX, kGated>);
  }
  int blocks_per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, p2m_conv_kernel<DX, kGated>, l.threads, l.smem);
  }
  const int report[] = {(int)l.grid.x,  (int)l.grid.y,     l.threads,
                        (int)l.smem,    kB1Pixels,         attr.numRegs,
                        (int)attr.localSizeBytes, blocks_per_sm};
  for (int i = 0; i < 8; ++i) geometry[i] = report[i];
  return err;
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
// contiguous fp32 tensors; raw may be null.  B1 with its tiling
// (conv.b1_tiling): tile_px pixels of one output row a tile, grid_x
// persistent blocks.  Allocates nothing, launches on `stream`, does not
// synchronise.  Returns the launch's cudaError_t.
extern "C" int p2m_conv_forward(const float* images, const float* wrows,
                                const float* shift, float* out, float* raw,
                                int B, int H, int W, int C, int k, int s,
                                int N, int dx, int n_tile, int tile_px,
                                int grid_x, int mode, float v_lsb,
                                int max_count, float full_scale,
                                void* stream) {
  const Args a{images, wrows, shift, nullptr, nullptr, out, raw, B, H, W, C,
               k, s, N, n_tile, mode, v_lsb, max_count, full_scale};
  return dispatch<false>(a, dx, tile_px, grid_x, stream);
}

// The delta-gated stem (B5): out[b] = B1(images[b]) where rerun[b] != 0,
// else cached[b] (B, Ho, Wo, N).  rerun is int32 per image, on the device.
// nbuf = 0 runs B1's gated body with B1's tiling (tile_px, grid_x;
// block_h is not read); nbuf >= 1 runs the gated instance of B2's ring
// with block_h rows of B*Ho a block, block_h dividing Ho, as
// p2m_conv_pipelined_forward takes its blocks (tile_px and grid_x are not
// read).  Same conventions as p2m_conv_forward; no raw output.
extern "C" int p2m_conv_gated_forward(const float* images, const float* wrows,
                                      const float* shift, const float* cached,
                                      const int* rerun, float* out, int B,
                                      int H, int W, int C, int k, int s,
                                      int N, int dx, int n_tile, int block_h,
                                      int nbuf, int tile_px, int grid_x,
                                      int mode, float v_lsb, int max_count,
                                      float full_scale, void* stream) {
  const Args a{images, wrows, shift, cached, rerun, out, nullptr, B, H, W, C,
               k, s, N, n_tile, mode, v_lsb, max_count, full_scale};
  if (nbuf == 0) return dispatch<true>(a, dx, tile_px, grid_x, stream);
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

// The launch p2m_conv_forward (gated = 0) or B1's gated body of
// p2m_conv_gated_forward (gated = 1) makes with these arguments, into
// geometry[8]: blocks in x and y, threads a block, dynamic shared memory
// (bytes), pixels a thread, registers a thread, local memory a thread
// (bytes: spills and stack), and blocks an SM as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them.  Launches
// nothing.  Returns a cudaError_t.
extern "C" int p2m_conv_b1_geometry(int B, int H, int W, int C, int k,
                                    int s, int N, int dx, int n_tile,
                                    int tile_px, int grid_x, int gated,
                                    int* geometry) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               B, H, W, C, k, s, N, n_tile, kRaw, 1.0f, 0, 0.0f};
  if (!b1_takes(a, tile_px, grid_x)) return (int)cudaErrorInvalidValue;
  return (int)with_dx(dx, [&](auto d) {
    constexpr int kDx = decltype(d)::value;
    return gated ? report_b1<kDx, true>(a, tile_px, grid_x, geometry)
                 : report_b1<kDx, false>(a, tile_px, grid_x, geometry);
  });
}

// Largest dx the kernel is compiled for; the wrapper checks against it.
extern "C" int p2m_conv_max_dx() { return kMaxDx; }
