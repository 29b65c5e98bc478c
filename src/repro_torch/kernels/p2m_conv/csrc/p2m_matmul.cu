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
// Design for that: x is read from device memory once, in copies that are
// in flight while the block computes, and no powered operand exists
// outside the block.  The TPU kernel forms dw*dx products of powered tiles
// in VMEM; here a block premixes its N tile of w in shared memory once,
// for all of its tiles, into
//   W~_j = sum_i a_ij sign(w) |w|^i,   j = 1..dx,
// so a row costs dx products instead of dw*dx (the same function in
// another order).
//
// A persistent grid of one wave (kernel.matmul_tiling, the one launch
// rule): each block walks a contiguous run of row tiles of block_m rows,
// the first tiles % gridDim.x blocks one more.  Where block_k >= K a
// tile is one contiguous span of block_m * K floats; where x, the tile and
// M * K allow it (16-byte alignment: K = 75 wants block_m a multiple of
// 4) one thread copies it with one bulk copy (cp.async.bulk, completed on
// the slot's mbarrier) into a ring of two slots, the next tile in flight
// while the current one computes; elsewhere every thread copies with
// 4-byte cp.async.  Where block_k < K a tile is copied a K tile at a time
// (rows padded to an odd stride), each slot with its K tile of W~
// premixed beside it, so block_k keeps its meaning.  Where two slots do
// not fit a block, one does, without overlap.
//
// A thread computes kRowsPerThread rows at an N tile of 8 (one at wider
// tiles, so that at most 32 sums stay live), dealt T apart over the tile,
// so each W~ value it reads from shared memory (a broadcast float4) feeds
// that many rows' FMAs, and a warp's lanes read rows K floats apart (75,
// odd at the stem's shape: no bank conflict).  The CUDA cores suffice at
// about 11 FLOP a byte.  Splitting K over 4 neighbouring lanes, whose
// sums a shuffle adds (4x the warps an SM), was timed in turns with this
// design and ran 15 % slower (PERF.md §6).
//
// The quant epilogue divides (no reciprocal) and rounds half to even
// (rintf), like jnp.round; build without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxDeg = 4;         // dw and dx, compile-time max
constexpr int kChunk = 8;          // outputs read as two float4 at a time
constexpr int kMaxTileChunks = 4;  // a thread keeps <= 32 outputs live
constexpr int kMaxRows = 256;      // rows a tile takes (block_m)
constexpr int kMaxSlots = 2;       // ring slots a block has
// Rows a thread computes at an N tile of one register chunk.
constexpr int kRowsPerThread = 2;

// Rows a thread computes at an N tile of NCH register chunks:
// kRowsPerThread at one chunk, fewer at more, at most 32 sums live.
template <int NCH>
__host__ __device__ constexpr int rows_per_thread() {
  return kRowsPerThread / NCH > 1 ? kRowsPerThread / NCH : 1;
}

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// Wait until at most `pending` (0 or 1) of this thread's groups fly.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
}

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

// Floats of one slot's x: block_m rows of K floats where block_k >= K,
// else of block_k | 1 (odd: no bank conflict), padded to 16 bytes.
__host__ __device__ inline int x_slot_floats(int block_m, int K,
                                             int block_k) {
  const int ld = block_k >= K ? K : (block_k | 1);
  return (block_m * ld + 3) & ~3;
}

// Shared memory of one block, in bytes (kernel.matmul_smem_bytes): where
// block_k >= K, W~ for all of K once and nslots slots of x; else nslots
// slots of x and of that K tile's W~.
size_t matmul_smem(int block_m, int K, int block_k, int dx, int n_tile,
                   int nslots) {
  const size_t tile = (n_tile + kChunk - 1) / kChunk * kChunk;
  const size_t xs = x_slot_floats(block_m, K, block_k);
  if (block_k >= K) return sizeof(float) * (dx * K * tile + nslots * xs);
  return sizeof(float) * nslots * (xs + dx * block_k * tile);
}

// Premix w's rows [k0, k0 + kt) for the N tile at n0 into
// dst[(j * ld + e) * kTile + c]; columns past N are zero.
template <int DX, int kTile>
__device__ __forceinline__ void premix(float* dst, const float* __restrict__ w,
                                       int N, int n0, int n_end, int k0,
                                       int kt, int ld, int dw,
                                       const Coeffs& co) {
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
    for (int j = 0; j < DX; ++j) dst[(j * ld + e) * kTile + c] = mix[j];
  }
}

template <int DX, int NCH>
__global__ void __launch_bounds__(kMaxRows, 2)
p2m_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ shift, float* __restrict__ out,
                  float* __restrict__ raw_out, long long M, int K, int N,
                  int dw, Coeffs co, int block_m, int block_k, int nslots,
                  int bulk, int mode, float v_lsb, float max_count,
                  float full_scale) {
  constexpr int kTile = NCH * kChunk;
  constexpr int P = rows_per_thread<NCH>();
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[kMaxSlots];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nk = (K + block_k - 1) / block_k;  // K tiles a row tile
  const bool one_k = nk == 1;
  const int xld = one_k ? K : (block_k | 1);
  const int x_floats = x_slot_floats(block_m, K, block_k);
  const int slot_floats = one_k ? x_floats : x_floats + DX * block_k * kTile;
  float* slots = smem + (one_k ? DX * K * kTile : 0);
  const int n0 = blockIdx.y * kTile;
  const int n_end = min(kTile, N - n0);

  // This block's row tiles [t0, t1), and its stages: each tile's K tiles.
  const long long tiles = (M + block_m - 1) / block_m;
  const long long per = tiles / gridDim.x;
  const long long extra = tiles - per * gridDim.x;
  const long long t0 = blockIdx.x * per + min((long long)blockIdx.x, extra);
  const long long stages = (per + (blockIdx.x < extra ? 1 : 0)) * nk;

  // Start the copy of stage c (row tile t0 + c / nk, K tile c % nk) into
  // `slot`; a K tile of several also premixes its W~ beside it.
  auto stage = [&](long long c, int slot) {
    const long long r0 = (t0 + c / nk) * block_m;
    const int rows_here = (int)min((long long)block_m, M - r0);
    float* xs = slots + slot * slot_floats;
    if (one_k) {
      const float* src = x + r0 * K;
      if (bulk) {
        if (threadIdx.x == 0) {
          bulk_copy(xs, src, (unsigned)(4 * rows_here * K), &bars[slot]);
        }
      } else {
        for (int u = threadIdx.x; u < rows_here * K; u += blockDim.x) {
          cp_async4(xs + u, src + u);
        }
      }
      return;
    }
    const int k0 = (int)(c % nk) * block_k;
    const int kt = min(block_k, K - k0);
    for (int idx = threadIdx.x; idx < rows_here * kt; idx += blockDim.x) {
      const int r = idx / kt;
      const int e = idx - r * kt;
      cp_async4(xs + r * xld + e, x + (r0 + r) * K + k0 + e);
    }
    premix<DX, kTile>(xs + x_floats, w, N, n0, n_end, k0, kt, block_k, dw,
                      co);
  };

  if (bulk && threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = 0; c < nslots && c < stages; ++c) {  // fill the ring
    stage(c, c);
    if (!bulk) cp_async_commit();
  }
  if (one_k) premix<DX, kTile>(smem, w, N, n0, n_end, 0, K, K, dw, co);

  const int T = (block_m + P - 1) / P;  // threads with rows
  const bool vec_out = N % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(raw_out) % 16 == 0;
  float acc[P][kTile];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[p][q] = 0.0f;
  }
  for (long long c = 0; c < stages; ++c) {
    const int slot = (int)(c % nslots);
    if (bulk) {
      mbar_wait(&bars[slot], (unsigned)((c / nslots) & 1));
    } else {
      cp_async_wait_pending((int)min(stages - c - 1, (long long)nslots - 1));
    }
    __syncthreads();  // the stage (and W~) are visible to every thread
    const long long r0 = (t0 + c / nk) * block_m;
    const int rows_here = (int)min((long long)block_m, M - r0);
    const int kt = one_k ? K : min(block_k, K - (int)(c % nk) * block_k);
    const float* xs = slots + slot * slot_floats;
    const float* ws = one_k ? smem : xs + x_floats;
    const int wld = one_k ? K : block_k;
    int xoff[P];  // each row in the slot
    bool mine[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = threadIdx.x + p * T;
      mine[p] = threadIdx.x < T && r < rows_here;
      xoff[p] = mine[p] ? r * xld : 0;
    }
    if (mine[0]) {  // a thread's later rows come after its first
      for (int e = 0; e < kt; ++e) {
        float xv[P], xpow[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          xv[p] = xs[xoff[p] + e];
          xpow[p] = xv[p];
        }
#pragma unroll
        for (int j = 0; j < DX; ++j) {
          const float* wj = ws + (j * wld + e) * kTile;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            const float4* wv =
                reinterpret_cast<const float4*>(wj + ch * kChunk);
            const float4 w0 = wv[0];
            const float4 w1 = wv[1];
#pragma unroll
            for (int p = 0; p < P; ++p) {
              float* a = acc[p] + ch * kChunk;
              a[0] = fmaf(xpow[p], w0.x, a[0]);
              a[1] = fmaf(xpow[p], w0.y, a[1]);
              a[2] = fmaf(xpow[p], w0.z, a[2]);
              a[3] = fmaf(xpow[p], w0.w, a[3]);
              a[4] = fmaf(xpow[p], w1.x, a[4]);
              a[5] = fmaf(xpow[p], w1.y, a[5]);
              a[6] = fmaf(xpow[p], w1.z, a[6]);
              a[7] = fmaf(xpow[p], w1.w, a[7]);
            }
          }
#pragma unroll
          for (int p = 0; p < P; ++p) xpow[p] *= xv[p];
        }
      }
    }
    if (c % nk == nk - 1) {  // the row tile's last K tile: store, reset
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (mine[p]) {
          const long long o = (r0 + threadIdx.x + p * T) * N + n0;
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
                v[i] = epilogue(acc[p][q + i], shift[n0 + q + i], mode,
                                v_lsb, max_count, full_scale);
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
#pragma unroll
        for (int q = 0; q < kTile; ++q) acc[p][q] = 0.0f;
      }
    }
    __syncthreads();  // every thread is done with the slot: refill it
    if (c + nslots < stages) {
      stage(c + nslots, slot);
      if (!bulk) cp_async_commit();
    }
  }
}

// One launch's arguments.
struct Args {
  const float* x;
  const float* w;
  const float* shift;
  float* out;
  float* raw;  // may be null
  long long M;
  int K, N, dw, dx, block_m, n_tile, block_k, grid_x, nslots, mode;
  float v_lsb;
  int max_count;
  float full_scale;
};

// The launch from the tiling (kernel.matmul_tiling): grid_x persistent
// blocks in x, one N tile of NCH chunks a block in y, a thread for each
// rows_per_thread<NCH>() rows of a tile in whole warps.
struct Launch {
  dim3 grid;
  int threads;
  size_t smem;
};

template <int NCH>
Launch matmul_launch(const Args& a) {
  const int with_rows =
      (a.block_m + rows_per_thread<NCH>() - 1) / rows_per_thread<NCH>();
  return {dim3((unsigned)a.grid_x,
               (unsigned)((a.N + NCH * kChunk - 1) / (NCH * kChunk)), 1u),
          (with_rows + 31) / 32 * 32,
          matmul_smem(a.block_m, a.K, a.block_k, a.dx, NCH * kChunk,
                      a.nslots)};
}

template <int DX, int NCH>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(p2m_matmul_kernel<DX, NCH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DX, int NCH>
cudaError_t launch(const Args& a, const Coeffs& co, cudaStream_t stream) {
  const Launch l = matmul_launch<NCH>(a);
  const cudaError_t err = allow_smem<DX, NCH>(l.smem);
  if (err != cudaSuccess) return err;
  // One bulk copy a tile where it is one 16-byte-aligned span whose
  // length, and every tile's start, are multiples of 16 bytes.
  const int bulk = a.block_k >= a.K &&
                   reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                   ((long long)a.block_m * a.K) % 4 == 0 &&
                   (a.M * a.K) % 4 == 0;
  p2m_matmul_kernel<DX, NCH><<<l.grid, l.threads, l.smem, stream>>>(
      a.x, a.w, a.shift, a.out, a.raw, a.M, a.K, a.N, a.dw, co, a.block_m,
      a.block_k, a.nslots, bulk, a.mode, a.v_lsb, (float)a.max_count,
      a.full_scale);
  return cudaGetLastError();
}

// What launch would launch, and what the card makes of it, into
// geometry[8] (the order of p2m_matmul_geometry).
template <int DX, int NCH>
cudaError_t report(const Args& a, int* geometry) {
  const Launch l = matmul_launch<NCH>(a);
  cudaError_t err = allow_smem<DX, NCH>(l.smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, p2m_matmul_kernel<DX, NCH>);
  }
  int blocks_per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, p2m_matmul_kernel<DX, NCH>, l.threads, l.smem);
  }
  const int out[] = {(int)l.grid.x,           (int)l.grid.y,
                     l.threads,               (int)l.smem,
                     rows_per_thread<NCH>(),  attr.numRegs,
                     (int)attr.localSizeBytes, blocks_per_sm};
  for (int i = 0; i < 8; ++i) geometry[i] = out[i];
  return err;
}

// Calls f(dx, chunks) with both as compile-time constants.
template <class F>
cudaError_t with_instance(int dx, int n_tile, F&& f) {
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
    case kMaxDeg: return chunks(integral_constant<int, kMaxDeg>{});
    default: return cudaErrorInvalidValue;
  }
}

bool takes(const Args& a) {
  return a.M >= 1 && a.K >= 1 && a.N >= 1 && a.dw >= 1 && a.dw <= kMaxDeg &&
         a.block_m >= 1 && a.block_m <= kMaxRows && a.block_k >= 1 &&
         a.n_tile >= 1 && a.n_tile <= kMaxTileChunks * kChunk &&
         a.grid_x >= 1 && a.nslots >= 1 && a.nslots <= kMaxSlots &&
         a.mode >= kRaw && a.mode <= kQuant;
}

}  // namespace

// C entry point, loaded with ctypes.  x (M, K), w (K, N), shift (N,), out
// and raw (M, N) are device pointers of contiguous fp32 tensors; raw may be
// null.  coeffs holds dw x dx floats, row-major, on the host (a_ij
// multiplies w^(i+1) x^(j+1)).  block_m rows a tile, n_tile (<= 32)
// outputs a block, block_k rows of K a copy; grid_x persistent blocks and
// nslots (1 or 2) ring slots, as kernel.matmul_tiling gives them.
// Allocates nothing, launches on `stream`, does not synchronise.  Returns
// the launch's cudaError_t.
extern "C" int p2m_matmul_forward(const float* x, const float* w,
                                  const float* shift, float* out, float* raw,
                                  long long M, int K, int N, int dw, int dx,
                                  const float* coeffs, int block_m,
                                  int n_tile, int block_k, int grid_x,
                                  int nslots, int mode, float v_lsb,
                                  int max_count, float full_scale,
                                  void* stream) {
  const Args a{x,       w,      shift,   out,    raw,    M,
               K,       N,      dw,      dx,     block_m, n_tile,
               block_k, grid_x, nslots,  mode,   v_lsb,  max_count,
               full_scale};
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  Coeffs co{};
  for (int i = 0; i < dw; ++i)
    for (int j = 0; j < dx && j < kMaxDeg; ++j)
      co.a[i * kMaxDeg + j] = coeffs[i * dx + j];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_instance(dx, n_tile, [&](auto d, auto nch) {
    return launch<decltype(d)::value, decltype(nch)::value>(a, co, st);
  });
}

// The launch p2m_matmul_forward makes with these arguments, into
// geometry[8]: blocks in x and y, threads a block, dynamic shared memory
// (bytes), rows a thread, registers a thread, local memory a thread
// (bytes: spills and stack), and blocks an SM as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them.  Launches
// nothing.  Returns a cudaError_t.
extern "C" int p2m_matmul_geometry(long long M, int K, int N, int dx,
                                   int block_m, int n_tile, int block_k,
                                   int grid_x, int nslots, int* geometry) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, M,
               K,       N,       1,       dx,      block_m, n_tile,
               block_k, grid_x,  nslots,  kRaw,    1.0f,    0,
               0.0f};
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  return (int)with_instance(dx, n_tile, [&](auto d, auto nch) {
    return report<decltype(d)::value, decltype(nch)::value>(a, geometry);
  });
}

// Largest dw and dx the kernel is compiled for; the wrapper checks them.
extern "C" int p2m_matmul_max_degree() { return kMaxDeg; }
