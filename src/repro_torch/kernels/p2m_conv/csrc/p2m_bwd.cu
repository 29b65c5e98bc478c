// Closed-form backward of the P2M basis sum (DESIGN.md §4), for Hopper
// (sm_90a).  With raw = sum_j (X^j) @ W~_j and the epilogue mask already
// applied to the cotangent G by the caller:
//
//   dX = sum_j j * X^(j-1) (.) (G @ W~_j^T)                         (B3)
//   dW = sum_i i * |W|^(i-1) (.) sum_j a_ij * T_j,  T_j = (X^j)^T @ G (B4)
//
// X is the (M, K) im2col matrix of the images, G the (M, N) cotangent,
// W~ (dx, K, N) the premixed weights, W (K, N) the clipped weights.
//
// B3 replaces src/repro/kernels/p2m_conv/backward.py::p2m_bwd_dx_pallas,
// B4 replaces src/repro/kernels/p2m_conv/backward.py::p2m_bwd_dw_pallas.
// Neither keeps the TPU tiling: it pads N to 128 lanes and K to 128, which
// at the training shape (K = 75, N = 8) would be mostly padding.
//
// What bounds them on this card: bytes.  At the training shape (M = 32 x
// 112 x 112 = 401,408 rows, K = 75, N = 8, dx = 3) B3 reads X and G and
// writes dX (254 MB against 1.7 GFLOP); B4 reads X and G (133 MB against
// 1.4 GFLOP): both are below the ~20 FLOP per byte at which the fp32 rate,
// and not the memory, would set the limit.
//
// B3 design: one block per tile of 128 rows.  W~ (7.2 KB at the training
// shape) is staged transposed, [j][n][e], so that a warp reading 32
// consecutive e hits 32 banks; the tile's G rows are staged in shared
// memory with coalesced loads.  A thread owns one column e and four rows of
// the tile (rows rg, rg + 32, rg + 64, rg + 96), so each W~ value it loads
// from shared memory serves four rows; it reads X and writes dX straight
// from and to device memory, and for each of its four rows the warp's 32
// threads touch 32 consecutive floats: coalesced without staging.
//
// B4 design: split-M, two launches.  At the training shape B4 is 722 M
// fused multiply-adds against 133 MB: on the CUDA cores the FMAs, powers
// and shared-memory reads alone take about as long as the bytes, so the
// contraction goes to the tensor cores, and the rest of the design keeps
// the copies in flight.
//  Pass one: block b walks rows [b * rows_per_block, ...), a fixed split
//  from M and the row width alone (`backward.dw_split`: about 264 blocks,
//  two an SM by the register budget, whole tiles of up to 64 rows), so
//  the bits do not depend on the card.  Tiles of X and G come through a
//  ring of kDwStages slots in shared memory by cp.async (16-byte units
//  for a whole tile where x and g are 16-byte aligned, else 4-byte and
//  zero-filled past the block's rows): tiles t+1 and t+2 are in flight
//  while t computes, one barrier a tile.  Each warp takes 8-row k-steps
//  of the tile and runs T_j += (X^j)^T G on mma.sync m16n8k8 in 3xTF32
//  (each operand split into a TF32 high part, rounded to nearest, and a
//  remainder by integer and fp32 instructions; lo*hi + hi*lo + hi*hi
//  into a fresh fragment each k-step, added to the accumulator in fp32,
//  so neither the split nor the tensor cores' rounding toward zero biases
//  sums over 10^5 rows).  A = x^j, 16 columns e by 8 rows, x^j formed in
//  fp32 as x, x*x, (x*x)*x like the reference and split once a power;
//  B = G's 8 rows by 8 columns, split once a k-step and shared by every
//  e-tile and j.  K pads to e-tiles of 16, N to n-tiles of 8; a block
//  holds kDwETiles e-tiles (K <= 80 in one), further e-groups and n-tiles
//  go along y.  The warps' fragments are summed in warp order into the
//  block's partial (dx, K, N): 262 x 7.2 KB = 1.9 MB at the training
//  shape.
//  Pass two: one block per kFinPairs (e, n) pairs, kFinSlices threads a
//  pair each summing a fixed stride of the partials, then the slices in
//  order; applies sum_i a_ij i |W|^(i-1).  150 blocks at the training
//  shape, so every SM takes part.
// No atomics: the gradient is the same from run to run.
//
// Built without --use_fast_math; the coefficients are fp32, as the
// reference multiplies them into fp32 sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxDx = 4;  // pixel-model degree in x, compile-time max
constexpr int kMaxDw = 4;  // pixel-model degree in w
constexpr int kThreads = 256;

// ---------------------------------------------------------------- B3 (dX)

constexpr int kDxRowsPerThread = 4;
constexpr int kDxTileRows = 128;
constexpr int kDxRowGroups = kDxTileRows / kDxRowsPerThread;

size_t dx_smem_bytes(int dx, int K, int N) {
  return sizeof(float) * ((size_t)dx * K * N + (size_t)kDxTileRows * N);
}

template <int DX>
__global__ void __launch_bounds__(kThreads)
p2m_bwd_dx_kernel(const float* __restrict__ g, const float* __restrict__ wmix,
                  const float* __restrict__ x, float* __restrict__ out,
                  long long M, int K, int N) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [DX][N][K]
  float* gs = ws + DX * K * N;                  // [kDxTileRows][N]
  const long long m0 = (long long)blockIdx.x * kDxTileRows;
  const int rows = (int)min((long long)kDxTileRows, M - m0);
  const int kn = K * N;

  for (int idx = threadIdx.x; idx < DX * kn; idx += blockDim.x) {
    const int j = idx / kn;
    const int rem = idx - j * kn;
    const int e = rem / N;
    const int n = rem - e * N;
    ws[(j * N + n) * K + e] = wmix[idx];
  }
  const float* gt = g + m0 * N;
  for (int idx = threadIdx.x; idx < kDxTileRows * N; idx += blockDim.x) {
    gs[idx] = idx < rows * N ? gt[idx] : 0.0f;
  }
  __syncthreads();

  const float* xt = x + m0 * K;
  float* ot = out + m0 * K;
  const int items = kDxRowGroups * K;
  for (int q = threadIdx.x; q < items; q += blockDim.x) {
    const int rg = q / K;
    const int e = q - rg * K;
    float xv[kDxRowsPerThread];
#pragma unroll
    for (int r = 0; r < kDxRowsPerThread; ++r) {
      const int ml = rg + r * kDxRowGroups;
      xv[r] = ml < rows ? xt[(long long)ml * K + e] : 0.0f;
    }
    float acc[kDxRowsPerThread][DX];
#pragma unroll
    for (int r = 0; r < kDxRowsPerThread; ++r)
#pragma unroll
      for (int j = 0; j < DX; ++j) acc[r][j] = 0.0f;

    for (int n = 0; n < N; ++n) {
      float gv[kDxRowsPerThread];
#pragma unroll
      for (int r = 0; r < kDxRowsPerThread; ++r)
        gv[r] = gs[(rg + r * kDxRowGroups) * N + n];
#pragma unroll
      for (int j = 0; j < DX; ++j) {
        const float w = ws[(j * N + n) * K + e];
#pragma unroll
        for (int r = 0; r < kDxRowsPerThread; ++r)
          acc[r][j] = fmaf(gv[r], w, acc[r][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < kDxRowsPerThread; ++r) {
      const int ml = rg + r * kDxRowGroups;
      if (ml < rows) {
        float total = 0.0f;
        float xpow = 1.0f;  // x^(j-1)
#pragma unroll
        for (int j = 0; j < DX; ++j) {
          total += (float)(j + 1) * xpow * acc[r][j];
          xpow *= xv[r];
        }
        ot[(long long)ml * K + e] = total;
      }
    }
  }
}

template <int DX>
cudaError_t launch_dx(const float* g, const float* wmix, const float* x,
                      float* out, long long M, int K, int N,
                      cudaStream_t stream) {
  const size_t smem = dx_smem_bytes(DX, K, N);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        p2m_bwd_dx_kernel<DX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((M + kDxTileRows - 1) / kDxTileRows);
  p2m_bwd_dx_kernel<DX><<<blocks, kThreads, smem, stream>>>(g, wmix, x, out,
                                                            M, K, N);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- B4 (dW)

constexpr int kDwWarps = 8;        // warps of pass one
constexpr int kDwThreads = 32 * kDwWarps;
constexpr int kDwStages = 3;       // ring slots: t+1, t+2 land as t runs
constexpr int kDwETiles = 5;       // 16-column e-tiles a block holds
constexpr int kDwBlocksPerSm = 2;  // the register budget
constexpr int kFinPairs = 4;       // (e, n) pairs a block of pass two
constexpr int kFinSlices = 64;     // threads a pair, over the partials

struct Coeffs {
  float a[kMaxDw][kMaxDx];  // a[i-1][j-1] multiplies w^i x^j
  int dw;
};

// The copies and the mma as in rwkv_wkv/csrc/wkv.cu (B7), which is built
// on its own.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// x = hi + lo in three instructions: hi is x rounded to TF32 (half an
// ulp added to the magnitude, the low 13 mantissa bits cleared); lo =
// x - hi is exact in fp32, and the tensor cores read the TF32 part of it
// (they ignore a .tf32 operand's low 13 bits, as cuBLAS's TF32 mode,
// which feeds them fp32 words, relies on).  hi rounds to nearest, so lo
// and the bits dropped from it take either sign: the errors do not pile
// up one way over 10^5 rows.  A product keeps ~2^-21 of itself.  B7's
// split (two cvt.rna.tf32) left pass one a fifth slower at the training
// shape: the splits of X's powers are most of its instructions.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a * b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b, one m16n8k8 TF32 product from a zero accumulator.
__device__ __forceinline__ void mma_tf32_zero(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// acc += a * b over one k-step in 3xTF32, the small terms first: a_lo b_hi
// + a_hi b_lo + a_hi b_hi (lo*lo dropped, ~2^-22 of the product) into a
// fresh fragment, then added to acc by fp32 adds.  The tensor cores do
// not round their fp32 sums to nearest (they cut them toward zero):
// summed over a k-step's 8 rows only, that bias stays at the size of one
// k-step's sum instead of growing with acc over a block's 1,536 rows,
// and acc itself rounds to nearest.
__device__ __forceinline__ void mma3_add(float (&acc)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         uint32_t bh0, uint32_t bh1,
                                         uint32_t bl0, uint32_t bl1) {
  float t[4];
  mma_tf32_zero(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] += t[c];
}

// Copy `total` floats (a multiple of 4) of a tile from src to the ring
// slot dst; the first `valid` are the tile's rows, the rest zero-filled.
// A whole tile (valid == total) whose src is 16-byte aligned goes in
// 16-byte copies; the rest (the last tile of the last block, unaligned
// views) in 4-byte copies: the same bits land either way.
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int total, int valid, bool vec) {
  if (vec && valid == total) {
    for (int c = 4 * threadIdx.x; c < total; c += 4 * kDwThreads)
      cp_async16(dst + c, src + c);
  } else {
    for (int i = threadIdx.x; i < total; i += kDwThreads)
      cp_async4(dst + i, i < valid ? src + i : src, i < valid);
  }
}

int dw_e_groups(int K) {
  return ((K + 15) / 16 + kDwETiles - 1) / kDwETiles;
}

size_t dw_smem_bytes(int dx, int K, int N, int tile_rows) {
  const size_t ring = (size_t)kDwStages * tile_rows * (K + N);
  const size_t red = (size_t)kDwWarps * kDwETiles * dx * 128;
  return sizeof(float) * (ring > red ? ring : red);
}

// Pass one.  Block (bx, by) reduces rows [bx * rows_per_block, ...) of
// e-group by % e_groups (kDwETiles e-tiles) and n-tile by / e_groups (8
// columns of G) into its slice of `partial` (blocks, DX, K, N).  Tiles of
// tile_rows rows of X and G go through a ring of kDwStages slots in
// shared memory; warp w takes the 8-row k-steps w, w + kDwWarps, ... of
// each tile.  Per k-step: the mma's B is G's 8 x 8 (rows x columns),
// split once; its A, for each e-tile, is (X^j)^T, 16 columns e by the 8
// rows, x^j formed in fp32 as x, x*x, (x*x)*x like the reference and
// split once a power.  The warps' fragments are summed in warp order.
template <int DX>
__global__ void __launch_bounds__(kDwThreads, kDwBlocksPerSm)
p2m_bwd_dw_partial_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          float* __restrict__ partial, long long M, int K,
                          int N, long long rows_per_block, int tile_rows,
                          int e_groups) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int slot_floats = tile_rows * (K + N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int eg = blockIdx.y % e_groups, nt = blockIdx.y / e_groups;
  const int e_first = eg * kDwETiles * 16;
  const int net = min(kDwETiles, (K - e_first + 15) / 16);
  const int n = nt * 8 + gid;
  const bool n_ok = n < N;

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(M, r0 + rows_per_block);
  const int tiles = (int)((r1 - r0 + tile_rows - 1) / tile_rows);
  // Every tile starts at a multiple of 8 rows: x + t0 * K and g + t0 * N
  // are 16-byte aligned where x and g are.
  const bool vec_x = aligned16(x), vec_g = aligned16(g);
  auto load = [&](int t) {
    const long long t0 = r0 + (long long)t * tile_rows;
    const int rows = (int)min((long long)tile_rows, r1 - t0);
    float* xs = ring + (t % kDwStages) * slot_floats;
    copy_tile(xs, x + t0 * K, tile_rows * K, rows * K, vec_x);
    copy_tile(xs + tile_rows * K, g + t0 * N, tile_rows * N, rows * N,
              vec_g);
  };

  float acc[kDwETiles][DX][4];
#pragma unroll
  for (int et = 0; et < kDwETiles; ++et)
#pragma unroll
    for (int j = 0; j < DX; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[et][j][c] = 0.0f;

#pragma unroll
  for (int t = 0; t < kDwStages - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }
  const int ksteps = tile_rows / 8;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kDwStages - 2>();  // this thread's copies of tile t
    __syncthreads();                 // everyone's; slot t-1 is free
    if (t + kDwStages - 1 < tiles) load(t + kDwStages - 1);
    cp_async_commit();
    const float* xs = ring + (t % kDwStages) * slot_floats;
    const float* gs = xs + tile_rows * K;
    for (int ks = warp; ks < ksteps; ks += kDwWarps) {
      const int ra = ks * 8 + tig, rb = ra + 4;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(n_ok ? gs[ra * N + n] : 0.0f, bh0, bl0);
      split_tf32(n_ok ? gs[rb * N + n] : 0.0f, bh1, bl1);
#pragma unroll
      for (int et = 0; et < kDwETiles; ++et) {
        if (et < net) {
          const int e = e_first + et * 16 + gid;
          const bool lo_ok = e < K, hi_ok = e + 8 < K;
          float xv[4];
          xv[0] = lo_ok ? xs[ra * K + e] : 0.0f;
          xv[1] = hi_ok ? xs[ra * K + e + 8] : 0.0f;
          xv[2] = lo_ok ? xs[rb * K + e] : 0.0f;
          xv[3] = hi_ok ? xs[rb * K + e + 8] : 0.0f;
          float p[4] = {xv[0], xv[1], xv[2], xv[3]};
#pragma unroll
          for (int j = 0; j < DX; ++j) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(p[q], ah[q], al[q]);
            mma3_add(acc[et][j], ah, al, bh0, bh1, bl0, bl1);
            if (j + 1 < DX) {
#pragma unroll
              for (int q = 0; q < 4; ++q) p[q] *= xv[q];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // Each warp's fragments, [warp][et][j][lane] float4s; summed in warp
  // order, one thread an element.
  constexpr int kWarpFloats = kDwETiles * DX * 128;
  float4* mine = reinterpret_cast<float4*>(ring) + warp * (kWarpFloats / 4);
#pragma unroll
  for (int et = 0; et < kDwETiles; ++et)
#pragma unroll
    for (int j = 0; j < DX; ++j)
      mine[(et * DX + j) * 32 + lane] = make_float4(
          acc[et][j][0], acc[et][j][1], acc[et][j][2], acc[et][j][3]);
  __syncthreads();
  const long long kn = (long long)K * N;
  float* dst = partial + (long long)blockIdx.x * DX * kn;
  for (int idx = threadIdx.x; idx < net * DX * 128; idx += kDwThreads) {
    float sum = ring[idx];
    for (int w = 1; w < kDwWarps; ++w) sum += ring[w * kWarpFloats + idx];
    const int c = idx & 3, l = (idx >> 2) & 31, ej = idx >> 7;
    const int et = ej / DX, j = ej - et * DX;
    const int e = e_first + et * 16 + (l >> 2) + (c >= 2 ? 8 : 0);
    const int nn = nt * 8 + 2 * (l & 3) + (c & 1);
    if (e < K && nn < N) dst[j * kn + (long long)e * N + nn] = sum;
  }
}

// Pass two.  Block b sums pairs [b * kFinPairs, ...) of (e, n) over the
// partials: thread (slice, q) adds partials slice, slice + kFinSlices, ...
// of pair q; slice 0 then adds the slices in order and applies
// sum_i a_ij i |W|^(i-1).
template <int DX>
__global__ void __launch_bounds__(kFinPairs * kFinSlices)
p2m_bwd_dw_finalize_kernel(const float* __restrict__ partial,
                           const float* __restrict__ w,
                           float* __restrict__ out, int blocks, int K, int N,
                           Coeffs coeffs) {
  __shared__ float red[kFinSlices][DX][kFinPairs];
  const int q = threadIdx.x % kFinPairs;
  const int slice = threadIdx.x / kFinPairs;
  const long long kn = (long long)K * N;
  const long long pair = (long long)blockIdx.x * kFinPairs + q;

  float acc[DX];
#pragma unroll
  for (int j = 0; j < DX; ++j) acc[j] = 0.0f;
  if (pair < kn) {
    for (int p = slice; p < blocks; p += kFinSlices) {
      const float* src = partial + (long long)p * DX * kn + pair;
#pragma unroll
      for (int j = 0; j < DX; ++j) acc[j] += src[j * kn];
    }
  }
#pragma unroll
  for (int j = 0; j < DX; ++j) red[slice][j][q] = acc[j];
  __syncthreads();
  if (slice != 0 || pair >= kn) return;

  float t[DX];
#pragma unroll
  for (int j = 0; j < DX; ++j) t[j] = 0.0f;
  for (int v = 0; v < kFinSlices; ++v)
#pragma unroll
    for (int j = 0; j < DX; ++j) t[j] += red[v][j][q];

  const float aw = fabsf(w[pair]);
  float total = 0.0f;
  float wpow = 1.0f;  // |w|^(i-1)
#pragma unroll  // static indices into coeffs: no copy of it in local memory
  for (int i = 1; i <= kMaxDw; ++i) {
    if (i > coeffs.dw) break;
    float u = 0.0f;
#pragma unroll
    for (int j = 0; j < DX; ++j) {
      const float a = coeffs.a[i - 1][j];
      if (a != 0.0f) u += a * t[j];
    }
    total += (float)i * wpow * u;
    if (i < coeffs.dw) wpow *= aw;
  }
  out[pair] = total;
}

struct DwLaunch {
  dim3 grid1;
  size_t smem;
  unsigned grid2;
};

DwLaunch dw_launch(int dx, int K, int N, int blocks, int tile_rows) {
  DwLaunch l;
  l.grid1 = dim3((unsigned)blocks,
                 (unsigned)(dw_e_groups(K) * ((N + 7) / 8)));
  l.smem = dw_smem_bytes(dx, K, N, tile_rows);
  l.grid2 = (unsigned)(((long long)K * N + kFinPairs - 1) / kFinPairs);
  return l;
}

template <int DX>
cudaError_t allow_dw_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(p2m_bwd_dw_partial_kernel<DX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DX>
cudaError_t launch_dw(const float* x, const float* g, const float* w,
                      float* partial, float* out, long long M, int K, int N,
                      const Coeffs& coeffs, int blocks,
                      long long rows_per_block, int tile_rows,
                      cudaStream_t stream) {
  const DwLaunch l = dw_launch(DX, K, N, blocks, tile_rows);
  cudaError_t err = allow_dw_smem<DX>(l.smem);
  if (err != cudaSuccess) return err;
  p2m_bwd_dw_partial_kernel<DX><<<l.grid1, kDwThreads, l.smem, stream>>>(
      x, g, partial, M, K, N, rows_per_block, tile_rows, dw_e_groups(K));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p2m_bwd_dw_finalize_kernel<DX><<<l.grid2, kFinPairs * kFinSlices, 0,
                                   stream>>>(partial, w, out, blocks, K, N,
                                             coeffs);
  return cudaGetLastError();
}

// Pass one's and pass two's launch: grid, threads, dynamic shared memory,
// and what the card makes of each kernel (registers and local bytes a
// thread; blocks an SM).
template <int DX>
cudaError_t report_dw(int K, int N, int blocks, int tile_rows,
                      int* geometry) {
  const DwLaunch l = dw_launch(DX, K, N, blocks, tile_rows);
  cudaError_t err = allow_dw_smem<DX>(l.smem);
  cudaFuncAttributes a1{}, a2{};
  int per_sm1 = 0, per_sm2 = 0;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a1, p2m_bwd_dw_partial_kernel<DX>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm1, p2m_bwd_dw_partial_kernel<DX>, kDwThreads, l.smem);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a2, p2m_bwd_dw_finalize_kernel<DX>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm2, p2m_bwd_dw_finalize_kernel<DX>, kFinPairs * kFinSlices, 0);
  const int report[] = {(int)l.grid1.x,
                        (int)l.grid1.y,
                        kDwThreads,
                        (int)l.smem,
                        a1.numRegs,
                        (int)a1.localSizeBytes,
                        per_sm1,
                        (int)l.grid2,
                        kFinPairs * kFinSlices,
                        a2.numRegs,
                        (int)a2.localSizeBytes,
                        per_sm2};
  for (int i = 0; i < 12; ++i) geometry[i] = report[i];
  return err;
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

bool dw_split_ok(long long M, int blocks, long long rows_per_block,
                 int tile_rows) {
  return blocks >= 1 && tile_rows >= 8 && tile_rows <= 64 &&
         tile_rows % 8 == 0 && rows_per_block >= 1 &&
         rows_per_block % tile_rows == 0 &&
         (long long)blocks * rows_per_block >= M;
}

}  // namespace

// C entry points, loaded with ctypes.  All pointers but `coeffs` are device
// pointers of contiguous fp32 tensors.  They allocate nothing, launch on
// `stream` and do not synchronise.  Each returns the launch's cudaError_t.

// dX (M, K) of the raw basis sum from the masked cotangent g (M, N), the
// premixed weights wmix (dx, K, N) and the im2col matrix x (M, K).
extern "C" int p2m_bwd_dx(const float* g, const float* wmix, const float* x,
                          float* out, long long M, int K, int N, int dx,
                          void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dx) {
    case 1: return (int)launch_dx<1>(g, wmix, x, out, M, K, N, st);
    case 2: return (int)launch_dx<2>(g, wmix, x, out, M, K, N, st);
    case 3: return (int)launch_dx<3>(g, wmix, x, out, M, K, N, st);
    case kMaxDx: return (int)launch_dx<kMaxDx>(g, wmix, x, out, M, K, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dW (K, N) of the raw basis sum from x (M, K), g (M, N) and the clipped
// weights w (K, N).  `coeffs` is a host array of dw * dx floats, row i-1
// holding a_i1 .. a_idx.  `partial` is scratch of blocks * dx * K * N
// floats; pass one's block b reduces rows [b * rows_per_block, ...) in
// tiles of tile_rows (a multiple of 8 up to 64 that divides
// rows_per_block).
extern "C" int p2m_bwd_dw(const float* x, const float* g, const float* w,
                          float* partial, float* out, long long M, int K,
                          int N, int dx, int dw, const float* coeffs,
                          int blocks, long long rows_per_block,
                          int tile_rows, void* stream) {
  if (M < 1 || K < 1 || N < 1 || dw < 1 || dw > kMaxDw ||
      !dw_split_ok(M, blocks, rows_per_block, tile_rows)) {
    return (int)cudaErrorInvalidValue;
  }
  Coeffs c = {};
  c.dw = dw;
  for (int i = 0; i < dw; ++i)
    for (int j = 0; j < dx && j < kMaxDx; ++j) c.a[i][j] = coeffs[i * dx + j];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_dx(dx, [&](auto d) {
    return launch_dw<decltype(d)::value>(x, g, w, partial, out, M, K, N, c,
                                         blocks, rows_per_block, tile_rows,
                                         st);
  });
}

// The launch p2m_bwd_dw makes at these sizes, into geometry[12]: pass
// one's blocks in x and y, threads, dynamic shared memory, registers and
// local bytes a thread, blocks an SM; pass two's blocks, threads,
// registers, local bytes, blocks an SM.  Launches nothing.
extern "C" int p2m_bwd_dw_geometry(long long M, int K, int N, int dx,
                                   int blocks, long long rows_per_block,
                                   int tile_rows, int* geometry) {
  if (M < 1 || K < 1 || N < 1 ||
      !dw_split_ok(M, blocks, rows_per_block, tile_rows)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)with_dx(dx, [&](auto d) {
    return report_dw<decltype(d)::value>(K, N, blocks, tile_rows, geometry);
  });
}

// Largest pixel-model degree (in w and in x) the kernels are compiled for.
extern "C" int p2m_bwd_max_degree() { return kMaxDx; }

// Dynamic shared memory, in bytes, a launch of B3 and of B4's first pass
// asks for at these sizes; the wrapper refuses what the card cannot give.
extern "C" long long p2m_bwd_dx_smem(int dx, int K, int N) {
  return (long long)dx_smem_bytes(dx, K, N);
}
extern "C" long long p2m_bwd_dw_smem(int dx, int K, int N, int tile_rows) {
  return (long long)dw_smem_bytes(dx, K, N, tile_rows);
}
