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
// B4 design: split-M.  Pass one: each block reduces a contiguous chunk of
// rows into its own partial T (dx, K, N), forming x^j in registers; rows
// come through shared memory in tiles of 32 (coalesced loads), a thread
// owns one (e, block of 8 n) pair for all j (24 accumulators at dx = 3) and
// every lanes-th row of the tile, and the lanes are summed in lane order
// at the end.  Pass two: one block per 32 (e, n) pairs sums the partials
// over the blocks of pass one in a fixed order (32 warps, each a fixed
// stride of blocks, then warp order) and applies sum_i a_ij i |W|^(i-1).
// No atomics: the gradient is the same from run to run.
//
// Built without --use_fast_math; the coefficients are fp32, as the
// reference multiplies them into fp32 sums.

#include <cuda_runtime.h>

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

constexpr int kDwChunk = 8;      // n outputs a thread owns (two float4)
constexpr int kDwTileRows = 32;  // rows staged per step
constexpr int kFinWarps = 32;    // warps of the second pass

struct Coeffs {
  float a[kMaxDw][kMaxDx];  // a[i-1][j-1] multiplies w^i x^j
  int dw;
};

struct DwGeometry {
  int n_chunks;     // ceil(N / 8)
  int items;        // K * n_chunks (e, n-chunk) pairs
  int group;        // pairs one block handles: min(items, kThreads)
  int lanes;        // threads per pair: kThreads / group
  size_t smem;      // bytes of dynamic shared memory of pass one
};

DwGeometry dw_geometry(int dx, int K, int N) {
  DwGeometry geo;
  geo.n_chunks = (N + kDwChunk - 1) / kDwChunk;
  geo.items = K * geo.n_chunks;
  geo.group = geo.items < kThreads ? geo.items : kThreads;
  geo.lanes = kThreads / geo.group;
  const size_t tile = (size_t)kDwTileRows * (K + geo.n_chunks * kDwChunk);
  const size_t red = (size_t)(geo.lanes - 1) * geo.group * dx * kDwChunk;
  geo.smem = sizeof(float) * (tile > red ? tile : red);
  return geo;
}

template <int DX>
__global__ void __launch_bounds__(kThreads)
p2m_bwd_dw_partial_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          float* __restrict__ partial, long long M, int K,
                          int N, long long rows_per_block, int n_chunks,
                          int items, int group, int lanes) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kDwTileRows][K]
  const int np = n_chunks * kDwChunk;
  float* gs = xs + kDwTileRows * K;             // [kDwTileRows][np]

  const int it = threadIdx.x % group;
  const int lane = threadIdx.x / group;
  const int item = blockIdx.y * group + it;
  const bool active = lane < lanes && item < items;
  const int e = item % K;
  const int nc = item / K;

  float acc[DX][kDwChunk];
#pragma unroll
  for (int j = 0; j < DX; ++j)
#pragma unroll
    for (int c = 0; c < kDwChunk; ++c) acc[j][c] = 0.0f;

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(M, r0 + rows_per_block);
  for (long long t0 = r0; t0 < r1; t0 += kDwTileRows) {
    const int rows = (int)min((long long)kDwTileRows, r1 - t0);
    const float* xt = x + t0 * K;
    for (int idx = threadIdx.x; idx < rows * K; idx += blockDim.x)
      xs[idx] = xt[idx];
    for (int idx = threadIdx.x; idx < kDwTileRows * np; idx += blockDim.x) {
      const int ml = idx / np;
      const int n = idx - ml * np;
      gs[idx] = (ml < rows && n < N) ? g[(t0 + ml) * N + n] : 0.0f;
    }
    __syncthreads();
    if (active) {
      for (int ml = lane; ml < rows; ml += lanes) {
        const float xv = xs[ml * K + e];
        const float4* gv =
            reinterpret_cast<const float4*>(gs + ml * np + nc * kDwChunk);
        const float4 g0 = gv[0];
        const float4 g1 = gv[1];
        float xpow = xv;  // x^j, formed as x, x*x, (x*x)*x like the reference
#pragma unroll
        for (int j = 0; j < DX; ++j) {
          acc[j][0] = fmaf(xpow, g0.x, acc[j][0]);
          acc[j][1] = fmaf(xpow, g0.y, acc[j][1]);
          acc[j][2] = fmaf(xpow, g0.z, acc[j][2]);
          acc[j][3] = fmaf(xpow, g0.w, acc[j][3]);
          acc[j][4] = fmaf(xpow, g1.x, acc[j][4]);
          acc[j][5] = fmaf(xpow, g1.y, acc[j][5]);
          acc[j][6] = fmaf(xpow, g1.z, acc[j][6]);
          acc[j][7] = fmaf(xpow, g1.w, acc[j][7]);
          xpow *= xv;
        }
      }
    }
    __syncthreads();
  }

  // Sum the lanes of each pair in lane order; the tile buffers are free.
  float* red = xs;  // [lanes - 1][group][DX][kDwChunk]
  const int per = DX * kDwChunk;
  if (active && lane > 0) {
    float* dst = red + ((long long)(lane - 1) * group + it) * per;
#pragma unroll
    for (int j = 0; j < DX; ++j)
#pragma unroll
      for (int c = 0; c < kDwChunk; ++c) dst[j * kDwChunk + c] = acc[j][c];
  }
  __syncthreads();
  if (active && lane == 0) {
    for (int l = 1; l < lanes; ++l) {
      const float* src = red + ((long long)(l - 1) * group + it) * per;
#pragma unroll
      for (int j = 0; j < DX; ++j)
#pragma unroll
        for (int c = 0; c < kDwChunk; ++c) acc[j][c] += src[j * kDwChunk + c];
    }
    const long long kn = (long long)K * N;
    float* dst = partial + (long long)blockIdx.x * DX * kn;
#pragma unroll
    for (int j = 0; j < DX; ++j)
#pragma unroll
      for (int c = 0; c < kDwChunk; ++c) {
        const int n = nc * kDwChunk + c;
        if (n < N) dst[j * kn + (long long)e * N + n] = acc[j][c];
      }
  }
}

template <int DX>
__global__ void __launch_bounds__(kFinWarps * 32)
p2m_bwd_dw_finalize_kernel(const float* __restrict__ partial,
                           const float* __restrict__ w,
                           float* __restrict__ out, int blocks, int K, int N,
                           Coeffs coeffs) {
  __shared__ float red[kFinWarps][DX][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long kn = (long long)K * N;
  const long long pair = (long long)blockIdx.x * 32 + lane;

  float acc[DX];
#pragma unroll
  for (int j = 0; j < DX; ++j) acc[j] = 0.0f;
  if (pair < kn) {
    for (int p = warp; p < blocks; p += kFinWarps) {
      const float* src = partial + (long long)p * DX * kn + pair;
#pragma unroll
      for (int j = 0; j < DX; ++j) acc[j] += src[j * kn];
    }
  }
#pragma unroll
  for (int j = 0; j < DX; ++j) red[warp][j][lane] = acc[j];
  __syncthreads();
  if (warp != 0 || pair >= kn) return;

  float t[DX];
#pragma unroll
  for (int j = 0; j < DX; ++j) t[j] = 0.0f;
  for (int v = 0; v < kFinWarps; ++v)
#pragma unroll
    for (int j = 0; j < DX; ++j) t[j] += red[v][j][lane];

  const float aw = fabsf(w[pair]);
  float total = 0.0f;
  float wpow = 1.0f;  // |w|^(i-1)
  for (int i = 1; i <= coeffs.dw; ++i) {
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

template <int DX>
cudaError_t launch_dw(const float* x, const float* g, const float* w,
                      float* partial, float* out, long long M, int K, int N,
                      const Coeffs& coeffs, int blocks,
                      long long rows_per_block, cudaStream_t stream) {
  const DwGeometry geo = dw_geometry(DX, K, N);
  if (geo.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        p2m_bwd_dw_partial_kernel<DX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
    if (err != cudaSuccess) return err;
  }
  // Pairs beyond one block's group go to further blocks along y; each of
  // them writes its own pairs of the same partial slice.
  const dim3 grid1((unsigned)blocks,
                   (unsigned)((geo.items + geo.group - 1) / geo.group));
  p2m_bwd_dw_partial_kernel<DX><<<grid1, kThreads, geo.smem, stream>>>(
      x, g, partial, M, K, N, rows_per_block, geo.n_chunks, geo.items,
      geo.group, geo.lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned grid2 = (unsigned)(((long long)K * N + 31) / 32);
  p2m_bwd_dw_finalize_kernel<DX><<<grid2, kFinWarps * 32, 0, stream>>>(
      partial, w, out, blocks, K, N, coeffs);
  return cudaGetLastError();
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
// floats; pass one's block b reduces rows [b * rows_per_block, ...).
extern "C" int p2m_bwd_dw(const float* x, const float* g, const float* w,
                          float* partial, float* out, long long M, int K,
                          int N, int dx, int dw, const float* coeffs,
                          int blocks, long long rows_per_block,
                          void* stream) {
  if (M < 1 || K < 1 || N < 1 || dw < 1 || dw > kMaxDw || blocks < 1 ||
      rows_per_block < 1 || (long long)blocks * rows_per_block < M) {
    return (int)cudaErrorInvalidValue;
  }
  Coeffs c = {};
  c.dw = dw;
  for (int i = 0; i < dw; ++i)
    for (int j = 0; j < dx && j < kMaxDx; ++j) c.a[i][j] = coeffs[i * dx + j];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dx) {
    case 1: return (int)launch_dw<1>(x, g, w, partial, out, M, K, N, c,
                                     blocks, rows_per_block, st);
    case 2: return (int)launch_dw<2>(x, g, w, partial, out, M, K, N, c,
                                     blocks, rows_per_block, st);
    case 3: return (int)launch_dw<3>(x, g, w, partial, out, M, K, N, c,
                                     blocks, rows_per_block, st);
    case kMaxDx: return (int)launch_dw<kMaxDx>(x, g, w, partial, out, M, K,
                                               N, c, blocks, rows_per_block,
                                               st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Largest pixel-model degree (in w and in x) the kernels are compiled for.
extern "C" int p2m_bwd_max_degree() { return kMaxDx; }

// Dynamic shared memory, in bytes, a launch of B3 and of B4's first pass
// asks for at these sizes; the wrapper refuses what the card cannot give.
extern "C" long long p2m_bwd_dx_smem(int dx, int K, int N) {
  return (long long)dx_smem_bytes(dx, K, N);
}
extern "C" long long p2m_bwd_dw_smem(int dx, int K, int N) {
  return (long long)dw_geometry(dx, K, N).smem;
}
