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
// at which the fp32 rate outside the tensor cores would set the limit.  So
// the design keeps the copies in flight and spends few instructions a byte.
//
// Launch geometry, one rule from (B, H, D): one block a (b, h), grid B*H;
// one warp for each 16 value columns e of the state, ceil(D / 16) warps
// (128 threads at D = 64); a ring of kStages chunk tiles in dynamic
// shared memory; a register budget of kBlocksPerSm blocks an SM, so the
// 320 blocks of the serving shape are resident at once on 132 SMs.  The
// TPU kernel walks the chunks as the inner, sequential grid axis and
// carries the state in VMEM; here the block loops over the chunks itself,
// and each warp keeps its 16 columns of the state in registers for the
// whole sequence: they touch device memory once in, once out.
//
// Per chunk, two barriers:
//  1. The ring: chunk c+1's r, k, v, lw tiles are copied with cp.async
//     while chunk c computes (16-byte copies where every input is
//     16-byte aligned and D % 4 == 0, else 4-byte copies; decided in the
//     kernel, so an unaligned view gives the same bits).  Positions past S
//     are zero-filled (lw = 0, r = k = v = 0), which the reference's
//     padding makes exact; channels past D stay zero.
//  2. Decays, in place: each warp owns 16 channels, a thread one token and
//     8 of them; the cumulative log decay is a shuffle scan over the 16
//     tokens, each element takes three expf (q = r e^{L_{t-1}},
//     qd = r e^{L_{t-1}-L_C}, kd = k e^{L_C-L_t}), stored once as TF32
//     high parts and remainders; e^{L_C} once a channel; the bonus r . u k
//     as the warp's partial sums.
//  3. Scores: each warp multiplies qd by kd^T over its own 16 channels on
//     the tensor cores (no block barrier: the warp wrote those channels);
//     A = the sum of the warps' 16 x 16 parts, strictly causal, with the
//     bonus on its diagonal.
//  4. Products on the tensor cores, mma.sync m16n8k8 in 3xTF32 (each
//     operand split into a TF32 high part and a TF32 remainder; hi*hi +
//     hi*lo + lo*hi in three fp32 accumulators): a warp computes its
//     columns as
//        y^T  = S^T q^T + v^T A^T                 (16 x 16 a warp)
//        S^T <- e^{L_C} S^T + v^T kd              (16 x D a warp)
//     The state's accumulator fragment serves as the A operand of the next
//     chunk's S^T q^T with the d axis permuted inside each 8-wide step
//     (d = 2*tig, 2*tig+1), the same permutation applied to q; so the state
//     never leaves the registers.  Plain TF32 keeps ~3 digits; 3xTF32 keeps
//     ~2^-22 of each product, inside the 1e-4 of the largest |plain| the
//     kernel is held to.
//
// Numerics: fp32 accumulation, IEEE expf (build without --use_fast_math);
// chunk 16 keeps |dL| <= 80 < 88.  The new state is
// fmaf(e^{L_C}, S, sum kd v) in fp32 outside the tensor cores: on a row
// whose chunk has lw = 0 and k = 0 (a masked prefix) that is
// fmaf(1, S, 0) = S, so the state comes back bit for bit, subnormals
// included.  No atomics: two launches on the same inputs agree bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;
constexpr int kMaxD = 64;
// Row strides: 72 = 8 (mod 32) and 20 put the 4 x 8 (row, column) reads of
// an mma fragment, and the float2 reads of q, on 32 distinct banks.
constexpr int kLd = kMaxD + 8;       // the chunk tiles
constexpr int kLdA = kChunk + 4;     // the score matrices
constexpr int kStages = 2;           // ring depth: chunk c+1 lands as c runs
constexpr int kBlocksPerSm = 3;      // the register budget: 168 at D > 48
constexpr unsigned kFull = 0xffffffffu;

// One ring slot: a chunk's tiles, [t][d] with row stride kLd.  The decay
// phase overwrites r, k and lw with the TF32 high parts (as bits) of qd,
// kd and q.
struct Stage {
  float r[kChunk * kLd];
  float k[kChunk * kLd];
  float v[kChunk * kLd];
  float lw[kChunk * kLd];
};

// One chunk's working set beside the ring.
struct Work {
  uint32_t q_lo[kChunk * kLd];   // TF32 remainders of q, qd and kd
  uint32_t qd_lo[kChunk * kLd];
  uint32_t kd_lo[kChunk * kLd];
  // Each warp's scores over its 16 channels, [t][s]: qd_t . kd_s for
  // s < t, its part of the bonus r_t . u k_t at s == t, 0 above.
  float part[kMaxD / 16][kChunk * kLdA];
  float elc[kMaxD];              // e^{L_C} of each channel
  float u[kMaxD];                // u[h]
};

constexpr size_t kSmemBytes = kStages * sizeof(Stage) + sizeof(Work);

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32 (the remainder rounded once more).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Split four values and store their high parts at hi, their remainders
// at lo (16-byte aligned).
__device__ __forceinline__ void store_split4(float* hi, uint32_t* lo,
                                             const float (&x)[4]) {
  uint4 h, l;
  split_tf32(x[0], h.x, l.x);
  split_tf32(x[1], h.y, l.y);
  split_tf32(x[2], h.z, l.z);
  split_tf32(x[3], h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

__device__ __forceinline__ uint32_t bits(const float* p) {
  return __float_as_uint(*p);
}

// c += a * b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: hh += a_hi b_hi, hl += a_hi b_lo, lh += a_lo b_hi (lo*lo
// dropped); three accumulators keep the three chains apart.
__device__ __forceinline__ void mma3(float (&hh)[4], float (&hl)[4],
                                     float (&lh)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(hh, ah, bh0, bh1);
  mma_tf32(hl, ah, bl0, bl1);
  mma_tf32(lh, al, bh0, bh1);
}

template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps, kBlocksPerSm)
wkv_chunked_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   float* __restrict__ y, float* __restrict__ s_out, int S,
                   int H, int D) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kDp = 16 * kWarps;  // channels, padded to the warps' slices
  constexpr int kDTiles = kDp / 8;  // 8-wide steps over d
  extern __shared__ float4 smem4[];
  Stage* stages = reinterpret_cast<Stage*>(smem4);
  Work& wk = *reinterpret_cast<Work*>(stages + kStages);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const long long tok_stride = (long long)H * D;
  const long long base = (long long)b * S * tok_stride + (long long)h * D;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  if (D != kDp) {  // channels past D stay zero: no copy writes them
    constexpr int kZero4 = (int)(kSmemBytes / 16);
    for (int i = tid; i < kZero4; i += kThreads)
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

  // The copies: 16 bytes where every input is 16-byte aligned and D % 4
  // == 0, else 4 bytes.  A thread's copies walk the (token, unit) grid of
  // a tile with a fixed step, the same in every chunk.
  const bool vec16 = (D & 3) == 0 && aligned16(r) && aligned16(k) &&
                     aligned16(v) && aligned16(lw);
  const int width = vec16 ? 4 : 1;
  const int units = D / width;  // copies a token row
  const int step_t = kThreads / units, step_u = kThreads - step_t * units;
  const int first_t = tid / units, first_u = tid - first_t * units;
  auto fetch = [&](int c) {
    Stage& sg = stages[c % kStages];
    const int t0 = c * kChunk;
    int t = first_t, un = first_u;
    while (t < kChunk) {
      const bool in = t0 + t < S;
      const long long g =
          in ? base + (long long)(t0 + t) * tok_stride + un * width : 0;
      const int o = t * kLd + un * width;
      if (vec16) {
        cp_async16(sg.r + o, r + g, in);
        cp_async16(sg.k + o, k + g, in);
        cp_async16(sg.v + o, v + g, in);
        cp_async16(sg.lw + o, lw + g, in);
      } else {
        cp_async4(sg.r + o, r + g, in);
        cp_async4(sg.k + o, k + g, in);
        cp_async4(sg.v + o, v + g, in);
        cp_async4(sg.lw + o, lw + g, in);
      }
      t += step_t;
      un += step_u;
      if (un >= units) un -= units, ++t;
    }
  };
  for (int i = tid; i < D; i += kThreads)  // u[h] lands with chunk 0
    cp_async4(wk.u + i, u + (long long)h * D + i, true);
  if (n_chunks > 0) fetch(0);  // fill the ring
  cp_async_commit();

  // This warp's 16 columns of the state, as S^T (rows e, columns d) in the
  // accumulator layout of m16n8: st[j] covers d in [8j, 8j + 8), element q
  // at e = e0 + 8 (q >> 1), d = 8j + 2 tig + (q & 1).
  const int e0 = 16 * warp + gid;
  const float* s0b = s0 + (long long)bh * D * D;
  float st[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + 8 * (q >> 1), d = 8 * j + 2 * tig + (q & 1);
      st[j][q] = (e < D && d < D) ? s0b[(long long)d * D + e] : 0.f;
    }
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // this thread's copies of chunk c landed
    __syncthreads();     // everyone's; chunk c - 1 is consumed
    if (c + 1 < n_chunks) fetch(c + 1);
    cp_async_commit();
    Stage& sg = stages[c % kStages];
    const int t0 = c * kChunk;

    // Decays: token t, channels d0..d0+7 a thread, four at a time; each
    // warp owns the 16 channels 16 warp + [0, 16).
    {
      const int t = lane & 15, d0 = 16 * warp + 8 * (lane >> 4);
      float dg = 0.f, my_lc = 0.f;
#pragma unroll 1
      for (int m = 0; m < 2; ++m) {
        const int o = t * kLd + d0 + 4 * m;
        const float4 r4 = *reinterpret_cast<const float4*>(sg.r + o);
        const float4 k4 = *reinterpret_cast<const float4*>(sg.k + o);
        const float4 l4 = *reinterpret_cast<const float4*>(sg.lw + o);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
        float L[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int off = 1; off < kChunk; off <<= 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float o2 = __shfl_up_sync(kFull, L[j], off, kChunk);
            if (t >= off) L[j] += o2;
          }
        }
        float q[4], qd[4], kd[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float LC = __shfl_sync(kFull, L[j], kChunk - 1, kChunk);
          if (t == 4 * m + j) my_lc = LC;  // L_C of channel d0 + t
          const float Lp = L[j] - lv[j];   // L_{t-1}, formed as the reference
          q[j] = rv[j] * expf(Lp);
          qd[j] = rv[j] * expf(Lp - LC);
          kd[j] = kv[j] * expf(LC - L[j]);
          dg = fmaf(rv[j] * wk.u[d0 + 4 * m + j], kv[j], dg);
        }
        store_split4(sg.lw + o, wk.q_lo + o, q);
        store_split4(sg.r + o, wk.qd_lo + o, qd);
        store_split4(sg.k + o, wk.kd_lo + o, kd);
      }
      if (t < 8) wk.elc[d0 + t] = expf(my_lc);  // once a channel
      dg += __shfl_xor_sync(kFull, dg, 16);
      __syncwarp();

      // Scores over this warp's channels: qd (rows t) times kd^T (columns
      // s), two 8-wide steps over d, two 8-wide tiles of s.
      float ph[2][4] = {}, pl[2][4] = {}, pm[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int dc = 16 * warp + 8 * kk + tig;
        uint32_t ah[4], al[4];
        ah[0] = bits(sg.r + gid * kLd + dc);
        al[0] = wk.qd_lo[gid * kLd + dc];
        ah[1] = bits(sg.r + (gid + 8) * kLd + dc);
        al[1] = wk.qd_lo[(gid + 8) * kLd + dc];
        ah[2] = bits(sg.r + gid * kLd + dc + 4);
        al[2] = wk.qd_lo[gid * kLd + dc + 4];
        ah[3] = bits(sg.r + (gid + 8) * kLd + dc + 4);
        al[3] = wk.qd_lo[(gid + 8) * kLd + dc + 4];
#pragma unroll
        for (int js = 0; js < 2; ++js) {
          const int so = (8 * js + gid) * kLd + dc;
          mma3(ph[js], pl[js], pm[js], ah, al, bits(sg.k + so),
               bits(sg.k + so + 4), wk.kd_lo[so], wk.kd_lo[so + 4]);
        }
      }
      float* part = wk.part[warp];
#pragma unroll
      for (int js = 0; js < 2; ++js) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tt = gid + 8 * (q >> 1), ss = 8 * js + 2 * tig + (q & 1);
          part[tt * kLdA + ss] =
              ss < tt ? ph[js][q] + (pl[js][q] + pm[js][q]) : 0.f;
        }
      }
      __syncwarp();
      if (lane < kChunk) part[t * kLdA + t] = dg;
    }
    __syncthreads();

    // This warp's columns: v^T as the A operand (rows e, k = s).
    uint32_t vh[2][4], vl[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* vp = sg.v + (8 * kk + tig) * kLd + e0;
      split_tf32(vp[0], vh[kk][0], vl[kk][0]);
      split_tf32(vp[8], vh[kk][1], vl[kk][1]);
      split_tf32(vp[4 * kLd], vh[kk][2], vl[kk][2]);
      split_tf32(vp[4 * kLd + 8], vh[kk][3], vl[kk][3]);
    }
    // y^T (rows e, columns t), n-tile j covers t in [8j, 8j + 8).
    float yh[2][4] = {}, yl[2][4] = {}, ym[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kDTiles; ++kk) {  // S^T q^T, d permuted in a step
      uint32_t ah[4], al[4];
      split_tf32(st[kk][0], ah[0], al[0]);
      split_tf32(st[kk][2], ah[1], al[1]);
      split_tf32(st[kk][1], ah[2], al[2]);
      split_tf32(st[kk][3], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qo = (8 * j + gid) * kLd + 8 * kk + 2 * tig;
        const uint2 qh = *reinterpret_cast<const uint2*>(sg.lw + qo);
        const uint2 ql = *reinterpret_cast<const uint2*>(wk.q_lo + qo);
        mma3(yh[j], yl[j], ym[j], ah, al, qh.x, qh.y, ql.x, ql.y);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // v^T A^T: the causal part and the bonus
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ao = (8 * j + gid) * kLdA + 8 * kk + tig;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          a0 += wk.part[w][ao];
          a1 += wk.part[w][ao + 4];
        }
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(a0, bh0, bl0);
        split_tf32(a1, bh1, bl1);
        mma3(yh[j], yl[j], ym[j], vh[kk], vl[kk], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = e0 + 8 * (q >> 1), t = 8 * j + 2 * tig + (q & 1);
        if (e < D && t0 + t < S)
          y[base + (long long)(t0 + t) * tok_stride + e] =
              yh[j][q] + (yl[j][q] + ym[j][q]);
      }
    }
    // S^T <- e^{L_C} S^T + v^T kd, n-tile jn covers d in [8jn, 8jn + 8).
#pragma unroll
    for (int jn = 0; jn < kDTiles; ++jn) {
      float sh[4] = {}, sl[4] = {}, sm[4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ko = (8 * kk + tig) * kLd + 8 * jn + gid;
        mma3(sh, sl, sm, vh[kk], vl[kk], bits(sg.k + ko),
             bits(sg.k + ko + 4 * kLd), wk.kd_lo[ko], wk.kd_lo[ko + 4 * kLd]);
      }
      const float2 el =
          *reinterpret_cast<const float2*>(wk.elc + 8 * jn + 2 * tig);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        st[jn][q] =
            fmaf((q & 1) ? el.y : el.x, st[jn][q], sh[q] + (sl[q] + sm[q]));
    }
  }

  cp_async_wait<0>();  // no copy may land after the block has ended
  float* sob = s_out + (long long)bh * D * D;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + 8 * (q >> 1), d = 8 * j + 2 * tig + (q & 1);
      if (e < D && d < D) sob[(long long)d * D + e] = st[j][q];
    }
  }
}

struct Args {
  const float *r, *k, *v, *lw, *u, *s0;
  float *y, *s_out;
  int B, S, H, D;
};

template <int kWarps>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_chunked_kernel<kWarps>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
  }
  wkv_chunked_kernel<kWarps>
      <<<(unsigned)(a.B * a.H), 32 * kWarps, kSmemBytes, stream>>>(
          a.r, a.k, a.v, a.lw, a.u, a.s0, a.y, a.s_out, a.S, a.H, a.D);
  return cudaGetLastError();
}

}  // namespace

// One launch over all (b, h), with ceil(D / 16) warps a block; returns the
// cudaError of the launch.  D in 1..wkv_max_head_dim().
extern "C" int wkv_chunked_forward(const float* r, const float* k,
                                   const float* v, const float* lw,
                                   const float* u, const float* s0, float* y,
                                   float* s_out, int B, int S, int H, int D,
                                   void* stream) {
  if (B < 1 || H < 1 || S < 0 || D < 1 || D > kMaxD ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, lw, u, s0, y, s_out, B, S, H, D};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return (int)launch<1>(a, st);
    case 2: return (int)launch<2>(a, st);
    case 3: return (int)launch<3>(a, st);
    default: return (int)launch<4>(a, st);
  }
}

// The launch wkv_chunked_forward makes for (B, H, D): geometry[0..3] =
// blocks, threads a block, dynamic shared memory in bytes, ring depth.
extern "C" void wkv_launch_geometry(int B, int H, int D, int* geometry) {
  geometry[0] = B * H;
  geometry[1] = 32 * ((D + 15) / 16);
  geometry[2] = (int)kSmemBytes;
  geometry[3] = kStages;
}

extern "C" int wkv_max_head_dim() { return kMaxD; }

extern "C" int wkv_chunk() { return kChunk; }
