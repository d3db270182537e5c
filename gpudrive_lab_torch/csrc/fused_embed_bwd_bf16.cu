// Fused embed + max-pool backward in the bf16 compute mode: kernel
// K4-bf16, the parameter gradients of K3-bf16, on the tensor cores.
//
// K3-bf16 (fused_embed_bf16.cu) computes, per row b and entity e,
//   pre = bf16(x) @ bf16(w1) + b1, xh = LayerNorm(pre), t = act(xh*g + be),
//   y = bf16(t) @ bf16(w2) + b2,
// then pooled[b, j] = max_e y[e, j] with the winner argmax[b, j].  The
// cotangent of y is dpool[b, j] at (argmax[b, j], j), so only the entities
// that win a unit carry a gradient.  As the JAX package's bf16 kernel does
// (fused_embed.py:136-172), the operands of every product are rounded to
// bf16 and the products summed in f32: x and w1 (layer 1 again), dpool and
// w2 (the cotangent of t), t and dpool (dw2), x and dpre (dw1).  db1, dg,
// dbe and db2 are f32 sums of unrounded values.  The float32 mode is K4 in
// fused_embed_bwd.cu.
//
// What bounds it.  x is read only at the winners, so the bytes are mostly
// the argmax and dpool (512 bytes a row); the products are ~16 KFLOP a row
// of bf16 work.  Bytes bound it: ~0.015 ms for the policy's two blocks at
// 35,328 rows.
//
// Design: the winners as dense matrices.  A block of 8 warps walks a fixed
// range of rows in tiles of R = 16.
//  1. Each warp finds the distinct winners of 2 rows (match.any, shuffles;
//     argmax and dpool loaded a tile ahead), as K4 does: their ranks in
//     order of first appearance, their entities, and for every unit the rank
//     of its winner.  db2 adds the tile's dpool.
//  2. The tile's winners, numbered across its rows, go in chunks of up to
//     CAP = 128.  Each is mapped to (row, rank, entity) and its x is gathered
//     by cp.async as the 4-byte words that hold it (bf16 x sits at any
//     2-byte offset), so both dtypes are gathered asynchronously.
//  3. Warp w takes winners 16w .. 16w + 15 of the chunk as the rows of an
//     m16 tile, on mma.sync.m16n8k16 bf16 with f32 accumulators:
//       pre = Xw @ w1 + b1         (A: the winners' x, rounded to bf16)
//       LayerNorm, act and act' in f32 registers (quad shuffles, tanhf)
//       dT  = dY @ w2^T            (dY [16, 64]: dpool[row, j] where the
//                                   winner won unit j, else 0, in bf16)
//       dlin = dT * act', the LayerNorm backward -> dpre, in f32;
//     dg, dbe and db1 are summed over the tile's winners by shuffles into
//     the warp's own f32 sums in shared memory.  bf16(t), dY and bf16(dpre)
//     go to shared memory transposed ([unit][winner], by movmatrix), and
//     x's bf16 values as [feature][winner].
//  4. After a barrier, the chunk's two weight products, with the winners as
//     the k dimension: dw2 += bf16(t)^T @ dY, warp w owning rows
//     16 (w / 2) .. + 15 and columns 32 (w % 2) .. + 31; dw1 += Xw^T @
//     bf16(dpre), warp w owning units 8w .. 8w + 7.  Their accumulators stay
//     in registers for the whole block, each entry in one lane.
// mma.sync and not wgmma: a chunk's winners come 16 to a warp, a count the
// data sets (about 13 a road row, fewer in the partner block), and a warp
// works on its own tile with no warpgroup in step; the products are a
// small share of the time, so the tensor cores' rate does not matter here.
// Padding rows of a warp's tile (past the chunk's winners) have x = 0 and
// dY = 0, so every product and sum they enter gets exact zeros.
//
// Determinism.  Every block writes its own partial sums and a second
// kernel adds them, each output's partials in a fixed order (8 interleaved
// strands, then the strands in order).  No atomics: the same inputs give
// the same bits on every run.  The tensor cores' f32 sums are not a
// sequence of IEEE adds; the plain version is matched at the bars of
// fused_embed.BF16_PRODUCT_BAR (dw1, dw2) and 1e-4 (the f32 sums).
//
// Source note: replaces _bwd_kernel / _fused_bwd of
// gpudrive_lab_tpu/networks/fused_embed.py (:112-172, :236-280) in compute
// dtype bfloat16.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (gpudrive_lab_torch/cuda_build.py).  C interface, launched on the caller's
// stream; fused_embed_pool_bwd_bf16 returns cudaGetLastError() after its
// launches.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int H = 64;
constexpr int FMAX = 16;               // largest feature width F accepted
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 16;                  // rows per tile
constexpr int ROWS_PER_WARP = R / WARPS;
constexpr int CAP = 128;               // winners per chunk: 16 a warp
constexpr int CS = CAP + 8;            // padded row of the [..][winner] tables
constexpr int W1S = 24;                // padded row of w1^T [unit][feature]
constexpr int W2S = H + 8;             // padded row of w2 [hidden][unit]
constexpr int STRANDS = 8;             // partial sums per output in the sum
constexpr float LN_EPS = 1e-6f;        // flax.linen.LayerNorm default
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  uint16_t w1t[H * W1S];           // bf16 w1^T [unit][feature], 0 for f >= F
  uint16_t w2s[H * W2S];           // bf16 w2 [hidden][unit]
  float prm[3][H];                 // b1, g, be
  float dps[R][H];                 // dpool of (row, unit), 0 if no winner
  int went[R][H];                  // entity of the row's winner n
  int cnt[R];                      // winners of each row
  int start[R];                    // winners of the tile's earlier rows
  signed char wrank[R][H];         // unit j's winner in its row, or -1
  signed char wrow[CAP];           // row in the tile of the chunk's winner
  signed char wrk[CAP];            // its rank in the row
  unsigned char whead[CAP];        // byte offset of its x in its words
  __align__(16) uint32_t xraw[CAP][FMAX];  // the winners' x, as gathered
  __align__(16) uint16_t xwt[FMAX * CS];   // bf16 x [feature][winner]
  __align__(16) uint16_t tst[H * CS];      // bf16 t [hidden][winner]
  __align__(16) uint16_t dyt[H * CS];      // bf16 dY [unit][winner]
  __align__(16) uint16_t dpt[H * CS];      // bf16 dpre [unit][winner]
  float acc[WARPS][3][H];          // each warp's db1, dg, dbe
};

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the 8 x 8 b16 matrix whose row lane / 4 holds columns 2 (lane % 4) + {0, 1}
// in v, transposed across the warp
__device__ __forceinline__ uint32_t transpose8(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(r) : "r"(v));
  return r;
}

// d += a @ b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st32(uint16_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int ACT>
__device__ __forceinline__ float activation(float v) {
  if (ACT == 0) return tanhf(v);
  const float c = 0.7978845608028654f;
  return v * (0.5f * (1.0f + tanhf(c * (v + 0.044715f * (v * v * v)))));
}

// d act / d lin at lin, given t = act(lin)
template <int ACT>
__device__ __forceinline__ float activation_grad(float lin, float t) {
  if (ACT == 0) return 1.0f - t * t;
  const float c = 0.7978845608028654f;
  const float a = 0.044715f;
  const float th = tanhf(c * (lin + a * lin * lin * lin));
  return 0.5f * (1.0f + th)
         + 0.5f * lin * (1.0f - th * th) * c * (1.0f + 3.0f * a * lin * lin);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// the sum over the 8 lanes g = 0..7 that share lane % 4
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 8);
  v += __shfl_xor_sync(FULL, v, 16);
  return v;
}

// Output layout, one flat float array of n_out = F*64 + 64*64 + 4*64:
//   dw1 [F][64] | db1 [64] | dg [64] | dbe [64] | dw2 [64][64] | db2 [64]
__host__ __device__ __forceinline__ int n_out(int F) { return F * H + H * H + 4 * H; }

// argmax and dpool of units (lane, lane + 32) of a row; -1 past the range
struct RowIn {
  int a0, a1;
  float d0, d1;
};

__device__ __forceinline__ RowIn load_row(const int* __restrict__ amax,
                                          const float* __restrict__ dpool,
                                          int row, bool live, int lane) {
  RowIn v{-1, -1, 0.0f, 0.0f};
  if (live) {
    v.a0 = amax[(size_t)row * H + lane];
    v.a1 = amax[(size_t)row * H + lane + 32];
    v.d0 = dpool[(size_t)row * H + lane];
    v.d1 = dpool[(size_t)row * H + lane + 32];
  }
  return v;
}

// Step 1 for row r of the tile: its distinct winners, their ranks (order of
// first appearance among the 64 units) and entities, each unit's winner
// rank and dpool (0 where it has no winner).
__device__ __forceinline__ void find_winners(Smem& sm, int r, RowIn in,
                                             int E, int lane) {
  const bool ok0 = in.a0 >= 0 && in.a0 < E, ok1 = in.a1 >= 0 && in.a1 < E;
  const int e0 = ok0 ? in.a0 : -1, e1 = ok1 ? in.a1 : -1;
  const float d0 = ok0 ? in.d0 : 0.0f, d1 = ok1 ? in.d1 : 0.0f;
  // first unit with the same winner: within a half by match.any, for the
  // upper half also the first lower-half unit holding it
  const unsigned m0 = __match_any_sync(FULL, e0);
  const unsigned m1 = __match_any_sync(FULL, e1);
  int cross = -1;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int v = __shfl_sync(FULL, e0, i);
    if (cross < 0 && v == e1) cross = i;
  }
  const int lead0 = __ffs(m0) - 1;
  const int lead1 = cross >= 0 ? cross : 32 + __ffs(m1) - 1;
  const bool w0 = e0 >= 0 && lead0 == lane;
  const bool w1 = e1 >= 0 && lead1 == lane + 32;
  const unsigned bal0 = __ballot_sync(FULL, w0);
  const unsigned bal1 = __ballot_sync(FULL, w1);
  const unsigned below = (1u << lane) - 1u;
  const int rank0 = __popc(bal0 & below);
  const int rank1 = __popc(bal0) + __popc(bal1 & below);
  const int ra = __shfl_sync(FULL, rank0, lead0 & 31);
  const int rb0 = __shfl_sync(FULL, rank0, lead1 & 31);
  const int rb1 = __shfl_sync(FULL, rank1, lead1 & 31);
  sm.dps[r][lane] = d0;
  sm.dps[r][lane + 32] = d1;
  sm.wrank[r][lane] = (signed char)(e0 >= 0 ? ra : -1);
  sm.wrank[r][lane + 32] =
      (signed char)(e1 >= 0 ? (lead1 < 32 ? rb0 : rb1) : -1);
  if (w0) sm.went[r][rank0] = e0;
  if (w1) sm.went[r][rank1] = e1;
  if (lane == 0) sm.cnt[r] = __popc(bal0) + __popc(bal1);
}

// Step 2 for the chunk's winner n = c0 + i (one thread each): its row,
// rank and entity, and the cp.async of the 4-byte words holding its x.
template <typename XT>
__device__ __forceinline__ void gather(Smem& sm, const XT* __restrict__ x,
                                       int base, int i, int c0, int c1,
                                       int F, long long row_stride) {
  if (c0 + i >= c1) {
    sm.wrow[i] = -1;
    return;
  }
  const int n = c0 + i;
  int r = 0;  // the row whose range holds n
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (sm.start[k] <= n && n < sm.start[k] + sm.cnt[k]) r = k;
  }
  const int rank = n - sm.start[r];
  const int e = sm.went[r][rank];
  const uintptr_t a = reinterpret_cast<uintptr_t>(
      x + (size_t)(base + r) * row_stride + (size_t)e * F);
  const uintptr_t a4 = a & ~(uintptr_t)3;
  const int head = (int)(a - a4);
  const int words = (head + F * (int)sizeof(XT) + 3) / 4;
  for (int w = 0; w < words; ++w) {
    cp_async4(&sm.xraw[i][w], reinterpret_cast<const void*>(a4 + 4 * w));
  }
  sm.wrow[i] = (signed char)r;
  sm.wrk[i] = (signed char)rank;
  sm.whead[i] = (unsigned char)head;
}

// feature f of the chunk's winner i as bf16 bits, 0 past F or past the
// chunk's winners
template <typename XT>
__device__ __forceinline__ uint32_t x_bits(const Smem& sm, int i, int f,
                                           int F) {
  if (f >= F || sm.wrow[i] < 0) return 0u;
  const unsigned char* p =
      reinterpret_cast<const unsigned char*>(sm.xraw[i]) + sm.whead[i] +
      f * (int)sizeof(XT);
  if constexpr (sizeof(XT) == 4) {
    return bf16_bits(*reinterpret_cast<const float*>(p));
  } else {
    return *reinterpret_cast<const uint16_t*>(p);
  }
}

// the cotangent dY[i][j] of the chunk's winner i at unit j, as bf16 bits
__device__ __forceinline__ uint32_t dy_bits(const Smem& sm, int r, int rank,
                                            int j) {
  return r >= 0 && sm.wrank[r][j] == rank ? bf16_bits(sm.dps[r][j]) : 0u;
}

// Step 3: the m16 tile of the chunk's winners n0 .. n0 + 15, this warp's.
template <int ACT, typename XT>
__device__ __forceinline__ void winners_tile(Smem& sm, int n0, int F,
                                             int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  // layer 1: A = the winners' x; x^T to shared memory for dw1
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + g + (i & 1) * 8;
    const int f = 2 * q + (i >> 1) * 8;
    const uint32_t lo = x_bits<XT>(sm, n, f, F);
    const uint32_t hi = x_bits<XT>(sm, n, f + 1, F);
    a[i] = lo | (hi << 16);
    sm.xwt[f * CS + n] = (uint16_t)lo;
    sm.xwt[(f + 1) * CS + n] = (uint16_t)hi;
  }
  float p[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float b0 = sm.prm[0][nt * 8 + 2 * q];
    const float b1 = sm.prm[0][nt * 8 + 2 * q + 1];
    p[nt][0] = b0; p[nt][1] = b1; p[nt][2] = b0; p[nt][3] = b1;
    const uint16_t* w = sm.w1t + (nt * 8 + g) * W1S + 2 * q;
    mma(p[nt], a, ld32(w), ld32(w + 8));
  }

  // LayerNorm of rows g (c0, c1) and g + 8 (c2, c3), the activation and
  // its derivative; bf16(t) to shared memory as [hidden][winner]
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s0 += p[nt][0] + p[nt][1];
    s1 += p[nt][2] + p[nt][3];
  }
  const float mu0 = quad_sum(s0) / (float)H, mu1 = quad_sum(s1) / (float)H;
  float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    p[nt][0] -= mu0; p[nt][1] -= mu0; p[nt][2] -= mu1; p[nt][3] -= mu1;
    v0 += p[nt][0] * p[nt][0] + p[nt][1] * p[nt][1];
    v1 += p[nt][2] * p[nt][2] + p[nt][3] * p[nt][3];
  }
  const float rstd[2] = {rsqrtf(quad_sum(v0) / (float)H + LN_EPS),
                         rsqrtf(quad_sum(v1) / (float)H + LN_EPS)};
  float ag[8][4];  // act' at lin; p becomes xh
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = nt * 8 + 2 * q + (i & 1);
      p[nt][i] *= rstd[i >> 1];
      const float lin = p[nt][i] * sm.prm[1][k] + sm.prm[2][k];
      t[i] = activation<ACT>(lin);
      ag[nt][i] = activation_grad<ACT>(lin, t[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st32(sm.tst + (nt * 8 + g) * CS + n0 + 8 * h + 2 * q,
           transpose8(pack(t[2 * h], t[2 * h + 1])));
    }
  }

  // the cotangent dY [16, 64] as A fragments (units as k), dY^T to shared
  // memory; dT = dY @ w2^T
  const int r0 = sm.wrow[n0 + g], r1 = sm.wrow[n0 + g + 8];
  const int k0 = sm.wrk[n0 + g], k1 = sm.wrk[n0 + g + 8];
  float dt[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dt[nt][i] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t d[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = kk * 16 + 2 * q + (i >> 1) * 8;
      const int r = i & 1 ? r1 : r0, rk = i & 1 ? k1 : k0;
      d[i] = dy_bits(sm, r, rk, j) | (dy_bits(sm, r, rk, j + 1) << 16);
      st32(sm.dyt + (kk * 16 + (i >> 1) * 8 + g) * CS + n0 + (i & 1) * 8 +
               2 * q,
           transpose8(d[i]));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint16_t* w = sm.w2s + (nt * 8 + g) * W2S + kk * 16 + 2 * q;
      mma(dt[nt], d, ld32(w), ld32(w + 8));
    }
  }

  // dlin = dT * act'; dg and dbe summed over the tile's winners
  float* acc = &sm.acc[warp][0][0];
  float e0 = 0.0f, e1 = 0.0f, f0 = 0.0f, f1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float dg[2], dbe[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float gk = sm.prm[1][nt * 8 + 2 * q + c];
      dt[nt][c] *= ag[nt][c];
      dt[nt][2 + c] *= ag[nt][2 + c];
      dg[c] = column_sum(dt[nt][c] * p[nt][c] + dt[nt][2 + c] * p[nt][2 + c]);
      dbe[c] = column_sum(dt[nt][c] + dt[nt][2 + c]);
      // the LayerNorm backward's row sums of dxh = dlin * g and dxh * xh
      const float x0 = dt[nt][c] * gk, x1 = dt[nt][2 + c] * gk;
      e0 += x0;
      e1 += x1;
      f0 += x0 * p[nt][c];
      f1 += x1 * p[nt][2 + c];
    }
    if (g == 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        acc[1 * H + nt * 8 + 2 * q + c] += dg[c];
        acc[2 * H + nt * 8 + 2 * q + c] += dbe[c];
      }
    }
  }
  const float m1[2] = {quad_sum(e0) / (float)H, quad_sum(e1) / (float)H};
  const float m2[2] = {quad_sum(f0) / (float)H, quad_sum(f1) / (float)H};

  // dpre; db1 summed over the tile's winners, bf16(dpre)^T to shared memory
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float dp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float gk = sm.prm[1][nt * 8 + 2 * q + (i & 1)];
      const int h = i >> 1;
      dp[i] = (dt[nt][i] * gk - m1[h] - p[nt][i] * m2[h]) * rstd[h];
    }
    const float db0 = column_sum(dp[0] + dp[2]);
    const float db1 = column_sum(dp[1] + dp[3]);
    if (g == 0) {
      acc[nt * 8 + 2 * q] += db0;
      acc[nt * 8 + 2 * q + 1] += db1;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st32(sm.dpt + (nt * 8 + g) * CS + n0 + 8 * h + 2 * q,
           transpose8(pack(dp[2 * h], dp[2 * h + 1])));
    }
  }
}

// Step 4: the chunk's weight products over its winners 0 .. kn - 1 (kn a
// multiple of 16): dw2 rows 16 (warp / 2) .., columns 32 (warp % 2) ..;
// dw1 units 8 warp ...
__device__ __forceinline__ void weight_products(const Smem& sm, int kn,
                                                int warp, int lane,
                                                float (&dw2)[4][4],
                                                float (&dw1)[4]) {
  const int g = lane >> 2, q = lane & 3;
  const int hm = warp >> 1, un = warp & 1;
  for (int k0 = 0; k0 < kn; k0 += 16) {
    const int c = k0 + 2 * q;
    uint32_t a[4];
    const uint16_t* ta = sm.tst + (16 * hm + g) * CS + c;
    a[0] = ld32(ta);
    a[1] = ld32(ta + 8 * CS);
    a[2] = ld32(ta + 8);
    a[3] = ld32(ta + 8 * CS + 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint16_t* b = sm.dyt + (32 * un + 8 * nt + g) * CS + c;
      mma(dw2[nt], a, ld32(b), ld32(b + 8));
    }
    const uint16_t* xa = sm.xwt + g * CS + c;
    a[0] = ld32(xa);
    a[1] = ld32(xa + 8 * CS);
    a[2] = ld32(xa + 8);
    a[3] = ld32(xa + 8 * CS + 8);
    const uint16_t* b = sm.dpt + (8 * warp + g) * CS + c;
    mma(dw1, a, ld32(b), ld32(b + 8));
  }
}

// XT: x's stored type (float or __nv_bfloat16)
template <int ACT, typename XT>
__global__ void __launch_bounds__(THREADS, 2)
embed_pool_bwd_bf16_partial(const XT* __restrict__ x,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const float* __restrict__ g,
                            const float* __restrict__ be,
                            const float* __restrict__ w2,
                            const int* __restrict__ amax,
                            const float* __restrict__ dpool,
                            float* __restrict__ partial, int B, int E, int F,
                            long long row_stride, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < H * W1S; i += THREADS) {
    const int n = i / W1S, f = i % W1S;
    sm.w1t[i] = bf16_bits(f < F ? w1[f * H + n] : 0.0f);
  }
  for (int i = tid; i < H * H; i += THREADS) {
    sm.w2s[(i / H) * W2S + i % H] = bf16_bits(w2[i]);
  }
  for (int i = tid; i < H; i += THREADS) {
    sm.prm[0][i] = b1[i];
    sm.prm[1][i] = g[i];
    sm.prm[2][i] = be[i];
  }
  for (int i = tid; i < WARPS * 3 * H; i += THREADS) {
    (&sm.acc[0][0][0])[i] = 0.0f;
  }
  float dw2[4][4], dw1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dw1[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dw2[i][j] = 0.0f;
  }
  float db2 = 0.0f;  // unit tid, for tid < 64

  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(B, row0 + rows_per_block);
  __syncthreads();

  // each warp's rows of the next tile are loaded a tile ahead
  RowIn next[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int row = row0 + warp * ROWS_PER_WARP + i;
    next[i] = load_row(amax, dpool, row, row < row1, lane);
  }

  for (int base = row0; base < row1; base += R) {
    // 1. each warp finds the winners of its rows
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const RowIn cur = next[i];
      const int row = base + R + warp * ROWS_PER_WARP + i;
      next[i] = load_row(amax, dpool, row, row < row1, lane);
      find_winners(sm, warp * ROWS_PER_WARP + i, cur, E, lane);
    }
    __syncthreads();
    if (tid < H) {
#pragma unroll
      for (int r = 0; r < R; ++r) db2 += sm.dps[r][tid];
    }
    // the tile's winners are numbered row by row: row r holds
    // [start[r], start[r] + cnt[r])
    const int c = lane < R ? sm.cnt[lane] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    if (warp == 0 && lane < R) sm.start[lane] = incl - c;
    __syncthreads();

    for (int c0 = 0; c0 < total; c0 += CAP) {
      const int c1 = min(total, c0 + CAP);
      // 2. map and gather the chunk's winners
      if (tid < CAP) {
        gather(sm, x, base, tid, c0, c1, F, row_stride);
      }
      cp_async_wait_all();
      __syncthreads();
      // 3. the warps' tiles of 16 winners
      const int kn = (c1 - c0 + 15) / 16 * 16;
      if (16 * warp < kn) winners_tile<ACT, XT>(sm, 16 * warp, F, warp, lane);
      __syncthreads();
      // 4. the weight products over the chunk
      weight_products(sm, kn, warp, lane, dw2, dw1);
      __syncthreads();  // the chunk's tables are rewritten next
    }
  }

  // add the warps' db1, dg, dbe in warp order
  float* out = partial + (size_t)blockIdx.x * n_out(F);
  for (int i = tid; i < 3 * H; i += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += (&sm.acc[w][0][0])[i];
    out[F * H + i] = s;
  }
  const int gg = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = gg + (i >> 1) * 8;
    if (f < F) out[f * H + 8 * warp + 2 * q + (i & 1)] = dw1[i];
  }
  float* dw2o = out + F * H + 3 * H;
  const int hm = warp >> 1, un = warp & 1;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 16 * hm + gg + (i >> 1) * 8;
      const int j = 32 * un + 8 * nt + 2 * q + (i & 1);
      dw2o[k * H + j] = dw2[nt][i];
    }
  }
  if (tid < H) dw2o[H * H + tid] = db2;
}

// out[i] = sum over blocks of partial[b, i], in a fixed order: strand s adds
// blocks s, s + STRANDS, ... in turn, then the strands are added in order.
// A block of 32 x STRANDS threads covers 32 consecutive outputs.
__global__ void __launch_bounds__(32 * STRANDS)
sum_partials(const float* __restrict__ partial, float* __restrict__ out,
             int nblocks, int n) {
  __shared__ float s[STRANDS][32];
  const int lane = threadIdx.x & 31;
  const int strand = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (i < n) {
    for (int b = strand; b < nblocks; b += STRANDS) {
      acc += partial[(size_t)b * n + i];
    }
  }
  s[strand][lane] = acc;
  __syncthreads();
  if (strand == 0 && i < n) {
    float t = s[0][lane];
    for (int k = 1; k < STRANDS; ++k) t += s[k][lane];
    out[i] = t;
  }
}

// Blocks of one kernel instance that fit on an SM, with its shared-memory
// opt-in, once.
template <int ACT, typename XT>
int blocks_per_sm() {
  static int nb = -1;
  if (nb < 0) {
    auto kern = embed_pool_bwd_bf16_partial<ACT, XT>;
    int n = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS,
                                                      sizeof(Smem)) !=
            cudaSuccess) {
      return 0;
    }
    nb = n;
  }
  return nb;
}

// the fewer of one x dtype's two instances (both activations)
template <typename XT>
int min_blocks_per_sm() {
  const int a = blocks_per_sm<0, XT>(), b = blocks_per_sm<1, XT>();
  return a < b ? a : b;
}

template <typename XT>
int max_blocks(int B) {
  int dev = 0, sms = 0;
  const int nb = min_blocks_per_sm<XT>();
  if (B < 1 || nb < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  const int tiles = (B + R - 1) / R;
  return nb * sms < tiles ? nb * sms : tiles;
}

template <typename XT>
int run(const XT* x, const float* w1, const float* b1, const float* g,
        const float* be, const float* w2, const int* amax,
        const float* dpool, float* partial, float* out, int B, int E, int F,
        long long row_stride, int max_blocks, int act, void* stream) {
  if (F < 1 || F > FMAX || E < 1 || B < 1 || max_blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (min_blocks_per_sm<XT>() < 1) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorLaunchFailure;
  }
  // whole tiles of R rows per block
  const int rows = (B + max_blocks - 1) / max_blocks;
  const int per = (rows + R - 1) / R * R;
  const int nblocks = (B + per - 1) / per;
  const cudaStream_t s = (cudaStream_t)stream;
  auto kern = act == 0 ? embed_pool_bwd_bf16_partial<0, XT>
                       : embed_pool_bwd_bf16_partial<1, XT>;
  kern<<<nblocks, THREADS, sizeof(Smem), s>>>(
      x, w1, b1, g, be, w2, amax, dpool, partial, B, E, F, row_stride, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = n_out(F);
  sum_partials<<<(n + 31) / 32, 32 * STRANDS, 0, s>>>(partial, out, nblocks, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Upper bound on the partial blocks the backward uses for B rows: as many
// as run on the card at once, and no more than one per R rows.  The caller
// sizes the partial buffer [max_blocks, n_out] with it.  0 on an error.
extern "C" int fused_embed_pool_bwd_blocks_bf16(int B, int x_bf16) {
  return x_bf16 ? max_blocks<__nv_bfloat16>(B) : max_blocks<float>(B);
}

// x float32 (x_bf16 = 0) or bf16 (x_bf16 = 1), the products' operands
// rounded to bf16; parameters and gradients float32
extern "C" int fused_embed_pool_bwd_bf16(const void* x, const float* w1,
                                         const float* b1, const float* g,
                                         const float* be, const float* w2,
                                         const int* amax, const float* dpool,
                                         float* partial, float* out, int B,
                                         int E, int F, long long row_stride,
                                         int max_blocks, int x_bf16, int act,
                                         void* stream) {
  if (x_bf16) {
    return run(static_cast<const __nv_bfloat16*>(x), w1, b1, g, be, w2, amax,
               dpool, partial, out, B, E, F, row_stride, max_blocks, act,
               stream);
  }
  return run(static_cast<const float*>(x), w1, b1, g, be, w2, amax, dpool,
             partial, out, B, E, F, row_stride, max_blocks, act, stream);
}
