// Fused embed + max-pool backward: kernel K4, the parameter gradients of K3.
//
// K3 (fused_embed.cu) computes, per row b and entity e of x [B, E, F],
//   pre = x[b, e] @ w1 + b1,  xh = LayerNorm(pre) (f32 statistics, eps 1e-6),
//   t = act(xh * g + be),     y = t @ w2 + b2,
// then pooled[b, j] = max_e y[e, j] with the winning entity argmax[b, j].
// Given the pooled cotangent dpool [B, 64], the cotangent of y is dpool[b, j]
// at (e = argmax[b, j], j) and zero elsewhere, so only the entities that win
// at least one of the 64 units carry a gradient: at most 64 of a row's E,
// often far fewer.  This kernel recomputes the activations of those winners
// only and accumulates
//   dw1 [F, 64], db1, dg (LN scale), dbe (LN bias) [64], dw2 [64, 64], db2 [64];
// d/dx is not computed (x is data).  Units whose argmax is outside [0, E)
// (padding rows carry -1) contribute nothing.
//
// What bounds it.  x is read only at the winners, so a row costs ~0.5 KB of
// argmax and dpool against ~16 KFLOP of dt and dw2 plus ~2.7 KFLOP per
// winner: fp32 operations bound it, at ~0.05 ms for a minibatch (35,328
// rows).  The kernel runs an order of magnitude above that: a winner's
// recompute is a chain of warp-shuffle reductions, tanhf and shared-memory
// loads (layer 1's w1, the units' dpool and w2 for dt), the gathers of x are
// scattered, and each tile passes its barriers.
//
// Design: tiles of many rows.  A block of 256 threads (8 warps) takes a
// fixed contiguous range of rows and walks it in tiles of R = 16 rows:
//  1. each warp finds the distinct winners of 2 rows (match.any within each
//     half of the 64 units, shuffles across the halves; argmax and dpool
//     loaded a tile ahead); a winner's rank is its order of first
//     appearance, and the units it won form a 64-bit mask;
//  2. the tile's winners (~170 for road rows) are numbered across its rows
//     by a prefix sum, and the warps take them round robin in chunks of up
//     to CAP: each warp first issues the cp.async gathers of all its
//     winners' x, then works on G winners at once (their shuffles and loads
//     interleaved): layer 1, LayerNorm statistics as warp sums,
//     dt[k] = sum over the winner's units j of dpool[j] * w2[k, j], and the
//     LayerNorm backward; dw1, db1, dg and dbe stay in the warp's registers,
//     t goes to shared memory;
//  3. all threads add dw2[k, j] += t[winner(j), k] * dpool[j] for their 16
//     entries of dw2, kept in registers.
// That is three block barriers per tile of 16 rows (one more per extra
// chunk), not three per row, and all 8 warps recompute at once.  The loops
// over features are unrolled for F <= 8 or F <= 16.  At the end the 8
// warps' registers are added in warp order.  Blocks: as many as fit on the
// card at once (2 per SM, set by the shared memory).
//
// Determinism.  The Pallas kernel adds into one output block and relies on
// the TPU grid running in order.  Here every block writes its own partial
// sums and a second kernel adds them, each output's partials in a fixed
// order (8 interleaved strands, then the strands in order).  No atomics:
// the gradients are the same bits on every run.
//
// The bf16 compute mode is K4-bf16, in fused_embed_bwd_bf16.cu.
//
// Source note: replaces _bwd_kernel / _fused_bwd of
// gpudrive_lab_tpu/networks/fused_embed.py (:112-172, :236-280) in
// compute dtype float32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (gpudrive_lab_torch/cuda_build.py).  C interface, launched on the caller's
// stream; fused_embed_pool_bwd returns cudaGetLastError() after its
// launches.

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;
constexpr int FMAX = 16;               // largest feature width F accepted
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 16;                  // rows per tile
constexpr int ROWS_PER_WARP = R / WARPS;
constexpr int CAP = 192;               // winners per chunk of a tile
constexpr int G = 2;                   // winners a warp works on at once
constexpr int TS = H + 1;              // padded rows of the winners' t
constexpr int KQ = H * H / THREADS;    // dw2 entries per thread (16)
constexpr int STRANDS = 8;             // partial sums per output in the sum
constexpr float LN_EPS = 1e-6f;        // flax.linen.LayerNorm default
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float w2t[H * H];                 // [j][k] = w2[k][j]
  float w1s[FMAX * H];              // [f][k], zero for f >= F
  float ts[CAP * TS];               // t of the chunk's winners; at the end
                                    // the cross-warp sums
  __align__(16) float xs[CAP][FMAX];  // x of the chunk's winners
  float dps[R][H];                  // dpool of (row, unit), 0 if no winner
  unsigned long long wmask[R][H];   // units won by the row's winner n
  int went[R][H];                   // entity of the row's winner n
  int cnt[R];                       // winners of each row
  int start[R];                     // winners of the tile's earlier rows
  signed char wrank[R][H];          // unit j's winner in its row, or -1
};

// sums over the warp of N values at once, their shuffles interleaved
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int u = 0; u < N; ++u) v[u] += __shfl_xor_sync(FULL, v[u], off);
  }
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
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

// Phase 1 for row r of the tile: its distinct winners, their ranks (order
// of first appearance among the 64 units), entities and unit masks.
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
  const int wr0 = e0 >= 0 ? ra : -1;
  const int wr1 = e1 >= 0 ? (lead1 < 32 ? rb0 : rb1) : -1;
  sm.dps[r][lane] = d0;
  sm.dps[r][lane + 32] = d1;
  sm.wrank[r][lane] = (signed char)wr0;
  sm.wrank[r][lane + 32] = (signed char)wr1;
  if (w0) sm.went[r][rank0] = e0;
  if (w1) sm.went[r][rank1] = e1;
  const int n = __popc(bal0) + __popc(bal1);
  for (int i = 0; i < n; ++i) {
    const unsigned lo = __ballot_sync(FULL, wr0 == i);
    const unsigned hi = __ballot_sync(FULL, wr1 == i);
    if (lane == 0) sm.wmask[r][i] = ((unsigned long long)hi << 32) | lo;
  }
  if (lane == 0) sm.cnt[r] = n;
}

// FT: 8 or 16, the feature widths the loops over f are unrolled for
template <int ACT, int FT>
__global__ void __launch_bounds__(THREADS, 2)
embed_pool_bwd_partial(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ g,
                       const float* __restrict__ be, const float* __restrict__ w2,
                       const int* __restrict__ amax,
                       const float* __restrict__ dpool,
                       float* __restrict__ partial, int B, int E, int F,
                       long long row_stride, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = lane;
  const int k1 = lane + 32;

  for (int i = tid; i < H * H; i += THREADS) {
    sm.w2t[(i % H) * H + i / H] = w2[i];
  }
  for (int i = tid; i < FMAX * H; i += THREADS) {
    sm.w1s[i] = i < F * H ? w1[i] : 0.0f;
  }
  const float b1a = b1[k0], b1b = b1[k1];
  const float ga = g[k0], gb = g[k1];
  const float bea = be[k0], beb = be[k1];
  float dw1a[FT], dw1b[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) {
    dw1a[f] = 0.0f;
    dw1b[f] = 0.0f;
  }
  float db1a = 0.0f, db1b = 0.0f, dga = 0.0f, dgb = 0.0f;
  float dbea = 0.0f, dbeb = 0.0f;

  // this thread's dw2 entries: unit jo, hidden k = kq * KQ + q
  const int jo = tid % H;
  const int kq = tid / H;
  float dw2acc[KQ];
#pragma unroll
  for (int q = 0; q < KQ; ++q) dw2acc[q] = 0.0f;
  float db2acc = 0.0f;

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

    // the tile's winners are numbered row by row: row r holds [excl, incl)
    const int c = lane < R ? sm.cnt[lane] : 0;
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    const int excl = incl - c;
    const int total = __shfl_sync(FULL, incl, 31);
    if (warp == 0 && lane < R) sm.start[lane] = excl;

    for (int c0 = 0; c0 < total; c0 += CAP) {
      const int c1 = min(total, c0 + CAP);
      // 2a. issue the gathers of x for all of this warp's winners
      for (int n = c0 + warp; n < c1; n += WARPS) {
        const int r = __popc(__ballot_sync(FULL, lane < R && incl <= n));
        const int e = sm.went[r][n - __shfl_sync(FULL, excl, r)];
        if (lane < F) {
          const float* src =
              x + (size_t)(base + r) * row_stride + (size_t)e * F + lane;
          cp_async4(&sm.xs[n - c0][lane], src);
        }
      }
      cp_async_wait_all();
      __syncwarp();

      // 2b. recompute and backward of the warp's winners, G at a time so
      // that their shuffle and load latencies overlap; a missing last one
      // repeats the first and adds nothing
      for (int n0 = c0 + warp; n0 < c1; n0 += G * WARPS) {
        bool ok[G];
        int r[G], slot[G];
        unsigned long long mask[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const int n = n0 + u * WARPS;
          ok[u] = n < c1;
          slot[u] = (ok[u] ? n : n0) - c0;
          r[u] = __popc(__ballot_sync(FULL, lane < R && incl <= slot[u] + c0));
          mask[u] = sm.wmask[r[u]][slot[u] + c0 - __shfl_sync(FULL, excl, r[u])];
        }
        float pa[G], pb[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          pa[u] = 0.0f;
          pb[u] = 0.0f;
        }
#pragma unroll
        for (int f4 = 0; f4 < FT; f4 += 4) {
          float4 xv[G];  // 4 features of each winner, one broadcast load
#pragma unroll
          for (int u = 0; u < G; ++u) {
            xv[u] = *reinterpret_cast<const float4*>(&sm.xs[slot[u]][f4]);
          }
#pragma unroll
          for (int f = f4; f < f4 + 4; ++f) {
            if (f < F) {
              const float wa = sm.w1s[f * H + k0], wb = sm.w1s[f * H + k1];
#pragma unroll
              for (int u = 0; u < G; ++u) {
                const float xf = component(xv[u], f - f4);
                pa[u] += xf * wa;
                pb[u] += xf * wb;
              }
            }
          }
        }
        float s1[G], s2[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          pa[u] += b1a;
          pb[u] += b1b;
          s1[u] = pa[u] + pb[u];
        }
        warp_sums<G>(s1);
        float d0[G], d1[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const float mu = s1[u] / (float)H;
          d0[u] = pa[u] - mu;
          d1[u] = pb[u] - mu;
          s2[u] = d0[u] * d0[u] + d1[u] * d1[u];
        }
        warp_sums<G>(s2);
        float rstd[G], xh0[G], xh1[G], dl0[G], dl1[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          rstd[u] = rsqrtf(s2[u] / (float)H + LN_EPS);
          xh0[u] = d0[u] * rstd[u];
          xh1[u] = d1[u] * rstd[u];
          const float lin0 = xh0[u] * ga + bea, lin1 = xh1[u] * gb + beb;
          const float t0 = activation<ACT>(lin0), t1 = activation<ACT>(lin1);
          if (ok[u]) {  // the dw2 product's operand
            sm.ts[slot[u] * TS + k0] = t0;
            sm.ts[slot[u] * TS + k1] = t1;
          }
          // dt[k] = sum over the units j this entity wins of
          // dpool[j] * w2[k, j]
          float dt0 = 0.0f, dt1 = 0.0f;
          for (unsigned long long m = mask[u]; m; m &= m - 1) {
            const int j = __ffsll((long long)m) - 1;
            const float d = sm.dps[r[u]][j];
            dt0 += d * sm.w2t[j * H + k0];
            dt1 += d * sm.w2t[j * H + k1];
          }
          dl0[u] = dt0 * activation_grad<ACT>(lin0, t0);
          dl1[u] = dt1 * activation_grad<ACT>(lin1, t1);
          s1[u] = dl0[u] * ga + dl1[u] * gb;
          s2[u] = dl0[u] * ga * xh0[u] + dl1[u] * gb * xh1[u];
        }
        warp_sums<G>(s1);
        warp_sums<G>(s2);
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if (!ok[u]) continue;
          dga += dl0[u] * xh0[u];
          dgb += dl1[u] * xh1[u];
          dbea += dl0[u];
          dbeb += dl1[u];
          const float m1 = s1[u] / (float)H, m2 = s2[u] / (float)H;
          const float dp0 = (dl0[u] * ga - m1 - xh0[u] * m2) * rstd[u];
          const float dp1 = (dl1[u] * gb - m1 - xh1[u] * m2) * rstd[u];
          db1a += dp0;
          db1b += dp1;
#pragma unroll
          for (int f4 = 0; f4 < FT; f4 += 4) {
            const float4 xv =
                *reinterpret_cast<const float4*>(&sm.xs[slot[u]][f4]);
#pragma unroll
            for (int f = f4; f < f4 + 4; ++f) {
              if (f < F) {
                const float xf = component(xv, f - f4);
                dw1a[f] += xf * dp0;
                dw1b[f] += xf * dp1;
              }
            }
          }
        }
      }
      __syncthreads();

      // 3. dw2 and db2 of the units whose winner is in this chunk
      for (int r = 0; r < R; ++r) {
        const int wr = sm.wrank[r][jo];
        if (wr < 0) continue;
        const int s = sm.start[r] + wr - c0;
        if (s < 0 || s >= c1 - c0) continue;
        const float d = sm.dps[r][jo];
        const float* tr = sm.ts + s * TS + kq * KQ;
#pragma unroll
        for (int q = 0; q < KQ; ++q) dw2acc[q] += tr[q] * d;
        if (kq == 0) db2acc += d;
      }
      __syncthreads();  // ts, xs and the tile's tables are rewritten next
    }
    if (total == 0) __syncthreads();  // cnt is rewritten by the next tile
  }

  // add the warps' dw1, db1, dg, dbe in warp order
  float* red = sm.ts;
  for (int i = tid; i < FMAX * H + 3 * H; i += THREADS) red[i] = 0.0f;
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        if (f < F) {
          red[f * H + k0] += dw1a[f];
          red[f * H + k1] += dw1b[f];
        }
      }
      red[FMAX * H + k0] += db1a;
      red[FMAX * H + k1] += db1b;
      red[FMAX * H + H + k0] += dga;
      red[FMAX * H + H + k1] += dgb;
      red[FMAX * H + 2 * H + k0] += dbea;
      red[FMAX * H + 2 * H + k1] += dbeb;
    }
    __syncthreads();
  }

  float* out = partial + (size_t)blockIdx.x * n_out(F);
  for (int i = tid; i < F * H; i += THREADS) out[i] = red[i];
  for (int i = tid; i < 3 * H; i += THREADS) out[F * H + i] = red[FMAX * H + i];
  float* dw2o = out + F * H + 3 * H;
#pragma unroll
  for (int q = 0; q < KQ; ++q) dw2o[(kq * KQ + q) * H + jo] = dw2acc[q];
  if (kq == 0) dw2o[H * H + jo] = db2acc;
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
template <int ACT, int FT>
int blocks_per_sm() {
  static int nb = -1;
  if (nb < 0) {
    auto kern = embed_pool_bwd_partial<ACT, FT>;
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

// the fewest of the four instances (both activations, both FT)
int min_blocks_per_sm() {
  const int n[4] = {blocks_per_sm<0, 8>(), blocks_per_sm<1, 8>(),
                    blocks_per_sm<0, 16>(), blocks_per_sm<1, 16>()};
  int m = n[0];
  for (int i = 1; i < 4; ++i) m = n[i] < m ? n[i] : m;
  return m;
}

int max_blocks(int B) {
  int dev = 0, sms = 0;
  const int nb = min_blocks_per_sm();
  if (B < 1 || nb < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  const int tiles = (B + R - 1) / R;
  return nb * sms < tiles ? nb * sms : tiles;
}

int run(const float* x, const float* w1, const float* b1, const float* g,
        const float* be, const float* w2, const int* amax,
        const float* dpool, float* partial, float* out, int B, int E, int F,
        long long row_stride, int max_blocks, int act, void* stream) {
  if (F < 1 || F > FMAX || E < 1 || B < 1 || max_blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (min_blocks_per_sm() < 1) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorLaunchFailure;
  }
  const int rows = (B + max_blocks - 1) / max_blocks;
  const int nblocks = (B + rows - 1) / rows;
  const cudaStream_t s = (cudaStream_t)stream;
  auto kern = act == 0 ? (F <= 8 ? embed_pool_bwd_partial<0, 8>
                                 : embed_pool_bwd_partial<0, 16>)
                       : (F <= 8 ? embed_pool_bwd_partial<1, 8>
                                 : embed_pool_bwd_partial<1, 16>);
  kern<<<nblocks, THREADS, sizeof(Smem), s>>>(
      x, w1, b1, g, be, w2, amax, dpool, partial, B, E, F, row_stride, rows);
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
extern "C" int fused_embed_pool_bwd_blocks(int B) { return max_blocks(B); }

// float32: x float32, every product in float32
extern "C" int fused_embed_pool_bwd(const float* x, const float* w1,
                                    const float* b1, const float* g,
                                    const float* be, const float* w2,
                                    const int* amax, const float* dpool,
                                    float* partial, float* out, int B, int E,
                                    int F, long long row_stride,
                                    int max_blocks, int act, void* stream) {
  return run(x, w1, b1, g, be, w2, amax, dpool, partial, out, B, E, F,
             row_stride, max_blocks, act, stream);
}
