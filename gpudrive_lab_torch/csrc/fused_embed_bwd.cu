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
// Determinism.  The Pallas kernel adds into one output block and relies on
// the TPU grid running in order.  Here blocks run in parallel, so each block
// takes a fixed contiguous range of rows, walks it in order and writes its
// own partial sums; a second kernel adds the partials of all blocks in block
// order.  No atomics: the gradients are the same from run to run.
//
// Layout of the work: a block of 256 threads (8 warps) takes one row at a
// time.  Threads 0..63 load the row's argmax and dpool and find, for each
// unit, the first unit with the same winner (its "leader").  Each warp then
// recomputes the winners of the leader units u = warp, warp + 8, ...: one
// lane per two hidden units k (lane, lane + 32), layer 1 from registers, the
// LayerNorm statistics as warp-shuffle sums, dt[k] = sum over the units j
// won by the entity of dpool[j] * w2[k, j] from a transposed copy of w2 in
// shared memory, then the LayerNorm backward; dw1, db1, dg and dbe stay in
// the warp's registers.  The winners' activations t go to shared memory, and
// all 256 threads then add dw2[k, j] += t[winner(j), k] * dpool[j] for their
// 16 entries of dw2.  At the end the 8 warps' registers are added in warp
// order through shared memory.  Accumulation is float32 throughout.
//
// Source note: replaces _bwd_kernel / _fused_bwd of
// gpudrive_lab_tpu/networks/fused_embed.py (:112-172, :236-280).  Bound on the
// H100: x is read only at the winners, so a row costs ~0.5 KB of argmax and
// dpool against ~65 KFLOP (the cotangent of t and dw2 over all 64 units, and
// the winners' recompute); fp32 operations bound it, not bytes.  The kernel
// is latency-bound well above that: each row passes three block barriers and
// a warp recomputes its winners one after another.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (gpudrive_lab_torch/cuda_build.py).  C interface, launched on the caller's
// stream; the entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;
constexpr int FMAX = 16;           // largest feature width F accepted
constexpr int THREADS = 256;       // one row at a time per block
constexpr int WARPS = THREADS / 32;
constexpr int TS_STRIDE = H + 1;   // padded rows of the winners' t
constexpr int KQ = H * H / THREADS;  // dw2 entries per thread (16)
constexpr float LN_EPS = 1e-6f;    // flax.linen.LayerNorm default

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
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

template <int ACT>
__global__ void __launch_bounds__(THREADS)
embed_pool_bwd_partial(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ g,
                       const float* __restrict__ be, const float* __restrict__ w2,
                       const int* __restrict__ amax,
                       const float* __restrict__ dpool,
                       float* __restrict__ partial, int B, int E, int F,
                       long long row_stride, int rows_per_block) {
  __shared__ float w2t[H * H];          // [j][k] = w2[k][j]
  __shared__ float ts[H * TS_STRIDE];   // t of the winner led by unit u, row u
  __shared__ float red[FMAX * H + 3 * H];  // cross-warp sums at the end
  __shared__ float dps[H];              // dpool of unit j (0 if no winner)
  __shared__ int win[H];                // winner of unit j, or -1
  __shared__ int lead[H];               // first unit with the same winner

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = lane;
  const int k1 = lane + 32;

  for (int i = tid; i < H * H; i += THREADS) {
    w2t[(i % H) * H + i / H] = w2[i];
  }

  float w1a[FMAX], w1b[FMAX], dw1a[FMAX], dw1b[FMAX];
#pragma unroll
  for (int f = 0; f < FMAX; ++f) {
    w1a[f] = f < F ? w1[f * H + k0] : 0.0f;
    w1b[f] = f < F ? w1[f * H + k1] : 0.0f;
    dw1a[f] = 0.0f;
    dw1b[f] = 0.0f;
  }
  const float b1a = b1[k0], b1b = b1[k1];
  const float ga = g[k0], gb = g[k1];
  const float bea = be[k0], beb = be[k1];
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

  for (int row = row0; row < row1; ++row) {
    if (tid < H) {
      const int a = amax[(size_t)row * H + tid];
      const bool ok = a >= 0 && a < E;
      win[tid] = ok ? a : -1;
      dps[tid] = ok ? dpool[(size_t)row * H + tid] : 0.0f;
    }
    __syncthreads();
    if (tid < H) {
      const int a = win[tid];
      int l = tid;
      for (int u = 0; u < tid; ++u) {
        if (win[u] == a) { l = u; break; }
      }
      lead[tid] = l;
    }
    __syncthreads();

    const float* xr = x + (size_t)row * row_stride;
    for (int u = warp; u < H; u += WARPS) {
      const int e = win[u];
      if (e < 0 || lead[u] != u) continue;  // uniform per warp
      const float xv = lane < F ? xr[(size_t)e * F + lane] : 0.0f;
      float pa = 0.0f, pb = 0.0f;
#pragma unroll
      for (int f = 0; f < FMAX; ++f) {
        if (f < F) {
          const float xf = __shfl_sync(0xffffffffu, xv, f);
          pa += xf * w1a[f];
          pb += xf * w1b[f];
        }
      }
      pa += b1a;
      pb += b1b;
      const float mu = warp_sum(pa + pb) / (float)H;
      const float d0 = pa - mu;
      const float d1 = pb - mu;
      const float var = warp_sum(d0 * d0 + d1 * d1) / (float)H;
      const float rstd = rsqrtf(var + LN_EPS);
      const float xh0 = d0 * rstd, xh1 = d1 * rstd;
      const float lin0 = xh0 * ga + bea, lin1 = xh1 * gb + beb;
      const float t0 = activation<ACT>(lin0), t1 = activation<ACT>(lin1);
      ts[u * TS_STRIDE + k0] = t0;
      ts[u * TS_STRIDE + k1] = t1;

      // dt[k] = sum over the units j this entity wins of dpool[j] * w2[k, j];
      // units before u have other winners (u leads its winner)
      float dt0 = 0.0f, dt1 = 0.0f;
      for (int j = u; j < H; ++j) {
        if (lead[j] == u) {
          const float d = dps[j];
          dt0 += d * w2t[j * H + k0];
          dt1 += d * w2t[j * H + k1];
        }
      }
      const float dl0 = dt0 * activation_grad<ACT>(lin0, t0);
      const float dl1 = dt1 * activation_grad<ACT>(lin1, t1);
      dga += dl0 * xh0;
      dgb += dl1 * xh1;
      dbea += dl0;
      dbeb += dl1;
      const float dxh0 = dl0 * ga, dxh1 = dl1 * gb;
      const float m1 = warp_sum(dxh0 + dxh1) / (float)H;
      const float m2 = warp_sum(dxh0 * xh0 + dxh1 * xh1) / (float)H;
      const float dp0 = (dxh0 - m1 - xh0 * m2) * rstd;
      const float dp1 = (dxh1 - m1 - xh1 * m2) * rstd;
      db1a += dp0;
      db1b += dp1;
#pragma unroll
      for (int f = 0; f < FMAX; ++f) {
        if (f < F) {
          const float xf = __shfl_sync(0xffffffffu, xv, f);
          dw1a[f] += xf * dp0;
          dw1b[f] += xf * dp1;
        }
      }
    }
    __syncthreads();

    if (win[jo] >= 0) {  // ts rows of units without a winner are stale
      const float d = dps[jo];
      const float* tr = ts + lead[jo] * TS_STRIDE + kq * KQ;
#pragma unroll
      for (int q = 0; q < KQ; ++q) dw2acc[q] += tr[q] * d;
      if (kq == 0) db2acc += d;
    }
    __syncthreads();  // win, lead, dps and ts are rewritten by the next row
  }

  // add the warps' dw1, db1, dg, dbe in warp order
  for (int i = tid; i < FMAX * H + 3 * H; i += THREADS) red[i] = 0.0f;
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int f = 0; f < FMAX; ++f) {
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

// out[i] = sum over blocks b (in order) of partial[b, i]
__global__ void sum_partials(const float* __restrict__ partial,
                             float* __restrict__ out, int nblocks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * n + i];
  out[i] = s;
}

}  // namespace

// Number of partial blocks the backward uses for B rows when it may use at
// most max_blocks; the caller sizes the partial buffer [max_blocks, n_out].
extern "C" int fused_embed_pool_bwd_blocks(int B, int max_blocks) {
  if (B < 1 || max_blocks < 1) return 0;
  const int rows = (B + max_blocks - 1) / max_blocks;
  return (B + rows - 1) / rows;
}

extern "C" int fused_embed_pool_bwd(const float* x, const float* w1,
                                    const float* b1, const float* g,
                                    const float* be, const float* w2,
                                    const int* amax, const float* dpool,
                                    float* partial, float* out, int B, int E,
                                    int F, long long row_stride,
                                    int max_blocks, int act, void* stream) {
  if (F < 1 || F > FMAX || E < 1 || B < 1 || max_blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = (B + max_blocks - 1) / max_blocks;
  const int nblocks = (B + rows - 1) / rows;
  const cudaStream_t s = (cudaStream_t)stream;
  if (act == 0) {
    embed_pool_bwd_partial<0><<<nblocks, THREADS, 0, s>>>(
        x, w1, b1, g, be, w2, amax, dpool, partial, B, E, F, row_stride, rows);
  } else {
    embed_pool_bwd_partial<1><<<nblocks, THREADS, 0, s>>>(
        x, w1, b1, g, be, w2, amax, dpool, partial, B, E, F, row_stride, rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = n_out(F);
  sum_partials<<<(n + 255) / 256, 256, 0, s>>>(partial, out, nblocks, n);
  return (int)cudaGetLastError();
}
