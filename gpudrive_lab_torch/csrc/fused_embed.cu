// Fused embed + max-pool forward: kernel K3.
//
// For each row b and entity e of x [B, E, F] (float32; each row's E*F
// values contiguous, rows row_stride floats apart, so a slice of the flat
// observation is read in place):
//   pre = x[b, e] @ w1 + b1                      (w1 [F, 64], as flax stores it)
//   xh  = (pre - mean(pre)) / sqrt(var(pre) + 1e-6)   (f32 statistics)
//   t   = act(xh * g + be)                       (tanh, or gelu's tanh form)
//   y   = t @ w2 + b2                            (w2 [64, 64])
// then pooled[b, j] = max_e y[e, j] and argmax[b, j] = the winning e.
// The [B, E, 64] activations never leave the SM: the kernel reads x once
// and writes the pooled [B, 64] float32 and the argmax [B, 64] int32.
//
// Layout of the work: one warp per row, two hidden units per lane
// (j = lane and lane + 32).  Entities go in groups of EG: the group's EG*F
// inputs are staged in shared memory (one coalesced load), layer 1 runs
// from registers (w1 columns of the lane's two units), the LayerNorm
// statistics are warp-shuffle sums, and layer 2 reads w2 from shared memory
// once per k for all EG entities of the group.  Accumulation is float32
// throughout.
//
// Argmax rule: entities are visited in ascending order and a later entity
// replaces the winner only if it is strictly larger, so among exactly equal
// maxima the smallest entity index wins.  (The Pallas kernel picks the
// largest index within a chunk of 16 and the earliest chunk; the two rules
// differ only on exact ties.)  The pooled max does not depend on the order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (gpudrive_lab_torch/cuda_build.py).  C interface, launched on the caller's
// stream; the entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int H = 64;
constexpr int FMAX = 16;          // largest feature width F accepted
constexpr int EG = 4;             // entities per group
constexpr int WARPS = 8;          // warps (rows in flight) per block
constexpr int ROWS_PER_WARP = 4;  // rows each warp handles in turn
constexpr float LN_EPS = 1e-6f;   // flax.linen.LayerNorm default

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int ACT>
__device__ __forceinline__ float activation(float v) {
  if (ACT == 0) return tanhf(v);
  // gelu, tanh approximation (jax.nn.gelu default)
  const float c = 0.7978845608028654f;
  return v * (0.5f * (1.0f + tanhf(c * (v + 0.044715f * (v * v * v)))));
}

template <int ACT>
__global__ void __launch_bounds__(WARPS * 32)
embed_pool_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ g,
                      const float* __restrict__ be, const float* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int* __restrict__ amax, int B, int E, int F,
                      long long row_stride) {
  __shared__ float w2s[H * H];                       // [k][j]
  __shared__ __align__(16) float ts[WARPS][H][EG];   // activations t[k][q]
  __shared__ float xs[WARPS][EG * FMAX];             // the group's inputs

  for (int k = threadIdx.x; k < H * H; k += blockDim.x) w2s[k] = w2[k];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = lane;
  const int j1 = lane + 32;

  float w1a[FMAX], w1b[FMAX];
#pragma unroll
  for (int f = 0; f < FMAX; ++f) {
    w1a[f] = f < F ? w1[f * H + j0] : 0.0f;
    w1b[f] = f < F ? w1[f * H + j1] : 0.0f;
  }
  const float b1a = b1[j0], b1b = b1[j1];
  const float ga = g[j0], gb = g[j1];
  const float bea = be[j0], beb = be[j1];
  const float b2a = b2[j0], b2b = b2[j1];

  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = (blockIdx.x * ROWS_PER_WARP + r) * WARPS + warp;
    if (row >= B) break;  // uniform per warp; no block barrier follows
    const float* xr = x + (size_t)row * row_stride;
    float best0 = -CUDART_INF_F, best1 = -CUDART_INF_F;
    int arg0 = 0, arg1 = 0;

    for (int e0 = 0; e0 < E; e0 += EG) {
      const int ne = min(EG, E - e0);
      const int n = ne * F;
      for (int k = lane; k < EG * FMAX; k += 32) {
        xs[warp][k] = k < n ? xr[(size_t)e0 * F + k] : 0.0f;
      }
      __syncwarp();

      float pa[EG], pb[EG];
#pragma unroll
      for (int q = 0; q < EG; ++q) {
        pa[q] = 0.0f;
        pb[q] = 0.0f;
#pragma unroll
        for (int f = 0; f < FMAX; ++f) {
          if (f < F) {
            const float xv = xs[warp][q * F + f];
            pa[q] += xv * w1a[f];
            pb[q] += xv * w1b[f];
          }
        }
        pa[q] += b1a;
        pb[q] += b1b;
      }

#pragma unroll
      for (int q = 0; q < EG; ++q) {
        const float mu = warp_sum(pa[q] + pb[q]) / (float)H;
        const float d0 = pa[q] - mu;
        const float d1 = pb[q] - mu;
        const float var = warp_sum(d0 * d0 + d1 * d1) / (float)H;
        const float rstd = 1.0f / sqrtf(var + LN_EPS);
        ts[warp][j0][q] = activation<ACT>(d0 * rstd * ga + bea);
        ts[warp][j1][q] = activation<ACT>(d1 * rstd * gb + beb);
      }
      __syncwarp();

      float ya[EG], yb[EG];
#pragma unroll
      for (int q = 0; q < EG; ++q) {
        ya[q] = 0.0f;
        yb[q] = 0.0f;
      }
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float4 tv = *reinterpret_cast<const float4*>(&ts[warp][k][0]);
        const float wa = w2s[k * H + j0];
        const float wb = w2s[k * H + j1];
        ya[0] += tv.x * wa; yb[0] += tv.x * wb;
        ya[1] += tv.y * wa; yb[1] += tv.y * wb;
        ya[2] += tv.z * wa; yb[2] += tv.z * wb;
        ya[3] += tv.w * wa; yb[3] += tv.w * wb;
      }
#pragma unroll
      for (int q = 0; q < EG; ++q) {
        if (q < ne) {
          const float va = ya[q] + b2a;
          const float vb = yb[q] + b2b;
          if (va > best0) { best0 = va; arg0 = e0 + q; }
          if (vb > best1) { best1 = vb; arg1 = e0 + q; }
        }
      }
      __syncwarp();  // ts and xs are rewritten by the next group
    }
    out[(size_t)row * H + j0] = best0;
    out[(size_t)row * H + j1] = best1;
    amax[(size_t)row * H + j0] = arg0;
    amax[(size_t)row * H + j1] = arg1;
  }
}

}  // namespace

extern "C" int fused_embed_pool_fwd(const float* x, const float* w1,
                                    const float* b1, const float* g,
                                    const float* be, const float* w2,
                                    const float* b2, float* out, int* amax,
                                    int B, int E, int F,
                                    long long row_stride, int act,
                                    void* stream) {
  if (F < 1 || F > FMAX || E < 1) return (int)cudaErrorInvalidValue;
  const int rows_per_block = WARPS * ROWS_PER_WARP;
  const dim3 grid((B + rows_per_block - 1) / rows_per_block);
  const cudaStream_t s = (cudaStream_t)stream;
  if (act == 0) {
    embed_pool_fwd_kernel<0><<<grid, WARPS * 32, 0, s>>>(
        x, w1, b1, g, be, w2, b2, out, amax, B, E, F, row_stride);
  } else {
    embed_pool_fwd_kernel<1><<<grid, WARPS * 32, 0, s>>>(
        x, w1, b1, g, be, w2, b2, out, amax, B, E, F, row_stride);
  }
  return (int)cudaGetLastError();
}
