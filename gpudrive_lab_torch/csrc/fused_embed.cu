// Fused embed + max-pool forward: kernel K3, on the tensor cores (wgmma).
//
// For each row b and entity e of x [B, E, F] (float32; each row's E*F
// values contiguous, rows row_stride elements apart, so a slice of the
// flat observation is read in place):
//   pre = x[b, e] @ w1 + b1                      (w1 [F, 64], as flax stores it)
//   xh  = (pre - mean(pre)) / sqrt(var(pre) + 1e-6)   (f32 statistics)
//   t   = act(xh * g + be)                       (tanh, or gelu's tanh form)
//   y   = t @ w2 + b2                            (w2 [64, 64])
// then pooled[b, j] = max_e y[e, j] and argmax[b, j] = the winning e.
// The [B, E, 64] activations never leave the registers: the kernel reads x
// once and writes the pooled [B, 64] float32 and the argmax [B, 64] int32.
//
// What bounds it.  2*F*64 + 2*64*64 multiply-adds per entity against 4*F
// bytes of input, so operations bound it, never bytes.  On the fp32 cores
// (67 TFLOP/s) the policy's two blocks at 65,536 rows take at least 3.2 ms;
// here both products run on the tensor cores, whose TF32 bound for them is
// 3 x products / 495 TFLOP/s = 1.2 ms.  The rest (LayerNorm, tanhf, the
// split of the operands, the running max) stays on the fp32 cores, and on
// the H100 that part and the tensor-core part take about as long each: the
// kernel runs at ~3.5 ms, neither side hidden behind the other.
//
// Precision: 3xTF32.  Each operand v is split into hi = tf32(v) and
// lo = tf32(v - hi) (cvt.rna), and a product is lo*hi + hi*lo + hi*hi with
// fp32 sums in the tensor core (the tf32 x tf32 products are exact).  That
// gives ~1e-6 errors, which the argmax needs (equal to the plain version's
// wherever the top two differ by more than 1e-5); one TF32 pass gives
// ~1e-3 (tests/test_torch_tf32_split.py).  tanhf and the LayerNorm
// statistics stay in fp32 (no tanh.approx).
//
// Layout of the work.  A block is one warpgroup (4 warps); each warp holds
// an m-tile of 16 entities of its row, and the warpgroup's 64 entities go
// through wgmma.m64n64k8 (TF32 in, fp32 out) with A from registers and B
// from shared memory:
//   layer 1: A = the tile's x (k-steps of 8 features, zero-padded), B = w1,
//            the accumulators start at b1 -> pre [16, 64] in registers;
//   LayerNorm: a lane holds two entities (rows g and g+8 of its tile) and
//            16 of their 64 hidden units, so the statistics are sums over
//            the 4 lanes of a quad (two shuffles);
//   layer 2: the accumulator fragment of n-tile kk is the A fragment of
//            k-step kk once w2's rows are permuted to match (A columns q and
//            q + 4 are units kk*8 + 2q and kk*8 + 2q + 1), so t never leaves
//            the registers; the accumulators start at b2, and at -inf for
//            entities past E, which then never win.
// w1 and w2 sit in shared memory pre-split into hi and lo, as K-major core
// matrices of 8 n-rows x 4 k (no swizzle).  x is read straight into the A
// fragments with 4-byte loads, at any alignment (the partner slice starts
// 24 bytes into its row), the next tile's before the current one is
// computed.  Each lane keeps the running max and argmax of its 16 columns;
// at the end of a row the 8 lanes of each column combine by shuffles.
//
// Filling the card: each warp takes one row, and blocks are persistent (as
// many as fit at once, 3 per SM) and walk the rows in groups of 4.  The
// warps of a block run the same number of tiles in step, as wgmma needs; a
// warp past the last row sees no entities.
//
// The bf16 compute mode is K3-bf16, in fused_embed_bf16.cu.
//
// Argmax rule: a lane visits its entities in ascending order and replaces
// its winner only on a strictly larger value; lanes combine by (larger
// value, then smaller index).  So among exactly equal maxima the smallest
// entity index wins.  (The Pallas kernel
// picks the largest index within a chunk of 16 and the earliest chunk; the
// two rules differ only on exact ties.)  The same inputs give the same bits
// on every launch.
//
// Source note: replaces _fwd_kernel / _fused_fwd_impl of
// gpudrive_lab_tpu/networks/fused_embed.py (:84-109, :198-228) in
// compute dtype float32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (gpudrive_lab_torch/cuda_build.py; wgmma needs sm_90a).  C interface,
// launched on the caller's stream; fused_embed_pool_fwd returns
// cudaGetLastError() after its launch.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int H = 64;
constexpr int NT = H / 8;         // n-tiles (and layer-2 k-steps) of 8 units
constexpr int FMAX = 16;          // largest feature width F accepted
constexpr int MT = 16;            // entities per warp and m-tile
constexpr int WARPS = 4;          // one warpgroup per block
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 3;     // blocks per SM the registers are sized for
constexpr float LN_EPS = 1e-6f;   // flax.linen.LayerNorm default

struct Smem {
  // w2 and w1 per k-step, hi then lo: 8 k x 64 n tf32 as core matrices of
  // 8 n-rows x 4 k (128 bytes), core (n / 8, k / 4) at n / 8 * 2 + k / 4
  __align__(128) float w2g[NT][2][8 * H];
  __align__(128) float w1g[FMAX / 8][2][8 * H];
  float p[4][H];                 // b1, g, be, b2
};

// offset of element (k, n) of an 8 x 64 k-step in the core-matrix layout
__host__ __device__ constexpr int core_offset(int k, int n) {
  return ((n / 8) * 2 + k / 4) * 32 + (n % 8) * 4 + k % 4;
}

// byte offsets between core matrices along k (leading) and n (stride)
constexpr int LBO = 128;
constexpr int SBO = 256;

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// one element of x
__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

// shared-memory matrix descriptor of a k-step, no swizzle
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

// d[64 x 64] += a[64 x 8] @ b[8 x 64] over the warpgroup, a from registers
// (this warp's 16 rows: (g, q), (g+8, q), (g, q+4), (g+8, q+4)), b from
// shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// keep the compiler from moving accesses of d across the asynchronous
// wgmma region
__device__ __forceinline__ void pin(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[nt][i]) :: "memory");
  }
}

// d += a @ b in 3xTF32 (the small terms first); a as 4 floats in fragment
// order, b's hi and lo k-step tiles in shared memory.  Issued, not waited.
__device__ __forceinline__ void mma_3xtf32(float (&d)[NT][4], float a0,
                                           float a1, float a2, float a3,
                                           const float* bh, const float* bl) {
  uint32_t ah[4], al[4];
  split(a0, ah[0], al[0]);
  split(a1, ah[1], al[1]);
  split(a2, ah[2], al[2]);
  split(a3, ah[3], al[3]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint64_t dh = smem_desc(bh), dl = smem_desc(bl);
  wgmma_tf32(d, al, dh);
  wgmma_tf32(d, ah, dl);
  wgmma_tf32(d, ah, dh);
}

__device__ __forceinline__ void wgmma_wait(float (&d)[NT][4]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  pin(d);
}

template <int ACT>
__device__ __forceinline__ float activation(float v) {
  if (ACT == 0) return tanhf(v);
  // gelu, tanh approximation (jax.nn.gelu default)
  const float c = 0.7978845608028654f;
  return v * (0.5f * (1.0f + tanhf(c * (v + 0.044715f * (v * v * v)))));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// (v, i) takes (ov, oi) if that is larger, or equal with a smaller index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The A fragments of an m-tile's inputs: a0 (row g, col q), a1 (g+8, q),
// a2 (g, q+4), a3 (g+8, q+4) of each k-step; zero outside [E, F).
template <int KK1>
__device__ __forceinline__ void load_x(const float* __restrict__ xr, int e0,
                                       int E, int F, int lane,
                                       float (&xa)[KK1][4]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KK1; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + g + (i & 1) * 8;
      const int f = kk * 8 + q + (i >> 1) * 4;
      xa[kk][i] = (e < E && f < F) ? load_f(xr + (size_t)e * F + f) : 0.0f;
    }
  }
}

// Layer 1, LayerNorm and the activation of the warp's m-tile: t [16, 64]
// as 8 accumulator fragments (rows g and g + 8, units nt*8 + 2q + {0, 1}).
template <int ACT, int KK1>
__device__ __forceinline__ void layer1_act(const Smem& sm,
                                           const float (&xa)[KK1][4], int lane,
                                           float (&t)[NT][4]) {
  const int q = lane & 3;
  const float2* b1 = reinterpret_cast<const float2*>(sm.p[0]);
  const float2* gg = reinterpret_cast<const float2*>(sm.p[1]);
  const float2* be = reinterpret_cast<const float2*>(sm.p[2]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = b1[nt * 4 + q];
    t[nt][0] = b.x; t[nt][1] = b.y; t[nt][2] = b.x; t[nt][3] = b.y;
  }
  pin(t);
#pragma unroll
  for (int kk = 0; kk < KK1; ++kk) {
    mma_3xtf32(t, xa[kk][0], xa[kk][1], xa[kk][2], xa[kk][3], sm.w1g[kk][0],
            sm.w1g[kk][1]);
  }
  wgmma_wait(t);

  // LayerNorm over the 64 units of rows g (c0, c1) and g+8 (c2, c3)
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s0 += t[nt][0] + t[nt][1];
    s1 += t[nt][2] + t[nt][3];
  }
  const float mu0 = quad_sum(s0) / (float)H, mu1 = quad_sum(s1) / (float)H;
  float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    t[nt][0] -= mu0; t[nt][1] -= mu0; t[nt][2] -= mu1; t[nt][3] -= mu1;
    v0 += t[nt][0] * t[nt][0] + t[nt][1] * t[nt][1];
    v1 += t[nt][2] * t[nt][2] + t[nt][3] * t[nt][3];
  }
  const float r0 = rsqrtf(quad_sum(v0) / (float)H + LN_EPS);
  const float r1 = rsqrtf(quad_sum(v1) / (float)H + LN_EPS);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 gv = gg[nt * 4 + q], bv2 = be[nt * 4 + q];
    t[nt][0] = activation<ACT>(t[nt][0] * r0 * gv.x + bv2.x);
    t[nt][1] = activation<ACT>(t[nt][1] * r0 * gv.y + bv2.y);
    t[nt][2] = activation<ACT>(t[nt][2] * r1 * gv.x + bv2.x);
    t[nt][3] = activation<ACT>(t[nt][3] * r1 * gv.y + bv2.y);
  }
}

// Layer 2 of the warp's m-tile: y = t @ w2 + b2, with the accumulators of
// entities past E starting at -inf.
__device__ __forceinline__ void layer2(const Smem& sm, const float (&t)[NT][4],
                                       int e0, int E, int lane,
                                       float (&y)[NT][4]) {
  const int g = lane >> 2, q = lane & 3;
  const float2* b2 = reinterpret_cast<const float2*>(sm.p[3]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = b2[nt * 4 + q];
    y[nt][0] = b.x; y[nt][1] = b.y; y[nt][2] = b.x; y[nt][3] = b.y;
  }
  if (e0 + MT > E) {  // a partial tile (uniform over the warp)
    const float lo0 = e0 + g < E ? 0.0f : -CUDART_INF_F;
    const float lo1 = e0 + g + 8 < E ? 0.0f : -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      y[nt][0] += lo0; y[nt][1] += lo0; y[nt][2] += lo1; y[nt][3] += lo1;
    }
  }
  pin(y);
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    mma_3xtf32(y, t[kk][0], t[kk][2], t[kk][1], t[kk][3], sm.w2g[kk][0],
            sm.w2g[kk][1]);
  }
  wgmma_wait(y);
}

// The lane's running maxima bv / bi of its 16 columns nt*8 + 2q + c (index
// nt*2 + c) over the tile's two entities of the lane, in order.
__device__ __forceinline__ void max_update(const float (&y)[NT][4], int e0,
                                           int lane, float (&bv)[2 * NT],
                                           int (&bi)[2 * NT]) {
  const int g = lane >> 2;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = nt * 2 + c;
      if (y[nt][c] > bv[k]) { bv[k] = y[nt][c]; bi[k] = e0 + g; }
      if (y[nt][2 + c] > bv[k]) { bv[k] = y[nt][2 + c]; bi[k] = e0 + g + 8; }
    }
  }
}

template <int ACT, int KK1>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
embed_pool_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ g,
                      const float* __restrict__ be, const float* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int* __restrict__ amax, int B, int E, int F,
                      long long row_stride) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;

  // weights, pre-split into hi and lo.  w2's k-step kk holds rows
  // kk*8 + {0, 2, 4, 6, 1, 3, 5, 7} (see layer 2 above).
  for (int i = tid; i < NT * 8 * H; i += THREADS) {
    const int kk = i / (8 * H), k = (i / H) % 8, n = i % H;
    const int src = kk * 8 + (k < 4 ? 2 * k : 2 * (k - 4) + 1);
    uint32_t hi, lo;
    split(w2[src * H + n], hi, lo);
    sm.w2g[kk][0][core_offset(k, n)] = __uint_as_float(hi);
    sm.w2g[kk][1][core_offset(k, n)] = __uint_as_float(lo);
  }
  for (int i = tid; i < KK1 * 8 * H; i += THREADS) {
    const int kk = i / (8 * H), k = (i / H) % 8, n = i % H;
    const int f = kk * 8 + k;
    uint32_t hi, lo;
    split(f < F ? w1[f * H + n] : 0.0f, hi, lo);
    sm.w1g[kk][0][core_offset(k, n)] = __uint_as_float(hi);
    sm.w1g[kk][1][core_offset(k, n)] = __uint_as_float(lo);
  }
  for (int i = tid; i < H; i += THREADS) {
    sm.p[0][i] = b1[i];
    sm.p[1][i] = g[i];
    sm.p[2][i] = be[i];
    sm.p[3][i] = b2[i];
  }
  // the tensor cores read w1g and w2g through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int T = (E + MT - 1) / MT;          // m-tiles per row
  const int groups = (B + WARPS - 1) / WARPS;

  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int row = grp * WARPS + warp;   // uniform per warp
    float bv[2 * NT];
    int bi[2 * NT];
#pragma unroll
    for (int k = 0; k < 2 * NT; ++k) {
      bv[k] = -CUDART_INF_F;
      bi[k] = INT_MAX;
    }
    // every warp of the block runs T tiles in step; a warp past the last
    // row sees no entities
    const float* xr = x + (size_t)min(row, B - 1) * row_stride;
    const int Er = row < B ? E : 0;
    float xa[KK1][4];
    load_x<KK1>(xr, 0, Er, F, lane, xa);
    for (int tc = 0; tc < T; ++tc) {
      float xn[KK1][4], t[NT][4], y[NT][4];
      load_x<KK1>(xr, (tc + 1) * MT, Er, F, lane, xn);
      layer1_act<ACT, KK1>(sm, xa, lane, t);
      layer2(sm, t, tc * MT, Er, lane, y);
      max_update(y, tc * MT, lane, bv, bi);
#pragma unroll
      for (int kk = 0; kk < KK1; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) xa[kk][j] = xn[kk][j];
      }
    }
    // combine the 8 lanes (g = 0..7) that hold each column
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < 2 * NT; ++k) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv[k], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi[k], off);
        take_better(bv[k], bi[k], ov, oi);
      }
    }
    if (row < B && lane < 4) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const size_t o = (size_t)row * H + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(out + o) =
            make_float2(bv[nt * 2], bv[nt * 2 + 1]);
        *reinterpret_cast<int2*>(amax + o) =
            make_int2(bi[nt * 2] == INT_MAX ? 0 : bi[nt * 2],
                      bi[nt * 2 + 1] == INT_MAX ? 0 : bi[nt * 2 + 1]);
      }
    }
  }
}

// Occupancy of one kernel instance, and its shared-memory opt-in, once.
template <int ACT, int KK1>
int blocks_per_sm() {
  static int nb = -1;
  if (nb < 0) {
    auto kern = embed_pool_fwd_kernel<ACT, KK1>;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem)) != cudaSuccess) {
      return 0;
    }
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS,
                                                      sizeof(Smem)) !=
        cudaSuccess) {
      return 0;
    }
    nb = n;
  }
  return nb;
}

template <int ACT, int KK1>
int launch(const float* x, const float* w1, const float* b1, const float* g,
           const float* be, const float* w2, const float* b2, float* out,
           int* amax, int B, int E, int F, long long row_stride,
           cudaStream_t s) {
  const int nb = blocks_per_sm<ACT, KK1>();
  int dev = 0, sms = 0;
  if (nb < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorLaunchFailure;
  }
  const int resident = nb * sms;
  const int groups = (B + WARPS - 1) / WARPS;
  const int grid = groups < resident ? groups : resident;
  embed_pool_fwd_kernel<ACT, KK1><<<grid, THREADS, sizeof(Smem), s>>>(
      x, w1, b1, g, be, w2, b2, out, amax, B, E, F, row_stride);
  return (int)cudaGetLastError();
}

int dispatch(const float* x, const float* w1, const float* b1, const float* g,
             const float* be, const float* w2, const float* b2, float* out,
             int* amax, int B, int E, int F, long long row_stride, int act,
             void* stream) {
  if (F < 1 || F > FMAX || E < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (F <= 8) {
    return act == 0 ? launch<0, 1>(x, w1, b1, g, be, w2, b2, out, amax, B,
                                       E, F, row_stride, s)
                    : launch<1, 1>(x, w1, b1, g, be, w2, b2, out, amax, B,
                                       E, F, row_stride, s);
  }
  return act == 0 ? launch<0, 2>(x, w1, b1, g, be, w2, b2, out, amax, B,
                                     E, F, row_stride, s)
                  : launch<1, 2>(x, w1, b1, g, be, w2, b2, out, amax, B,
                                     E, F, row_stride, s);
}

}  // namespace

// float32: x float32, both products in 3xTF32
extern "C" int fused_embed_pool_fwd(const float* x, const float* w1,
                                    const float* b1, const float* g,
                                    const float* be, const float* w2,
                                    const float* b2, float* out, int* amax,
                                    int B, int E, int F,
                                    long long row_stride, int act,
                                    void* stream) {
  return dispatch(x, w1, b1, g, be, w2, b2, out, amax, B, E, F, row_stride,
                  act, stream);
}
