// Fused embed + max-pool forward in the bf16 compute mode: kernel K3-bf16,
// on native bf16 wgmma.
//
// For each row b and entity e of x [B, E, F] (float32 or bf16 as stored;
// each row's E*F values contiguous, rows row_stride elements apart, so a
// slice of the flat observation is read in place):
//   pre = bf16(x[b, e]) @ bf16(w1) + b1          (f32 sums)
//   xh  = (pre - mean(pre)) / sqrt(var(pre) + 1e-6)   (f32 statistics)
//   t   = act(xh * g + be)                       (tanhf, or gelu's tanh form)
//   y   = bf16(t) @ bf16(w2) + b2                (f32 sums)
// then pooled[b, j] = max_e y[e, j] and argmax[b, j] = the winning e.  This
// is the JAX package's compute dtype bfloat16: the operands of both
// products rounded to bf16 (round to nearest even), biases, LayerNorm
// statistics, the activation and the max in f32.  The float32 mode is K3 in
// fused_embed.cu.
//
// What bounds it.  2*F*64 + 2*64*64 bf16 multiply-adds per entity (the
// products at 989 TFLOP/s: 0.111 ms for the policy's two blocks at 35,328
// rows) beside about 10*64 f32 operations per entity on the fp32 cores
// (0.110 ms at 67 TFLOP/s, tanh counted as one), against 2*F or 4*F bytes
// of x: operations bind it.  The fp32 side costs more than that bound
// charges it: tanhf alone is 16 instructions (two on the special-function
// unit), the LayerNorm, tanhf and packing about 24 per entity and unit and
// the running max about 4 more (cuobjdump of the road instance), against
// the products' 5 wgmma per 16 x 64 tile.  So instruction issue on the
// fp32 side sets the pace, and the products only have to stay off its
// path.
//
// Design.
//  * Products on native bf16 wgmma, m64n64k16 with f32 accumulators, A from
//    registers (two bf16 to a 32-bit register, the lower column in the low
//    half), B (w1, w2 as bf16) in shared memory as K-major core matrices of
//    8 n-rows x 8 k (128 bytes, no swizzle).  Layer 1 is one k16 step (F <=
//    16, zero-padded); layer 2 four.  A 16-bit A fragment of k-step kk holds,
//    per warp, (g, 2q..2q+1), (g+8, 2q..2q+1), (g, 2q+8..2q+9) and
//    (g+8, 2q+8..2q+9) of its 16 x 16 block (g = lane / 4, q = lane % 4), and
//    the f32 accumulator of n-tile nt holds (g, 8nt+2q..+1) and (g+8, ...):
//    so the accumulators of n-tiles 2kk and 2kk+1, rounded and packed in
//    pairs, are layer 2's A fragment of k-step kk as they stand, and t never
//    leaves the registers (tests/test_torch_bf16_dataflow.py emulates these
//    index maps).  Both products start from zero (scale-d 0); b1 is added
//    in the LayerNorm and b2 in the running max, as the plain version adds
//    each bias after its product.
//  * The overlap: several warpgroups per SM, each issuing its products and
//    waiting for them, so that one warpgroup's LayerNorm and tanhf run while
//    another's products are on the tensor cores.  One warpgroup is a block
//    of 110-115 registers a thread, three of them an SM (MIN_BLOCKS; four
//    and five measured no faster).  Pipelining inside a warpgroup (layer 1
//    of the next tile and layer 2 of the last in flight during this tile's
//    epilogue) was built and measured (NVIDIA H100 80GB HBM3, 700 W;
//    scripts/time_embed_bf16.py): with two accumulators, two packed t and
//    two x fragments it needs
//    ~170-200 registers, two blocks an SM, and ran 1.21-1.30 ms for both
//    blocks at 35,328 rows of bf16 x against 1.154-1.160 ms for this design;
//    with products left in flight across iterations ptxas serializes them
//    anyway (C7513/C7514).  Two warpgroups ping-ponging on named barriers
//    would order what the scheduler already interleaves.
//  * x is staged in shared memory.  Each warp keeps a ring of 3 chunks of
//    64 entities (4 tiles) of its row, filled by cp.async 16 bytes at a time
//    two chunks ahead of the tile being built.  A slice starts at any 2-byte
//    offset (bf16) of its row, so a chunk is copied as the enclosing
//    16-byte-aligned span and read at its offset; such a span never leaves
//    the allocation's 512-byte blocks.  The A fragments are built from the
//    chunk, the pairs rounded to bf16 from float32 x or taken as stored.
//  * Filling the card: each warp takes one row; blocks are persistent (as
//    many as fit at once) and walk groups of 4 rows.  The 4 warps run the
//    same tiles in step, as wgmma needs; a warp past the last row sees no
//    entities.
//  * Kept from K3: exact tanhf (no tanh.approx), the LayerNorm as the mean
//    of squares of centred values, entities past E left out of the max, and
//    the argmax rule: a lane visits its entities in ascending order and
//    replaces its winner only on a strictly larger value; lanes combine by
//    (larger value, then smaller index), so among equal maxima the smallest
//    index wins.  The same inputs give the same bits on every launch.
//
// Source note: replaces _fwd_kernel / _fused_fwd_impl of
// gpudrive_lab_tpu/networks/fused_embed.py (:84-109, :198-228) in compute
// dtype bfloat16 (its _embed_chunk, :69-82).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (gpudrive_lab_torch/cuda_build.py; wgmma needs sm_90a).  C interface,
// launched on the caller's stream; fused_embed_pool_fwd_bf16 returns
// cudaGetLastError() after its launch.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int H = 64;
constexpr int NT = H / 8;         // n-tiles of 8 units
constexpr int K2 = H / 16;        // layer-2 k-steps of 16
constexpr int FMAX = 16;          // largest feature width F accepted
constexpr int MT = 16;            // entities per warp and m-tile
constexpr int CH = 64;            // entities per staged chunk of x
constexpr int TPC = CH / MT;      // tiles per chunk
constexpr int STAGES = 3;         // chunks in each warp's ring
constexpr int WARPS = 4;          // one warpgroup per block
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 3;     // blocks per SM the registers are sized for
constexpr float LN_EPS = 1e-6f;   // flax.linen.LayerNorm default

struct Weights {
  // w2's k-steps and w1's one k-step: 16 k x 64 n bf16 as core matrices of
  // 8 n-rows x 8 k (128 bytes), core (n / 8, k / 8) at n / 8 * 2 + k / 8
  __align__(128) uint16_t w2[K2][16 * H];
  __align__(128) uint16_t w1[16 * H];
  float p[4][H];                 // b1, g, be, b2
};

// bytes of one staged chunk: 64 entities of up to 16 features of 4 bytes,
// plus the span's misaligned head and tail
__host__ __device__ constexpr int stage_bytes(int F, int xsz) {
  return (CH * F * xsz + 32 + 15) / 16 * 16;
}

// offset of element (k, n) of a 16 x 64 k-step in the core-matrix layout
__device__ __forceinline__ int core_offset(int k, int n) {
  return ((n / 8) * 2 + k / 8) * 64 + (n % 8) * 8 + k % 8;
}

// byte offsets between core matrices along k (leading) and n (stride)
constexpr int LBO = 128;
constexpr int SBO = 256;

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// shared-memory matrix descriptor of a k-step, no swizzle
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

// d[64 x 64] = a[64 x 16] @ b[16 x 64] (+ d if acc) over the warpgroup,
// bf16 operands, a from registers, b from shared memory (K-major, not
// transposed)
__device__ __forceinline__ void wgmma_bf16(float (&d)[NT][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc)
      : "memory");
}

// keep the compiler from moving accesses of d or a across the asynchronous
// wgmma region
__device__ __forceinline__ void pin(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[nt][i]) :: "memory");
  }
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

template <int M, int N>
__device__ __forceinline__ void pin(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) pin(a[i]);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until every committed group of products is done
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread's copies runs
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// a staged element of x as bf16 bits: float32 rounded, bf16 as stored
__device__ __forceinline__ uint32_t bits_of(const unsigned char* p,
                                            const float*) {
  return bf16_bits(*reinterpret_cast<const float*>(p));
}
__device__ __forceinline__ uint32_t bits_of(const unsigned char* p,
                                            const __nv_bfloat16*) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The stream of a block: its groups of 4 rows in turn (group blockIdx.x +
// k * gridDim.x), each walked in T tiles of 16 entities; the chunks of 64
// entities of a row are numbered along the same stream.
struct Stream {
  int B, E, F, T, NCH, groups;
  long long row_stride;
  int stage;  // bytes of a ring slot
};

// Copy chunk n of this warp's stream into its ring slot n % STAGES, as the
// 16-byte-aligned span that holds it; commits one group (empty past the
// end), so that every lane's group count follows the chunk count.
template <typename XT>
__device__ __forceinline__ void fetch_chunk(const XT* __restrict__ x,
                                            const Stream& s,
                                            unsigned char* ring, int n,
                                            int warp, int lane) {
  const int grp = blockIdx.x + (n / s.NCH) * gridDim.x;
  const int row = grp * WARPS + warp;
  if (grp < s.groups && row < s.B) {
    const int e0 = (n % s.NCH) * CH;
    const int e1 = min(s.E, e0 + CH);
    const XT* base = x + (size_t)row * s.row_stride;
    const uintptr_t a0 =
        reinterpret_cast<uintptr_t>(base + (size_t)e0 * s.F) & ~(uintptr_t)15;
    const uintptr_t a1 =
        (reinterpret_cast<uintptr_t>(base + (size_t)e1 * s.F) + 15) &
        ~(uintptr_t)15;
    unsigned char* dst = ring + (n % STAGES) * s.stage;
    const int n16 = (int)((a1 - a0) >> 4);
    for (int i = lane; i < n16; i += 32) {
      cp_async16(dst + 16 * i, reinterpret_cast<const void*>(a0 + 16 * i));
    }
  }
  cp_commit();
}

// A tile of the stream: tile t of the rows of the block's group k.
struct Tile {
  int k, t;
};

__device__ __forceinline__ Tile next_tile(Tile a, int T) {
  return a.t + 1 < T ? Tile{a.k, a.t + 1} : Tile{a.k + 1, 0};
}

// The row of this warp in the block's group k.
__device__ __forceinline__ int row_of(int k, int warp) {
  return (blockIdx.x + k * gridDim.x) * WARPS + warp;
}

// The layer-1 A fragment of a tile (FW: 8 or 16, the padded feature
// width): pairs (g, 2q..), (g+8, 2q..), (g, 2q+8..), (g+8, 2q+8..) of the
// tile's 16 entities, zero outside [E, F) and past the last row.  At the
// first tile of a chunk, waits for that chunk and fetches the one two
// ahead into the slot just freed.
template <int FW, typename XT>
__device__ __forceinline__ void build_a(const XT* __restrict__ x,
                                        const Stream& st, unsigned char* ring,
                                        Tile tile, int warp, int lane,
                                        uint32_t (&a)[4]) {
  const int tc = tile.t;
  const int n = tile.k * st.NCH + tc / TPC;
  if (tc % TPC == 0) {
    cp_wait1();
    __syncwarp();
    fetch_chunk(x, st, ring, n + 2, warp, lane);
  }
  const int row = row_of(tile.k, warp);
  const int Er = row < st.B ? st.E : 0;
  const int e0 = (tc / TPC) * CH;
  const XT* base = x + (size_t)min(row, st.B - 1) * st.row_stride;
  const int head = (int)(reinterpret_cast<uintptr_t>(base + (size_t)e0 * st.F)
                         & 15);
  const unsigned char* src = ring + (n % STAGES) * st.stage + head;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = tc * MT + g + (i & 1) * 8;
    const int f = 2 * q + (i >> 1) * 8;
    uint32_t lo = 0u, hi = 0u;
    if (FW == 16 || i < 2) {
      const unsigned char* p =
          src + ((size_t)(e - e0) * st.F + f) * sizeof(XT);
      if (e < Er && f < st.F) lo = bits_of(p, (const XT*)nullptr);
      if (e < Er && f + 1 < st.F) {
        hi = bits_of(p + sizeof(XT), (const XT*)nullptr);
      }
    }
    a[i] = lo | (hi << 16);
  }
}

// LayerNorm and the activation of a finished layer-1 accumulator, rounded
// to bf16 and packed as layer 2's A fragments: k-step kk takes n-tiles 2kk
// (columns 16kk + 2q..) and 2kk + 1 (16kk + 8 + 2q..), rows g then g + 8.
template <int ACT>
__device__ __forceinline__ void layer_norm_act(const Weights& sm,
                                               float (&p)[NT][4], int lane,
                                               uint32_t (&t)[K2][4]) {
  const int q = lane & 3;
  const float2* b1 = reinterpret_cast<const float2*>(sm.p[0]);
  const float2* gg = reinterpret_cast<const float2*>(sm.p[1]);
  const float2* be = reinterpret_cast<const float2*>(sm.p[2]);
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = b1[nt * 4 + q];
    p[nt][0] += b.x; p[nt][1] += b.y; p[nt][2] += b.x; p[nt][3] += b.y;
    s0 += p[nt][0] + p[nt][1];
    s1 += p[nt][2] + p[nt][3];
  }
  const float mu0 = quad_sum(s0) / (float)H, mu1 = quad_sum(s1) / (float)H;
  float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    p[nt][0] -= mu0; p[nt][1] -= mu0; p[nt][2] -= mu1; p[nt][3] -= mu1;
    v0 += p[nt][0] * p[nt][0] + p[nt][1] * p[nt][1];
    v1 += p[nt][2] * p[nt][2] + p[nt][3] * p[nt][3];
  }
  const float r0 = rsqrtf(quad_sum(v0) / (float)H + LN_EPS);
  const float r1 = rsqrtf(quad_sum(v1) / (float)H + LN_EPS);
#pragma unroll
  for (int kk = 0; kk < K2; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nt = 2 * kk + h;
      const float2 gv = gg[nt * 4 + q], bv = be[nt * 4 + q];
      t[kk][2 * h] = pack(activation<ACT>(p[nt][0] * r0 * gv.x + bv.x),
                          activation<ACT>(p[nt][1] * r0 * gv.y + bv.y));
      t[kk][2 * h + 1] = pack(activation<ACT>(p[nt][2] * r1 * gv.x + bv.x),
                              activation<ACT>(p[nt][3] * r1 * gv.y + bv.y));
    }
  }
}

// The lane's running maxima bv / bi of its 16 columns nt*8 + 2q + c (index
// nt*2 + c) over the tile's two entities of the lane, in order: y + b2,
// entities past Er left out.
__device__ __forceinline__ void max_update(const Weights& sm,
                                           const float (&y)[NT][4], int e0,
                                           int Er, int lane,
                                           float (&bv)[2 * NT],
                                           int (&bi)[2 * NT]) {
  const int g = lane >> 2, q = lane & 3;
  const float2* b2 = reinterpret_cast<const float2*>(sm.p[3]);
  const bool ok0 = e0 + g < Er, ok1 = e0 + g + 8 < Er;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = b2[nt * 4 + q];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = nt * 2 + c;
      const float bc = c ? b.y : b.x;
      const float v0 = y[nt][c] + bc, v1 = y[nt][2 + c] + bc;
      const bool u0 = ok0 && v0 > bv[k];
      bi[k] = u0 ? e0 + g : bi[k];
      bv[k] = u0 ? v0 : bv[k];
      const bool u1 = ok1 && v1 > bv[k];
      bi[k] = u1 ? e0 + g + 8 : bi[k];
      bv[k] = u1 ? v1 : bv[k];
    }
  }
}

// The end of a row: combine the 8 lanes (g = 0..7) that hold each column,
// write the row (if it exists) and reset the running maxima.
__device__ __forceinline__ void finish_row(int row, int B, int lane,
                                           float (&bv)[2 * NT],
                                           int (&bi)[2 * NT],
                                           float* __restrict__ out,
                                           int* __restrict__ amax) {
  const int q = lane & 3;
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
#pragma unroll
  for (int k = 0; k < 2 * NT; ++k) {
    bv[k] = -CUDART_INF_F;
    bi[k] = INT_MAX;
  }
}

// A tile is done: its max, and at the last tile of a row the row's output.
__device__ __forceinline__ void finish_tile(const Weights& sm,
                                            const Stream& st, Tile tile,
                                            int warp, int lane,
                                            const float (&y)[NT][4],
                                            float (&bv)[2 * NT],
                                            int (&bi)[2 * NT],
                                            float* __restrict__ out,
                                            int* __restrict__ amax) {
  const int row = row_of(tile.k, warp);
  max_update(sm, y, tile.t * MT, row < st.B ? st.E : 0, lane, bv, bi);
  if (tile.t == st.T - 1) finish_row(row, st.B, lane, bv, bi, out, amax);
}

// XT: x's stored type (float or __nv_bfloat16); FW: 8 or 16, the padded
// feature width
template <int ACT, int FW, typename XT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
embed_pool_fwd_bf16_kernel(const XT* __restrict__ x,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ g,
                           const float* __restrict__ be,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2,
                           float* __restrict__ out, int* __restrict__ amax,
                           int B, int E, int F, long long row_stride,
                           int stage) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Weights& sm = *reinterpret_cast<Weights*>(smem_raw);
  const int tid = threadIdx.x;

  for (int i = tid; i < K2 * 16 * H; i += THREADS) {
    const int kk = i / (16 * H), k = (i / H) % 16, n = i % H;
    sm.w2[kk][core_offset(k, n)] = bf16_bits(w2[(kk * 16 + k) * H + n]);
  }
  for (int i = tid; i < 16 * H; i += THREADS) {
    const int k = i / H, n = i % H;
    sm.w1[core_offset(k, n)] = bf16_bits(k < F ? w1[k * H + n] : 0.0f);
  }
  for (int i = tid; i < H; i += THREADS) {
    sm.p[0][i] = b1[i];
    sm.p[1][i] = g[i];
    sm.p[2][i] = be[i];
    sm.p[3][i] = b2[i];
  }
  // the tensor cores read w1 and w2 through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  Stream st;
  st.B = B;
  st.E = E;
  st.F = F;
  st.T = (E + MT - 1) / MT;
  st.NCH = (E + CH - 1) / CH;
  st.groups = (B + WARPS - 1) / WARPS;
  st.row_stride = row_stride;
  st.stage = stage;
  const int mine = (st.groups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  unsigned char* ring = smem_raw + sizeof(Weights) +
                        (size_t)warp * STAGES * stage;

  float bv[2 * NT];
  int bi[2 * NT];
#pragma unroll
  for (int k = 0; k < 2 * NT; ++k) {
    bv[k] = -CUDART_INF_F;
    bi[k] = INT_MAX;
  }
  // chunks 0 and 1 in flight; the first tile's build_a fetches chunk 2
  fetch_chunk(x, st, ring, 0, warp, lane);
  fetch_chunk(x, st, ring, 1, warp, lane);
  for (Tile cur{0, 0}; cur.k < mine; cur = next_tile(cur, st.T)) {
    uint32_t a[4], t[K2][4];
    float p[NT][4], y[NT][4];
    build_a<FW>(x, st, ring, cur, warp, lane, a);
    pin(a);
    fence();
    wgmma_bf16(p, a, smem_desc(sm.w1), 0);
    commit();
    wait_all();
    pin(p);
    layer_norm_act<ACT>(sm, p, lane, t);
    pin(t);
    fence();
#pragma unroll
    for (int kk = 0; kk < K2; ++kk) {
      wgmma_bf16(y, t[kk], smem_desc(sm.w2[kk]), kk > 0);
    }
    commit();
    wait_all();
    pin(y);
    finish_tile(sm, st, cur, warp, lane, y, bv, bi, out, amax);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int MAX_SMEM = (int)sizeof(Weights) + WARPS * STAGES *
                                                    stage_bytes(FMAX, 4);

// Occupancy of one kernel instance at smem bytes of shared memory, with its
// shared-memory opt-in; kept for the last smem asked.
template <int ACT, int FW, typename XT>
int blocks_per_sm(int smem) {
  static int last_smem = -1, nb = 0;
  if (smem != last_smem) {
    auto kern = embed_pool_fwd_bf16_kernel<ACT, FW, XT>;
    int n = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS,
                                                      smem) != cudaSuccess) {
      return 0;
    }
    last_smem = smem;
    nb = n;
  }
  return nb;
}

template <int ACT, int FW, typename XT>
int launch(const XT* x, const float* w1, const float* b1, const float* g,
           const float* be, const float* w2, const float* b2, float* out,
           int* amax, int B, int E, int F, long long row_stride,
           cudaStream_t s) {
  const int stage = stage_bytes(F, (int)sizeof(XT));
  const int smem = (int)sizeof(Weights) + WARPS * STAGES * stage;
  const int nb = blocks_per_sm<ACT, FW, XT>(smem);
  int dev = 0, sms = 0;
  if (nb < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorLaunchFailure;
  }
  const int groups = (B + WARPS - 1) / WARPS;
  const int grid = groups < nb * sms ? groups : nb * sms;
  embed_pool_fwd_bf16_kernel<ACT, FW, XT><<<grid, THREADS, smem, s>>>(
      x, w1, b1, g, be, w2, b2, out, amax, B, E, F, row_stride, stage);
  return (int)cudaGetLastError();
}

template <typename XT>
int dispatch(const XT* x, const float* w1, const float* b1, const float* g,
             const float* be, const float* w2, const float* b2, float* out,
             int* amax, int B, int E, int F, long long row_stride, int act,
             void* stream) {
  if (F < 1 || F > FMAX || E < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (F <= 8) {
    return act == 0 ? launch<0, 8>(x, w1, b1, g, be, w2, b2, out, amax, B, E,
                                   F, row_stride, s)
                    : launch<1, 8>(x, w1, b1, g, be, w2, b2, out, amax, B, E,
                                   F, row_stride, s);
  }
  return act == 0 ? launch<0, 16>(x, w1, b1, g, be, w2, b2, out, amax, B, E,
                                  F, row_stride, s)
                  : launch<1, 16>(x, w1, b1, g, be, w2, b2, out, amax, B, E,
                                  F, row_stride, s);
}

}  // namespace

// x float32 (x_bf16 = 0) or bf16 (x_bf16 = 1); the products' operands
// rounded to bf16; parameters float32
extern "C" int fused_embed_pool_fwd_bf16(const void* x, const float* w1,
                                         const float* b1, const float* g,
                                         const float* be, const float* w2,
                                         const float* b2, float* out,
                                         int* amax, int B, int E, int F,
                                         long long row_stride, int x_bf16,
                                         int act, void* stream) {
  if (x_bf16) {
    return dispatch(static_cast<const __nv_bfloat16*>(x), w1, b1, g, be, w2,
                    b2, out, amax, B, E, F, row_stride, act, stream);
  }
  return dispatch(static_cast<const float*>(x), w1, b1, g, be, w2, b2, out,
                  amax, B, E, F, row_stride, act, stream);
}
