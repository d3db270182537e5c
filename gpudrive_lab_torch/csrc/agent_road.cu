// Agent-road narrow phase: kernels K1 (tile-skip) and K2 (dense).
//
// Both evaluate the closed-form separating-axis test of two oriented boxes
// with the collision-pair whitelist, and take the max of the hits per agent.
// Layouts (float32):
//   agents [W, A, 8]       px, py, cos, sin, half0, half1, active, is_vehicle
//   roads  [W, 8, R]       px, py, cos, sin, half0, half1, allow_veh, allow_other
//   tiles  [W, T, 8, RT]   the same eight rows per tile of RT segments
//   mask   [W, A/16, T]    int32, tile t reachable from agent block ab
// Output [W, A] float32, 1.0 where some allowed road box overlaps.
//
// Only pairs that can hit are tested.  A pair's hit is
// (sep ? 0 : 1) * allowed * active, so an agent with active == 0, or a road
// whose two allow values are both 0, gives +-0 against every partner (NaN
// only where an input is inf or NaN, and fmaxf drops NaN).  Each block
// therefore compacts its world's live agents (active != 0) and collidable
// roads (allow_veh != 0 or allow_other != 0) into shared memory with warp
// ballots, spreads the live-agent x collidable-road pairs over all its
// threads, and combines each agent's hits with atomicMax on the int bits of
// the non-negative float maximum (order-free, so every launch gives the
// same bits).  Every output row is written; rows of skipped agents get +0.0.
// Work is proportional to the pairs that can hit: at the slice's reset state
// 1.1 % of the [W, A, R] lattice.
//
// Exactness: the hits must equal the plain PyTorch versions bit for bit.
// The SAT compares sums of products, so this file is compiled with
// --fmad=false (no a*b+c contraction into FMA) and sat_hit() keeps the plain
// version's operation order; a pair on the boundary then resolves the same
// way in both.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false -shared
// (gpudrive_lab_torch/cuda_build.py).  C interface, launched on the caller's
// stream; every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int ROAD_F = 8;
// K2: threads per block; also the agents and roads compacted per round.
constexpr int THREADS = 256;
// K1: threads per block, and agents per mask row (core/kernels.py
// AGENT_BLOCK).
constexpr int K1_THREADS = 128;
constexpr int AGENT_BLOCK = 16;

// One agent or road segment: its eight feature rows.
struct __align__(16) Box {
  float4 p;  // px, py, cos, sin
  float4 q;  // half0, half1, active | allow_veh, is_vehicle | allow_other
};

// One pair: allowed * active if the boxes overlap, else 0.
// Same expressions, in the same order, as core/kernels.py _sat_hits, so
// each of the four axis tests answers as there.  A pair that the first two
// tests separate returns +0.0 at once (most pairs of a world are far
// apart); _sat_hits gives such a pair +-0, or NaN where allow or active is
// not finite, and either leaves fmaxf's max from +0.0 unchanged.
__device__ __forceinline__ float sat_hit(const Box& a, const Box& b) {
  const float px = a.p.x, py = a.p.y, ca = a.p.z, sa = a.p.w;
  const float a0 = a.q.x, a1 = a.q.y, active = a.q.z, is_veh = a.q.w;
  const float rx = b.p.x, ry = b.p.y, cb = b.p.z, sb = b.p.w;
  const float b0 = b.q.x, b1 = b.q.y, allow_veh = b.q.z, allow_other = b.q.w;
  float dx_w = rx - px;
  float dy_w = ry - py;
  float ac = fabsf(cb * ca + sb * sa);
  float asn = fabsf(sb * ca - cb * sa);
  float dxa = ca * dx_w + sa * dy_w;
  float dya = -sa * dx_w + ca * dy_w;
  if ((fabsf(dxa) > a0 + b0 * ac + b1 * asn) |
      (fabsf(dya) > a1 + b0 * asn + b1 * ac))
    return 0.0f;
  float exb = cb * dx_w + sb * dy_w;
  float eyb = -sb * dx_w + cb * dy_w;
  bool sep = (fabsf(exb) > b0 + a0 * ac + a1 * asn) |
             (fabsf(eyb) > b1 + a0 * asn + a1 * ac);
  float allowed = is_veh > 0.5f ? allow_veh : allow_other;
  return (sep ? 0.0f : 1.0f) * allowed * active;
}

__device__ __forceinline__ bool agent_live(const Box& a) {
  return a.q.z != 0.0f;
}

__device__ __forceinline__ bool road_live(const Box& b) {
  return b.q.z != 0.0f || b.q.w != 0.0f;
}

// Block-wide stream compaction of two predicates at once, in thread order.
// Every thread of the block (NT threads) calls it.  Returns each item's slot
// (or -1) and the block's counts; two barriers.  wb: NT / 16 ints of shared
// scratch.
template <int NT>
__device__ __forceinline__ void compact2(bool p0, bool p1, int* wb, int& s0,
                                         int& s1, int& n0, int& n1) {
  constexpr int WARPS = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m0 = __ballot_sync(0xffffffffu, p0);
  const unsigned m1 = __ballot_sync(0xffffffffu, p1);
  if (lane == 0) {
    wb[warp] = __popc(m0);
    wb[WARPS + warp] = __popc(m1);
  }
  __syncthreads();
  int b0 = 0, b1 = 0;
  n0 = 0;
  n1 = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const int c0 = wb[k], c1 = wb[WARPS + k];
    if (k < warp) {
      b0 += c0;
      b1 += c1;
    }
    n0 += c0;
    n1 += c1;
  }
  __syncthreads();  // wb is reused by the next call
  const unsigned below = (1u << lane) - 1u;
  s0 = p0 ? b0 + __popc(m0 & below) : -1;
  s1 = p1 ? b1 + __popc(m1 & below) : -1;
}

// Tests every (agent, road) pair of the compacted lists and raises each
// agent's flag to its largest hit.  Agent k of the pass is la[sel[k]] (or
// la[k] without sel) and owns flag[fidx[...]].  The pairs are spread over
// the block: G = NT / nA threads per agent, each walking every G-th road,
// so neighbouring threads read the same road (a broadcast).
template <int NT>
__device__ __forceinline__ void test_pairs(const Box* la, const int* sel,
                                           const int* fidx, int nA,
                                           const Box* lr, int nR, int* flag) {
  if (nA == 0 || nR == 0) return;
  const int G = max(1, min(NT / nA, nR));
  for (int v = threadIdx.x; v < nA * G; v += NT) {
    const int k = v % nA;
    const int lane = v / nA;
    const int ai = sel ? sel[k] : k;
    const Box a = la[ai];
    float acc = 0.0f;
    for (int j = lane; j < nR; j += G) acc = fmaxf(acc, sat_hit(a, lr[j]));
    // acc is +0.0, -0.0 or positive: int order is float order for > 0
    if (acc > 0.0f) atomicMax(&flag[fidx[ai]], __float_as_int(acc));
  }
}

__device__ __forceinline__ Box load_agent(const float* __restrict__ p) {
  Box a;
  a.p = make_float4(p[0], p[1], p[2], p[3]);
  a.q = make_float4(p[4], p[5], p[6], p[7]);
  return a;
}

// Road j of a [8, stride] row block.
__device__ __forceinline__ Box load_road(const float* __restrict__ p,
                                         size_t stride) {
  Box b;
  b.p = make_float4(p[0], p[stride], p[2 * stride], p[3 * stride]);
  b.q = make_float4(p[4 * stride], p[5 * stride], p[6 * stride],
                    p[7 * stride]);
  return b;
}

// K2: one block per world.  Agents are taken THREADS at a time (one pass
// for A <= 256); roads stream in chunks of THREADS segments, one per thread,
// the next chunk loaded into registers while the current one is tested.
__global__ void __launch_bounds__(THREADS)
ar_dense_kernel(const float* __restrict__ agents,
                const float* __restrict__ roads, float* __restrict__ out,
                int A, int R) {
  __shared__ Box la[THREADS];   // live agents of the pass
  __shared__ int lslot[THREADS];
  __shared__ int flag[THREADS];
  __shared__ Box lr[THREADS];   // collidable roads of the chunk
  __shared__ int wb[THREADS / 16];
  const int tid = threadIdx.x;
  const int w = blockIdx.x;
  const float* aw = agents + (size_t)w * A * 8;
  const float* rw = roads + (size_t)w * ROAD_F * R;
  float* ow = out + (size_t)w * A;
  const Box zero = {make_float4(0.f, 0.f, 0.f, 0.f),
                    make_float4(0.f, 0.f, 0.f, 0.f)};

  for (int a0 = 0; a0 < A; a0 += THREADS) {
    const int na = min(THREADS, A - a0);
    // this thread's agent and the first chunk's road, loaded together
    const Box ab = tid < na ? load_agent(aw + (size_t)(a0 + tid) * 8) : zero;
    Box next = tid < R ? load_road(rw + tid, R) : zero;
    flag[tid] = 0;
    int sa, nA, s_, n_;
    compact2<THREADS>(tid < na && agent_live(ab), false, wb, sa, s_, nA, n_);
    if (sa >= 0) {
      la[sa] = ab;
      lslot[sa] = tid;
    }
    if (nA > 0) {
      for (int r0 = 0; r0 < R; r0 += THREADS) {
        const Box rb = next;
        int sr, nR;
        compact2<THREADS>(r0 + tid < R && road_live(rb), false, wb, sr, s_,
                          nR, n_);
        if (sr >= 0) lr[sr] = rb;
        __syncthreads();
        if (r0 + THREADS + tid < R)
          next = load_road(rw + r0 + THREADS + tid, R);
        // lr is refilled only after compact2's barriers, which every
        // thread reaches once its pairs are done
        test_pairs<THREADS>(la, nullptr, lslot, nA, lr, nR, flag);
      }
    }
    __syncthreads();
    if (tid < na) ow[a0 + tid] = __int_as_float(flag[tid]);
    __syncthreads();  // la, flag are refilled by the next pass
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Shared memory of K1, in bytes, for A agents, T tiles of RT segments.
// Keep in step with the carve-up at the top of ar_tiled_kernel.
size_t tiled_smem(int A, int T, int RT) {
  return (size_t)2 * ROAD_F * RT * 4  // two tile buffers
         + (size_t)RT * sizeof(Box)   // collidable roads of a tile
         + (size_t)A * sizeof(Box)    // live agents
         + (size_t)A * 4 * 3          // their rows, the tile's selection, flags
         + (size_t)(A / AGENT_BLOCK) * T * 4  // mask rows
         + (size_t)T * 4;             // live tiles
}

// K1: one block per world.  The block reads its world's mask rows, lists
// the live tiles (live for some agent block) and the live agents, then
// walks the live tiles with cp.async double buffering: the next tile is in
// flight while this one's collidable roads are compacted and tested against
// the live agents whose block marks it.  A tile live for several agent
// blocks is staged once.  Every output row is written.
__global__ void __launch_bounds__(K1_THREADS)
ar_tiled_kernel(const float* __restrict__ agents,
                const float* __restrict__ tiles, const int* __restrict__ mask,
                float* __restrict__ out, int A, int T, int RT, int vec16) {
  constexpr int NT = K1_THREADS;
  extern __shared__ float4 smem4[];
  const int AB = A / AGENT_BLOCK;
  float* buf = reinterpret_cast<float*>(smem4);      // [2][8][RT]
  Box* lr = reinterpret_cast<Box*>(buf + 2 * ROAD_F * RT);  // [RT]
  Box* la = lr + RT;                                  // [A]
  int* lidx = reinterpret_cast<int*>(la + A);         // [A]
  int* tsel = lidx + A;                               // [A]
  int* flag = tsel + A;                               // [A]
  int* msk = flag + A;                                // [AB][T]
  int* tl = msk + AB * T;                             // [T]
  __shared__ int wb[NT / 16];

  const int tid = threadIdx.x;
  const int w = blockIdx.x;
  const float* aw = agents + (size_t)w * A * 8;
  const float* tw = tiles + (size_t)w * T * ROAD_F * RT;
  const int* mw = mask + (size_t)w * AB * T;
  const Box zero = {make_float4(0.f, 0.f, 0.f, 0.f),
                    make_float4(0.f, 0.f, 0.f, 0.f)};

  for (int k = tid; k < AB * T; k += NT) msk[k] = mw[k];
  for (int i = tid; i < A; i += NT) flag[i] = 0;
  int nA = 0;
  for (int i0 = 0; i0 < A; i0 += NT) {
    const int i = i0 + tid;
    const Box ab = i < A ? load_agent(aw + (size_t)i * 8) : zero;
    int s, s1, n, n1;
    compact2<NT>(i < A && agent_live(ab), false, wb, s, s1, n, n1);
    if (s >= 0) {
      la[nA + s] = ab;
      lidx[nA + s] = i;
    }
    nA += n;
  }
  __syncthreads();  // msk is complete
  int nT = 0;
  for (int t0 = 0; t0 < T; t0 += NT) {
    const int t = t0 + tid;
    bool live = false;
    if (t < T && nA > 0)
      for (int b = 0; b < AB; ++b) live |= msk[b * T + t] > 0;
    int s, s1, n, n1;
    compact2<NT>(live, false, wb, s, s1, n, n1);
    if (s >= 0) tl[nT + s] = t;
    nT += n;
  }
  __syncthreads();  // tl is complete

  const int tile_f = ROAD_F * RT;
  auto stage = [&](int kk) {
    const float* src = tw + (size_t)tl[kk] * tile_f;
    float* dst = buf + (kk & 1) * tile_f;
    if (vec16) {
      for (int e = tid * 4; e < tile_f; e += NT * 4)
        cp_async16(dst + e, src + e);
    } else {
      for (int e = tid; e < tile_f; e += NT) cp_async4(dst + e, src + e);
    }
  };
  if (nT > 0) stage(0);
  cp_async_commit();
  const int rounds = max(RT, nA);
  for (int kk = 0; kk < nT; ++kk) {
    if (kk + 1 < nT) stage(kk + 1);
    cp_async_commit();
    cp_async_wait_one();  // this thread's copies of the tile have landed
    __syncthreads();      // and every other thread's
    const float* tb = buf + (kk & 1) * tile_f;
    const int t = tl[kk];
    int nR = 0, nS = 0;
    for (int r0 = 0; r0 < rounds; r0 += NT) {
      const int j = r0 + tid;
      Box rb = zero;
      bool pr = false;
      if (j < RT) {
        rb = load_road(tb + j, RT);
        pr = road_live(rb);
      }
      const bool pa = j < nA && msk[(lidx[j] / AGENT_BLOCK) * T + t] > 0;
      int sr, sa, cr, ca;
      compact2<NT>(pr, pa, wb, sr, sa, cr, ca);
      if (sr >= 0) lr[nR + sr] = rb;
      if (sa >= 0) tsel[nS + sa] = j;
      nR += cr;
      nS += ca;
    }
    __syncthreads();  // after it nothing reads this tile's buffer
    // lr and tsel are refilled only after the next compact2's barriers,
    // which every thread reaches once its pairs are done
    test_pairs<NT>(la, tsel, lidx, nS, lr, nR, flag);
  }
  __syncthreads();  // every pair is in the flags
  for (int i = tid; i < A; i += NT)
    out[(size_t)w * A + i] = __int_as_float(flag[i]);
}

}  // namespace

extern "C" int agent_road_hits_dense(const float* agents, const float* roads,
                                     float* out, int W, int A, int R,
                                     void* stream) {
  ar_dense_kernel<<<W, THREADS, 0, (cudaStream_t)stream>>>(agents, roads, out,
                                                           A, R);
  return (int)cudaGetLastError();
}

extern "C" int agent_road_hits_tiled(const float* agents, const float* tiles,
                                     const int* mask, float* out, int W, int A,
                                     int T, int RT, void* stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = tiled_smem(A, T, RT);
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ar_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int vec16 = ((size_t)tiles & 15) == 0;
  ar_tiled_kernel<<<W, K1_THREADS, smem, (cudaStream_t)stream>>>(
      agents, tiles, mask, out, A, T, RT, vec16);
  return (int)cudaGetLastError();
}
