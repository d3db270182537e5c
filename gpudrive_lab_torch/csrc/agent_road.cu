// Agent-road narrow phase: kernels K1 (tile-skip) and K2 (dense).
//
// Both evaluate, for every (agent, road segment) pair, the closed-form
// separating-axis test of two oriented boxes with the collision-pair
// whitelist, and OR the hits per agent.  Layouts (float32):
//   agents [W, A, 8]       px, py, cos, sin, half0, half1, active, is_vehicle
//   roads  [W, 8, R]       px, py, cos, sin, half0, half1, allow_veh, allow_other
//   tiles  [W, T, 8, RT]   the same eight rows per tile of RT segments
//   mask   [W, A/16, T]    int32, tile t reachable from agent block ab
// Output [W, A] float32, 1.0 where some allowed road box overlaps.
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

constexpr int AGENT_F = 8;
constexpr int ROAD_F = 8;
// K2: roads staged through shared memory in chunks of this many segments.
constexpr int ROAD_CHUNK = 256;
// K2: agents per block (one thread per agent).
constexpr int DENSE_THREADS = 128;
// K1: agents per block (core/kernels.py AGENT_BLOCK) and threads per agent.
constexpr int AGENT_BLOCK = 16;
constexpr int LANES = 16;

struct Agent {
  float px, py, ca, sa, a0, a1, active, is_veh;
};

__device__ __forceinline__ Agent load_agent(const float* __restrict__ p) {
  Agent a;
  a.px = p[0]; a.py = p[1]; a.ca = p[2]; a.sa = p[3];
  a.a0 = p[4]; a.a1 = p[5]; a.active = p[6]; a.is_veh = p[7];
  return a;
}

// One pair: 1.0 if the boxes overlap and the pair is allowed, else 0.0.
// Same expressions, in the same order, as core/kernels.py _sat_hits.
__device__ __forceinline__ float sat_hit(const Agent& a, float rx, float ry,
                                         float cb, float sb, float b0,
                                         float b1, float allow_veh,
                                         float allow_other) {
  float dx_w = rx - a.px;
  float dy_w = ry - a.py;
  float ac = fabsf(cb * a.ca + sb * a.sa);
  float asn = fabsf(sb * a.ca - cb * a.sa);
  float dxa = a.ca * dx_w + a.sa * dy_w;
  float dya = -a.sa * dx_w + a.ca * dy_w;
  float exb = cb * dx_w + sb * dy_w;
  float eyb = -sb * dx_w + cb * dy_w;
  bool sep = (fabsf(dxa) > a.a0 + b0 * ac + b1 * asn) |
             (fabsf(dya) > a.a1 + b0 * asn + b1 * ac) |
             (fabsf(exb) > b0 + a.a0 * ac + a.a1 * asn) |
             (fabsf(eyb) > b1 + a.a0 * asn + a.a1 * ac);
  float allowed = a.is_veh > 0.5f ? allow_veh : allow_other;
  return (sep ? 0.0f : 1.0f) * allowed * a.active;
}

// K2: grid (W, ceil(A / DENSE_THREADS)), one thread per agent.  The block
// streams its world's roads through shared memory in chunks; every thread
// reads the same segment at once (a broadcast).  Any R: the last chunk is
// masked.
__global__ void ar_dense_kernel(const float* __restrict__ agents,
                                const float* __restrict__ roads,
                                float* __restrict__ out, int A, int R) {
  __shared__ float rs[ROAD_F][ROAD_CHUNK];
  const int w = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = i < A;
  Agent a = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live) a = load_agent(agents + ((size_t)w * A + i) * AGENT_F);
  const float* rw = roads + (size_t)w * ROAD_F * R;
  float acc = 0.0f;
  for (int r0 = 0; r0 < R; r0 += ROAD_CHUNK) {
    const int n = min(ROAD_CHUNK, R - r0);
    for (int k = threadIdx.x; k < ROAD_F * ROAD_CHUNK; k += blockDim.x) {
      const int f = k / ROAD_CHUNK;
      const int j = k - f * ROAD_CHUNK;
      rs[f][j] = j < n ? rw[(size_t)f * R + r0 + j] : 0.0f;
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        acc = fmaxf(acc, sat_hit(a, rs[0][j], rs[1][j], rs[2][j], rs[3][j],
                                 rs[4][j], rs[5][j], rs[6][j], rs[7][j]));
      }
    }
    __syncthreads();
  }
  if (live) out[(size_t)w * A + i] = acc;
}

// K1: grid (W, A / AGENT_BLOCK), AGENT_BLOCK * LANES threads.  Thread
// (agent q, lane l) tests segments l, l + LANES, ... of each live tile.
// The whole block reads the same mask entry, so a dead tile is skipped by
// every thread together (no divergence, no load of its segments).
__global__ void ar_tiled_kernel(const float* __restrict__ agents,
                                const float* __restrict__ tiles,
                                const int* __restrict__ mask,
                                float* __restrict__ out, int A, int T,
                                int RT) {
  extern __shared__ float ts[];  // [ROAD_F][RT]
  const int w = blockIdx.x;
  const int ab = blockIdx.y;
  const int q = threadIdx.x / LANES;
  const int lane = threadIdx.x - q * LANES;
  const int i = ab * AGENT_BLOCK + q;
  const Agent a = load_agent(agents + ((size_t)w * A + i) * AGENT_F);
  const int* mrow = mask + ((size_t)w * (A / AGENT_BLOCK) + ab) * T;
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    if (mrow[t] <= 0) continue;
    const float* tile = tiles + ((size_t)w * T + t) * ROAD_F * RT;
    for (int k = threadIdx.x; k < ROAD_F * RT; k += blockDim.x) ts[k] = tile[k];
    __syncthreads();
    for (int j = lane; j < RT; j += LANES) {
      acc = fmaxf(acc, sat_hit(a, ts[j], ts[RT + j], ts[2 * RT + j],
                               ts[3 * RT + j], ts[4 * RT + j], ts[5 * RT + j],
                               ts[6 * RT + j], ts[7 * RT + j]));
    }
    __syncthreads();
  }
  // OR over the agent's LANES threads: consecutive lanes of one warp.
  for (int off = LANES / 2; off > 0; off >>= 1) {
    acc = fmaxf(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) out[(size_t)w * A + i] = acc;
}

}  // namespace

extern "C" int agent_road_hits_dense(const float* agents, const float* roads,
                                     float* out, int W, int A, int R,
                                     void* stream) {
  dim3 grid(W, (A + DENSE_THREADS - 1) / DENSE_THREADS);
  ar_dense_kernel<<<grid, DENSE_THREADS, 0, (cudaStream_t)stream>>>(
      agents, roads, out, A, R);
  return (int)cudaGetLastError();
}

extern "C" int agent_road_hits_tiled(const float* agents, const float* tiles,
                                     const int* mask, float* out, int W, int A,
                                     int T, int RT, void* stream) {
  dim3 grid(W, A / AGENT_BLOCK);
  size_t smem = (size_t)ROAD_F * RT * sizeof(float);
  ar_tiled_kernel<<<grid, AGENT_BLOCK * LANES, smem, (cudaStream_t)stream>>>(
      agents, tiles, mask, out, A, T, RT);
  return (int)cudaGetLastError();
}
