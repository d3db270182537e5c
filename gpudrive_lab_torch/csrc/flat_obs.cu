// K5: the flat policy observation of PPO's remat_obs recompute.
//
// Replaces no Pallas kernel.  The JAX package recomputes each minibatch's
// observations from the stored pre-step states with the same jnp code as
// the rollout and leaves the fusion to XLA.  Eager PyTorch has no such
// fusion: env_torch.flat_observation is about 200 launches, and PPO's
// update called it once per time step of every minibatch, so the recompute
// made about half of an iteration's launches and held ~56 KB a row of
// intermediates.  This kernel writes the rows of all the time steps of a
// minibatch in one launch, straight from the stored states, with no
// intermediate in device memory.
//
// Output out[n_times * N, 3368] float32: row i * N + n is the observation
// of ego (w_idx[n], a_idx[n]) in the state at time times[i], equal bit for
// bit to flat_observation(scene, state_t, ...)[0][n] as CUDA PyTorch
// computes it for the classic spec with norm_obs and the LINEAR road
// selection:
//   ego      6 floats: speed, length, width, rel goal x, y, collided
//   partner  127 x 6: speed, rel x, rel y, rel heading, length, width
//            (slot k reads agent k + (k >= a); zero where the slot does not
//            exist, lies beyond the agent bucket or out of the radius)
//   road     200 x 13: rel x, rel y, scale(3), rel heading, one-hot type(7)
//            (the first 200 in-radius roads in index order, then
//            MapObservation::zero() fillers)
// every feature normalised as flat_observation does; a padded ego gets the
// zero rows of each block.
//
// Inputs (contiguous): the stacked states pos [T, W, A, 2], yaw [T, W, A],
// vel [T, W, A, 2], collided [T, W, A] int32; the scene's agents size
// [W, A, 3], goal [W, A, 2], valid [W, A] bool, num_agents [W] int32; its
// roads pos [W, R, 3], yaw [W, R], scale [W, R, 3], etype [W, R] int32,
// valid [W, R] bool; the ego pairs w_idx, a_idx [N] int64.  The time
// indices and the normalisation constants come by value: no copy to the
// device, no synchronisation.
//
// Exactness.  Every product, sum and difference is written with the _rn
// intrinsics, which the compiler never contracts into an FMA, in the order
// of the plain expressions (core/geometry.py, core/observations.py,
// env/env_torch.py); sinf, cosf, atan2f and sqrtf are the functions
// PyTorch's CUDA kernels call, built with the same default flags.  A
// division by a Python scalar is, in CUDA PyTorch, a product with the
// float reciprocal, so the wrapper passes reciprocals computed as PyTorch
// computes them (env/flat_obs_kernel.py, _norm).
//
// Bound: bytes.  Each row is 13,472 bytes written once; the states and the
// scene it reads are shared by the egos of a world and by the time steps
// and stay in L2.  At the update's minibatch (8 x 4,416 rows) that is
// 476 MB, 0.142 ms at 3.35 TB/s.  Design: one warp per row.  The warp
// builds the ego and partner blocks (lanes over partner slots) in shared
// memory and writes them as float4, then scans the world's roads 32 at a
// time, placing each in-radius road at its slot by a ballot prefix count,
// stops at 200, fills the rest, and writes the road block as float4.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (gpudrive_lab_torch/cuda_build.py).  C interface, launched on the caller's
// stream; the entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <cstring>

// A named namespace: the profiler's name of the kernel then carries no
// "(anonymous namespace)::" inside its parameter list, where a reader that
// finds kernels by name would take the wrong part for the name.
namespace k5 {

constexpr int OBS_DIM = 3368;
constexpr int EGO_F = 6;
constexpr int PARTNERS = 127;
constexpr int PARTNER_F = 6;
constexpr int ROADS_K = 200;
constexpr int ROAD_F = 13;
constexpr int ROAD_TYPES = 7;
constexpr int HEAD = EGO_F + PARTNERS * PARTNER_F;  // 768 floats
constexpr int ROAD_BLOCK = ROADS_K * ROAD_F;        // 2600 floats
constexpr int WARPS = 4;                            // rows per block
constexpr int MAX_TIMES = 32;                       // time steps per launch

static_assert(HEAD % 4 == 0 && ROAD_BLOCK % 4 == 0 && OBS_DIM % 4 == 0,
              "float4 stores need 16-byte aligned blocks");

// The time indices of one launch.
struct Times {
  int n;
  int t[MAX_TIMES];
};

// The normalisation constants, each rounded as PyTorch rounds the Python
// scalar it stands for; inv_* are float reciprocals of divisors.
struct Norm {
  float len_scale;      // VEHICLE_LENGTH_SCALE
  float inv_speed;      // 1 / MAX_SPEED
  float inv_veh_len;    // 1 / MAX_VEH_LEN
  float inv_veh_wid;    // 1 / MAX_VEH_WIDTH
  float goal_lo;        // MIN_REL_GOAL_COORD
  float inv_goal;       // 1 / (MAX_REL_GOAL_COORD - MIN_REL_GOAL_COORD)
  float agent_lo;       // MIN_REL_AGENT_POS
  float inv_agent;      // 1 / (MAX_REL_AGENT_POS - MIN_REL_AGENT_POS)
  float rg_lo;          // MIN_RG_COORD
  float inv_rg;         // 1 / (MAX_RG_COORD - MIN_RG_COORD)
  float inv_orient;     // 1 / MAX_ORIENTATION_RAD
  float inv_seg_len;    // 1 / MAX_ROAD_LINE_SEGMENT_LEN
  float inv_road_scale; // 1 / MAX_ROAD_SCALE
  float radius;         // observation_radius
  float radius2;        // observation_radius ** 2
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// _minmax: 2 * ((x - lo) / (hi - lo)) - 1, the division a product with
// the reciprocal.
__device__ __forceinline__ float minmax(float x, float lo, float inv) {
  return sub(mul(2.0f, mul(sub(x, lo), inv)), 1.0f);
}

// vec_norm: sqrt(x * x + y * y).
__device__ __forceinline__ float norm2(float x, float y) {
  return sqrtf(add(mul(x, x), mul(y, y)));
}

// quat_yaw_diff(a, b): atan2(sin(b - a), cos(b - a)).
__device__ __forceinline__ float yaw_diff(float a, float b) {
  const float d = sub(b, a);
  return atan2f(sinf(d), cosf(d));
}

// The partner block's six features of one slot, normalised; zeros in,
// the normalised zero slot out.
__device__ __forceinline__ void put_partner(float* o, float speed, float x,
                                            float y, float head, float len,
                                            float wid, const Norm& nm) {
  o[0] = mul(speed, nm.inv_speed);
  o[1] = minmax(x, nm.agent_lo, nm.inv_agent);
  o[2] = minmax(y, nm.agent_lo, nm.inv_agent);
  o[3] = mul(head, nm.inv_orient);
  o[4] = mul(mul(len, nm.len_scale), nm.inv_veh_len);
  o[5] = mul(mul(wid, nm.len_scale), nm.inv_veh_wid);
}

// The road block's thirteen features of one slot, normalised.
__device__ __forceinline__ void put_road(float* o, float x, float y, float d0,
                                         float d1, float d2, float head,
                                         int type, const Norm& nm) {
  o[0] = minmax(x, nm.rg_lo, nm.inv_rg);
  o[1] = minmax(y, nm.rg_lo, nm.inv_rg);
  o[2] = mul(d0, nm.inv_seg_len);
  o[3] = mul(d1, nm.inv_road_scale);
  o[4] = mul(d2, nm.inv_road_scale);
  o[5] = mul(head, nm.inv_orient);
#pragma unroll
  for (int q = 0; q < ROAD_TYPES; ++q) o[6 + q] = q == type ? 1.0f : 0.0f;
}

// The warp writes n4 float4 of its staged block to dst.
__device__ __forceinline__ void flush(const float* buf, float* dst, int n4,
                                      int lane) {
  const float4* s = reinterpret_cast<const float4*>(buf);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int q = lane; q < n4; q += 32) d[q] = s[q];
}

__global__ void __launch_bounds__(WARPS * 32)
flat_obs_kernel(float* __restrict__ out, const float* __restrict__ pos,
                const float* __restrict__ yaw, const float* __restrict__ vel,
                const int* __restrict__ collided,
                const float* __restrict__ size, const float* __restrict__ goal,
                const unsigned char* __restrict__ valid,
                const int* __restrict__ num_agents,
                const float* __restrict__ rpos, const float* __restrict__ ryaw,
                const float* __restrict__ rscale,
                const int* __restrict__ retype,
                const unsigned char* __restrict__ rvalid,
                const long long* __restrict__ w_idx,
                const long long* __restrict__ a_idx, int N, int W, int A,
                int R, Times times, Norm nm) {
  __shared__ __align__(16) float stage[WARPS][ROAD_BLOCK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= (long long)times.n * N) return;  // the whole warp
  float* buf = stage[warp];
  const int i = (int)(row / N);
  const int n = (int)(row - (long long)i * N);
  const int w = (int)w_idx[n];
  const int a = (int)a_idx[n];
  const size_t sa = (size_t)w * A;                         // scene agents
  const size_t st = ((size_t)times.t[i] * W + w) * A;      // states at t
  const bool ego_valid = valid[sa + a] != 0;
  const float ex = pos[2 * (st + a)];
  const float ey = pos[2 * (st + a) + 1];
  const float eyaw = yaw[st + a];
  const float c = cosf(eyaw);
  const float s = sinf(eyaw);
  float* dst = out + row * OBS_DIM;

  // ---- ego ---------------------------------------------------------------
  if (lane == 0) {
    float speed = 0.0f, len = 0.0f, wid = 0.0f, gx = 0.0f, gy = 0.0f;
    float hit = 0.0f;
    if (ego_valid) {
      speed = norm2(vel[2 * (st + a)], vel[2 * (st + a) + 1]);
      len = size[3 * (sa + a)];
      wid = size[3 * (sa + a) + 1];
      const float dx = sub(goal[2 * (sa + a)], ex);
      const float dy = sub(goal[2 * (sa + a) + 1], ey);
      gx = add(mul(c, dx), mul(s, dy));
      gy = add(mul(-s, dx), mul(c, dy));
      hit = collided[st + a] != 0 ? 1.0f : 0.0f;
    }
    buf[0] = mul(speed, nm.inv_speed);
    buf[1] = mul(mul(len, nm.len_scale), nm.inv_veh_len);
    buf[2] = mul(mul(wid, nm.len_scale), nm.inv_veh_wid);
    buf[3] = minmax(gx, nm.goal_lo, nm.inv_goal);
    buf[4] = minmax(gy, nm.goal_lo, nm.inv_goal);
    buf[5] = hit;
  }

  // ---- partners: lane over slots -----------------------------------------
  const int slots = min(A - 1, num_agents[w] - 1);  // existing slots
  for (int k = lane; k < PARTNERS; k += 32) {
    float speed = 0.0f, x = 0.0f, y = 0.0f, head = 0.0f, len = 0.0f;
    float wid = 0.0f;
    if (ego_valid && k < slots) {
      const int j = k < a ? k : k + 1;
      const float dx = sub(pos[2 * (st + j)], ex);
      const float dy = sub(pos[2 * (st + j) + 1], ey);
      const float rx = add(mul(c, dx), mul(s, dy));
      const float ry = add(mul(-s, dx), mul(c, dy));
      if (norm2(rx, ry) <= nm.radius) {
        speed = norm2(vel[2 * (st + j)], vel[2 * (st + j) + 1]);
        x = rx;
        y = ry;
        head = yaw_diff(eyaw, yaw[st + j]);
        len = size[3 * (sa + j)];
        wid = size[3 * (sa + j) + 1];
      }
    }
    put_partner(buf + EGO_F + PARTNER_F * k, speed, x, y, head, len, wid, nm);
  }
  __syncwarp();
  flush(buf, dst, HEAD / 4, lane);
  __syncwarp();

  // ---- roads: the first ROADS_K in-radius roads in index order -------------
  int count = 0;
  if (ego_valid) {
    const size_t sr = (size_t)w * R;
    for (int base = 0; base < R && count < ROADS_K; base += 32) {
      const int r = base + lane;
      bool within = false;
      float dx = 0.0f, dy = 0.0f;
      if (r < R && rvalid[sr + r]) {
        dx = sub(rpos[3 * (sr + r)], ex);
        dy = sub(rpos[3 * (sr + r) + 1], ey);
        within = add(mul(dx, dx), mul(dy, dy)) <= nm.radius2;
      }
      const unsigned m = __ballot_sync(0xffffffffu, within);
      const int slot = count + __popc(m & ((1u << lane) - 1u));
      if (within && slot < ROADS_K) {
        const float* sc = rscale + 3 * (sr + r);
        put_road(buf + ROAD_F * slot, add(mul(c, dx), mul(s, dy)),
                 add(mul(-s, dx), mul(c, dy)), sc[0], sc[1], sc[2],
                 yaw_diff(eyaw, ryaw[sr + r]), min(max(retype[sr + r], 0), 6),
                 nm);
      }
      count += __popc(m);
    }
  }
  for (int slot = min(count, ROADS_K) + lane; slot < ROADS_K; slot += 32)
    put_road(buf + ROAD_F * slot, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0, nm);
  __syncwarp();
  flush(buf, dst + HEAD, ROAD_BLOCK / 4, lane);
}

}  // namespace k5

// norm: the 15 floats of Norm in its order.  times: n_times host ints.
// Launches ceil(n_times / MAX_TIMES) times, each writing its rows of out.
extern "C" int flat_obs_rows(float* out, const float* pos, const float* yaw,
                             const float* vel, const int* collided,
                             const float* size, const float* goal,
                             const unsigned char* valid,
                             const int* num_agents, const float* rpos,
                             const float* ryaw, const float* rscale,
                             const int* retype, const unsigned char* rvalid,
                             const long long* w_idx, const long long* a_idx,
                             int N, int W, int A, int R, const int* times,
                             int n_times, const float* norm, void* stream) {
  static_assert(sizeof(k5::Norm) == 15 * sizeof(float), "Norm is 15 floats");
  k5::Norm nm;
  memcpy(&nm, norm, sizeof(k5::Norm));
  const int per = k5::MAX_TIMES;
  for (int first = 0; first < n_times; first += per) {
    k5::Times tt;
    tt.n = n_times - first < per ? n_times - first : per;
    for (int q = 0; q < tt.n; ++q) tt.t[q] = times[first + q];
    const long long rows = (long long)tt.n * N;
    const unsigned blocks = (unsigned)((rows + k5::WARPS - 1) / k5::WARPS);
    k5::flat_obs_kernel<<<blocks, k5::WARPS * 32, 0, (cudaStream_t)stream>>>(
        out + (size_t)first * N * k5::OBS_DIM, pos, yaw, vel, collided, size,
        goal, valid, num_agents, rpos, ryaw, rscale, retype, rvalid, w_idx,
        a_idx, N, W, A, R, tt, nm);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
