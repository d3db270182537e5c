// K6: the flat policy observation written straight from the state, for
// the env step and for PPO's remat_obs recompute.
//
// Replace no Pallas kernel.  The JAX package computes the observation
// with jnp code and leaves the fusion to XLA.  Eager PyTorch has no such
// fusion: env_torch.flat_observation_plain is about 200 launches a call
// and holds ~56 KB a row of intermediates (the [.., R] distance lattice,
// the top-K buffers, the gathered road columns, the torch.cat copies).
//
// Two launches (entries road_select and obs_step) over states stacked
// along a leading [T], at up to MAX_TIMES time indices t[i] per launch
// pair: the rows of time index i go to out[i * N + n], n the ego's row in
// flat_observation's order.  The env step's one state is T = 1, t = [0]
// (flat_observation on CUDA, with the partner and road masks); the update
// recomputes all the time steps of a minibatch in one pair (no masks: null
// mask pointers write none).  Roads selected KNEAREST or LINEAR.
//
// Output row [3368] float32, equal bit for bit (the road block but where
// two roads of an ego lie at the same d2, see road_select_kernel below) to
// flat_observation_plain as CUDA PyTorch computes it for the classic spec
// with norm_obs:
//   ego      6 floats: speed, length, width, rel goal x, y, collided
//   partner  127 x 6: speed, rel x, rel y, rel heading, length, width
//            (slot k reads agent k + (k >= a); zero where the slot does not
//            exist, lies beyond the agent bucket or out of the radius)
//   road     200 x 13: rel x, rel y, scale(3), rel heading, one-hot type(7)
// every feature normalised as flat_observation does; a padded ego gets the
// zero rows of each block.
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
// Inputs (contiguous): the states' pos [T, W, A, 2], yaw [T, W, A], vel
// [T, W, A, 2], collided [T, W, A] int32; the scene's agents size [W, A,
// 3], goal [W, A, 2], valid [W, A] bool, aid [W, A] int32, static [W, A]
// bool, num_agents [W] int32; its roads pos [W, R, 3], yaw [W, R], scale
// [W, R, 3], etype [W, R] int32, rid [W, R] int32, valid [W, R] bool; the
// egos.  Constants and time indices come by value: no copy to the device,
// no synchronisation.
//
// Bound: bytes, the rows (and masks) written once (13,472 bytes a row,
// 14,180 with the masks: 232 and 116 MB at the sim cells' 16,384 and 8,192
// rows, 476 MB at the update's minibatch of 8 x 4,416 rows; 0.069, 0.035
// and 0.142 ms at 3.35 TB/s) and the indices written and read once (8
// bytes a selected road, at most 200 an ego).  The states and the scene it
// reads are shared by the egos of a world and stay in L2.  What the plain
// code spends on the [N, R] lattice, its sort and the copies, K6 keeps in
// registers and shared memory.
//   road_select_kernel: the indices of each ego's roads, nearest first
//   with KNEAREST, and their count, written as int32 into the ego's own
//   output row (the count over its first float, the indices over its road
//   block), which obs_step_kernel reads before it writes the row: K6 needs
//   no memory beyond its outputs.
//   One block per world and time index where the egos of a world are
//   consecutive rows (every agent row, or [W, C] slots) and the world's
//   road xy and valid flags fit in shared memory (10,240 roads: 92 KB),
//   staged there; else one warp per row reading the roads from global
//   memory.  One warp per ego computes d2 with the plain expression's
//   rounding (the radius filter and the selection depend on those bits).
//   LINEAR: the first 200 in the radius in index order.  KNEAREST: the
//   plain code takes the 200 least d2 (invalid roads +inf) and then keeps
//   those in the radius, so when at most 200 roads lie in the radius it
//   keeps exactly those, which the first pass collects in index order.
//   When more do, it keeps the 200 least d2 among them.  The first pass
//   also counts them in 256 bins of d2 over [0, radius^2] (the bin a
//   monotone function of d2, so every road of a lower bin is nearer than
//   every road of a higher one); a warp scan finds the bin that holds the
//   200th; a second pass takes the roads of the lower bins and buffers
//   those of that bin, and a rank count over the buffer takes the nearest
//   of them.  A bin of more than BIN_CAP roads takes a radix select over
//   d2's bits instead (four passes of 8 bits).  Then a bitonic sort of the
//   selected roads' (d2, index) keys in registers (32 to 256 slots, the
//   fewest that hold them) puts them in the plain code's order, nearest
//   first (torch.topk's sorted values).  Ties of d2 go to the lower road
//   index; torch.topk breaks them in no stated order, so where two of an
//   ego's roads lie at exactly the same d2 its road rows may come in
//   another order, or, at the 200th place, hold another road of that d2.
//   obs_step_kernel: one warp per row.  The warp builds the ego and
//   partner blocks (lanes over partner slots) in shared memory and writes
//   them as float4, then the roads at the selected indices and the
//   fillers, written as float4; where given, the masks: partner_mask [..,
//   127] int32 (0 partner, 1 static, 2 nonexistent or out of the radius)
//   and road_mask [.., 200] bool (an id of -1: every filler of a padded
//   ego and of LINEAR, none of KNEAREST's all-zero fillers).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (gpudrive_lab_torch/cuda_build.py).  C interface, launched on the caller's
// stream; each entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <cstring>

// A named namespace: the profiler's name of the kernel then carries no
// "(anonymous namespace)::" inside its parameter list, where a reader that
// finds kernels by name would take the wrong part for the name.
namespace k6 {

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
constexpr int MAX_TIMES = 32;                       // time indices a launch

static_assert(HEAD % 4 == 0 && ROAD_BLOCK % 4 == 0 && OBS_DIM % 4 == 0,
              "float4 stores need 16-byte aligned blocks");

// The time indices of one launch, blockIdx.y indexing them.  The kernels
// take it __grid_constant__: indexed in place, where a by-value copy
// indexed at run time would go to every thread's stack.
struct Times {
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

// Road r (an index into the world's roads) seen from the ego, normalised.
__device__ __forceinline__ void put_road_at(float* o, size_t r, float ex,
                                            float ey, float c, float s,
                                            float eyaw,
                                            const float* __restrict__ rpos,
                                            const float* __restrict__ ryaw,
                                            const float* __restrict__ rscale,
                                            const int* __restrict__ retype,
                                            const Norm& nm) {
  const float dx = sub(rpos[3 * r], ex);
  const float dy = sub(rpos[3 * r + 1], ey);
  const float* sc = rscale + 3 * r;
  put_road(o, add(mul(c, dx), mul(s, dy)), add(mul(-s, dx), mul(c, dy)),
           sc[0], sc[1], sc[2], yaw_diff(eyaw, ryaw[r]),
           min(max(retype[r], 0), 6), nm);
}

// The warp writes n4 float4 of its staged block to dst.
__device__ __forceinline__ void flush(const float* buf, float* dst, int n4,
                                      int lane) {
  const float4* s = reinterpret_cast<const float4*>(buf);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int q = lane; q < n4; q += 32) d[q] = s[q];
}

// One ego at one time: st indexes the states' [T, W, A] rows at that
// time, sa the scene's [W, A] rows.
struct Ego {
  bool valid;
  float x, y, yaw, c, s;
  size_t st, sa;
  int a, slots;
};

// The ego and partner blocks of one row into buf (HEAD floats).  Where
// pmask is given, also the row's partner mask as flat_observation_plain
// builds it: 1 where the partner is static and the sum of its six raw
// features is not 0, else 2 where its id is -1 or below (out of the
// radius, nonexistent, a padded ego's), else 0.
__device__ __forceinline__ void put_head(
    float* buf, int* __restrict__ pmask, const Ego& e, int lane,
    const float* __restrict__ pos, const float* __restrict__ yaw,
    const float* __restrict__ vel, const int* __restrict__ collided,
    const float* __restrict__ size, const float* __restrict__ goal,
    const int* __restrict__ aid, const unsigned char* __restrict__ stat,
    const Norm& nm) {
  const size_t st = e.st, sa = e.sa;
  if (lane == 0) {
    float speed = 0.0f, len = 0.0f, wid = 0.0f, gx = 0.0f, gy = 0.0f;
    float hit = 0.0f;
    if (e.valid) {
      speed = norm2(vel[2 * (st + e.a)], vel[2 * (st + e.a) + 1]);
      len = size[3 * (sa + e.a)];
      wid = size[3 * (sa + e.a) + 1];
      const float dx = sub(goal[2 * (sa + e.a)], e.x);
      const float dy = sub(goal[2 * (sa + e.a) + 1], e.y);
      gx = add(mul(e.c, dx), mul(e.s, dy));
      gy = add(mul(-e.s, dx), mul(e.c, dy));
      hit = collided[st + e.a] != 0 ? 1.0f : 0.0f;
    }
    buf[0] = mul(speed, nm.inv_speed);
    buf[1] = mul(mul(len, nm.len_scale), nm.inv_veh_len);
    buf[2] = mul(mul(wid, nm.len_scale), nm.inv_veh_wid);
    buf[3] = minmax(gx, nm.goal_lo, nm.inv_goal);
    buf[4] = minmax(gy, nm.goal_lo, nm.inv_goal);
    buf[5] = hit;
  }

  // partners: lane over slots
  for (int k = lane; k < PARTNERS; k += 32) {
    float speed = 0.0f, x = 0.0f, y = 0.0f, head = 0.0f, len = 0.0f;
    float wid = 0.0f;
    int m = 2;
    if (e.valid && k < e.slots) {
      const int j = k < e.a ? k : k + 1;
      const float dx = sub(pos[2 * (st + j)], e.x);
      const float dy = sub(pos[2 * (st + j) + 1], e.y);
      const float rx = add(mul(e.c, dx), mul(e.s, dy));
      const float ry = add(mul(-e.s, dx), mul(e.c, dy));
      if (norm2(rx, ry) <= nm.radius) {
        speed = norm2(vel[2 * (st + j)], vel[2 * (st + j) + 1]);
        x = rx;
        y = ry;
        head = yaw_diff(e.yaw, yaw[st + j]);
        len = size[3 * (sa + j)];
        wid = size[3 * (sa + j) + 1];
        if (pmask != nullptr) {
          // the plain code's feat_sum, summed left to right; only whether
          // it is 0 counts
          const float fs = add(add(add(add(add(speed, x), y), head), len),
                               wid);
          m = (stat[sa + j] != 0 && fs != 0.0f) ? 1
              : (aid[sa + j] <= -1 ? 2 : 0);
        }
      }
    }
    put_partner(buf + EGO_F + PARTNER_F * k, speed, x, y, head, len, wid, nm);
    if (pmask != nullptr) pmask[k] = m;
  }
}

constexpr int SEL_WARPS = 16;  // egos in flight per block of road_select
constexpr int BINS = 256;      // d2 bins, and the radix select's digits
constexpr int BIN_CAP = 128;   // roads of the 200th's bin ranked in place
constexpr int SCRATCH = BINS * 4;               // bytes per warp
constexpr int MAX_SMEM = 232448;                // a block's limit (H100)
constexpr unsigned FULL = 0xffffffffu;

static_assert(2 * BIN_CAP <= BINS, "the bin buffer reuses the histogram");
static_assert(ROADS_K <= 256, "nearest_first sorts at most 256 roads");

// The egos of a launch, row by row: every agent row (mode 0: row = w *
// per + a), [W, C] slots (mode 1: row = w * per + c, the agent a[row]) or
// flat pairs (mode 2: w[row], a[row]).
struct Egos {
  int mode, per;
  const long long* w;
  const long long* a;
};

__device__ __forceinline__ void ego_of(const Egos& g, long long row, int& w,
                                       int& a) {
  if (g.mode == 2) {
    w = (int)g.w[row];
    a = (int)g.a[row];
  } else {
    w = (int)(row / g.per);
    a = g.mode == 0 ? (int)(row - (long long)w * g.per) : (int)g.a[row];
  }
}

// A world's roads, staged in shared memory or read from global memory.
struct SharedRoads {
  const float2* xy;
  const unsigned char* v;
  __device__ __forceinline__ bool get(int r, float& x, float& y) const {
    const float2 p = xy[r];
    x = p.x;
    y = p.y;
    return v[r] != 0;
  }
};
struct GlobalRoads {
  const float* pos;  // the world's [R, 3]
  const unsigned char* v;
  __device__ __forceinline__ bool get(int r, float& x, float& y) const {
    x = pos[3 * r];
    y = pos[3 * r + 1];
    return v[r] != 0;
  }
};

// Road r in the radius, and its d2 as the plain code rounds it:
// (delta * delta).sum(-1) of delta = road - ego.
template <class Roads>
__device__ __forceinline__ bool near(const Roads& rd, int r, int R, float ex,
                                     float ey, float radius2, float& d2) {
  d2 = 0.0f;
  if (r >= R) return false;
  float x, y;
  const bool ok = rd.get(r, x, y);
  const float dx = sub(x, ex);
  const float dy = sub(y, ey);
  d2 = add(mul(dx, dx), mul(dy, dy));
  return ok && d2 <= radius2;
}

// The d2 bin: a non-decreasing function of d2 >= 0 (NaN, from 0 * inf at
// radius 0, goes to the last bin like every other d2 then).
__device__ __forceinline__ int bin_of(float d2, float scale) {
  return (int)fminf(mul(d2, scale), (float)(BINS - 1));
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The bin of counts hist[BINS] (per warp) holding the kk-th item (1-based,
// kk <= the total), and in *below the count of the bins before it.
__device__ int warp_find(const int* hist, int kk, int lane, int* below) {
  const int per = BINS / 32;
  int s = 0;
#pragma unroll
  for (int q = 0; q < per; ++q) s += hist[lane * per + q];
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - s;
  const unsigned hit = __ballot_sync(FULL, excl < kk && kk <= incl);
  const int owner = __ffs(hit) - 1;
  int bin = 0, acc = excl;
  if (lane == owner) {
    for (int q = 0; q < per; ++q) {
      const int h = hist[lane * per + q];
      if (acc + h >= kk) {
        bin = lane * per + q;
        break;
      }
      acc += h;
    }
  }
  *below = __shfl_sync(FULL, acc, owner);
  return __shfl_sync(FULL, bin, owner);
}

// out[0, n), the indices of n <= 2^LOG selected roads, put in the plain
// code's order: by d2, nearest first, ties to the lower index.  Each
// road's key is its d2's bits (d2 >= 0, so the bits order as the values)
// over its index; a bitonic network sorts 2^LOG keys, slot j * 32 + lane in
// the lane's register j, the free slots after every road.
template <int LOG, class Roads>
__device__ void sort_nearest(const Roads& rd, int R, float ex, float ey,
                             const Norm& nm, int* out, int n, int lane) {
  constexpr int PER = (1 << LOG) / 32;
  unsigned long long key[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = j * 32 + lane;
    key[j] = ~0ull;
    if (s < n) {
      const int r = out[s];
      float d2;
      near(rd, r, R, ex, ey, nm.radius2, d2);
      key[j] = ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)r;
    }
  }
  // stage (lk, lm): runs of 2^lk keys merged at distance m = 2^lm; every
  // loop has a constant trip count, so unrolled, key[] stays in registers
#pragma unroll
  for (int lk = 1; lk <= LOG; ++lk) {
#pragma unroll
    for (int lm = LOG - 1; lm >= 0; --lm) {
      if (lm >= lk) continue;
      const int k = 1 << lk, m = 1 << lm;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const bool up = ((j * 32 + lane) & k) == 0;
        if (m >= 32) {  // the partner slot is this lane's register jp
          const int jp = j ^ (m >> 5);
          if (jp > j) {
            const unsigned long long a = key[j], b = key[jp];
            const bool swap = up ? a > b : a < b;
            key[j] = swap ? b : a;
            key[jp] = swap ? a : b;
          }
        } else {  // the partner slot is lane ^ m's register j
          const unsigned long long o = __shfl_xor_sync(FULL, key[j], m);
          const bool low = ((lane & m) == 0) == up;
          key[j] = low ? (o < key[j] ? o : key[j])
                       : (o > key[j] ? o : key[j]);
        }
      }
    }
  }
  __syncwarp();  // every lane has read out[]
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (j * 32 + lane < n) out[j * 32 + lane] = (int)(unsigned)key[j];
}

// out[0, n), n <= ROADS_K, nearest first (sort_nearest over the fewest
// slots that hold them).
template <class Roads>
__device__ void nearest_first(const Roads& rd, int R, float ex, float ey,
                              const Norm& nm, int* out, int n, int lane) {
  __syncwarp();  // out[] as the other lanes wrote it
  if (n <= 32)
    sort_nearest<5>(rd, R, ex, ey, nm, out, n, lane);
  else if (n <= 64)
    sort_nearest<6>(rd, R, ex, ey, nm, out, n, lane);
  else if (n <= 128)
    sort_nearest<7>(rd, R, ex, ey, nm, out, n, lane);
  else
    sort_nearest<8>(rd, R, ex, ey, nm, out, n, lane);
}

// One ego's road selection by one warp: out[0, count) the indices (nearest
// first with KNEAREST), count written to *count.  scratch: BINS ints of the
// warp's shared memory.
template <class Roads>
__device__ void select_roads(const Roads& rd, int R, float ex, float ey,
                             bool knn, const Norm& nm, float scale,
                             int* out, int* count, int* scratch, int lane) {
  const unsigned lt = lanes_below(lane);
  if (knn) {
    for (int q = lane; q < BINS; q += 32) scratch[q] = 0;
    __syncwarp();
  }
  // pass 1: the first ROADS_K in the radius in index order; with KNEAREST
  // also all of them, counted by bin
  int total = 0;
  for (int base = 0; base < R; base += 32) {
    if (!knn && total >= ROADS_K) break;  // uniform across the warp
    float d2;
    const bool in = near(rd, base + lane, R, ex, ey, nm.radius2, d2);
    const unsigned m = __ballot_sync(FULL, in);
    const int slot = total + __popc(m & lt);
    if (in && slot < ROADS_K) out[slot] = base + lane;
    if (knn && in) atomicAdd(&scratch[bin_of(d2, scale)], 1);
    total += __popc(m);
  }
  if (!knn || total <= ROADS_K) {
    if (knn) nearest_first(rd, R, ex, ey, nm, out, total, lane);
    if (lane == 0) *count = min(total, ROADS_K);
    return;
  }
  // more than ROADS_K in the radius: the ROADS_K nearest of them
  __syncwarp();
  int below;
  const int b = warp_find(scratch, ROADS_K, lane, &below);
  const int in_b = scratch[b];
  const int need = ROADS_K - below;
  __syncwarp();
  if (in_b <= BIN_CAP) {
    // pass 2: the lower bins' roads straight to out, bin b's to a buffer
    float* key = reinterpret_cast<float*>(scratch);
    int* idx = scratch + BIN_CAP;
    int c = 0, t = 0;
    for (int base = 0; base < R; base += 32) {
      float d2;
      const bool in = near(rd, base + lane, R, ex, ey, nm.radius2, d2);
      const int bin = in ? bin_of(d2, scale) : BINS;
      const unsigned ml = __ballot_sync(FULL, bin < b);
      const unsigned me = __ballot_sync(FULL, bin == b);
      if (bin < b) out[c + __popc(ml & lt)] = base + lane;
      if (bin == b) {
        const int p = t + __popc(me & lt);
        key[p] = d2;
        idx[p] = base + lane;
      }
      c += __popc(ml);
      t += __popc(me);
    }
    __syncwarp();
    // bin b's roads in index order: rank by (d2, index), keep the need
    // first
    for (int e = lane; e < t; e += 32) {
      const float ke = key[e];
      int rank = 0;
      for (int f = 0; f < t; ++f) {
        const float kf = key[f];
        rank += (kf < ke) || (kf == ke && f < e);
      }
      if (rank < need) out[below + rank] = idx[e];
    }
  } else {
    // radix select: T, the bits of the ROADS_K-th least d2 (d2 >= 0, so
    // the bits order as the values), and kk, how many of d2 == T to take
    unsigned prefix = 0;
    int kk = ROADS_K;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int q = lane; q < BINS; q += 32) scratch[q] = 0;
      __syncwarp();
      const unsigned high = shift == 24 ? 0u : FULL << (shift + 8);
      for (int base = 0; base < R; base += 32) {
        float d2;
        const bool in = near(rd, base + lane, R, ex, ey, nm.radius2, d2);
        const unsigned k = __float_as_uint(d2);
        if (in && (k & high) == prefix)
          atomicAdd(&scratch[(k >> shift) & (BINS - 1)], 1);
      }
      __syncwarp();
      int under;
      const int d = warp_find(scratch, kk, lane, &under);
      kk -= under;
      prefix |= (unsigned)d << shift;
      __syncwarp();
    }
    int c = 0, eq = 0;
    for (int base = 0; base < R; base += 32) {
      float d2;
      const bool in = near(rd, base + lane, R, ex, ey, nm.radius2, d2);
      const unsigned k = __float_as_uint(d2);
      const unsigned me = __ballot_sync(FULL, in && k == prefix);
      const bool take = in && (k < prefix ||
                               (k == prefix && eq + __popc(me & lt) < kk));
      const unsigned mt = __ballot_sync(FULL, take);
      if (take) out[c + __popc(mt & lt)] = base + lane;
      c += __popc(mt);
      eq += __popc(me);
    }
  }
  nearest_first(rd, R, ex, ey, nm, out, ROADS_K, lane);
  if (lane == 0) *count = ROADS_K;
}

// Where row's selection goes in the output rows, seen as int32: its count
// over the row's first float, its indices over the road block.
__device__ __forceinline__ int* sel_count(int* rows, long long row) {
  return rows + row * OBS_DIM;
}
__device__ __forceinline__ int* sel_idx(int* rows, long long row) {
  return rows + row * OBS_DIM + HEAD;
}

// Both kernels: blockIdx.y the time index i, output rows i * N + n.
//
// STAGED: one block per world (the egos of world blockIdx.x are the rows
// [w * per, (w + 1) * per)), its roads in shared memory.  Else one warp
// per row.  Dynamic shared memory: SEL_WARPS * SCRATCH bytes, then (STAGED)
// the roads' xy [R] float2 and valid flags [R].
template <bool STAGED>
__global__ void __launch_bounds__(SEL_WARPS * 32)
road_select_kernel(int* rows, const float* __restrict__ pos,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ rpos,
                   const unsigned char* __restrict__ rvalid, Egos egos, int N,
                   int W, int A, int R, int knn,
                   const __grid_constant__ Times times, Norm nm,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* scratch = reinterpret_cast<int*>(smem) + warp * BINS;
  const long long first = (long long)blockIdx.y * N;  // the time's rows
  const size_t st = (size_t)times.t[blockIdx.y] * W * A;
  if (STAGED) {
    const int w = blockIdx.x;
    float2* xy = reinterpret_cast<float2*>(smem + SEL_WARPS * SCRATCH);
    unsigned char* v = reinterpret_cast<unsigned char*>(xy + R);
    const size_t sr = (size_t)w * R;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      xy[r] = make_float2(rpos[3 * (sr + r)], rpos[3 * (sr + r) + 1]);
      v[r] = rvalid[sr + r];
    }
    __syncthreads();
    const SharedRoads rd{xy, v};
    for (int e = warp; e < egos.per; e += SEL_WARPS) {
      const long long n = (long long)w * egos.per + e;
      const int a = egos.mode == 0 ? e : (int)egos.a[n];
      const size_t s = (size_t)w * A + a;
      if (valid[s] == 0) {
        if (lane == 0) *sel_count(rows, first + n) = 0;
        continue;
      }
      select_roads(rd, R, pos[2 * (st + s)], pos[2 * (st + s) + 1], knn != 0,
                   nm, scale, sel_idx(rows, first + n),
                   sel_count(rows, first + n), scratch, lane);
    }
  } else {
    const long long n = (long long)blockIdx.x * SEL_WARPS + warp;
    if (n >= N) return;  // the whole warp
    int w, a;
    ego_of(egos, n, w, a);
    const size_t s = (size_t)w * A + a;
    if (valid[s] == 0) {
      if (lane == 0) *sel_count(rows, first + n) = 0;
      return;
    }
    const GlobalRoads rd{rpos + 3 * (size_t)w * R, rvalid + (size_t)w * R};
    select_roads(rd, R, pos[2 * (st + s)], pos[2 * (st + s) + 1], knn != 0,
                 nm, scale, sel_idx(rows, first + n),
                 sel_count(rows, first + n), scratch, lane);
  }
}

// pmask and rmask may be null: then no masks are written.
__global__ void __launch_bounds__(WARPS * 32)
obs_step_kernel(float* out, int* __restrict__ pmask,
                unsigned char* __restrict__ rmask,
                const float* __restrict__ pos, const float* __restrict__ yaw,
                const float* __restrict__ vel,
                const int* __restrict__ collided,
                const float* __restrict__ size, const float* __restrict__ goal,
                const unsigned char* __restrict__ valid,
                const int* __restrict__ aid,
                const unsigned char* __restrict__ stat,
                const int* __restrict__ num_agents,
                const float* __restrict__ rpos, const float* __restrict__ ryaw,
                const float* __restrict__ rscale,
                const int* __restrict__ retype, const int* __restrict__ rid,
                Egos egos, int N, int W, int A, int R, int knn,
                const __grid_constant__ Times times, Norm nm) {
  __shared__ __align__(16) float stage[WARPS][ROAD_BLOCK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = (long long)blockIdx.x * WARPS + warp;
  if (n >= N) return;  // the whole warp
  const long long row = (long long)blockIdx.y * N + n;
  float* buf = stage[warp];
  int w;
  Ego e;
  ego_of(egos, n, w, e.a);
  e.sa = (size_t)w * A;
  e.st = ((size_t)times.t[blockIdx.y] * W + w) * A;
  e.valid = valid[e.sa + e.a] != 0;
  e.x = pos[2 * (e.st + e.a)];
  e.y = pos[2 * (e.st + e.a) + 1];
  e.yaw = yaw[e.st + e.a];
  e.c = cosf(e.yaw);
  e.s = sinf(e.yaw);
  e.slots = min(A - 1, num_agents[w] - 1);
  float* dst = out + row * OBS_DIM;
  // road_select_kernel's count and indices, read before the row is written
  int* rows = reinterpret_cast<int*>(out);
  const int cnt = e.valid ? *sel_count(rows, row) : 0;
  const int* idx = sel_idx(rows, row);

  put_head(buf, pmask == nullptr ? nullptr : pmask + row * PARTNERS, e, lane,
           pos, yaw, vel, collided, size, goal, aid, stat, nm);
  __syncwarp();
  flush(buf, dst, HEAD / 4, lane);
  __syncwarp();

  // roads at the selected indices, then the fillers: KNEAREST's are
  // all-zero rows (id 0), LINEAR's and a padded ego's MapObservation::zero
  // (id -1); both normalise to the same features
  const size_t sr = (size_t)w * R;
  const bool filler_id = !(knn && e.valid);
  for (int slot = lane; slot < ROADS_K; slot += 32) {
    bool id_neg = filler_id;
    if (slot < cnt) {
      const size_t r = sr + idx[slot];
      put_road_at(buf + ROAD_F * slot, r, e.x, e.y, e.c, e.s, e.yaw, rpos,
                  ryaw, rscale, retype, nm);
      if (rmask != nullptr) id_neg = rid[r] == -1;
    } else {
      put_road(buf + ROAD_F * slot, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0,
               nm);
    }
    if (rmask != nullptr) rmask[row * ROADS_K + slot] = id_neg ? 1 : 0;
  }
  __syncwarp();
  flush(buf, dst + HEAD, ROAD_BLOCK / 4, lane);
}

// The launches of one entry: the time indices times[0, n_times) in chunks
// of MAX_TIMES, each chunk's rows after the previous chunk's.
template <class Launch>
int each_chunk(const int* times, int n_times, Launch launch) {
  for (int first = 0; first < n_times; first += MAX_TIMES) {
    Times tt;
    const int n = n_times - first < MAX_TIMES ? n_times - first : MAX_TIMES;
    for (int q = 0; q < n; ++q) tt.t[q] = times[first + q];
    launch(first, n, tt);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

Norm norm_of(const float* norm) {
  static_assert(sizeof(Norm) == 15 * sizeof(float), "Norm is 15 floats");
  Norm nm;
  memcpy(&nm, norm, sizeof(Norm));
  return nm;
}

}  // namespace k6

// K6's first launch: each row's road indices and their count, written into
// out [n_times * N, 3368] (k6::sel_idx, k6::sel_count).  pos, valid: the
// states [T, W, A, 2] and the scene's [W, A]; mode, per, w_idx, a_idx: the
// egos (k6::Egos; unused pointers may be null); times: n_times host ints
// in [0, T); norm: the 15 floats of Norm in its order.  One block per
// world and time where mode < 2 and the world's roads fit in shared
// memory, else one warp per row.
extern "C" int road_select(float* out, const float* pos,
                           const unsigned char* valid, const float* rpos,
                           const unsigned char* rvalid, const long long* w_idx,
                           const long long* a_idx, int mode, int per, int N,
                           int W, int A, int R, int knn, const int* times,
                           int n_times, const float* norm, void* stream) {
  using namespace k6;
  const Norm nm = norm_of(norm);
  const Egos g{mode, per, w_idx, a_idx};
  const float scale = (float)BINS / nm.radius2;
  const size_t scratch = (size_t)SEL_WARPS * SCRATCH;
  const size_t staged = scratch + (size_t)R * 9;  // xy float2 + valid byte
  cudaStream_t s = (cudaStream_t)stream;
  int* rows = reinterpret_cast<int*>(out);
  if (mode < 2 && staged <= (size_t)MAX_SMEM) {
    // above 48 KB only after this opt-in, once per device
    static bool opted[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !opted[dev]) {
      e = cudaFuncSetAttribute(road_select_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) opted[dev] = true;
    }
    return each_chunk(times, n_times, [&](int first, int n, Times tt) {
      road_select_kernel<true><<<dim3(W, n), SEL_WARPS * 32, staged, s>>>(
          rows + (size_t)first * N * OBS_DIM, pos, valid, rpos, rvalid, g, N,
          W, A, R, knn, tt, nm, scale);
    });
  }
  const unsigned blocks = (unsigned)((N + SEL_WARPS - 1) / SEL_WARPS);
  return each_chunk(times, n_times, [&](int first, int n, Times tt) {
    road_select_kernel<false><<<dim3(blocks, n), SEL_WARPS * 32, scratch, s>>>(
        rows + (size_t)first * N * OBS_DIM, pos, valid, rpos, rvalid, g, N, W,
        A, R, knn, tt, nm, scale);
  });
}

// K6's second launch: out [n_times * N, 3368] float32 from the selection
// road_select left in out, and where pmask and rmask are not null, the
// masks pmask [n_times * N, 127] int32 and rmask [n_times * N, 200] bool.
// The states are stacked as road_select reads them, the times the same.
extern "C" int obs_step(float* out, int* pmask, unsigned char* rmask,
                        const float* pos,
                        const float* yaw, const float* vel,
                        const int* collided, const float* size,
                        const float* goal, const unsigned char* valid,
                        const int* aid, const unsigned char* stat,
                        const int* num_agents, const float* rpos,
                        const float* ryaw, const float* rscale,
                        const int* retype, const int* rid,
                        const long long* w_idx, const long long* a_idx,
                        int mode, int per, int N, int W, int A, int R,
                        int knn, const int* times, int n_times,
                        const float* norm, void* stream) {
  using namespace k6;
  const Norm nm = norm_of(norm);
  const Egos g{mode, per, w_idx, a_idx};
  const unsigned blocks = (unsigned)((N + WARPS - 1) / WARPS);
  return each_chunk(times, n_times, [&](int first, int n, Times tt) {
    const size_t r0 = (size_t)first * N;
    obs_step_kernel<<<dim3(blocks, n), WARPS * 32, 0, (cudaStream_t)stream>>>(
        out + r0 * OBS_DIM, pmask == nullptr ? nullptr : pmask + r0 * PARTNERS,
        rmask == nullptr ? nullptr : rmask + r0 * ROADS_K, pos, yaw, vel,
        collided, size, goal, valid, aid, stat, num_agents, rpos, ryaw,
        rscale, retype, rid, g, N, W, A, R, knn, tt, nm);
  });
}
