"""Kernel K6: the flat policy observation straight from the state.

It replaces no Pallas kernel: the JAX package leaves this computation to
XLA's fusion.  Eager PyTorch makes about 200 launches for one
``flat_observation_plain`` and holds about 56 KB a row of intermediates.
K6 lives in ``csrc/flat_obs.cu`` and writes each row once, bit for bit as
CUDA PyTorch computes ``flat_observation_plain`` (``env/observation.py``)
but where two roads of an ego lie at exactly the same distance.  It covers
the specs of ``step_supports``: the classic ego, partner and road blocks,
normalised, not reward-conditioned, roads KNEAREST or LINEAR.

Two launches over states stacked along a leading [T], at up to 32 time
indices a pair: ``road_select`` writes the indices of each ego's roads,
nearest first with KNEAREST as ``torch.topk`` sorts them, and their count
into the ego's output row (span ``obs.road``), then ``obs_step_kernel`` the
rows over them (span ``obs``).  ``flat_obs_step.launches`` counts the
launch pairs.  Two callers:

* ``flat_obs_step``: ``env_torch.flat_observation`` of one state (T = 1),
  with the partner mask and the road mask;
* ``flat_obs_rows``: PPO's ``remat_obs`` update recomputes each
  minibatch's observations from the states the rollout stored, all its
  time steps in one launch pair, without masks; row ``i * N + n`` is the
  observation of ego ``n`` at time ``t_idx[i]``.  Where K6 does not apply
  (CPU tensors, another spec) it runs the plain version,
  ``flat_obs_rows_plain``: one ``flat_observation_plain`` per time step.

``env_torch.flat_observation`` and ``flat_obs_rows`` choose, both by
``step_supports``; the kernel wrappers raise on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch import cuda_build
from gpudrive_lab_torch.core.types import (
    Params,
    RoadObsAlgorithm,
    Scene,
    SimState,
)
from gpudrive_lab_torch.env.observation import (
    ObsSpec,
    flat_observation_plain,
)
from gpudrive_lab_torch.utils.profiling import span

# the classic flat row: ego, 127 partner slots, 200 road slots
OBS_DIM = (C.EGO_FEAT_DIM + (C.MAX_AGENTS - 1) * C.PARTNER_FEAT_DIM
           + C.MAX_AGENT_MAP_OBS * C.ROAD_GRAPH_FEAT_DIM)
MAX_TIMES = 32  # time indices a launch pair (csrc/flat_obs.cu)


def step_supports(spec: ObsSpec, params: Params) -> bool:
    """Whether K6 computes the flat observation for this spec and these
    params: ego, partner and road blocks on, normalised, not
    reward-conditioned, roads selected KNEAREST or LINEAR."""
    return bool(spec.ego_state and spec.partner_obs and spec.road_map_obs
                and spec.norm_obs and not spec.reward_conditioned
                and params.road_obs_algorithm in (RoadObsAlgorithm.KNEAREST,
                                                  RoadObsAlgorithm.LINEAR))


def state_at(states: SimState, t: int) -> SimState:
    """The state at time ``t`` of states stacked along a leading [T]."""
    return SimState(**{f.name: getattr(states, f.name)[t]
                       for f in dataclasses.fields(SimState)})


def flat_obs_rows_plain(scene: Scene, states: SimState, t_idx, ego_idx,
                        params: Params, spec: ObsSpec,
                        reward_weights: torch.Tensor) -> torch.Tensor:
    """Plain version of ``flat_obs_rows``, for any spec:
    ``flat_observation_plain`` at each time of ``t_idx``, its rows written
    into one [len(t_idx) * N, D] tensor."""
    out = None
    for i, t in enumerate(t_idx):
        obs = flat_observation_plain(
            scene, state_at(states, t), params, spec, reward_weights,
            ego_idx)[0]
        obs = obs.reshape(-1, obs.shape[-1])
        n = obs.shape[0]
        if out is None:
            out = obs.new_empty((len(t_idx) * n, obs.shape[1]))
        out[i * n:(i + 1) * n] = obs
    return out


def _norm(params: Params):
    """K6's Norm: each constant as CUDA PyTorch applies the Python
    scalar it stands for, cast to float32; a division by a scalar is a
    product with the float32 reciprocal (1 / float32(divisor), computed in
    float32).  One array per observation radius, built once: the C entries
    only read it."""
    return _norm_of(float(params.observation_radius))


@functools.lru_cache(maxsize=None)
def _norm_of(radius: float):
    f = np.float32

    def inv(d):
        return f(1.0) / f(d)

    return (ctypes.c_float * 15)(
        f(C.VEHICLE_LENGTH_SCALE), inv(C.MAX_SPEED), inv(C.MAX_VEH_LEN),
        inv(C.MAX_VEH_WIDTH),
        f(C.MIN_REL_GOAL_COORD),
        inv(C.MAX_REL_GOAL_COORD - C.MIN_REL_GOAL_COORD),
        f(C.MIN_REL_AGENT_POS),
        inv(C.MAX_REL_AGENT_POS - C.MIN_REL_AGENT_POS),
        f(C.MIN_RG_COORD), inv(C.MAX_RG_COORD - C.MIN_RG_COORD),
        inv(C.MAX_ORIENTATION_RAD), inv(C.MAX_ROAD_LINE_SEGMENT_LEN),
        inv(C.MAX_ROAD_SCALE),
        f(radius), f(radius ** 2))


def _lib():
    lib = cuda_build.load("flat_obs")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.road_select.argtypes = [p] * 7 + [i] * 7 + [p, i, p, p]
        lib.obs_step.argtypes = [p] * 20 + [i] * 7 + [p, i, p, p]
        for f in (lib.road_select, lib.obs_step):
            f.restype = i
        lib._argtypes_set = True
    return lib


def _input(t: torch.Tensor, name: str, dtype) -> torch.Tensor:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    return t.contiguous()


def _idx64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64).contiguous()


def _egos(ego_idx, W: int, A: int) -> tuple:
    """K6's ego selection: (mode, per, w_idx, a_idx, lead shape).  Mode 0,
    every agent row (per A); 1, [W, C] slots (per C, a_idx the slots); 2,
    flat (w_idx, a_idx) pairs.  Unused indices are None."""
    if ego_idx is None:
        return 0, A, None, None, (W, A)
    if isinstance(ego_idx, tuple):
        w, a = (_idx64(x) for x in ego_idx)
        return 2, 0, w, a, (w.numel(),)
    return 1, ego_idx.shape[1], None, _idx64(ego_idx), tuple(ego_idx.shape)


def _inputs(scene: Scene, states: SimState) -> list:
    """K6's state and scene inputs, checked and contiguous: ``obs_step``'s
    from pos to rid in its order, then roads.valid."""
    dev = states.pos.device
    if dev.type != "cuda" or scene.agents.valid.device != dev:
        raise ValueError(f"states on {dev}, scene on "
                         f"{scene.agents.valid.device}: K6 needs both on one "
                         "CUDA device")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    agents, roads = scene.agents, scene.roads
    ins = [
        _input(states.pos, "pos", f32), _input(states.yaw, "yaw", f32),
        _input(states.vel, "vel", f32),
        _input(states.collided, "collided", i32),
        _input(agents.size, "agents.size", f32),
        _input(agents.goal, "agents.goal", f32),
        _input(agents.valid, "agents.valid", b),
        _input(agents.aid, "agents.aid", i32),
        _input(agents.static, "agents.static", b),
        _input(scene.num_agents, "num_agents", i32),
        _input(roads.pos, "roads.pos", f32),
        _input(roads.yaw, "roads.yaw", f32),
        _input(roads.scale, "roads.scale", f32),
        _input(roads.etype, "roads.etype", i32),
        _input(roads.rid, "roads.rid", i32),
        _input(roads.valid, "roads.valid", b),
    ]
    if any(x.device != dev for x in ins):
        raise ValueError("K6's inputs must share one CUDA device")
    return ins


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _k6(scene: Scene, states: SimState, t_idx: list, ego_idx,
        params: Params) -> tuple:
    """K6's launch pair (one per 32 time indices) over ``states`` at the
    times ``t_idx``.  States stacked along a leading [T] give (obs
    [len(t_idx) * N, 3368] float32, None, None); one state of [W, A]
    agent rows (T = 1, t_idx [0]) gives ``flat_observation``'s (obs,
    partner_mask, road_mask) with its lead axes.  Raises on CPU
    tensors."""
    ins = _inputs(scene, states)
    one = states.yaw.dim() == 2
    T, W, A = (1, *states.yaw.shape) if one else states.yaw.shape
    if A > C.MAX_AGENTS:
        raise ValueError(f"agent bucket {A} above {C.MAX_AGENTS}")
    if any(not 0 <= t < T for t in t_idx):
        raise IndexError(f"time indices {t_idx} outside [0, {T})")
    mode, per, w, a, lead = _egos(ego_idx, W, A)
    N, n = int(np.prod(lead)), len(t_idx)
    R = scene.roads.valid.shape[1]
    knn = int(params.road_obs_algorithm == RoadObsAlgorithm.KNEAREST)
    norm = _norm(params)
    dev = states.pos.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = lead if one else (n * N,)
    with span("obs"):
        obs = torch.empty(rows + (OBS_DIM,), dtype=torch.float32, device=dev)
        pmask = rmask = None
        if one:
            pmask = torch.empty(rows + (C.MAX_AGENTS - 1,), dtype=torch.int32,
                                device=dev)
            rmask = torch.empty(rows + (C.MAX_AGENT_MAP_OBS,),
                                dtype=torch.bool, device=dev)
        if N == 0 or n == 0:
            return obs, pmask, rmask
        times = (ctypes.c_int * n)(*t_idx)
        with span("obs.road"):
            status = _lib().road_select(
                obs.data_ptr(), ins[0].data_ptr(), ins[6].data_ptr(),
                ins[10].data_ptr(), ins[15].data_ptr(), _ptr(w), _ptr(a),
                mode, per, N, W, A, R, knn, times, n, norm, stream)
        cuda_build.check(status, "road_select")
        status = _lib().obs_step(
            obs.data_ptr(), _ptr(pmask), _ptr(rmask),
            *(x.data_ptr() for x in ins[:-1]), _ptr(w), _ptr(a), mode, per,
            N, W, A, R, knn, times, n, norm, stream)
    cuda_build.check(status, "obs_step")
    flat_obs_step.launches += -(-n // MAX_TIMES)
    return obs, pmask, rmask


def flat_obs_rows(scene: Scene, states: SimState, t_idx, ego_idx,
                  params: Params, spec: ObsSpec,
                  reward_weights: torch.Tensor) -> torch.Tensor:
    """The flat observations at the times ``t_idx`` (host ints) of
    ``states`` (SimStates stacked along a leading [T]) for ``ego_idx``
    (None, [W, C] slots or flat (w_idx, a_idx) pairs, as
    ``flat_observation`` takes them): [len(t_idx) * N, D], row ``i * N +
    n`` ego ``n``'s at ``t_idx[i]``.  K6 on CUDA tensors for the specs of
    ``step_supports``, else ``flat_obs_rows_plain``."""
    t_idx = [int(t) for t in t_idx]
    if states.pos.is_cuda and step_supports(spec, params):
        return _k6(scene, states, t_idx, ego_idx, params)[0]
    return flat_obs_rows_plain(scene, states, t_idx, ego_idx, params, spec,
                               reward_weights)


def flat_obs_step(scene: Scene, state: SimState, params: Params,
                  spec: ObsSpec, ego_idx=None) -> tuple:
    """K6: ``flat_observation(scene, state, params, spec, _, ego_idx)``'s
    (obs [.., 3368] float32, partner_mask [.., 127] int32, road_mask
    [.., 200] bool) for a spec of ``step_supports``, on CUDA tensors; the
    leading axes [W, A], [W, C] or [N] as ``ego_idx`` is None, [W, C]
    slots or flat (w_idx, a_idx) pairs.  Raises for another spec or on
    CPU tensors."""
    if not step_supports(spec, params):
        raise ValueError("K6 computes the classic normalised observation "
                         "with KNEAREST or LINEAR roads only; use "
                         "flat_observation_plain")
    return _k6(scene, state, [0], ego_idx, params)


flat_obs_step.launches = 0
