"""Kernels K5 and K6: the flat policy observation straight from the state.

Neither replaces a Pallas kernel: the JAX package leaves this computation
to XLA's fusion.  Eager PyTorch makes about 200 launches for one
``flat_observation_plain`` and holds about 56 KB a row of intermediates.
Both kernels live in ``csrc/flat_obs.cu`` and write each row once, bit for
bit as CUDA PyTorch computes ``flat_observation_plain``
(``env/observation.py``), K6's road block but where two roads of an ego
lie at exactly the same distance.

K5, ``flat_obs_rows``: PPO's ``remat_obs`` update recomputes each
minibatch's observations from the states the rollout stored.
``flat_obs_rows`` writes the rows of all the minibatch's time steps,
``[len(t_idx) * N, 3368]``, row ``i * N + n`` the observation of ego ``n``
at time ``t_idx[i]``, in one launch; on CPU tensors it runs the plain
version, ``flat_obs_rows_plain``: one ``flat_observation_plain`` per time
step, its rows written into the output.  K5 covers the specs of
``supports``: those of ``step_supports`` with roads selected LINEAR (the
first 200 in the radius); PPO keeps the plain version for every other
spec.  ``flat_obs_rows.launches`` counts K5's launches.

K6, ``flat_obs_step``: ``env_torch.flat_observation`` of one state on CUDA
tensors, for the specs of ``step_supports`` (the classic ego, partner and
road blocks, normalised, not reward-conditioned, roads KNEAREST or
LINEAR), in two launches: ``road_select`` writes the indices of each
ego's roads, nearest first with KNEAREST as ``torch.topk`` sorts them,
and their count into the ego's output row (span ``obs.road``), then
``obs_step_kernel`` the rows over them, the partner mask and the road mask
(span ``obs``).  On CPU tensors it runs the plain version,
``flat_observation_plain``.  ``flat_obs_step.launches`` counts K6's launch
pairs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import typing

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
MAX_TIMES = 32  # time steps per launch (csrc/flat_obs.cu)


def step_supports(spec: ObsSpec, params: Params) -> bool:
    """Whether K6 computes ``flat_observation`` for this spec and these
    params: ego, partner and road blocks on, normalised, not
    reward-conditioned, roads selected KNEAREST or LINEAR."""
    return bool(spec.ego_state and spec.partner_obs and spec.road_map_obs
                and spec.norm_obs and not spec.reward_conditioned
                and params.road_obs_algorithm in (RoadObsAlgorithm.KNEAREST,
                                                  RoadObsAlgorithm.LINEAR))


def supports(spec: ObsSpec, params: Params) -> bool:
    """Whether K5 computes ``flat_observation`` for this spec and these
    params: those of ``step_supports`` with roads selected LINEAR."""
    return (step_supports(spec, params)
            and params.road_obs_algorithm == RoadObsAlgorithm.LINEAR)


def state_at(states: SimState, t: int) -> SimState:
    """The state at time ``t`` of states stacked along a leading [T]."""
    return SimState(**{f.name: getattr(states, f.name)[t]
                       for f in dataclasses.fields(SimState)})


def flat_obs_rows_plain(scene: Scene, states: SimState, t_idx, ego_idx,
                        params: Params, spec: ObsSpec,
                        reward_weights: torch.Tensor) -> torch.Tensor:
    """Plain version of K5, for any spec: ``flat_observation_plain`` at each
    time of ``t_idx``, its rows written into one [len(t_idx) * N, D]
    tensor."""
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


def ego_pairs(ego_idx, W: int, A: int, device) -> tuple:
    """The ego selection as flat (w_idx [N], a_idx [N]) int64 pairs in the
    row order of ``flat_observation``'s output: all agent rows (None), the
    [W, C] per-world slots, or the flat pairs themselves."""
    if isinstance(ego_idx, tuple):
        w, a = ego_idx
        return (w.to(torch.int64).contiguous(),
                a.to(torch.int64).contiguous())
    if ego_idx is None:
        a = torch.arange(A, device=device).repeat(W)
        return torch.arange(W, device=device).repeat_interleave(A), a
    C_ = ego_idx.shape[1]
    return (torch.arange(W, device=device).repeat_interleave(C_),
            ego_idx.reshape(-1).to(torch.int64).contiguous())


def _norm(params: Params):
    """K5's and K6's Norm: each constant as CUDA PyTorch applies the Python
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
        lib.flat_obs_rows.argtypes = [p] * 16 + [i] * 4 + [p, i, p, p]
        lib.road_select.argtypes = [p] * 7 + [i] * 7 + [p, p]
        lib.obs_step.argtypes = [p] * 20 + [i] * 6 + [p, p]
        for f in (lib.flat_obs_rows, lib.road_select, lib.obs_step):
            f.restype = i
        lib._argtypes_set = True
    return lib


def _input(t: torch.Tensor, name: str, dtype) -> torch.Tensor:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    return t.contiguous()


def flat_obs_rows(scene: Scene, states: SimState, t_idx, ego_idx,
                  params: Params, spec: ObsSpec,
                  reward_weights: torch.Tensor) -> torch.Tensor:
    """K5.  ``states``: SimStates stacked along a leading [T]; ``t_idx``:
    host ints; ``ego_idx``: None, [W, C] slots or flat (w_idx, a_idx)
    pairs, as ``flat_observation`` takes them.  Returns
    [len(t_idx) * N, 3368] float32.  CPU tensors take the plain version; a
    CUDA tensor launches K5 (one launch per 32 time steps) or raises."""
    t_idx = [int(t) for t in t_idx]
    dev = states.pos.device
    if dev.type == "cpu" and scene.agents.valid.device.type == "cpu":
        return flat_obs_rows_plain(scene, states, t_idx, ego_idx, params,
                                   spec, reward_weights)
    if dev.type != "cuda" or scene.agents.valid.device != dev:
        raise ValueError(f"states on {dev}, scene on "
                         f"{scene.agents.valid.device}: both must be on one "
                         "CUDA device (or both on the CPU)")
    if not supports(spec, params):
        raise ValueError("K5 computes the classic normalised observation "
                         "with LINEAR roads only; use flat_obs_rows_plain")
    T, W, A = states.yaw.shape
    if A > C.MAX_AGENTS:
        raise ValueError(f"agent bucket {A} above {C.MAX_AGENTS}")
    if any(not 0 <= t < T for t in t_idx):
        raise IndexError(f"time indices {t_idx} outside [0, {T})")
    agents, roads = scene.agents, scene.roads
    R = roads.valid.shape[1]
    w_idx, a_idx = ego_pairs(ego_idx, W, A, dev)
    N = w_idx.numel()
    with span("obs"):
        out = torch.empty((len(t_idx) * N, OBS_DIM), dtype=torch.float32,
                          device=dev)
        if out.numel() == 0:
            return out
        f32, i32, b = torch.float32, torch.int32, torch.bool
        ins = [
            _input(states.pos, "pos", f32), _input(states.yaw, "yaw", f32),
            _input(states.vel, "vel", f32),
            _input(states.collided, "collided", i32),
            _input(agents.size, "agents.size", f32),
            _input(agents.goal, "agents.goal", f32),
            _input(agents.valid, "agents.valid", b),
            _input(scene.num_agents, "num_agents", i32),
            _input(roads.pos, "roads.pos", f32),
            _input(roads.yaw, "roads.yaw", f32),
            _input(roads.scale, "roads.scale", f32),
            _input(roads.etype, "roads.etype", i32),
            _input(roads.valid, "roads.valid", b), w_idx, a_idx,
        ]
        if any(x.device != dev for x in ins):
            raise ValueError("K5's inputs must share one CUDA device")
        times = (ctypes.c_int * len(t_idx))(*t_idx)
        status = _lib().flat_obs_rows(
            out.data_ptr(), *(x.data_ptr() for x in ins), N, W, A, R,
            times, len(t_idx), _norm(params),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(status, "flat_obs_rows")
    flat_obs_rows.launches += -(-len(t_idx) // MAX_TIMES)
    return out


flat_obs_rows.launches = 0


# ---- K6 -------------------------------------------------------------------

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


def _step_inputs(scene: Scene, state: SimState) -> list:
    """K6's state and scene inputs, checked and contiguous: ``obs_step``'s
    from pos to rid in its order, then roads.valid."""
    dev = state.pos.device
    if dev.type != "cuda" or scene.agents.valid.device != dev:
        raise ValueError(f"state on {dev}, scene on "
                         f"{scene.agents.valid.device}: both must be on one "
                         "CUDA device (or both on the CPU)")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    agents, roads = scene.agents, scene.roads
    ins = [
        _input(state.pos, "pos", f32), _input(state.yaw, "yaw", f32),
        _input(state.vel, "vel", f32),
        _input(state.collided, "collided", i32),
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


def _on_cpu(scene: Scene, state: SimState) -> bool:
    return (state.pos.device.type == "cpu"
            and scene.agents.valid.device.type == "cpu")


class _Launch(typing.NamedTuple):
    """What both of K6's launches take: the checked inputs
    (``_step_inputs``), the egos (``_egos``), the sizes, the road
    selection (1 KNEAREST, 0 LINEAR), the Norm and the stream."""

    ins: list
    egos: tuple
    N: int
    W: int
    A: int
    R: int
    knn: int
    norm: object
    stream: int


def _launch(scene: Scene, state: SimState, params: Params,
            ego_idx) -> _Launch:
    ins = _step_inputs(scene, state)
    W, A = state.yaw.shape
    if A > C.MAX_AGENTS:
        raise ValueError(f"agent bucket {A} above {C.MAX_AGENTS}")
    egos = _egos(ego_idx, W, A)
    return _Launch(ins, egos, int(np.prod(egos[4])), W, A,
                   scene.roads.valid.shape[1],
                   int(params.road_obs_algorithm == RoadObsAlgorithm.KNEAREST),
                   _norm(params),
                   torch.cuda.current_stream(state.pos.device).cuda_stream)


def _select(k: _Launch, obs: torch.Tensor) -> None:
    """K6's first launch: each row's road indices and their count into
    ``obs``, where the second launch reads them."""
    mode, per, w, a, _ = k.egos
    status = _lib().road_select(
        obs.data_ptr(), k.ins[0].data_ptr(), k.ins[6].data_ptr(),
        k.ins[10].data_ptr(), k.ins[15].data_ptr(), _ptr(w), _ptr(a), mode,
        per, k.N, k.W, k.A, k.R, k.knn, k.norm, k.stream)
    cuda_build.check(status, "road_select")


def flat_obs_step(scene: Scene, state: SimState, params: Params,
                  spec: ObsSpec, ego_idx=None) -> tuple:
    """K6: ``flat_observation(scene, state, params, spec, _, ego_idx)``'s
    (obs [.., 3368] float32, partner_mask [.., 127] int32, road_mask
    [.., 200] bool) for a spec of ``step_supports``; the leading axes
    [W, A], [W, C] or [N] as ``ego_idx`` is None, [W, C] slots or flat
    (w_idx, a_idx) pairs.  CPU tensors take the plain version; a CUDA
    tensor launches K6 (two launches) or raises."""
    if not step_supports(spec, params):
        raise ValueError("K6 computes the classic normalised observation "
                         "with KNEAREST or LINEAR roads only; use "
                         "flat_observation_plain")
    if _on_cpu(scene, state):
        return flat_observation_plain(scene, state, params, spec, None,
                                      ego_idx)
    k = _launch(scene, state, params, ego_idx)
    mode, per, w, a, lead = k.egos
    dev = state.pos.device
    with span("obs"):
        obs = torch.empty(lead + (OBS_DIM,), dtype=torch.float32, device=dev)
        pmask = torch.empty(lead + (C.MAX_AGENTS - 1,), dtype=torch.int32,
                            device=dev)
        rmask = torch.empty(lead + (C.MAX_AGENT_MAP_OBS,), dtype=torch.bool,
                            device=dev)
        if k.N == 0:
            return obs, pmask, rmask
        with span("obs.road"):
            _select(k, obs)
        status = _lib().obs_step(
            obs.data_ptr(), pmask.data_ptr(), rmask.data_ptr(),
            *(x.data_ptr() for x in k.ins[:-1]), _ptr(w), _ptr(a), mode, per,
            k.N, k.A, k.R, k.knn, k.norm, k.stream)
    cuda_build.check(status, "obs_step")
    flat_obs_step.launches += 1
    return obs, pmask, rmask


flat_obs_step.launches = 0
