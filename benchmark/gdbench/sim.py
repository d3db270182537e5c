"""The simulator driver: the port's headline bench step over a batch of
worlds with random discrete actions.

Set-up compiles the traffic's scenes with the port's ``build_scene``,
builds what ``gpudrive_lab_torch.bench.bench_step`` needs and steps past
one episode's reset.  The window then drives ``bench_step`` (step,
observation, reset of finished worlds by select) with action indices
drawn on the device from ``--seed``, one CUDA event after each step and no
synchronize inside the window.

Correctness: a few runs of ``CHAIN`` consecutive window steps are drawn
from the seed, one of them across the step where every episode ends.  Of
each step the window keeps the state ``bench_step`` was given, the action
indices and the state it returned; after the window, the port's
observation of each returned state is computed by its documented entry,
``env_torch.flat_observation``.  Once the program is freed, the plain
reference compiles the same scenes itself, starts each run from the
program's state before its first step and follows it from its own state:
the step, the reset select and the observation, each compared with the
program's; the numbers compared are the widest gaps.  The start, the
compiled scene and the reset state, is compared by itself.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import common, trace as tracemod, window
from .common import log
from .reference import constants as RC
from .reference import env_obs as rob
from .reference import step as rstep
from .reference import types as rtypes

EPISODE = RC.EPISODE_LEN
CHAIN = 3  # consecutive steps of each checked run


def _to_ref_state(d: dict, device) -> rtypes.SimState:
    return rtypes.SimState(**{k: v.to(device) for k, v in d.items()})


def sample_chains(seed: int, n_est: int, n: int, warm: int) -> list:
    """First window steps of ``n`` runs of ``CHAIN`` consecutive steps
    below ``n_est``, drawn from ``seed``, none overlapping: where the
    window holds an episode, one run from the step before the one after
    which every episode begun at reset ends (so its last step starts from
    the reset state), the rest at random."""
    rng = np.random.default_rng(seed)
    n_est = max(n_est, 3 * n * CHAIN)
    starts = []
    ends = [e for e in range(EPISODE - warm % EPISODE - 1, n_est - 1,
                             EPISODE) if e >= 1]
    if ends:
        starts.append(int(rng.choice(ends)) - 1)
    free = [s for s in range(0, n_est - CHAIN + 1, CHAIN)
            if all(abs(s - t) >= CHAIN for t in starts)]
    picks = rng.choice(len(free), n - len(starts), replace=False)
    return sorted(starts + [free[int(i)] for i in picks])


def run(cell, seed: int, seconds: float, traced: bool, clock,
        device: torch.device | None = None) -> common.RunResult:
    """One run of ``cell`` on ``device`` (by default the first card);
    ``clock()`` gives the seconds since the process began (set-up is read
    from it)."""
    from gpudrive_lab_torch import bench
    from gpudrive_lab_torch.core import step as stepmod
    from gpudrive_lab_torch.env import env_torch
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.scene.compiler import build_scene

    device = device or common.first_card()
    cfg, traffic = cell.config, cell.traffic
    parts = {"import_and_init_s": clock()}
    env = cfg["env"]
    ec = EnvConfig(**env)
    params = ec.sim_params()
    paths = common.scene_paths(traffic["scenes"])
    t = clock()
    scene = build_scene(paths, params, max_agents=ec.agent_bucket,
                        device=device)
    common.sync(device)
    parts["scene_compile_s"] = clock() - t
    t = clock()
    W, A = scene.agents.valid.shape
    table = bench.action_table(ec, device)
    weights = torch.zeros((W, A, 3), dtype=torch.float32, device=device)
    fresh = stepmod.reset(scene, None, params)
    spec = env_torch.ObsSpec()
    agents = int(scene.num_agents.sum())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def one(state, acc):
        idx = torch.randint(0, table.shape[0], (W, A), generator=gen,
                            device=device)
        new, acc = bench.bench_step(scene, fresh, table, weights, state,
                                    idx, acc, params, spec)
        return new, acc, idx

    state = fresh
    acc = torch.zeros((), dtype=torch.float32, device=device)
    warm = int(traffic["warmup_steps"])
    timed_from = warm // 2
    for i in range(warm):
        if i == timed_from:
            common.sync(device)
            t_half = time.perf_counter()
        state, acc, _ = one(state, acc)
    common.sync(device)
    step_s = (time.perf_counter() - t_half) / (warm - timed_from)
    parts["warmup_s"] = clock() - t

    starts = sample_chains(seed, int(0.5 * seconds / step_s),
                           int(traffic["check_steps"]), warm)
    keep = {s + i for s in starts for i in range(CHAIN)}
    cuda = device.type == "cuda"
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(int(2 * seconds / step_s) + 64)] if cuda else []
    start_ev = torch.cuda.Event(enable_timing=True) if cuda else None
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    setup_s = clock()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window -------------------------------------------------------
    kept, n = {}, 0
    common.sync(device)
    if cuda:
        start_ev.record()
    t0 = time.perf_counter()
    while True:
        before = state
        state, acc, idx = one(state, acc)
        if n in keep:
            kept[n] = (before, idx, state)
        if cuda:
            if n == len(events):
                events.append(torch.cuda.Event(enable_timing=True))
            events[n].record()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    elapsed = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        stamps = [0.0] + [start_ev.elapsed_time(e) for e in events[:n]]
        step_ms = window.intervals(stamps)
    else:
        step_ms = [1e3 * elapsed / n]
    e2e = {"setup_s": setup_s,
           "agent_steps_per_s": window.rate(agents * n, elapsed),
           "step_ms_p95": window.percentile(step_ms, 95),
           "peak_mem_gib": window_peak / common.GIB}
    log(f"window: {n} steps in {elapsed:.4f} s, {agents} agents, "
        f"{len(kept)} steps kept for the check, acc {float(acc):.6g}")

    # ---- the traced stretch (--trace 1) -----------------------------------
    summary, traced_states = None, []
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        t_trace = float(traffic["trace_seconds"])
        with profile(activities=acts) as prof:
            with record_function(tracemod.WINDOW):
                t1 = time.perf_counter()
                while time.perf_counter() - t1 < t_trace:
                    with record_function("gdbench.bench_step"):
                        state, acc, _ = one(state, acc)
                    traced_states.append(state)
                common.sync(device)
        summary = tracemod.summarize_profile(prof)
        traced_states = [common.cpu_state(s) for s in traced_states]

    # ---- what the check needs, then the program is freed ------------------
    chains = []
    for s in starts:
        chain = []
        for i in range(s, s + CHAIN):
            if i not in kept:  # the window closed before this step
                break
            before, idx, after = kept[i]
            chain.append((common.cpu_state(before), idx.cpu(),
                          common.cpu_state(after),
                          env_torch.flat_observation(
                              scene, after, params, spec, weights)[0].cpu()))
        if chain:
            chains.append(chain)
    prog_scene = common.scene_arrays(scene)
    prog_fresh = common.cpu_state(fresh)
    del scene, fresh, state, table, weights, one, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, ctx = check(cell, paths, chains, prog_scene, prog_fresh, device,
                        traced_states)
    ctx.update(setup=parts, trace=summary, steps_traced=len(traced_states),
               driver="sim")
    return common.RunResult(
        attempted=n, failed=0, end_to_end=e2e, checks=checks,
        memory_peak_bytes=max(setup_peak, window_peak), setup_parts=parts,
        device=device, trace=summary, ctx=ctx)


def reference_setup(cell, paths, device):
    """The reference's scene, params, reset state and action table."""
    rparams = rob.params_from_env(cell.config["env"])
    workers = int(cell.traffic.get("reference_workers", 0))
    rscene = common.compile_scenes_reference(paths, rparams, device, workers)
    return rscene, rparams, rstep.reset(rscene, None, rparams), \
        rob.classic_action_table(device)


def reference_step(rscene, rparams, rfresh, rtable, before, idx):
    """The reference's bench step: (state after the step and the reset
    select, observation of that state, worlds reset)."""
    W, A = idx.shape
    act = torch.zeros((W, A, RC.ACTION_DIM), dtype=torch.float32,
                      device=idx.device)
    act[..., :3] = rtable[idx.long()]
    s1 = rstep.step(rscene, before, act, rparams)
    done = ((s1.done != 0) | ~rscene.agents.valid).all(dim=1)
    s2 = rstep.select_worlds(done, rfresh, s1)
    obs = rob.flat_observation(
        rscene, s2, rparams, rob.ObsSpec(),
        torch.zeros((W, A, 3), dtype=torch.float32, device=idx.device))[0]
    return s2, obs, done


def compare_obs(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of two flat observations [W, A, D]: ego and partner
    blocks entry by entry, the road block as a set of rows per agent."""
    K, F = RC.MAX_AGENT_MAP_OBS, RC.ROAD_GRAPH_FEAT_DIM
    head = common.max_abs(prog[..., :-K * F], ref[..., :-K * F].cpu())
    return max(head, common.set_gap(prog[..., -K * F:].reshape(-1, K, F),
                                    ref[..., -K * F:].reshape(-1, K, F)))


def check(cell, paths, chains, prog_scene, prog_fresh, device,
          traced_states) -> tuple:
    """The numbers ``correct`` compares, each with its limit, and what
    the metric readers need of the reference."""
    t = time.perf_counter()
    rscene, rparams, rfresh, rtable = reference_setup(cell, paths, device)
    start_gap, start_flags = common.compare_start(prog_scene, prog_fresh,
                                                  rscene, rfresh)
    state_gap, flags, obs_gap, resets, steps = 0.0, 0, 0.0, 0, 0
    for chain in chains:
        # from the program's state before the run's first step, then from
        # the reference's own
        ref = _to_ref_state(chain[0][0], device)
        for _, idx, after, obs in chain:
            ref, robs, done = reference_step(rscene, rparams, rfresh, rtable,
                                             ref, idx.to(device))
            g, f = common.compare_states(after, ref)
            state_gap, flags = max(state_gap, g), flags + f
            obs_gap = max(obs_gap, compare_obs(obs, robs))
            resets += int(done.sum())
            steps += 1
    lim = cell.limits
    checks = {
        "start_gap": (start_gap, lim["start_gap"]),
        "start_flags": (float(start_flags), lim["start_flags"]),
        "state_gap": (state_gap, lim["state_gap"]),
        "state_flags": (float(flags), lim["state_flags"]),
        "obs_gap": (obs_gap, lim["obs_gap"]),
        "steps_unchecked": (float(not chains), 0.0),
    }
    log(f"check: {steps} steps in {len(chains)} runs, {resets} worlds reset "
        f"among them, reference {time.perf_counter() - t:.2f} s")
    return checks, {"reference_scene": rscene, "reference_params": rparams,
                    "traced_states": [_to_ref_state(s, device)
                                      for s in traced_states],
                    "device": device}


def control(cell, device, seed: int):
    """The control of this driver's cells (``gdbench/control.py``)."""
    from .control import sim_control

    return sim_control(cell, device)


def faults() -> dict:
    """The faults this driver's cells can have (``gdbench/faults.py``)."""
    from .faults import SIM

    return SIM
