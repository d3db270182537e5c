"""The VBD driver: episodes of the port's env with diffusion-sampled sim
agents from the released checkpoint's architecture at its full widths.

Set-up compiles the traffic's scenes into a ``GPUDriveTorchEnv`` with the
configuration's env keys (``use_vbd``, ``vbd_in_obs``, the
``distance_to_vdb_trajs`` reward), builds ``OfficialVBD`` at the
configuration's widths with weights drawn from ``--seed`` and an
``OfficialVBDSource`` whose draws come from the same seed, and runs
``warmup_episodes`` whole episodes (the first encode of a process is the
slow one).  An episode is a user's loop with the source: a reset of every
world, ``env.set_vbd_trajectories(source)`` (the sample: the host's
batch, the relations, the encode, every denoise step, the roll-out and the
scatter), then 91 env steps of random actions from the 91-action table,
drawn on the device from the seed, each with the observation (the VBD block
last), the reward and the dones.  The window runs whole episodes for
``--seconds``, one synchronize at each episode's end; ``agent_steps_per_s``
is the created agents x 91 x the episodes over their time, so the sample
is part of every episode's cost.

Correctness: one more episode after the window and the traced stretch, the
program's own objects recorded by wrappers (``Recorder``): the sample
batch's agent ids, the inputs, the encoder's outputs, the denoiser's x_t
and x0 and the scheduler step's x0, x_t, draw and result at
``check_diffusion_steps`` steps drawn from the seed, the final actions,
the installed trajectories, and at ``check_env_steps`` steps drawn from
the seed the state before and after, the actions, the clock, the
observation and the reward.  Once the program is freed, the plain
reference (``reference/vbd_official.py``, with the program's weights
loaded by name) recomputes each in blocks of ``reference_block`` worlds:
the relations from the inputs, the encoder on the program's inputs, the
denoiser on the program's x_t, the scheduler step with the recorded draw,
the roll-out of the final actions scattered to the agent rows; and the sim
reference (``reference/step.py``, ``reference/env_obs.py``) each recorded
env step from the program's state, its observation, and the VBD block and
reward on the installed trajectories.  Each VBD gap is relative to the
reference's largest magnitude; the state and observation gaps are the sim
cells' own.  The start, the compiled scene and the reset state, is
compared by itself.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from . import common, trace as tracemod, window
from .common import log
from .reference import constants as RC
from .reference import env_obs as rob
from .reference import step as rstep
from .reference import vbd_official as RV
from .sim import _to_ref_state, compare_obs

EPISODE = RC.EPISODE_LEN
VBD_OBS = RV.TRAJECTORY_LEN * RV.FEATURES  # the 455 floats last in the obs
# the weighted_combination part of the distance_to_vdb_trajs reward
BASE_REWARD = "weighted_combination"


def model_config(cfg: dict):
    """The program's OfficialVBDConfig of the configuration's ``model``
    block, which holds every field of it; raises where the program's
    fixed widths or its sample batch's sizes are not the configuration's."""
    from gpudrive_lab_torch.vbd import model_official as mo
    from gpudrive_lab_torch.vbd.data_utils import VBDSampleConfig

    m = cfg["model"]
    fields = {f.name for f in dataclasses.fields(mo.OfficialVBDConfig)}
    ocfg = mo.OfficialVBDConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in m.items() if k in fields})
    sample = dict(cfg["sample"], max_agents=ocfg.agents_len)
    program = dataclasses.asdict(VBDSampleConfig(max_agents=ocfg.agents_len))
    if (mo.D_MODEL, mo.FFN) != (m["hidden_dim"], m["ffn_dim"]) or (
            program != sample):
        raise ValueError(f"the program's widths {mo.D_MODEL}, {mo.FFN} and "
                         f"sample batch {program} are not the "
                         f"configuration's {m} and {sample}")
    return ocfg


def counts():
    """(samples, denoise steps) the program's sampler has counted; None
    where it keeps no counts."""
    from gpudrive_lab_torch.vbd import model_official as mo

    f = mo.sample_official
    return getattr(f, "samples", None), getattr(f, "denoise_steps", None)


def count_delta(before, after):
    if None in before or None in after:
        return None
    return tuple(b - a for a, b in zip(before, after))


def draw_steps(seed: int, diffusion_steps: int, n_diffusion: int,
               n_env: int) -> tuple:
    """The diffusion steps and the env steps (of 0..90) the check follows,
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    dsteps = sorted(int(t) for t in rng.choice(diffusion_steps, n_diffusion,
                                               replace=False))
    esteps = sorted(int(k) for k in rng.choice(EPISODE, n_env,
                                               replace=False))
    return dsteps, esteps


class Recorder:
    """Wrappers around the program's calls in one episode (installed on
    entry, removed on exit), keeping on the host what the check compares:
    ``agent_ids``, ``inputs``, ``enc``, ``denoise[t] = (x_t, x0)``,
    ``steps[t] = (x0, x_t, draws, x_{t-1})`` at the drawn diffusion steps
    ``dsteps``, ``actions`` (the sample's final actions) and ``env_steps``
    (filled by the episode)."""

    ENC_KEYS = ("encodings", "relation_encodings", "agents_mask",
                "maps_mask", "traffic_lights_mask")

    def __init__(self, model, scheduler, dsteps):
        self.model, self.scheduler, self.dsteps = model, scheduler, dsteps
        self.agent_ids = self.inputs = self.enc = self.actions = None
        self.denoise, self.steps, self.env_steps = {}, {}, {}

    def __enter__(self):
        from gpudrive_lab_torch.vbd import integration
        from gpudrive_lab_torch.vbd.model import as_draws

        batch_fn = integration.process_scenario_data
        inputs_fn = integration.official_inputs
        sample_fn = integration.sample_official
        encode, denoise = self.model.encode, self.model.denoise
        step = self.scheduler.step

        def rec_batch(*a, **k):
            out = batch_fn(*a, **k)
            self.agent_ids = out["agents_id"].cpu()
            return out

        def rec_inputs(*a, **k):
            out = inputs_fn(*a, **k)
            self.inputs = {n: v.cpu() for n, v in out.items()}
            return out

        def rec_sample(*a, **k):
            out = sample_fn(*a, **k)
            self.actions = out["denoised_actions"].cpu()
            return out

        def rec_encode(inputs):
            enc = encode(inputs)
            self.enc = {n: enc[n].cpu() for n in self.ENC_KEYS}
            return enc

        def rec_denoise(enc, x_t, steps):
            x0 = denoise(enc, x_t, steps)
            t = int(steps.reshape(-1)[0])
            if t in self.dsteps:
                self.denoise[t] = (x_t.cpu(), x0.cpu())
            return x0

        def rec_step(x0, x_t, t, noise):
            t = int(t)
            if t not in self.dsteps:
                return step(x0, x_t, t, noise)
            draws = as_draws(noise, x_t.device)
            normal, kept = draws.normal, []

            def keep(shape):
                e = normal(shape)
                kept.append(e.cpu())
                return e

            draws.normal = keep
            try:
                out = step(x0, x_t, t, draws)
            finally:
                del draws.normal
            self.steps[t] = (x0.cpu(), x_t.cpu(), kept, out.cpu())
            return out

        self._saved = [(integration, "process_scenario_data", batch_fn),
                       (integration, "official_inputs", inputs_fn),
                       (integration, "sample_official", sample_fn)]
        integration.process_scenario_data = rec_batch
        integration.official_inputs = rec_inputs
        integration.sample_official = rec_sample
        self.model.encode, self.model.denoise = rec_encode, rec_denoise
        self.scheduler.step = rec_step
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        del self.model.encode, self.model.denoise, self.scheduler.step
        return False

    def missing(self, n_env: int) -> int:
        """Records the check needs and the episode did not make."""
        return (sum(x is None for x in (self.agent_ids, self.inputs,
                                        self.enc, self.actions))
                + sum(t not in self.denoise for t in self.dsteps)
                + sum(t not in self.steps or len(self.steps[t][2]) != 1
                      for t in self.dsteps)
                + n_env - len(self.env_steps))


def run(cell, seed: int, seconds: float, traced: bool, clock,
        device: torch.device | None = None) -> common.RunResult:
    """One run of ``cell`` on ``device`` (by default the first card);
    ``clock()`` gives the seconds since the process began (set-up is read
    from it)."""
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.vbd import integration
    from gpudrive_lab_torch.vbd import model_official as mo

    device = device or common.first_card()
    cfg, traffic = cell.config, cell.traffic
    mcfg = model_config(cfg)
    parts = {"import_and_init_s": clock()}
    paths = common.scene_paths(traffic["scenes"])
    t = clock()
    env = GPUDriveTorchEnv(EnvConfig(**cfg["env"]), scene_paths=paths,
                           device=device)
    common.sync(device)
    parts["scene_compile_s"] = clock() - t
    t = clock()
    prog_scene = common.scene_arrays(env.scene)
    prog_fresh = common.cpu_state(env.state)
    model = mo.OfficialVBD(mcfg, device=device,
                           generator=torch.Generator().manual_seed(seed))
    model.eval()
    source = integration.OfficialVBDSource(model, seed=seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    W, A = env.num_worlds, env.max_agent_count
    agents = int(env.scene.num_agents.sum())
    n_actions = env.action_space_n

    def episode(keep=None):
        env.reset()
        env.set_vbd_trajectories(source)
        for k in range(EPISODE):
            idx = torch.randint(0, n_actions, (W, A), generator=gen,
                                device=device)
            if keep is not None and k in keep:
                before = (common.cpu_state(env.state),
                          env.world_time_steps.cpu())
            env.step_dynamics(idx)
            obs = env.get_obs()
            reward = env.get_rewards()
            env.get_dones()
            if keep is not None and k in keep:
                keep[k] = dict(before=before[0], clock=before[1],
                               idx=idx.cpu(),
                               after=common.cpu_state(env.state),
                               clock_after=env.world_time_steps.cpu(),
                               obs=obs.cpu(), reward=reward.cpu())

    for _ in range(int(traffic["warmup_episodes"])):
        episode()
    common.sync(device)
    parts["warmup_s"] = clock() - t
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    setup_s = clock()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window -------------------------------------------------------
    c0 = counts()
    ends = []
    common.sync(device)
    t0 = time.perf_counter()
    while True:
        episode()
        common.sync(device)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    episodes, elapsed = len(ends), ends[-1] - t0
    counts_window = count_delta(c0, counts())
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e = {"setup_s": setup_s,
           "agent_steps_per_s": window.rate(agents * EPISODE * episodes,
                                            elapsed),
           "peak_mem_gib": window_peak / common.GIB}
    log(f"window: {episodes} episodes of {W} worlds, {agents} agents, in "
        f"{elapsed:.4f} s; sampler counts {counts_window}")

    # ---- the traced stretch (--trace 1) -----------------------------------
    summary, traced_eps, counts_traced = None, 0, None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        c0 = counts()
        with profile(activities=acts) as prof:
            with record_function(tracemod.WINDOW):
                for _ in range(int(traffic["trace_episodes"])):
                    with record_function("gdbench.vbd_episode"):
                        episode()
                    traced_eps += 1
                common.sync(device)
        counts_traced = count_delta(c0, counts())
        summary = tracemod.summarize_profile(prof)

    # ---- the checked episode, then the program is freed -------------------
    dsteps, esteps = draw_steps(seed, mcfg.diffusion_steps,
                                int(traffic["check_diffusion_steps"]),
                                int(traffic["check_env_steps"]))
    rec = Recorder(model, source.scheduler, dsteps)
    keep = dict.fromkeys(esteps)
    with rec:
        episode(keep)
    rec.env_steps = {k: v for k, v in keep.items() if v is not None}
    prog = dict(
        installed=env.vbd_trajectories.cpu(), weights=model.state_dict(),
        reward_weights=env.reward_weights.cpu(),
        spec=dataclasses.asdict(env.spec),
        vbd_weight=float(env.config.vbd_trajectory_weight))
    prog["weights"] = {k: v.cpu() for k, v in prog["weights"].items()}
    shapes = dict(worlds=W, polylines=int(rec.inputs["polylines"].shape[1]),
                  points=int(rec.inputs["polylines"].shape[2]),
                  lights=int(rec.inputs["traffic_light_points"].shape[1]),
                  history=int(rec.inputs["agents_history"].shape[2]))
    del env, model, source, episode
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = check(cell, paths, device, mcfg, rec, prog, prog_scene,
                   prog_fresh, len(esteps))
    ctx = dict(setup=parts, trace=summary, driver="vbd", device=device,
               samples_traced=traced_eps, counts_traced=counts_traced,
               episodes=episodes, counts_window=counts_window,
               episode_s=elapsed / episodes,
               diffusion_steps=mcfg.diffusion_steps, model=cfg["model"],
               vbd_shapes=shapes)
    return common.RunResult(
        attempted=episodes, failed=0, end_to_end=e2e, checks=checks,
        memory_peak_bytes=max(setup_peak, window_peak), setup_parts=parts,
        device=device, trace=summary, ctx=ctx)


class Gap:
    """max |program - reference| over max |reference|, gathered over
    blocks; NaN reads as infinite."""

    def __init__(self):
        self.diff = self.scale = 0.0

    def add(self, prog: torch.Tensor, ref: torch.Tensor) -> None:
        self.diff = max(self.diff, common.max_abs(prog.to(ref.device), ref))
        if ref.numel():
            self.scale = max(self.scale, float(ref.double().abs().max()))

    @property
    def value(self) -> float:
        if not np.isfinite(self.diff):
            return float("inf")
        return self.diff / max(self.scale, 1e-30)


def check(cell, paths, device, mcfg, rec: Recorder, prog: dict, prog_scene,
          prog_fresh, n_env: int) -> dict:
    """The numbers ``correct`` compares, each with its limit."""
    t = time.perf_counter()
    env_cfg = cell.config["env"]
    rparams = rob.params_from_env(env_cfg)
    rscene = common.compile_scenes_reference(
        paths, rparams, device, int(cell.traffic.get("reference_workers", 0)))
    start_gap, start_flags = common.compare_start(
        prog_scene, prog_fresh, rscene, rstep.reset(rscene, None, rparams))
    gaps = {k: Gap() for k in ("relations", "encodings",
                               "relation_encodings", "denoise", "scheduler",
                               "rollout", "vbd_obs", "reward")}
    mask_flags = 0
    missing = rec.missing(n_env)
    if missing:
        log(f"check: {missing} records missing")
    else:
        net = RV.VBD(RV.Config(
            future_len=mcfg.future_len, agents_len=mcfg.agents_len,
            action_len=mcfg.action_len,
            diffusion_steps=mcfg.diffusion_steps,
            encoder_layers=mcfg.encoder_layers,
            action_mean=mcfg.action_mean, action_std=mcfg.action_std))
        net.load_state_dict(prog["weights"], strict=True)
        net.to(device)
        rsched = RV.DDPMScheduler(mcfg.diffusion_steps)
        inputs = rec.inputs
        W, A = inputs["agents_history"].shape[0], mcfg.agents_len
        block = int(cell.traffic["reference_block"])
        for w in range(0, W, block):
            sl = slice(w, w + block)
            inb = {k: v[sl].to(device) for k, v in inputs.items()}
            gaps["relations"].add(inb["relations"], RV.relations(
                inb["agents_history"], inb["polylines"],
                inb["traffic_light_points"]))
            renc = net.encode(inb)
            for k in ("encodings", "relation_encodings"):
                gaps[k].add(rec.enc[k][sl], renc[k])
            for k in ("agents_mask", "maps_mask", "traffic_lights_mask"):
                mask_flags += int((rec.enc[k][sl] != renc[k].cpu()).sum())
            for step, (x_t, x0) in rec.denoise.items():
                n = x_t[sl].shape[0]
                steps = torch.full((n, A), step, dtype=torch.long,
                                   device=device)
                gaps["denoise"].add(x0[sl], net.denoise(
                    renc, x_t[sl].to(device), steps))
            del renc, inb
        for step, (x0, x_t, draws, out) in rec.steps.items():
            gaps["scheduler"].add(out, rsched.step(
                x0.to(device), x_t.to(device), step, draws[0].to(device)))
        current = inputs["agents_history"][:, :A, -1, :5]
        trajs = RV.roll_out(current, rec.actions, mcfg.action_len)
        installed = prog["installed"]
        gaps["rollout"].add(installed, RV.scatter(trajs, rec.agent_ids,
                                                  installed.shape[1]))
        del net
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # the recorded env steps, from the program's state before each
    state_gap, state_flags, obs_gap = 0.0, 0, 0.0
    table = rob.classic_action_table(device)
    rspec = rob.ObsSpec(**prog["spec"])
    rw = prog["reward_weights"].to(device)
    installed = prog["installed"].to(device)
    for k, kept in sorted(rec.env_steps.items()):
        before = _to_ref_state(kept["before"], device)
        idx = kept["idx"].to(device)
        act = torch.zeros(idx.shape + (RC.ACTION_DIM,), dtype=torch.float32,
                          device=device)
        act[..., :3] = table[idx.long()]
        ref = rstep.step(rscene, before, act, rparams)
        g, f = common.compare_states(kept["after"], ref)
        state_gap, state_flags = max(state_gap, g), state_flags + f
        clock = kept["clock"].to(device)
        any_done = ((ref.done != 0) & rscene.agents.valid).any(dim=1)
        clock = torch.where(any_done, clock, clock + 1)
        state_flags += int((kept["clock_after"] != clock.cpu()).sum())
        robs = rob.flat_observation(rscene, ref, rparams, rspec, rw)[0]
        obs_gap = max(obs_gap, compare_obs(kept["obs"][..., :-VBD_OBS],
                                           robs))
        gaps["vbd_obs"].add(kept["obs"][..., -VBD_OBS:],
                            RV.vbd_obs_block(ref.pos, ref.yaw, installed))
        gaps["reward"].add(kept["reward"], rob.shaped_rewards(
            rscene, ref, BASE_REWARD, rw, clock) + RV.vbd_reward(
                ref.pos, installed, clock, prog["vbd_weight"]))

    lim = cell.limits
    checks = {
        "start_gap": (start_gap, lim["start_gap"]),
        "start_flags": (float(start_flags), lim["start_flags"]),
        "records_missing": (float(missing), 0.0),
        "mask_flags": (float(mask_flags), lim["mask_flags"]),
        **{f"{k}_gap": (g.value, lim[f"{k}_gap"]) for k, g in gaps.items()},
        "state_gap": (state_gap, lim["state_gap"]),
        "state_flags": (float(state_flags), lim["state_flags"]),
        "obs_gap": (obs_gap, lim["obs_gap"]),
    }
    log(f"check: diffusion steps {sorted(rec.denoise)}, env steps "
        f"{sorted(rec.env_steps)}; reference {time.perf_counter() - t:.2f} s")
    return checks


def span_reading(ctx, span: str, per_step: bool = False):
    """Stream ms of the ``span`` records inside ``vbd.sample`` over the
    traced episodes, per sample (``per_step``: per diffusion step).  None
    outside a traced run of this driver, where the port keeps no records
    or counts, and unless the counts and the ``vbd.sample`` records show
    one sample an episode of ``diffusion_steps`` steps."""
    n = ctx.get("samples_traced", 0)
    if ctx.get("driver") != "vbd" or ctx.get("trace") is None or not n:
        return None
    steps = ctx["diffusion_steps"]
    if ctx.get("counts_traced") != (n, n * steps):
        return None
    try:
        from gpudrive_lab_torch.utils.profiling import span_ms
    except ImportError:  # a port without spans
        return None
    ms = span_ms(span, "vbd.sample")
    if not ms or len(span_ms("vbd.sample")) != n:
        return None
    return sum(ms) / (n * steps if per_step else n)


def control(cell, device, seed: int):
    """The control of this driver's cells (``gdbench/vbd_control.py``)."""
    from .vbd_control import vbd_control

    return vbd_control(cell)


def faults() -> dict:
    """The faults this driver's cells can have
    (``gdbench/vbd_control.py``)."""
    from .vbd_control import FAULTS

    return FAULTS
