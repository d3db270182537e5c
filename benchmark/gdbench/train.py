"""The training driver: PPO iterations of the port's trainer on the
late-fusion policy.

Set-up builds the env over the traffic's scenes, one trainer with
``gpudrive_lab_torch.ppo.train.build_trainer`` and the policy's weights,
drawn on the device from ``--seed`` by the benchmark; the action draws and
the minibatch order come from the same seed through the trainer.  It runs
``warmup_iterations`` whole iterations through the trainer's own call
(three: the third's rollout crosses the step where every episode ends and
the worlds reset) and keeps what the trainer hands back (``Recorder``).
The window then runs whole iterations of the same trainer for
``--seconds``, one synchronize per iteration.

Correctness: once the window has closed and the program is freed, the
plain reference compiles the scenes itself and, from the reset state and
with the program's actions, follows the warm-up iterations' rollouts from
its own state: at every step the log-probs and values under the actions
taken (under the benchmark's weights in the first iteration, the
program's weights of that iteration in the later ones) and the mask;
after the last, the env state and the world clock.  It then computes the
first iteration's GAE and runs its first ``CHECK_STEPS`` optimizer steps
from the same weights in the program's minibatch order: each step's loss,
the first gradient and the parameters' change, the norms taken leaf by
leaf.  The start, the compiled scene and the reset state, is compared by
itself.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import common, trace as tracemod, window
from .common import log
from .reference import env_obs as rob
from .reference import step as rstep
from .reference.policy import LateFusionNet, make_weights
from .reference.ppo import Learner

CHECK_STEPS = 3  # optimizer steps the reference follows
# the trainer settings the reference follows (reference/ppo.py)
SUPPORTED = {"compact_mode": "flat", "remat_obs": True, "clip_vloss": False,
             "policy_dtype": "float32", "minibatch_rows": 0,
             "compact_blocks": 0}


class Recorder:
    """Keeps what the trainer hands back in the warm-up: the trajectory
    each ``rollout`` returns (actions, log-probs, values, masks), the
    first minibatch order ``minibatch_order`` returns and the first
    per-minibatch loss terms ``learn`` returns, the policy's weights
    before each iteration, and, through the optimizer's step hook, the
    first gradient as Adam got it (from its state after the first step)
    and the parameters after step ``CHECK_STEPS``."""

    def __init__(self, ppo):
        self.ppo = ppo
        self.trajs, self.weights = [], []
        self.perms = self.terms = self.grad1 = self.after = None
        names = {id(p): n for n, p in ppo.policy.named_parameters()}
        rollout, order, learn = ppo.rollout, ppo.minibatch_order, ppo.learn
        self.steps = 0

        def rec_rollout(*args, **kwargs):
            carry, traj = rollout(*args, **kwargs)
            self.trajs.append({k: getattr(traj, k).detach().cpu()
                               for k in ("action", "logprob", "value",
                                         "mask")})
            return carry, traj

        def rec_order():
            out = order()
            if self.perms is None:
                self.perms = out[0]  # (perms [E][M][Tm], row starts)
            return out

        def rec_learn(*args, **kwargs):
            out = learn(*args, **kwargs)
            if self.terms is None:  # {term: [E, M]}, in the steps' order
                flat = {k: v.reshape(-1)[:CHECK_STEPS].tolist()
                        for k, v in out.items()}
                self.terms = [{k: v[i] for k, v in flat.items()}
                              for i in range(len(flat["pg_loss"]))]
            return out

        def after_step(opt, args, kwargs):
            self.steps += 1
            if self.steps == 1:
                self.grad1 = {
                    names[id(p)]: (opt.state[p]["exp_avg"].detach()
                                   / (1.0 - g["betas"][0])).cpu()
                    for g in opt.param_groups for p in g["params"]
                    if "exp_avg" in opt.state.get(p, {})}
            if self.steps == CHECK_STEPS:
                self.after = {n: p.detach().cpu().clone()
                              for n, p in ppo.policy.named_parameters()}

        ppo.rollout, ppo.minibatch_order = rec_rollout, rec_order
        ppo.learn = rec_learn
        self.hook = ppo.optimizer.register_step_post_hook(after_step)

    def iteration(self, train_fn, *args):
        """One warm-up iteration through ``train_fn``, the weights it
        starts from kept."""
        self.weights.append({k: v.detach().cpu().clone() for k, v in
                             self.ppo.policy.state_dict().items()})
        return train_fn(*args)

    def close(self):
        del self.ppo.rollout, self.ppo.minibatch_order, self.ppo.learn
        self.hook.remove()


def run(cell, seed: int, seconds: float, traced: bool, clock,
        device: torch.device | None = None) -> common.RunResult:
    """One run of ``cell`` on ``device`` (by default the first card);
    ``clock()`` gives the seconds since the process began (set-up is read
    from it)."""
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.ppo.ppo import PPOConfig
    from gpudrive_lab_torch.ppo.train import build_trainer

    device = device or common.first_card()
    cfg, traffic = cell.config, cell.traffic
    check_supported(cfg["ppo"])
    parts = {"import_and_init_s": clock()}
    paths = common.scene_paths(traffic["scenes"])
    t = clock()
    env = GPUDriveTorchEnv(EnvConfig(**cfg["env"]), scene_paths=paths,
                           device=device)
    common.sync(device)
    parts["scene_compile_s"] = clock() - t
    t = clock()
    ppo, carry, fresh, train_fn = build_trainer(
        env, PPOConfig(**cfg["ppo"]), seed=seed)
    net = LateFusionNet(actions=env.action_space_n).to(device)
    w0 = make_weights(net, torch.Generator(device=device).manual_seed(seed),
                      device)
    ppo.policy.load_state_dict(w0)
    rec = Recorder(ppo)
    try:
        for _ in range(int(traffic["warmup_iterations"])):
            carry, m = rec.iteration(train_fn, env.scene, carry, fresh,
                                     env.reward_weights)
        common.sync(device)
    finally:
        rec.close()
    end_state = common.cpu_state(carry.state)
    end_clock = carry.world_time_steps.cpu()
    parts["warmup_s"] = clock() - t
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    setup_s = clock()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window -------------------------------------------------------
    samples = torch.zeros((), dtype=torch.float32, device=device)
    ends = []
    common.sync(device)
    t0 = time.perf_counter()
    while True:
        carry, m = train_fn(env.scene, carry, fresh, env.reward_weights)
        samples += m["samples"]
        common.sync(device)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    # every iteration ran whole; the window closes at the last one's end
    iters, elapsed = len(ends), ends[-1] - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    total = float(samples)
    e2e = {"setup_s": setup_s,
           "train_samples_per_s": window.rate(total, elapsed),
           "peak_mem_gib": window_peak / common.GIB}
    log(f"window: {iters} iterations, {total:.0f} samples in "
        f"{elapsed:.4f} s")

    summary, traced_iters = None, 0
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(tracemod.WINDOW):
                for _ in range(int(traffic["trace_iterations"])):
                    with record_function("gdbench.train_iteration"):
                        carry, m = train_fn(env.scene, carry, fresh,
                                            env.reward_weights)
                    traced_iters += 1
                common.sync(device)
        summary = tracemod.summarize_profile(prof)

    prog_scene = common.scene_arrays(env.scene)
    prog_fresh = common.cpu_state(fresh)
    del env, ppo, carry, fresh, train_fn, m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, ref_ctx = check(cell, paths, device, w0, rec, end_state,
                            end_clock, prog_scene, prog_fresh)
    ctx = dict(ref_ctx, setup=parts, trace=summary, driver="train",
               iterations_traced=traced_iters, iter_s=elapsed / iters,
               rows=int(cfg["ppo"]["compact"]), ppo=cfg["ppo"],
               policy=cfg["policy"], device=device)
    return common.RunResult(
        attempted=iters, failed=0, end_to_end=e2e, checks=checks,
        memory_peak_bytes=max(setup_peak, window_peak), setup_parts=parts,
        device=device, trace=summary, ctx=ctx)


def check_supported(ppo: dict) -> None:
    for k, v in SUPPORTED.items():
        if ppo.get(k, v) != v:
            raise ValueError(f"the reference follows {k}={v!r}, the "
                             f"configuration sets {ppo[k]!r}")


def winners_per_row(net, obs: torch.Tensor) -> dict:
    """Mean number of distinct entities that win one of the 64 pooled units
    of a row, for the partner and road embeds on ``obs`` [rows, D]."""
    e, p = net.ego, net.partners * 6
    blocks = {"partner": (net.partner_embed,
                          obs[:, e:e + p].unflatten(-1, (net.partners, 6))),
              "road": (net.road_map_embed,
                       obs[:, e + p:].unflatten(-1, (net.roads, 13)))}
    out = {}
    with torch.no_grad():
        for name, (embed, x) in blocks.items():
            arg = embed(x).argmax(dim=-2).sort(dim=-1).values  # [rows, 64]
            distinct = 1 + (arg[:, 1:] != arg[:, :-1]).sum(-1)
            out[name] = float(distinct.float().mean())
    return out


def check(cell, paths, device, w0, rec: Recorder, end_state, end_clock,
          prog_scene, prog_fresh) -> tuple:
    """The numbers ``correct`` compares (each with its limit) and what the
    metric readers need of the reference."""
    t = time.perf_counter()
    cfg, env, p = cell.config, cell.config["env"], cell.config["ppo"]
    rparams = rob.params_from_env(env)
    rscene = common.compile_scenes_reference(
        paths, rparams, device, int(cell.traffic.get("reference_workers", 0)))
    W, A = rscene.agents.valid.shape
    rw = torch.tensor([env["collision_weight"], env["goal_achieved_weight"],
                       env["off_road_weight"]], device=device).expand(
                           W, A, 3).contiguous()
    net = LateFusionNet(actions=cfg["policy"]["action_dim"]).to(device)
    learner = Learner(rscene, rparams, rob.ObsSpec(),
                      rob.classic_action_table(device), env["reward_type"],
                      rw, net, dict(p, reset_time_step=env["init_steps"]))
    fresh = rstep.reset(rscene, None, rparams)
    start_gap, start_flags = common.compare_start(prog_scene, prog_fresh,
                                                  rscene, fresh)

    # the warm-up's rollouts, from the reset state and the reference's own
    # states, with the program's actions
    state = fresh
    wts = torch.full((W,), env["init_steps"], dtype=torch.int32,
                     device=device)
    logp_gap = value_gap = 0.0
    mask_flags = 0
    for it, tr in enumerate(rec.trajs):
        net.load_state_dict(w0 if it == 0 else rec.weights[it])
        state, wts, ro = learner.rollout(state, wts, fresh,
                                         tr["action"].to(device))
        m = tr["mask"].bool()
        mask_flags += int((m != ro.mask.cpu()).sum())
        logp_gap = max(logp_gap, common.max_abs(tr["logprob"][m],
                                                ro.logprob.cpu()[m]))
        value_gap = max(value_gap, common.max_abs(tr["value"][m],
                                                  ro.value.cpu()[m]))
        if it == 0:
            first = ro
    state_gap, state_flags = common.compare_states(end_state, state)
    state_flags += int((end_clock != wts.cpu()).sum())
    net.load_state_dict(w0)
    actions = rec.trajs[0]["action"].to(device)
    winners = winners_per_row(net, torch.cat(
        [learner.obs(first.states[s]) for s in rec.perms[0][0]]))

    names = {id(q): n for n, q in net.named_parameters()}
    ref_grad1, ref_after = {}, {}

    def on_step(k, opt):
        if k == 1:
            ref_grad1.update({
                names[id(q)]: (opt.state[q]["exp_avg"].detach()
                               / (1.0 - g["betas"][0])).cpu()
                for g in opt.param_groups for q in g["params"]})
        if k == CHECK_STEPS:
            ref_after.update({n: q.detach().cpu().clone()
                              for n, q in net.named_parameters()})

    terms = learner.learn(first, actions, rec.perms, p["ent_coef"],
                          on_step, steps=CHECK_STEPS)
    loss_gap = max(_loss_gap(a, b, p) for a, b in zip(rec.terms, terms)) \
        if len(rec.terms) == len(terms) else float("inf")
    g_norms = {k: float(v.norm()) for k, v in ref_grad1.items()}
    med = float(np.median(list(g_norms.values())))
    keep = [k for k, v in g_norms.items() if v >= 1e-3 * med]
    w0c = {k: v.cpu() for k, v in w0.items()}
    if rec.grad1 and rec.after:
        grad_gap, grad_leaf = common.leaf_gap(rec.grad1, ref_grad1, keep)
        upd_gap, upd_leaf = common.leaf_gap(
            {k: rec.after[k] - w0c[k] for k in keep},
            {k: ref_after[k] - w0c[k] for k in keep}, keep)
    else:  # the program took fewer optimizer steps than the check follows
        grad_gap = upd_gap = float("inf")
        grad_leaf = upd_leaf = None
    lim = cell.limits
    checks = {
        "start_gap": (start_gap, lim["start_gap"]),
        "start_flags": (float(start_flags), lim["start_flags"]),
        "state_gap": (state_gap, lim["state_gap"]),
        "state_flags": (float(state_flags), lim["state_flags"]),
        "mask_flags": (float(mask_flags), lim["mask_flags"]),
        "logp_gap": (logp_gap, lim["logp_gap"]),
        "value_gap": (value_gap, lim["value_gap"]),
        "loss_gap": (loss_gap, lim["loss_gap"]),
        "grad1_gap": (grad_gap, lim["grad1_gap"]),
        "update_gap": (upd_gap, lim["update_gap"]),
    }
    log(f"check: {len(rec.trajs)} rollouts and {CHECK_STEPS} "
        f"optimizer steps followed; worst gradient leaf {grad_leaf}, worst "
        f"update leaf {upd_leaf}, leaves left out (first gradient under "
        f"1e-3 of the median leaf's) {sorted(set(g_norms) - set(keep))}; "
        f"reference {time.perf_counter() - t:.2f} s")
    return checks, {"winners_per_row": winners}


def _loss_gap(prog: dict, ref: dict, p: dict) -> float:
    """Gap of the program's and the reference's loss of one minibatch
    (pg - ent_coef * entropy + vf_coef * v), against the sum of the
    terms' magnitudes."""
    c, vf = p["ent_coef"], p["vf_coef"]

    def loss(d):
        return d["pg_loss"] - c * d["entropy"] + vf * d["v_loss"]

    scale = abs(ref["pg_loss"]) + c * abs(ref["entropy"]) + vf * abs(
        ref["v_loss"])
    return abs(loss(prog) - loss(ref)) / max(scale, 1e-30)


def control(cell, device, seed: int):
    """The control of this driver's cells (``gdbench/control.py``)."""
    from .control import train_control

    return train_control(cell, device, seed)


def faults() -> dict:
    """The faults this driver's cells can have (``gdbench/faults.py``)."""
    from .faults import TRAIN

    return TRAIN
