"""Sampling-time guidance for the VBD denoiser (port of
``gpudrive_lab_tpu/vbd/guidance.py``; reference:
gpudrive/integrations/vbd/guidance_metrics/, CTG-style costs steering the
reverse diffusion toward goals and away from collisions, used by
VBDTest.sample_denoiser in sim_agent/sim_actor.py:12-654).

A guidance term is a differentiable cost over the trajectories implied by
the (unnormalised) action samples; at the guided diffusion steps its
gradient, from autograd, moves the posterior mean.  Costs add up; rewards
(vbd/guidance_metrics.py) are summed and ascended.

Each sampler takes its draws through ``noise`` (vbd/model.Draws): x_T,
then one noise per diffusion step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch

from gpudrive_lab_torch.vbd.guidance_metrics import (
    onroad_reward,
    overlap_reward,
)
from gpudrive_lab_torch.vbd.model import (
    DDPMScheduler,
    NoiseSource,
    VBDConfig,
    as_draws,
    current_states,
    roll_out,
    unnormalize_actions,
)

# A guidance cost: (trajs [B, A, T, 5], batch) -> scalar cost.
GuidanceCost = Callable[[torch.Tensor, dict], torch.Tensor]


def goal_guidance(goals: torch.Tensor, weight: float = 1.0) -> GuidanceCost:
    """Pull the trajectory endpoints toward per-agent goals [B, A, 2]
    (reference: guidance_metrics goal cost)."""

    def cost(trajs, batch):
        end = trajs[..., -1, 0:2]
        m = (batch["agents_interested"] > 0).to(torch.float32)
        return weight * (torch.linalg.norm(end - goals, dim=-1) * m).sum()

    return cost


def collision_guidance(radius: float = 3.0,
                       weight: float = 1.0) -> GuidanceCost:
    """Penalise agent pairs closer than ``radius`` at any step (reference:
    guidance_metrics collision cost)."""

    def cost(trajs, batch):
        pos = trajs[..., 0:2]  # [B, A, T, 2]
        diff = pos[:, :, None, :, :] - pos[:, None, :, :, :]
        # a safe norm: sqrt at 0 (the i == i diagonal) has a NaN gradient
        # that would poison the whole step though the diagonal is masked
        d = torch.sqrt((diff * diff).sum(-1) + 1e-9)  # [B, A, A, T]
        A = d.shape[1]
        eye = torch.eye(A, dtype=torch.bool, device=d.device)[None, :, :, None]
        m = (batch["agents_interested"] > 0).to(torch.float32)
        pair_m = m[:, :, None, None] * m[:, None, :, None] * (~eye)
        return weight * (torch.clamp(radius - d, min=0.0) * pair_m).sum()

    return cost


def comfort_guidance(max_accel: float = 4.0,
                     weight: float = 0.1) -> GuidanceCost:
    """Penalise harsh accelerations (reference: guidance_metrics
    comfort)."""

    def cost(trajs, batch):
        v = torch.hypot(trajs[..., 3], trajs[..., 4])
        a = torch.diff(v, dim=-1) / 0.1
        m = (batch["agents_interested"] > 0).to(torch.float32)[..., None]
        return weight * (torch.clamp(torch.abs(a) - max_accel, min=0.0)
                         * m).sum()

    return cost


@contextlib.contextmanager
def _frozen(model: torch.nn.Module):
    """The model's parameters without gradients for the block: reward
    gradients flow through the denoiser to the sample only."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in flags:
            p.requires_grad_(f)


def _value_and_grad(fn, x: torch.Tensor):
    """(fn(x), d fn / d x) with a fresh leaf for x."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        value = fn(x)
        (grad,) = torch.autograd.grad(value, x)
    return value.detach(), grad


def _rollout(batch, actions, config):
    return roll_out(current_states(batch, config.agents_len), actions,
                    action_len=config.action_len, global_frame=True)


def _result(batch, x_t, config, **histories):
    actions = unnormalize_actions(x_t, config)
    out = {"denoised_actions": actions,
           "denoised_trajs": _rollout(batch, actions, config)}
    for name, hist in histories.items():
        out[name] = (torch.stack(hist) if hist
                     else torch.zeros((0,), device=x_t.device))
    return out


def _adam(lr, steps: int, grad_fn, x):
    """``steps`` steps of optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8)
    descending ``grad_fn`` from x, the moments starting at zero."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    for count in range(1, steps + 1):
        g = grad_fn(x)
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g * g + b2 * nu
        mu_hat = mu / (1 - torch.tensor(b1) ** count)
        nu_hat = nu / (1 - torch.tensor(b2) ** count)
        x = x + (mu_hat / (torch.sqrt(nu_hat) + eps)) * -lr
    return x


@torch.no_grad()
def sample_denoiser_guided(
    model,
    scheduler: DDPMScheduler,
    batch: dict,
    config: VBDConfig,
    noise: NoiseSource = None,
    guidance: Sequence[GuidanceCost] = (),
    guidance_scale: float = 0.05,
    rewards: Sequence = (),
    guidance_iter: int = 5,
    guidance_start: int = 99,
    guidance_end: int = 1,
    scale_grad_by_std: bool = True,
) -> Dict[str, torch.Tensor]:
    """Reverse diffusion with CTG guidance (reference: sim_actor.py
    ctg_guidance, :98-190): at each diffusion step t in [guidance_end,
    guidance_start], ``guidance_iter`` Adam steps on the posterior mean mu
    of q(x_{t-1} | x_t, x0_pred) minimising the summed costs less the
    summed rewards, the learning rate ``guidance_scale`` times the
    posterior std (``scale_grad_by_std``); then x_{t-1} = mu + std * noise.

    ``guidance``: scalar costs ``(trajs, batch) -> cost``; ``rewards``:
    reference-style metrics ``(traj_pred, action_pred, batch) -> rewards``
    (vbd/guidance_metrics.py)."""
    hist = batch["agents_history"]
    draws = as_draws(noise, hist.device)
    B, A = hist.shape[0], config.agents_len

    def total_cost(x_norm):
        actions = unnormalize_actions(x_norm, config)
        trajs = _rollout(batch, actions, config)
        cost = hist.new_zeros(())
        for g in guidance:
            cost = cost + g(trajs, batch)
        for r in rewards:
            cost = cost - r(trajs, actions, batch).sum()
        return cost

    guided = bool(guidance) or bool(rewards)
    x_t = draws.normal((B, A, config.action_blocks, 2))
    for step in reversed(range(scheduler.steps)):
        t = torch.full((B, A), step, dtype=torch.long, device=hist.device)
        denoised, _, _ = model(batch, x_t, t)
        if guided and guidance_end <= step <= guidance_start:
            mu, std = scheduler.posterior_mean_std(denoised, x_t, t)
            lr = guidance_scale * (scheduler.std_at(step).to(hist.device)
                                   if scale_grad_by_std and step > 0 else 1.0)
            mu = _adam(lr, guidance_iter,
                       lambda x: _value_and_grad(total_cost, x)[1], mu)
            eps = draws.normal(x_t.shape)
            x_t = mu + std * eps if step > 0 else mu
        else:
            x_t = scheduler.step(denoised, x_t, t, draws)
    return _result(batch, x_t, config)


@torch.no_grad()
def sample_denoiser_waymo(
    model,
    scheduler: DDPMScheduler,
    batch: dict,
    config: VBDConfig,
    noise: NoiseSource = None,
    rewards: Sequence = (),
    gradient_scale: float = 1.0,
    guidance_iter: int = 5,
    guidance_start: int = 99,
    guidance_end: int = 1,
    scale_grad_by_std: bool = True,
) -> Dict[str, torch.Tensor]:
    """Reverse diffusion with MotionDiffuser-style guidance (reference:
    sim_actor.py waymo_guidance, :192-289): at each guided step the
    posterior mean mu is refined by ``guidance_iter`` gradient-ascent steps
    on the summed rewards of the trajectories the denoiser predicts from mu
    at step t-1: the reward gradient flows through the denoiser (its
    parameters frozen), unlike CTG, which rolls mu out directly.  The
    gradient is scaled by the posterior std (``scale_grad_by_std``) and by
    ``gradient_scale``; then x_{t-1} = mu + std * noise.

    Returns the sample and ``reward_history`` [guided steps,
    guidance_iter] (the reference's ``guide_history``)."""
    hist = batch["agents_history"]
    draws = as_draws(noise, hist.device)
    B, A = hist.shape[0], config.agents_len

    def reward_through_denoiser(mu, t_prev):
        denoised, _, _ = model(batch, mu, t_prev)
        actions = unnormalize_actions(denoised, config)
        trajs = _rollout(batch, actions, config)
        total = hist.new_zeros(())
        for r in rewards:
            total = total + r(trajs, actions, batch).sum()
        return total

    reward_history = []
    x_t = draws.normal((B, A, config.action_blocks, 2))
    with _frozen(model):
        for step in reversed(range(scheduler.steps)):
            t = torch.full((B, A), step, dtype=torch.long, device=hist.device)
            denoised, _, _ = model(batch, x_t, t)
            if rewards and guidance_end <= step <= guidance_start:
                mu, std = scheduler.posterior_mean_std(denoised, x_t, t)
                std_scalar = scheduler.std_at(step).to(hist.device)
                t_prev = torch.full_like(t, max(step - 1, 0))
                step_rewards = []
                for _ in range(guidance_iter):
                    r, g = _value_and_grad(
                        lambda x: reward_through_denoiser(x, t_prev), mu)
                    if scale_grad_by_std and step > 0:
                        g = g * std_scalar
                    mu = mu + g * gradient_scale
                    step_rewards.append(r)
                reward_history.append(torch.stack(step_rewards))
                eps = draws.normal(x_t.shape)
                x_t = mu + std * eps if step > 0 else mu
            else:
                x_t = scheduler.step(denoised, x_t, t, draws)
    return _result(batch, x_t, config, reward_history=reward_history)


@torch.no_grad()
def sample_denoiser_ibr(
    model,
    scheduler: DDPMScheduler,
    batch: dict,
    config: VBDConfig,
    noise: NoiseSource = None,
    *,
    ego_idx: int,
    adv_idx: int,
    other_idx: Optional[Sequence[int]] = None,
    ego_iter: int = 5,
    adv_iter: int = 5,
    t_react: int = 81,
    adv_use_ctg: bool = False,
    ego_use_ctg: bool = False,
    gradient_scale: float = 0.1,
    guidance_iter: int = 5,
    guidance_start: int = 99,
    guidance_end: int = 1,
    scale_grad_by_std: bool = True,
    overlap_clip: float = 5.0,
) -> Dict[str, torch.Tensor]:
    """Reverse diffusion with iterative-best-response guidance (reference:
    sim_actor.py ibr_guidance, :290-517): at each guided step, alternate
    ``adv_iter`` adversary ascent steps (the adversary pulled toward the
    ego: the negated overlap signed distance, max over time, plus an
    on-road term; only its action blocks before ``t_react`` move) with
    ``ego_iter`` ego ascent steps (every agent maximises its least
    saturated evasion distance over time and partners, the adversary's
    rows before ``t_react`` pinned so the ego must react; reward = on-road
    + 15 x the evasion).  Each inner step's trajectories come from the
    denoiser at t-1 ("waymo") or a direct rollout of mu ("ctg", a 0.1x
    gradient scale) per ``adv_use_ctg`` / ``ego_use_ctg``; mu is clamped
    to the scheduler's action clamp after every step.

    Returns the sample and the pursue and evasion reward histories."""
    hist = batch["agents_history"]
    draws = as_draws(noise, hist.device)
    B, A = hist.shape[0], config.agents_len

    if other_idx is None:
        ego_aoi = None
        adv_i = adv_idx
    else:
        ego_aoi = [adv_idx, ego_idx] + list(other_idx)
        adv_i = 0

    # the reward factories (reference: sim_actor.py:385-476)
    pursue_overlap = overlap_reward(clip=overlap_clip, weight=1.0,
                                    aoi=[adv_idx, ego_idx], saturate=False)
    adv_onroad = onroad_reward(weight=2.0, aoi=[adv_idx])
    evasion_overlap = overlap_reward(clip=overlap_clip, weight=1.0,
                                     aoi=ego_aoi, offset=0.5, saturate=True)
    ego_onroad = onroad_reward(weight=0.1, aoi=ego_aoi)

    # t_react indexes action blocks in the gradient masks but trajectory
    # steps in the evasion pin (the reference applies one scalar to both
    # axes); each is clamped to its axis' length
    n_react = min(t_react, config.action_blocks)
    n_react_traj = min(t_react, config.future_len)

    def trajs_from(mu, t_prev, use_ctg):
        if use_ctg:
            actions = unnormalize_actions(mu, config)
        else:
            denoised, _, _ = model(batch, mu, t_prev)
            actions = unnormalize_actions(denoised, config)
        return _rollout(batch, actions, config), actions

    def adv_reward(mu, t_prev, use_ctg):
        trajs, actions = trajs_from(mu, t_prev, use_ctg)
        sd = pursue_overlap(trajs, actions, batch)  # [B, 2, T, 2]
        pursue = (-sd[:, 0, :, 1]).amax(dim=-1)  # the adversary chases
        onroad = adv_onroad(trajs, actions, batch).mean(dim=-1)  # [B, 1]
        return pursue.sum() + onroad.sum()

    def ego_reward(mu, t_prev, use_ctg):
        trajs, actions = trajs_from(mu, t_prev, use_ctg)
        ev = evasion_overlap(trajs, actions, batch)  # [B, A', T, A']
        # the adversary ignores collisions before t_react
        # (sim_actor.py:449-451)
        pin = torch.zeros(ev.shape[1:], dtype=torch.bool, device=ev.device)
        pin[adv_i, :n_react_traj] = True
        ev = torch.where(pin, 100.0, ev)
        ev_min = ev.reshape(ev.shape[0], ev.shape[1], -1).amin(dim=-1)
        onroad = ego_onroad(trajs, actions, batch).mean(dim=-1)  # [B, A']
        return (onroad + ev_min * 15.0).sum()

    clamp = scheduler.clamp_val
    pursue_history, evasion_history = [], []
    x_t = draws.normal((B, A, config.action_blocks, 2))
    with _frozen(model):
        for step in reversed(range(scheduler.steps)):
            t = torch.full((B, A), step, dtype=torch.long, device=hist.device)
            denoised, _, _ = model(batch, x_t, t)
            if guidance_end <= step <= guidance_start:
                mu, std = scheduler.posterior_mean_std(denoised, x_t, t)
                std_scalar = scheduler.std_at(step).to(hist.device)
                t_prev = torch.full_like(t, max(step - 1, 0))
                adv_mask = torch.zeros_like(mu)
                adv_mask[:, adv_idx, :n_react, :] = 1.0
                ego_mask = 1.0 - adv_mask
                for _ in range(guidance_iter):
                    for it in range(adv_iter + ego_iter):
                        is_adv = it < adv_iter
                        use_ctg = adv_use_ctg if is_adv else ego_use_ctg
                        # the ctg method applies a 0.1x scale
                        # (sim_actor.py:375)
                        scale = gradient_scale * (0.1 if use_ctg else 1.0)
                        fn = adv_reward if is_adv else ego_reward
                        r, g = _value_and_grad(
                            lambda x: fn(x, t_prev, use_ctg), mu)
                        g = g * (adv_mask if is_adv else ego_mask)
                        if scale_grad_by_std and step > 0:
                            g = g * std_scalar
                        mu = torch.clamp(mu + g * scale, -clamp, clamp)
                        (pursue_history if is_adv
                         else evasion_history).append(r)
                eps = draws.normal(x_t.shape)
                x_t = mu + std * eps if step > 0 else mu
            else:
                x_t = scheduler.step(denoised, x_t, t, draws)
    return _result(batch, x_t, config, pursue_history=pursue_history,
                   evasion_history=evasion_history)


#: The guidance modes (reference: sim_actor.py:54-57 guide_mode dispatch,
#: "ctg" / "waymo"; "ibr" is called by name there, listed here too).
GUIDANCE_MODES = {
    "ctg": sample_denoiser_guided,
    "waymo": sample_denoiser_waymo,
    "ibr": sample_denoiser_ibr,
}
