"""On-device PPO (port of ``gpudrive_lab_tpu/ppo/ppo.py``; reference:
gpudrive/integrations/puffer/ppo.py).

One train iteration is a rollout of ``rollout_len`` env steps with the
policy in the loop, GAE, and ``update_epochs`` x ``num_minibatches``
minibatch updates (clipped policy loss, value loss, entropy bonus, global
grad-norm clip, Adam).  Every tensor stays on the env's device: the rollout
auto-resets finished worlds by a per-world select against the ``fresh``
state, and nothing in the rollout or the update reads a device value on the
host.  ``PPO`` holds the policy (an ``nn.Module``) and its
``torch.optim.Adam``; the JAX package's ``make_ppo_funcs`` closures become
its methods.  With ``remat_obs`` the update recomputes each minibatch's
observations from the stored pre-step states through
``flat_obs_kernel.flat_obs_rows``: all its time steps in one launch pair of
kernel K6 where K6 covers the spec, else one ``flat_observation`` per time
step (env/flat_obs_kernel.py).

Random streams.  Actions are drawn from ``EnvCarry.rng``, a
``torch.Generator`` on the env's device; the minibatch order comes from
``PPO.perm_generator`` on the host.  Both can be given instead: the rollout
takes the actions (``actions=``) and the update the permutations
(``perms=``), so the JAX package's draws can drive the port.

World-parallel training.  With a ``group`` (parallel/mesh.WorldGroup of n
ranks, each holding a contiguous block of the worlds) ``learn`` computes
what one process computes over the union of the ranks' rows: per
minibatch the mask sum and the advantage mean, then the variance, are
summed over the ranks; each rank's loss is its own masked sums over the
global mask sum; the gradients are summed over the ranks before the
global-norm clip and Adam, so every rank applies the same update and the
parameters stay replicated; the returned metrics are the global ones.
Every rank draws the same minibatch order (the same-seeded
``perm_generator``); a minibatch is a time slice, so every rank holds its
part of each.  In flat mode with ``compact_blocks`` a multiple of n, rank
r's block-local selection is block r of one process's; otherwise each
rank keeps its share of one process's flat selection (``rank_rows``).
``minibatch_rows`` cuts the flat axis across ranks and raises with a
group.

The JAX package's ``unroll`` and ``epoch_preshuffle`` options change only
how XLA is asked to run the same computation; here they are accepted and
give the same result as without them.  ``policy_dtype="bfloat16"`` runs the
policy in bf16 (``PolicyConfig.dtype``; the fused blocks through K3 and K4
in their bf16 compute mode) with float32 parameters, logits and values; a
bf16 observation store then goes to the policy as stored.

Hyperparameter defaults mirror baselines/ppo/config/ppo_base_puffer.yaml.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.types import Params, Scene, SimState
from gpudrive_lab_torch.env import flat_obs_kernel
from gpudrive_lab_torch.env.env_torch import (
    ObsSpec,
    flat_observation,
    shaped_rewards,
)
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    sample_logits,
)
from gpudrive_lab_torch.parallel.mesh import WorldGroup
from gpudrive_lab_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """reference: ppo_base_puffer.yaml `train:` section.  Field for field the
    JAX package's PPOConfig; see its comments for each option's purpose."""

    rollout_len: int = 32
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    update_epochs: int = 4
    num_minibatches: int = 4
    norm_adv: bool = True
    clip_coef: float = 0.2
    clip_vloss: bool = False
    vf_clip_coef: float = 0.2
    ent_coef: float = 1e-4
    vf_coef: float = 0.3
    max_grad_norm: float = 0.5
    # World clock the auto-reset restores (init_steps of expert warm-up).
    reset_time_step: int = 0
    # Store per-step SimStates and recompute the observations of each
    # minibatch in the update, instead of storing the obs tensor.
    remat_obs: bool = True
    obs_store_dtype: str = "float32"  # "bfloat16" halves the stored obs
    obs_store: str = "flat"  # "flat" | "split" (remat_obs=False only)
    # Learner compaction: the first `compact` controlled slots per world
    # ("world", [W, C]) or `compact` rows across worlds ("flat", [N]);
    # 0 = dense over every agent row.
    compact: int = 0
    compact_mode: str = "world"
    compact_blocks: int = 0  # flat mode: block-local selection
    unroll: bool = False  # accepted; same result
    policy_dtype: str = "float32"  # or "bfloat16": the policy's dtype
    embed_remat: bool = False
    fused_embed: bool = False
    # flat mode: also cut minibatches to this many rows of the flat axis
    minibatch_rows: int = 0
    epoch_preshuffle: bool = False  # accepted; same result


class Transition(NamedTuple):
    """One rollout step; ``PPO.rollout`` stacks them along a leading [T]."""

    obs: Any  # [.., D] (or the split tuple); None when remat_obs
    action: torch.Tensor  # [W, A] / [W, C] / [N] int32
    logprob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor  # post-step
    mask: torch.Tensor  # valid training sample (controlled and alive)
    ep_done: torch.Tensor  # [W] bool: the world finished this step
    ep_goal: torch.Tensor  # [W] fraction of controlled agents at goal
    ep_collided: torch.Tensor  # [W]
    ep_off_road: torch.Tensor  # [W]
    env_state: Any = None  # pre-step SimState when remat_obs


class EnvCarry(NamedTuple):
    state: SimState
    world_time_steps: torch.Tensor
    rng: torch.Generator  # draws the rollout's actions; on the env's device


def compute_gae(rewards, values, dones, last_value, gamma, gae_lambda,
                unroll=False):
    """Reverse recurrence of GAE over [T, ...] tensors (reference:
    integrations/puffer/ppo.py:27-32,237-245).  ``dones[t]`` is the done
    after step t and masks ``next_value``.  Returns (advantages,
    returns).  ``unroll`` is accepted and changes nothing."""
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    adv = torch.zeros_like(last_value)
    out = [None] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = (rewards[t] + gamma * next_values[t] * (1.0 - dones[t])
                 - values[t])
        adv = delta + gamma * gae_lambda * (1.0 - dones[t]) * adv
        out[t] = adv
    advs = torch.stack(out)
    return advs, advs + values


def clip_by_global_norm(parameters, max_norm: float) -> None:
    """optax.clip_by_global_norm on the parameters' gradients, in place:
    scale by max_norm / g_norm only when g_norm >= max_norm, computed on
    the device (no host read)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


def _global_sum(group: WorldGroup | None, x: torch.Tensor) -> torch.Tensor:
    return x if group is None else group.all_reduce(x)


def normalize_advantages(adv, m, norm_adv: bool,
                         group: WorldGroup | None = None):
    """(advantages, msum): the mask sum clamped at 1 and, with
    ``norm_adv``, the advantages normalised by their masked mean and
    variance, each sum taken over every rank's rows of the minibatch (the
    mean's sums first, then the variance's, as one process's loss)."""
    s = _global_sum(group, torch.stack([m.sum(), (adv * m).sum()]))
    msum = torch.clamp(s[0], min=1.0)
    if not norm_adv:
        return adv, msum
    mean = s[1] / msum
    var = _global_sum(group, (((adv - mean) ** 2) * m).sum()[None])[0] / msum
    return (adv - mean) * torch.rsqrt(var + 1e-8), msum


def sync_gradients(parameters, group: WorldGroup) -> None:
    """Sum the parameters' gradients over the ranks, in one all-reduce of
    their concatenation; a missing gradient counts as zeros."""
    params = list(parameters)
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    group.all_reduce(flat)
    o = 0
    for p in params:
        p.grad = flat[o:o + p.numel()].view_as(p).clone()
        o += p.numel()


def rank_rows(group: WorldGroup, controlled: torch.Tensor,
              compact: int) -> torch.Tensor:
    """This rank's rows of one process's flat selection over all the
    ranks' worlds (controlled agents in (world, slot) order, then
    uncontrolled padding rows, cut at ``compact``): their indices on the
    global flat axis [n_r] (int64, host), in the order of the rank's own
    selection of ``n_r`` rows.  ``controlled`` is the rank's [W/n, A]
    mask."""
    c = int(controlled.sum())
    u = controlled.numel() - c
    counts = group.all_gather_ints([c, u])
    c_before = sum(x[0] for x in counts[:group.rank])
    u_before = sum(x[1] for x in counts[:group.rank])
    c_total = sum(x[0] for x in counts)
    nc = min(max(compact - c_before, 0), c)
    nu = min(max(compact - c_total - u_before, 0), u)
    return torch.cat([c_before + torch.arange(nc),
                      c_total + u_before + torch.arange(nu)])


def _map_obs(fn, obs):
    """Apply fn to the obs tensor or to each tensor of the split tuple."""
    return tuple(fn(o) for o in obs) if isinstance(obs, tuple) else fn(obs)


def _stack_states(states) -> SimState:
    return SimState(**{
        f.name: torch.stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(SimState)
    })


class PPO:
    """PPO over ``policy`` on the env described by (params, spec,
    action_table, reward_type).  ``rollout``, ``prepare`` (last value and
    GAE) and ``learn`` (the minibatch epochs) are the phases of
    ``train_step``; the policy and ``optimizer`` are updated in place."""

    def __init__(self, policy: LateFusionPolicy, params: Params,
                 spec: ObsSpec, action_table: torch.Tensor, reward_type: str,
                 config: PPOConfig,
                 perm_generator: torch.Generator | None = None,
                 group: WorldGroup | None = None):
        if config.policy_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown policy_dtype {config.policy_dtype!r}")
        if config.obs_store not in ("flat", "split"):
            raise ValueError(f"unknown obs_store {config.obs_store!r}")
        self.flat_mode = bool(config.compact) and config.compact_mode == "flat"
        if config.minibatch_rows and not self.flat_mode:
            raise ValueError("minibatch_rows requires compact_mode='flat'")
        # None: one process (a group of one rank reduces nothing)
        self.group = group if group is not None and group.size > 1 else None
        if self.group is not None:
            if config.minibatch_rows:
                raise ValueError(
                    "minibatch_rows cuts row blocks of the flat axis, which "
                    "span ranks; it is not supported with a process group")
            nb = config.compact_blocks
            if self.flat_mode and nb > 1 and nb % self.group.size:
                raise ValueError(
                    f"compact_blocks={nb} must be a multiple of the "
                    f"{self.group.size} ranks")
        self.policy = policy
        self.params = params
        self.spec = spec
        self.action_table = action_table
        self.reward_type = reward_type
        self.config = config
        self.split_store = (not config.remat_obs) and config.obs_store == "split"
        # traj arrays: [T, N] (flat) vs [T, W, C] / [T, W, A]
        self.batch_lead = 2 if self.flat_mode else 3
        self.optimizer = torch.optim.Adam(
            policy.parameters(), lr=config.learning_rate, eps=1e-5)
        self.perm_generator = perm_generator or torch.Generator()

    # ---- ego-axis compaction ---------------------------------------------

    def ctrl_slots(self, scene: Scene):
        """Controlled-first ego selection: None (dense), [W, C] per-world
        slots (stable order, controlled first), or the flat
        (w_idx [N], a_idx [N]) pair holding the batch's controlled agents in
        (world, slot) order, padded with the first uncontrolled slots;
        padding rows are masked out of every loss."""
        cfg = self.config
        if not cfg.compact:
            return None
        ctrl = scene.agents.controlled
        W, A = ctrl.shape
        key = torch.where(ctrl, 0, 1)
        if self.flat_mode:
            nb, compact = max(cfg.compact_blocks, 1), cfg.compact
            if self.group is not None:
                if nb > 1:  # this rank's blocks of one process's
                    if compact % nb:
                        raise ValueError("compact_blocks must divide "
                                         "compact")
                    compact //= self.group.size
                    nb //= self.group.size
                else:
                    compact = len(rank_rows(self.group, ctrl, compact))
            if nb > 1:
                if W % nb or compact % nb:
                    raise ValueError("compact_blocks must divide num_worlds "
                                     "and compact")
                o = torch.argsort(key.reshape(nb, (W // nb) * A), dim=1,
                                  stable=True)[:, : compact // nb]
                base = torch.arange(nb, device=o.device)[:, None] * (
                    (W // nb) * A)
                order = (o + base).reshape(-1)
            else:
                order = torch.argsort(key.reshape(-1), stable=True)
                order = order[:compact]
            return order // A, order % A
        return torch.argsort(key, dim=1, stable=True)[:, : cfg.compact]

    def global_rows(self, scene: Scene) -> torch.Tensor:
        """The indices, on axis 1 of one process's trajectory tensors
        ([T, W, ...] or [T, N]), of this rank's rows (int64, host): its
        block of worlds, or its rows of the flat selection.  Slices one
        process's actions for the rank (``rollout(actions=...)``)."""
        W = scene.agents.controlled.shape[0]
        if self.group is None:
            n = self.config.compact if self.flat_mode else W
            return torch.arange(n)
        r, n = self.group.rank, self.group.size
        if not self.flat_mode:
            return torch.arange(r * W, (r + 1) * W)
        if self.config.compact_blocks > 1:
            k = self.config.compact // n
            return torch.arange(r * k, (r + 1) * k)
        return rank_rows(self.group, scene.agents.controlled,
                         self.config.compact)

    def _gather_c(self, x: torch.Tensor, cidx) -> torch.Tensor:
        """[W, A(, d)] -> [W, C(, d)] / [N(, d)] (identity when dense)."""
        if cidx is None:
            return x
        if self.flat_mode:
            return x[cidx[0], cidx[1]]
        return torch.gather(x, 1, cidx.reshape(
            cidx.shape + (1,) * (x.dim() - 2)).expand(
                cidx.shape + x.shape[2:]))

    # ---- rollout ---------------------------------------------------------

    def _rollout_step(self, scene, carry: EnvCarry, fresh: SimState,
                      reward_weights, cidx, action=None):
        cfg = self.config
        controlled = scene.agents.controlled
        W, A = controlled.shape
        obs = flat_observation(scene, carry.state, self.params, self.spec,
                               reward_weights, cidx, split=self.split_store)[0]
        logits, value = self.policy(obs)
        with span("ppo.action"):
            a, logp, _ = sample_logits(carry.rng, logits, action)
            mask = self._gather_c(controlled & (carry.state.done == 0), cidx)
            if cidx is None:
                a_full = a
            elif self.flat_mode:
                # padding rows land on uncontrolled slots, inert in step()
                a_full = torch.zeros((W, A), dtype=a.dtype, device=a.device)
                a_full[cidx[0], cidx[1]] = a
            else:
                a_full = torch.zeros((W, A), dtype=a.dtype, device=a.device)
                a_full.scatter_(1, cidx, a)
            act = torch.zeros(a_full.shape + (C.ACTION_DIM,),
                              dtype=torch.float32, device=a.device)
            act[..., :3] = self.action_table[a_full.long()]
        state = stepmod.step(scene, carry.state, act, self.params)
        with span("ppo.reward"):
            # world clock: advances unless some agent finished (the env's
            # order)
            valid = scene.agents.valid
            any_done = ((state.done != 0) & valid).any(dim=1)
            wts_mid = torch.where(any_done, carry.world_time_steps,
                                  carry.world_time_steps + 1)
            reward = shaped_rewards(scene, state, self.reward_type,
                                    reward_weights, wts_mid)
            done = (state.done != 0).to(torch.float32)
            # auto-reset finished worlds (reference: env_puffer.py:265-386)
            world_done = stepmod.world_done(scene, state)
            n_ctrl = controlled.sum(dim=1).clamp(min=1)

            def frac(x):
                return torch.where(world_done, (x * controlled).sum(dim=1)
                                   / n_ctrl, 0.0)

            t = Transition(
                obs=None if cfg.remat_obs else _map_obs(
                    lambda o: o.to(getattr(torch, cfg.obs_store_dtype)), obs),
                action=a, logprob=logp, value=value,
                reward=self._gather_c(reward, cidx),
                done=self._gather_c(done, cidx), mask=mask,
                ep_done=world_done,
                ep_goal=frac(state.reached_goal),
                ep_collided=frac(torch.clamp(
                    state.collided_vehicle + state.collided_non_vehicle, 0,
                    1)),
                ep_off_road=frac(torch.clamp(state.collided_road, 0, 1)),
                env_state=carry.state if cfg.remat_obs else None,
            )
        state = stepmod.select_worlds(world_done, fresh, state)
        wts = torch.where(world_done,
                          torch.full_like(wts_mid, cfg.reset_time_step),
                          wts_mid)
        return EnvCarry(state, wts, carry.rng), t

    @torch.no_grad()
    def rollout(self, scene: Scene, carry: EnvCarry, fresh: SimState,
                reward_weights: torch.Tensor, actions=None):
        """``rollout_len`` steps from ``carry``; returns (carry, traj) with
        the Transition fields stacked [T, ...].  ``actions`` [T, ...] int
        (the policy's ego layout) replaces the sampled actions."""
        with span("ppo.rollout"):
            cidx = self.ctrl_slots(scene)
            ts = []
            for i in range(self.config.rollout_len):
                with span("ppo.rollout_step"):
                    carry, t = self._rollout_step(
                        scene, carry, fresh, reward_weights, cidx,
                        None if actions is None else actions[i])
                ts.append(t)
            return carry, Transition(
                obs=None if ts[0].obs is None else (
                    tuple(torch.stack(x) for x in zip(*(t.obs for t in ts)))
                    if isinstance(ts[0].obs, tuple)
                    else torch.stack([t.obs for t in ts])),
                env_state=(_stack_states([t.env_state for t in ts])
                           if self.config.remat_obs else None),
                **{f: torch.stack([getattr(t, f) for t in ts])
                   for f in Transition._fields
                   if f not in ("obs", "env_state")},
            )

    # ---- update ----------------------------------------------------------

    @torch.no_grad()
    def prepare(self, scene: Scene, carry: EnvCarry, traj: Transition,
                reward_weights: torch.Tensor) -> dict:
        """The bootstrap value of the state after the rollout and GAE;
        returns the training batch (time-major tensors)."""
        cfg = self.config
        with span("ppo.prepare"):
            last_obs = flat_observation(scene, carry.state, self.params,
                                        self.spec, reward_weights,
                                        self.ctrl_slots(scene))[0]
            _, last_value = self.policy(last_obs)
            advs, rets = compute_gae(traj.reward, traj.value, traj.done,
                                     last_value, cfg.gamma, cfg.gae_lambda)
        batch = {"action": traj.action, "logprob": traj.logprob,
                 "value": traj.value, "adv": advs, "ret": rets,
                 "mask": traj.mask}
        if not cfg.remat_obs:
            batch["obs"] = traj.obs
        return batch

    def minibatch_order(self):
        """Per epoch and minibatch, the time indices and the first row of
        the minibatch: (perms [E, M, Tm] int, row_starts [E, M] int) as
        nested lists, drawn from ``perm_generator`` (host side).  With
        minibatch_rows the M minibatches of an epoch tile the (time group,
        row block) grid in a random order, as in the JAX package."""
        cfg = self.config
        T, M = cfg.rollout_len, cfg.num_minibatches
        g = self.perm_generator
        perms, starts = [], []
        for _ in range(cfg.update_epochs):
            perm = torch.randperm(T, generator=g)
            if self._use_rows():
                G = cfg.compact // cfg.minibatch_rows
                Mt = M // G
                tgroups = perm.reshape(Mt, T // Mt)
                pairs = torch.randperm(M, generator=g)
                perms.append(tgroups[pairs // G].tolist())
                starts.append(((pairs % G) * cfg.minibatch_rows).tolist())
            else:
                perms.append(perm.reshape(M, T // M).tolist())
                starts.append([0] * M)
        return perms, starts

    def _use_rows(self) -> bool:
        return self.flat_mode and self.config.minibatch_rows > 0

    def _check_shapes(self):
        cfg = self.config
        T, M = cfg.rollout_len, cfg.num_minibatches
        if self._use_rows():
            rows = cfg.minibatch_rows
            if cfg.compact % rows:
                raise ValueError("minibatch_rows must divide compact")
            G = cfg.compact // rows
            if M % G or T % (M // G):
                raise ValueError(
                    "num_minibatches must be divisible by "
                    "compact//minibatch_rows, and the quotient must divide "
                    "rollout_len")
        elif T % M:
            raise ValueError("num_minibatches must divide rollout_len")

    def _minibatch(self, batch: dict, traj: Transition, t_idx, rstart: int,
                   scene, reward_weights, cidx) -> dict:
        cfg = self.config
        rows = cfg.minibatch_rows if self._use_rows() else 0

        def take(x):
            xt = torch.stack([x[t] for t in t_idx])
            if rows:
                xt = xt[:, rstart:rstart + rows]
            return xt.reshape((-1,) + x.shape[self.batch_lead:])

        with span("ppo.gather"):
            mb = {k: _map_obs(take, v) if k == "obs" else take(v)
                  for k, v in batch.items()}
        if cfg.remat_obs:
            # recompute this minibatch's observations from the stored
            # pre-step states (only this row block's agents when row-sliced)
            if rows:
                cidx = tuple(c[rstart:rstart + rows] for c in cidx)
            mb["obs"] = flat_obs_kernel.flat_obs_rows(
                scene, traj.env_state, t_idx, cidx, self.params, self.spec,
                reward_weights)
        elif cfg.policy_dtype == "float32":
            mb["obs"] = _map_obs(lambda o: o.to(torch.float32), mb["obs"])
        # else the store goes to the bf16 policy as it is: its Dense layers
        # and K3/K4 read bf16 or float32 alike (JAX ppo.py:446-453)
        return mb

    def loss(self, mb: dict, ent_coef):
        """The PPO loss of one minibatch -> (loss, aux dict of detached
        scalars)."""
        cfg = self.config
        logits, newvalue = self.policy(mb["obs"])
        _, newlogp, entropy = sample_logits(None, logits, mb["action"])
        logratio = newlogp - mb["logprob"]
        ratio = torch.exp(logratio)
        m = mb["mask"].to(torch.float32)
        adv, msum = normalize_advantages(mb["adv"], m, cfg.norm_adv,
                                         self.group)

        pg1 = -adv * ratio
        pg2 = -adv * torch.clamp(ratio, 1.0 - cfg.clip_coef,
                                 1.0 + cfg.clip_coef)
        pg_loss = (torch.maximum(pg1, pg2) * m).sum() / msum
        if cfg.clip_vloss:
            v_clipped = mb["value"] + torch.clamp(
                newvalue - mb["value"], -cfg.vf_clip_coef, cfg.vf_clip_coef)
            v_loss = (0.5 * torch.maximum((newvalue - mb["ret"]) ** 2,
                                          (v_clipped - mb["ret"]) ** 2)
                      * m).sum() / msum
        else:
            v_loss = (0.5 * (newvalue - mb["ret"]) ** 2 * m).sum() / msum
        ent_loss = (entropy * m).sum() / msum
        loss = pg_loss - ent_coef * ent_loss + cfg.vf_coef * v_loss
        approx_kl = (((ratio - 1.0) - logratio) * m).sum() / msum
        return loss, {"pg_loss": pg_loss.detach(), "v_loss": v_loss.detach(),
                      "entropy": ent_loss.detach(),
                      "approx_kl": approx_kl.detach()}

    def learn(self, scene: Scene, batch: dict, traj: Transition,
              reward_weights: torch.Tensor, ent_coef=None, perms=None,
              row_starts=None) -> dict:
        """The update epochs over ``batch`` (from ``prepare``).  ``perms``
        [E, M, Tm] (and ``row_starts`` [E, M] with minibatch_rows) give the
        minibatch order; by default it is drawn by ``minibatch_order``.
        Returns each loss metric per minibatch, [E, M] on the device."""
        cfg = self.config
        names = ("pg_loss", "v_loss", "entropy", "approx_kl")
        if cfg.update_epochs == 0:
            zero = torch.zeros((1, 1), device=batch["mask"].device)
            return dict.fromkeys(names, zero)
        self._check_shapes()
        if ent_coef is None:
            ent_coef = cfg.ent_coef
        if perms is None:
            perms, row_starts = self.minibatch_order()
        perms = torch.as_tensor(perms).tolist()
        if row_starts is None:
            row_starts = [[0] * len(p) for p in perms]
        row_starts = torch.as_tensor(row_starts).tolist()
        with span("ppo.learn"):
            cidx = self.ctrl_slots(scene) if cfg.remat_obs else None
            auxes = []
            for e in range(cfg.update_epochs):
                for m in range(cfg.num_minibatches):
                    with span("ppo.minibatch"):
                        auxes.append(self._step(
                            self._minibatch(batch, traj, perms[e][m],
                                            row_starts[e][m], scene,
                                            reward_weights, cidx),
                            ent_coef))
            # each rank's terms are its own sums over the global mask sum
            out = _global_sum(self.group, torch.stack(
                [torch.stack([a[k] for a in auxes]) for k in names]))
        return {k: out[i].reshape(cfg.update_epochs, cfg.num_minibatches)
                for i, k in enumerate(names)}

    def _step(self, mb: dict, ent_coef) -> dict:
        """One optimizer step on the minibatch ``mb``; returns its loss
        terms."""
        with span("ppo.loss"):
            loss, aux = self.loss(mb, ent_coef)
        with span("ppo.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("ppo.optimizer"):
            if self.group is not None:
                sync_gradients(self.policy.parameters(), self.group)
            clip_by_global_norm(self.policy.parameters(),
                                self.config.max_grad_norm)
            self.optimizer.step()
        return aux

    @staticmethod
    def episode_metrics(traj: Transition,
                        group: WorldGroup | None = None) -> dict:
        """Sample count, mean reward and the finished episodes' outcomes,
        over every rank's rows and worlds."""
        mask = traj.mask
        counts = _global_sum(group, torch.stack([mask.sum(),
                                                 traj.ep_done.sum()]))
        sums = _global_sum(group, torch.stack([
            (traj.reward * mask).sum(), traj.ep_goal.sum(),
            traj.ep_collided.sum(), traj.ep_off_road.sum()]))
        n_ep = torch.clamp(counts[1], min=1)
        return {
            "mean_reward": sums[0] / torch.clamp(counts[0], min=1),
            "samples": counts[0],
            "episodes": counts[1],
            "perc_goal_achieved": sums[1] / n_ep,
            "perc_collisions": sums[2] / n_ep,
            "perc_off_road": sums[3] / n_ep,
        }

    def update(self, scene: Scene, carry: EnvCarry, traj: Transition,
               reward_weights: torch.Tensor, ent_coef=None, perms=None,
               row_starts=None) -> dict:
        """GAE and the update epochs; returns the metrics (device scalars,
        the losses averaged over the minibatches)."""
        batch = self.prepare(scene, carry, traj, reward_weights)
        metrics = {k: v.mean() for k, v in self.learn(
            scene, batch, traj, reward_weights, ent_coef, perms,
            row_starts).items()}
        metrics.update(self.episode_metrics(traj, self.group))
        return metrics

    def train_step(self, scene: Scene, carry: EnvCarry, fresh: SimState,
                   reward_weights: torch.Tensor, ent_coef=None):
        """One iteration: rollout then update.  ``ent_coef`` overrides the
        config value (the entropy-floor controller).  Returns (carry,
        metrics)."""
        carry, traj = self.rollout(scene, carry, fresh, reward_weights)
        return carry, self.update(scene, carry, traj, reward_weights,
                                  ent_coef)
