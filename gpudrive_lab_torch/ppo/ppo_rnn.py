"""Recurrent PPO, an LSTM policy trained with BPTT (port of
``gpudrive_lab_tpu/ppo/ppo_rnn.py``; reference: the optional
use_rnn/bptt_horizon path of integrations/puffer/ppo.py:59-73, 156-163).

Against the feed-forward trainer (``ppo.py``):

  * the rollout carries an LSTM state per ego row, zeroed before a step
    where the agent is done or its world was reset at the end of the step
    before (``reset_pre``, stored per step);
  * the update replays the whole rollout through the network from the
    rollout's first LSTM state, with the stored ``reset_pre``, so recurrent
    credit assignment is exact; minibatches are over axis 1 of the
    trajectory, worlds [T, W, A] in the dense layout and ego rows [T, N]
    in the flat one (``compact_mode="flat"``, the batch's controlled agents
    from ``ctrl_slots``), which are independent sequences.

The replay embeds the [T x rows] observations of a minibatch in one pass
(the embeds do not depend on the LSTM state) and then loops over T for the
cell and the heads only: the same arithmetic per row as a step-by-step
replay, with about T times fewer launches for the embeds.

Random streams are those of ``ppo.py``: actions from ``RnnCarry.rng`` (a
``torch.Generator`` on the env's device), the minibatch order from
``RnnPPO.perm_generator`` on the host; the rollout takes ``actions=`` and
the update ``perms=`` instead, so the JAX package's draws can drive it.
As in the JAX trainer, a finished world is reset to ``fresh`` with its
clock at 0, observations are stored in ``obs_store_dtype`` and cast to
float32 for the replay, and ``unroll`` is accepted with the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.types import Params, Scene, SimState
from gpudrive_lab_torch.env.env_torch import (
    ObsSpec,
    flat_observation,
    shaped_rewards,
)
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionLSTMPolicy,
    sample_logits,
)
from gpudrive_lab_torch.ppo.ppo import (
    PPO,
    PPOConfig,
    clip_by_global_norm,
    compute_gae,
)


class RnnCarry(NamedTuple):
    state: SimState
    lstm: tuple  # (c, h): [W, A, H] each, or [N, H] in the flat layout
    world_time_steps: torch.Tensor
    rng: torch.Generator  # draws the rollout's actions; on the env's device
    # worlds reset at the end of the step before: their LSTM state is
    # zeroed at the start of the next step (and in the replay)
    just_reset: torch.Tensor  # [W] bool


class RnnTransition(NamedTuple):
    """One rollout step; ``RnnPPO.rollout`` stacks them along [T]."""

    obs: torch.Tensor  # [.., D] in obs_store_dtype
    reset_pre: torch.Tensor  # carry reset before the step (float32)
    action: torch.Tensor
    logprob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    mask: torch.Tensor
    ep_done: torch.Tensor  # [W] bool: the world finished this step
    ep_goal: torch.Tensor
    ep_collided: torch.Tensor
    ep_off_road: torch.Tensor


LOSS_NAMES = ("pg_loss", "v_loss", "entropy", "approx_kl")


class RnnPPO:
    """Recurrent PPO over ``policy`` on the env described by (params, spec,
    action_table, reward_type).  ``rollout``, ``prepare`` (bootstrap value
    and GAE) and ``learn`` (the BPTT minibatch epochs) are the phases of
    ``train_step``; the policy and ``optimizer`` (Adam, eps 1e-5, behind
    the global-norm clip) are updated in place.  ``config`` reads the
    PPOConfig fields the JAX recurrent trainer reads."""

    def __init__(self, policy: LateFusionLSTMPolicy, params: Params,
                 spec: ObsSpec, action_table: torch.Tensor, reward_type: str,
                 config: PPOConfig,
                 perm_generator: torch.Generator | None = None):
        self.policy = policy
        self.params = params
        self.spec = spec
        self.action_table = action_table
        self.reward_type = reward_type
        self.config = config
        self.flat_mode = bool(config.compact) and config.compact_mode == "flat"
        self.optimizer = torch.optim.Adam(
            policy.parameters(), lr=config.learning_rate, eps=1e-5)
        self.perm_generator = perm_generator or torch.Generator()

    def ctrl_slots(self, scene: Scene):
        """Flat layout: (w_idx [N], a_idx [N]), the batch's controlled
        agents in (world, slot) order then the first uncontrolled slots;
        None in the dense layout."""
        if not self.flat_mode:
            return None
        ctrl = scene.agents.controlled
        A = ctrl.shape[1]
        order = torch.argsort(torch.where(ctrl, 0, 1).reshape(-1),
                              stable=True)[: self.config.compact]
        return order // A, order % A

    def initial_lstm(self, scene: Scene) -> tuple:
        """Zero LSTM state for the layout: [compact, H] flat, else one row
        per agent row of the env [W, A, H]."""
        if self.flat_mode:
            return self.policy.initialize_carry((self.config.compact,))
        return self.policy.initialize_carry(
            tuple(scene.agents.controlled.shape))

    def reset_signal(self, state: SimState, just_reset, cidx):
        """max(agent done, world just reset) per ego row, float32."""
        done = (state.done != 0).to(torch.float32)
        jr = just_reset.to(torch.float32)
        if cidx is None:
            return torch.maximum(done, jr[:, None])
        return torch.maximum(done[cidx[0], cidx[1]], jr[cidx[0]])

    @staticmethod
    def _gather(x, cidx):
        return x if cidx is None else x[cidx[0], cidx[1]]

    def _rollout_step(self, scene, carry: RnnCarry, fresh: SimState,
                      reward_weights, cidx, action=None):
        cfg = self.config
        controlled = scene.agents.controlled
        W, A = controlled.shape
        obs = flat_observation(scene, carry.state, self.params, self.spec,
                               reward_weights, cidx)[0]
        reset_pre = self.reset_signal(carry.state, carry.just_reset, cidx)
        lstm, logits, value = self.policy(obs, carry.lstm, reset_pre)
        a, logp, _ = sample_logits(carry.rng, logits, action)
        mask = self._gather(controlled & (carry.state.done == 0), cidx)
        if cidx is None:
            a_full = a
        else:  # padding rows land on uncontrolled slots, inert in step()
            a_full = torch.zeros((W, A), dtype=a.dtype, device=a.device)
            a_full[cidx[0], cidx[1]] = a
        act = torch.zeros(a_full.shape + (C.ACTION_DIM,), dtype=torch.float32,
                          device=a.device)
        act[..., :3] = self.action_table[a_full.long()]
        state = stepmod.step(scene, carry.state, act, self.params)
        # world clock: advances unless some agent finished (the env's order)
        valid = scene.agents.valid
        any_done = ((state.done != 0) & valid).any(dim=1)
        wts_mid = torch.where(any_done, carry.world_time_steps,
                              carry.world_time_steps + 1)
        reward = shaped_rewards(scene, state, self.reward_type,
                                reward_weights, wts_mid)
        done = (state.done != 0).to(torch.float32)
        world_done = ((state.done != 0) | ~valid).all(dim=1)
        n_ctrl = controlled.sum(dim=1).clamp(min=1)

        def frac(x):
            return torch.where(world_done, (x * controlled).sum(dim=1)
                               / n_ctrl, 0.0)

        t = RnnTransition(
            obs=obs.to(getattr(torch, cfg.obs_store_dtype)),
            reset_pre=reset_pre, action=a, logprob=logp, value=value,
            reward=self._gather(reward, cidx),
            done=self._gather(done, cidx), mask=mask,
            ep_done=world_done,
            ep_goal=frac(state.reached_goal),
            ep_collided=frac(torch.clamp(
                state.collided_vehicle + state.collided_non_vehicle, 0, 1)),
            ep_off_road=frac(torch.clamp(state.collided_road, 0, 1)),
        )
        state = stepmod.select_worlds(world_done, fresh, state)
        wts = torch.where(world_done, torch.zeros_like(wts_mid), wts_mid)
        return RnnCarry(state, lstm, wts, carry.rng, world_done), t

    @torch.no_grad()
    def rollout(self, scene: Scene, carry: RnnCarry, fresh: SimState,
                reward_weights: torch.Tensor, actions=None):
        """``rollout_len`` steps from ``carry``; returns (carry, traj), the
        RnnTransition fields stacked [T, ...].  ``actions`` [T, rows] int
        replaces the sampled actions."""
        cidx = self.ctrl_slots(scene)
        ts = []
        for i in range(self.config.rollout_len):
            carry, t = self._rollout_step(
                scene, carry, fresh, reward_weights, cidx,
                None if actions is None else actions[i])
            ts.append(t)
        return carry, RnnTransition(*(torch.stack(x) for x in zip(*ts)))

    @torch.no_grad()
    def prepare(self, scene: Scene, carry: RnnCarry, traj: RnnTransition,
                reward_weights: torch.Tensor) -> dict:
        """The bootstrap value after the rollout (the LSTM state reset by
        ``reset_last``, as the next step would reset it) and GAE; returns
        the training batch, time-major."""
        cfg = self.config
        cidx = self.ctrl_slots(scene)
        last_obs = flat_observation(scene, carry.state, self.params,
                                    self.spec, reward_weights, cidx)[0]
        reset_last = self.reset_signal(carry.state, carry.just_reset, cidx)
        _, _, last_value = self.policy(last_obs, carry.lstm, reset_last)
        advs, rets = compute_gae(traj.reward, traj.value, traj.done,
                                 last_value, cfg.gamma, cfg.gae_lambda)
        return {"obs": traj.obs, "reset_pre": traj.reset_pre,
                "action": traj.action, "logprob": traj.logprob,
                "value": traj.value, "adv": advs, "ret": rets,
                "mask": traj.mask}

    def replay(self, obs, reset_pre, init_lstm):
        """The policy over a [T, rows, ...] sequence from ``init_lstm``:
        (logits [T, rows, action_dim], value [T, rows]).  One ``encode``
        for every step, then the cell and the heads step by step."""
        T = obs.shape[0]
        feats = self.policy.encode(obs.to(torch.float32))
        lstm, logits, values = init_lstm, [], []
        for t in range(T):
            lstm, lg, v = self.policy.step(feats[t], lstm, reset_pre[t])
            logits.append(lg)
            values.append(v)
        return torch.stack(logits), torch.stack(values)

    def loss(self, mb: dict, init_lstm, ent_coef):
        """The PPO loss of one minibatch replayed from ``init_lstm`` ->
        (loss, aux dict of detached scalars)."""
        cfg = self.config
        logits, newvalue = self.replay(mb["obs"], mb["reset_pre"], init_lstm)
        _, newlogp, entropy = sample_logits(None, logits, mb["action"])
        m = mb["mask"].to(torch.float32)
        msum = torch.clamp(m.sum(), min=1.0)
        logratio = newlogp - mb["logprob"]
        ratio = torch.exp(logratio)
        adv = mb["adv"]
        if cfg.norm_adv:
            mean = (adv * m).sum() / msum
            var = (((adv - mean) ** 2) * m).sum() / msum
            adv = (adv - mean) * torch.rsqrt(var + 1e-8)
        pg1 = -adv * ratio
        pg2 = -adv * torch.clamp(ratio, 1.0 - cfg.clip_coef,
                                 1.0 + cfg.clip_coef)
        pg_loss = (torch.maximum(pg1, pg2) * m).sum() / msum
        v_loss = (0.5 * (newvalue - mb["ret"]) ** 2 * m).sum() / msum
        ent_loss = (entropy * m).sum() / msum
        loss = pg_loss - ent_coef * ent_loss + cfg.vf_coef * v_loss
        approx_kl = (((ratio - 1.0) - logratio) * m).sum() / msum
        return loss, {"pg_loss": pg_loss.detach(), "v_loss": v_loss.detach(),
                      "entropy": ent_loss.detach(),
                      "approx_kl": approx_kl.detach()}

    def minibatch_order(self, rows: int):
        """Per epoch, a permutation of the ``rows`` sequences cut into
        num_minibatches groups: [E, M, rows // M] nested lists, drawn from
        ``perm_generator``."""
        M = min(self.config.num_minibatches, rows)
        return [torch.randperm(rows, generator=self.perm_generator)
                .reshape(M, rows // M).tolist()
                for _ in range(self.config.update_epochs)]

    def learn(self, batch: dict, init_lstm, ent_coef=None,
              perms=None) -> dict:
        """The update epochs over ``batch`` (from ``prepare``), each
        minibatch replayed from its rows of ``init_lstm`` (the rollout's
        first LSTM state).  ``perms`` [E, M, rows // M] gives the minibatch
        order.  Returns each loss metric per minibatch, [E, M]."""
        cfg = self.config
        B = batch["mask"].shape[1]
        M = min(cfg.num_minibatches, B)
        assert B % M == 0, "minibatch axis must divide num_minibatches"
        if ent_coef is None:
            ent_coef = cfg.ent_coef
        if perms is None:
            perms = self.minibatch_order(B)
        perms = torch.as_tensor(perms).tolist()
        dev = batch["mask"].device
        auxes = []
        for e in range(cfg.update_epochs):
            for m in range(M):
                idx = torch.as_tensor(perms[e][m], device=dev)
                mb = {k: v.index_select(1, idx) for k, v in batch.items()}
                lstm0 = tuple(x.index_select(0, idx) for x in init_lstm)
                loss, aux = self.loss(mb, lstm0, ent_coef)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm(self.policy.parameters(),
                                    cfg.max_grad_norm)
                self.optimizer.step()
                auxes.append(aux)
        return {k: torch.stack([a[k] for a in auxes]).reshape(
            cfg.update_epochs, M) for k in LOSS_NAMES}

    def update(self, scene: Scene, carry: RnnCarry, traj: RnnTransition,
               reward_weights: torch.Tensor, init_lstm, ent_coef=None,
               perms=None) -> dict:
        """GAE and the update epochs; the metrics as device scalars (the
        losses averaged over the minibatches)."""
        batch = self.prepare(scene, carry, traj, reward_weights)
        metrics = {k: v.mean() for k, v in self.learn(
            batch, init_lstm, ent_coef, perms).items()}
        metrics.update(PPO.episode_metrics(traj))
        return metrics

    def train_step(self, scene: Scene, carry: RnnCarry, fresh: SimState,
                   reward_weights: torch.Tensor, ent_coef=None):
        """One iteration: rollout then update.  ``ent_coef`` overrides the
        config value (the entropy-floor controller).  Returns (carry,
        metrics)."""
        init_lstm = carry.lstm
        carry, traj = self.rollout(scene, carry, fresh, reward_weights)
        return carry, self.update(scene, carry, traj, reward_weights,
                                  init_lstm, ent_coef)


def start_carry(rnn: RnnPPO, scene: Scene, state: SimState,
                world_time_steps: torch.Tensor,
                rng: torch.Generator) -> RnnCarry:
    """The trainer's carry at ``state``: zero LSTM state, no world just
    reset."""
    return RnnCarry(state=state, lstm=rnn.initial_lstm(scene),
                    world_time_steps=world_time_steps.clone(), rng=rng,
                    just_reset=torch.zeros(scene.agents.controlled.shape[0],
                                           dtype=torch.bool,
                                           device=world_time_steps.device))

