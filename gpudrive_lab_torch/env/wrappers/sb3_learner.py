"""Masked-rollout-buffer IPPO over the SB3 VecEnv adapter (port of
``gpudrive_lab_tpu/env/wrappers/sb3_learner.py``).

The reference's second training stack (reference: gpudrive/integrations/
sb3/ppo.py:40-251 IPPO and rollout_buffer.py:23-249 MaskedRolloutBuffer): a
fixed-width vector env where dead agents carry NaN rewards and
observations, a rollout buffer whose GAE maps NaNs to safe values as the
reference's EDIT_1..EDIT_4 patches do, samples filtered by
``~isnan(reward)`` before minibatching (EDIT_5/EDIT_6), and a clipped PPO
update.  The policy is the port's LateFusionPolicy (``fused_embed`` runs
its partner and road blocks through kernels K3 and K4) and the optimizer
``torch.optim.Adam`` behind the global-norm clip, in place of optax.

The buffer lives on the env's device: 91 steps of ~4,400 agents' 3,368
floats would be 5.4 GB on the host.  The minibatch order comes from a
host ``np.random.Generator``, so it is the JAX learner's for the same seed;
the actions come from a ``torch.Generator`` on the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
    sample_logits,
)
from gpudrive_lab_torch.ppo.ppo import clip_by_global_norm


class MaskedRolloutBuffer:
    """[T, n_envs] rollout storage with NaN-tolerant GAE and valid-sample
    filtering (reference: rollout_buffer.py:23-249)."""

    def __init__(self, buffer_size: int, n_envs: int, obs_dim: int,
                 gamma: float = 0.99, gae_lambda: float = 0.95,
                 device=None):
        self.buffer_size = buffer_size
        self.n_envs = n_envs
        self.obs_dim = obs_dim
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.device = torch.device("cpu" if device is None else device)
        self.reset()

    def reset(self) -> None:
        T, N = self.buffer_size, self.n_envs

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.observations = zeros(T, N, self.obs_dim)
        self.actions = zeros(T, N, dtype=torch.int64)
        self.rewards = zeros(T, N)
        self.episode_starts = zeros(T, N)
        self.values = zeros(T, N)
        self.log_probs = zeros(T, N)
        self.advantages = zeros(T, N)
        self.returns = zeros(T, N)
        self.pos = 0
        self.full = False

    def add(self, obs, action, reward, episode_start, value, log_prob):
        t = self.pos
        for buf, x in ((self.observations, obs), (self.actions, action),
                       (self.rewards, reward),
                       (self.episode_starts, episode_start),
                       (self.values, value), (self.log_probs, log_prob)):
            buf[t] = torch.as_tensor(x, device=self.device)
        self.pos += 1
        self.full = self.pos == self.buffer_size

    def compute_returns_and_advantage(self, last_values, dones) -> None:
        """GAE with the reference's NaN patches (rollout_buffer.py:126-178):
        NaN dones and episode starts count as episode boundaries, NaN
        rewards and values contribute zero."""
        last_values = torch.as_tensor(last_values, device=self.device)
        dones = torch.as_tensor(dones, device=self.device)
        last_gae = 0.0
        for step in reversed(range(self.buffer_size)):
            if step == self.buffer_size - 1:
                next_non_terminal = 1.0 - torch.nan_to_num(dones, nan=1.0)
                next_values = last_values
            else:
                next_non_terminal = 1.0 - torch.nan_to_num(
                    self.episode_starts[step + 1], nan=1.0)
                next_values = self.values[step + 1]
            delta = (
                torch.nan_to_num(self.rewards[step], nan=0.0)
                + torch.nan_to_num(
                    self.gamma * next_values * next_non_terminal, nan=0.0)
                - torch.nan_to_num(self.values[step], nan=0.0)
            )
            last_gae = (delta + self.gamma * self.gae_lambda
                        * next_non_terminal * last_gae)
            self.advantages[step] = last_gae
        self.returns = self.advantages + torch.nan_to_num(self.values,
                                                          nan=0.0)
        if bool(torch.isnan(self.advantages).any()):
            raise FloatingPointError("advantages contain NaN: check the "
                                     "GAE inputs")

    def get(self, batch_size: Optional[int] = None,
            rng: Optional[np.random.Generator] = None
            ) -> Iterator[Dict[str, torch.Tensor]]:
        """Shuffled minibatches over the VALID samples only, validity being
        ``~isnan(reward)`` as in the reference's EDIT_5
        (rollout_buffer.py:181-230).  The order is ``rng``'s permutation of
        the valid samples, drawn on the host."""
        if not self.full:
            raise RuntimeError("the rollout buffer is not full")
        valid = ~torch.isnan(self.rewards.reshape(-1))

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])[valid]

        data = {
            "obs": torch.nan_to_num(flat(self.observations), nan=0.0),
            "action": flat(self.actions),
            "value": flat(self.values),
            "logprob": flat(self.log_probs),
            "adv": flat(self.advantages),
            "ret": flat(self.returns),
        }
        if any(bool(torch.isnan(v.float()).any()) for v in data.values()):
            raise FloatingPointError("NaN leaked into the valid samples")
        n = int(valid.sum())
        rng = rng or np.random.default_rng(0)
        order = torch.as_tensor(rng.permutation(n), device=self.device)
        batch_size = batch_size or n
        for i in range(0, n, batch_size):
            ids = order[i:i + batch_size]
            yield {k: v[ids] for k, v in data.items()}

    @property
    def num_valid_samples(self) -> int:
        return int((~torch.isnan(self.rewards)).sum())


@dataclasses.dataclass
class IPPOConfig:
    """reference: sb3/ppo.py defaults and the ppo_base_sb3 yaml."""

    n_steps: int = 91
    batch_size: int = 512
    n_epochs: int = 5
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 1e-3
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    lr: float = 3e-4
    resample_freq: int = 0  # >0: resample the scene batch every N steps


class IPPO:
    """The reference's IPPO learn loop (sb3/ppo.py:65-251) over the VecEnv
    adapter: rollouts with dead agents NaN-masked, masked GAE, clipped PPO
    epochs.  ``policy_config`` defaults to the late-fusion widths with the
    env's action count; the policy's weights are drawn from ``seed``."""

    def __init__(self, env, config: IPPOConfig | None = None,
                 policy_config: PolicyConfig | None = None, seed: int = 0):
        self.env = env
        self.config = config or IPPOConfig()
        self.policy_config = policy_config or PolicyConfig(
            action_dim=int(env.action_space_n))
        self.device = env.device
        self.policy = LateFusionPolicy(
            self.policy_config, device=self.device,
            generator=torch.Generator().manual_seed(seed))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)
        self.optimizer = torch.optim.Adam(self.policy.parameters(),
                                          lr=self.config.lr)
        self.buffer = self._new_buffer()
        self.num_timesteps = 0
        self.resample_counter = 0
        self._last_obs = None
        self._last_episode_starts = None

    def _new_buffer(self) -> MaskedRolloutBuffer:
        cfg = self.config
        return MaskedRolloutBuffer(cfg.n_steps, self.env.num_envs,
                                   self.env.obs_dim, cfg.gamma,
                                   cfg.gae_lambda, device=self.device)

    @torch.no_grad()
    def act(self, obs: torch.Tensor):
        """(action, log-probability, value) sampled for ``obs``."""
        logits, value = self.policy(obs)
        action, logp, _ = sample_logits(self.generator, logits)
        return action, logp, value

    def loss(self, mb: Dict[str, torch.Tensor]):
        """The clipped PPO loss of one minibatch and its metrics."""
        cfg = self.config
        logits, value = self.policy(mb["obs"])
        _, newlogp, entropy = sample_logits(None, logits,
                                            action=mb["action"])
        logratio = newlogp - mb["logprob"]
        ratio = torch.exp(logratio)
        adv = mb["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg1 = -adv * ratio
        pg2 = -adv * torch.clamp(ratio, 1.0 - cfg.clip_range,
                                 1.0 + cfg.clip_range)
        pg_loss = torch.maximum(pg1, pg2).mean()
        v_loss = 0.5 * torch.square(value - mb["ret"]).mean()
        ent = entropy.mean()
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        approx_kl = ((ratio - 1.0) - logratio).mean()
        return loss, {"pg_loss": pg_loss.detach(), "v_loss": v_loss.detach(),
                      "entropy": ent.detach(),
                      "approx_kl": approx_kl.detach()}

    def update(self, mb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One Adam step on ``mb`` behind the global-norm clip; returns
        the loss metrics (device scalars)."""
        loss, aux = self.loss(mb)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm(self.policy.parameters(),
                            self.config.max_grad_norm)
        self.optimizer.step()
        return aux

    def collect_rollouts(self) -> None:
        """reference: sb3/ppo.py:65-180: NaN bookkeeping for dead agents,
        the policy's outputs for live ones, and the scene resample when
        ``resample_freq`` steps have passed."""
        cfg = self.config
        if cfg.resample_freq > 0 and self.resample_counter >= cfg.resample_freq:
            self.env.resample_scenario_batch()
            self.resample_counter = 0
            self.buffer = self._new_buffer()
            self._last_obs = None

        if self._last_obs is None:
            self._last_obs = self.env.reset()
            self._last_episode_starts = torch.ones(
                self.env.num_envs, device=self.device)

        self.buffer.reset()
        for _ in range(cfg.n_steps):
            obs = self._last_obs
            dead = torch.isnan(obs).any(dim=-1) | self.env.dead_agent_mask
            action, logp, value = self.act(torch.nan_to_num(obs, nan=0.0))
            # dead agents get NaN bookkeeping so their samples drop out
            logp = logp.masked_fill(dead, float("nan"))
            value = value.masked_fill(dead, float("nan"))

            new_obs, rewards, dones, _ = self.env.step(action)
            self.buffer.add(obs, action, rewards, self._last_episode_starts,
                            value, logp)
            self._last_obs = new_obs
            self._last_episode_starts = dones.float()
            n_live = int((~dead).sum())
            self.num_timesteps += n_live
            self.resample_counter += n_live

        dead = torch.isnan(self._last_obs).any(dim=-1)
        with torch.no_grad():
            _, last_value = self.policy(
                torch.nan_to_num(self._last_obs, nan=0.0))
        self.buffer.compute_returns_and_advantage(
            last_value.masked_fill(dead, float("nan")),
            self._last_episode_starts)

    def train(self) -> Dict[str, float]:
        """reference: stable-baselines PPO.train over the masked buffer."""
        auxes = []
        for _ in range(self.config.n_epochs):
            for mb in self.buffer.get(self.config.batch_size, self.np_rng):
                auxes.append(self.update(mb))
        # a window where every sample is masked yields no minibatches
        out = {}
        if auxes:
            host = torch.stack([torch.stack(list(a.values()))
                                for a in auxes]).double().cpu()
            out = {k: float(host[:, i].mean())
                   for i, k in enumerate(auxes[0])}
        out["valid_samples"] = self.buffer.num_valid_samples
        return out

    def learn(self, total_timesteps: int,
              log_fn=None) -> List[Dict[str, float]]:
        history = []
        t0 = time.time()
        while self.num_timesteps < total_timesteps:
            self.collect_rollouts()
            m = self.train()
            m["global_step"] = self.num_timesteps
            m["sps"] = self.num_timesteps / max(time.time() - t0, 1e-9)
            history.append(m)
            if log_fn:
                log_fn(m)
        return history
