"""PPO of the plain reference (reference: gpudrive/integrations/puffer/
ppo.py): the flat compaction of the learner's rows, GAE, the clipped
policy and value loss with the entropy bonus, the global-norm clip, and
one iteration driven by the actions and minibatch order that the program
under test chose.

Follows the port's ``ppo/ppo.py`` for ``compact_mode="flat"`` with the
observations recomputed per minibatch, no value clipping and one process.
"""

from __future__ import annotations

import dataclasses

import torch

from . import step as stepmod
from .env_obs import flat_observation, shaped_rewards
from .policy import log_prob_entropy


def flat_slots(controlled: torch.Tensor, compact: int):
    """(w_idx [N], a_idx [N]): the batch's controlled agents in (world,
    slot) order, padded with the first uncontrolled slots, N = compact."""
    A = controlled.shape[1]
    key = torch.where(controlled, 0, 1)
    order = torch.argsort(key.reshape(-1), stable=True)[:compact]
    return order // A, order % A


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """GAE over [T, ...]; ``dones[t]`` is the done after step t."""
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    adv = torch.zeros_like(last_value)
    out = [None] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = (rewards[t] + gamma * next_values[t] * (1.0 - dones[t])
                 - values[t])
        adv = delta + gamma * lam * (1.0 - dones[t]) * adv
        out[t] = adv
    advs = torch.stack(out)
    return advs, advs + values


def clip_by_global_norm(parameters, max_norm: float) -> None:
    grads = [p.grad for p in parameters if p.grad is not None]
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    if g_norm >= max_norm:
        for g in grads:
            g.copy_((g / g_norm) * max_norm)


def ppo_loss(net, obs, mb: dict, cfg: dict, ent_coef: float):
    """(loss, terms) of one minibatch; terms are detached floats."""
    logits, newvalue = net(obs)
    newlogp, entropy = log_prob_entropy(logits, mb["action"])
    logratio = newlogp - mb["logprob"]
    ratio = torch.exp(logratio)
    m = mb["mask"].to(torch.float32)
    msum = torch.clamp(m.sum(), min=1.0)
    adv = mb["adv"]
    if cfg["norm_adv"]:
        mean = (adv * m).sum() / msum
        var = (((adv - mean) ** 2) * m).sum() / msum
        adv = (adv - mean) * torch.rsqrt(var + 1e-8)
    clip = cfg["clip_coef"]
    pg = torch.maximum(-adv * ratio,
                       -adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip))
    pg_loss = (pg * m).sum() / msum
    v_loss = (0.5 * (newvalue - mb["ret"]) ** 2 * m).sum() / msum
    ent = (entropy * m).sum() / msum
    loss = pg_loss - ent_coef * ent + cfg["vf_coef"] * v_loss
    kl = (((ratio - 1.0) - logratio) * m).sum() / msum
    terms = {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
             "approx_kl": kl}
    return loss, {k: float(v.detach()) for k, v in terms.items()}


@dataclasses.dataclass
class Rollout:
    logprob: torch.Tensor  # [T, N] of the program's actions
    value: torch.Tensor
    entropy: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    mask: torch.Tensor
    states: list  # the pre-step state of each step
    last_value: torch.Tensor
    action: torch.Tensor
    after: list  # the state after each step's reset select


class Learner:
    """The reference's side of training: the scene, the net and Adam,
    stepped by the program's actions and minibatch order."""

    def __init__(self, scene, params, spec, table, reward_type: str,
                 reward_weights, net, cfg: dict):
        self.scene, self.params, self.spec = scene, params, spec
        self.table, self.reward_type = table, reward_type
        self.rw, self.net, self.cfg = reward_weights, net, cfg
        self.cidx = flat_slots(scene.agents.controlled, cfg["compact"])
        self.optimizer = torch.optim.Adam(net.parameters(),
                                          lr=cfg["learning_rate"], eps=1e-5)
        # (minibatch with its "obs", ent_coef) -> (loss, terms)
        self.loss_fn = lambda mb, c: ppo_loss(net, mb["obs"], mb, cfg, c)

    def obs(self, state):
        return flat_observation(self.scene, state, self.params, self.spec,
                                self.rw, self.cidx)[0]

    @torch.no_grad()
    def rollout(self, state, wts, fresh, actions, generator=None,
                follow=None):
        """``actions`` [T, N]: the program's; or, with ``actions`` an int
        T, drawn from the policy with ``generator``.  With ``follow``, the
        program's T + 1 states (before each step, then after the last),
        step t starts from ``follow[t]``, not from the state the rollout
        reached.  Returns (state, wts, Rollout) with the actions taken and
        the state after each step's reset select."""
        scene, cidx = self.scene, self.cidx
        valid, controlled = scene.agents.valid, scene.agents.controlled
        W, A = valid.shape
        out = {k: [] for k in ("logprob", "value", "entropy", "reward",
                               "done", "mask")}
        states, taken, after = [], [], []
        steps = range(actions) if isinstance(actions, int) else actions
        for t, a in enumerate(steps):
            if follow is not None:
                state = follow[t]
            states.append(state)
            logits, value = self.net(self.obs(state))
            if isinstance(actions, int):
                a = torch.multinomial(torch.softmax(logits, -1), 1,
                                      generator=generator)[:, 0].int()
            taken.append(a)
            logp, ent = log_prob_entropy(logits, a)
            mask = (controlled & (state.done == 0))[cidx]
            a_full = torch.zeros((W, A), dtype=torch.long, device=a.device)
            a_full[cidx[0], cidx[1]] = a.long()
            act = torch.zeros((W, A, 10), dtype=torch.float32,
                              device=a.device)
            act[..., :3] = self.table[a_full]
            state = stepmod.step(scene, state, act, self.params)
            any_done = ((state.done != 0) & valid).any(dim=1)
            wts_mid = torch.where(any_done, wts, wts + 1)
            reward = shaped_rewards(scene, state, self.reward_type, self.rw,
                                    wts_mid)
            world_done = ((state.done != 0) | ~valid).all(dim=1)
            for k, v in (("logprob", logp), ("value", value),
                         ("entropy", ent), ("reward", reward[cidx]),
                         ("done", (state.done != 0).float()[cidx]),
                         ("mask", mask)):
                out[k].append(v)
            state = stepmod.select_worlds(world_done, fresh, state)
            after.append(state)
            wts = torch.where(world_done,
                              torch.full_like(wts_mid,
                                              self.cfg["reset_time_step"]),
                              wts_mid)
        if follow is not None:
            state = follow[-1]
        _, last_value = self.net(self.obs(state))
        return state, wts, Rollout(
            **{k: torch.stack(v) for k, v in out.items()}, states=states,
            last_value=last_value, action=torch.stack(taken), after=after)

    def learn(self, ro: Rollout, actions, perms, ent_coef: float,
              on_step=None, steps: int | None = None) -> list:
        """The minibatch epochs over the rollout in the order ``perms``
        [E][M][Tm], or their first ``steps`` minibatches; returns each
        minibatch's loss terms.  ``on_step(k, optimizer)`` runs after the
        k-th Adam step (from 1)."""
        cfg = self.cfg
        advs, rets = compute_gae(ro.reward, ro.value, ro.done, ro.last_value,
                                 cfg["gamma"], cfg["gae_lambda"])
        batch = {"action": actions, "logprob": ro.logprob, "adv": advs,
                 "ret": rets, "mask": ro.mask}
        terms = []
        order = [t_idx for epoch in perms for t_idx in epoch]
        for t_idx in order[:steps]:
            mb = {k: torch.stack([v[t] for t in t_idx]).reshape(-1)
                  for k, v in batch.items()}
            obs = torch.stack([self.obs(ro.states[t]) for t in t_idx])
            mb["obs"] = obs.reshape(-1, obs.shape[-1])
            loss, aux = self.loss_fn(mb, ent_coef)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            clip_by_global_norm(list(self.net.parameters()),
                                cfg["max_grad_norm"])
            self.optimizer.step()
            terms.append(aux)
            if on_step is not None:
                on_step(len(terms), self.optimizer)
        return terms
