"""Faults planted under the timed path, to see the correctness check come
out false: a step that returns its state unchanged, half of the batch left
out with the mean taken over the rest, an answer altered where it is
produced, and finished worlds left unreset.  Each is a context manager that patches the program where the
drivers reach it and restores it on exit; ``control.py --fault`` reads
them on the chip, the CPU tests at a small size.  (The exchange between
chips exists in no cell of one chip.)"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def step_unchanged():
    """The simulator's step returns the state it was given."""
    from gpudrive_lab_torch.core import step as stepmod

    return _patched(stepmod, "step", lambda scene, state, act, p: state)


def step_half_batch():
    """Half of the worlds left out of the simulator's step: they keep
    their state."""
    from gpudrive_lab_torch.core import step as stepmod

    program = stepmod.step

    def step(scene, state, act, p):
        new = program(scene, state, act, p)
        W = state.pos.shape[0]
        keep = torch.arange(W, device=state.pos.device) >= W // 2
        return stepmod.select_worlds(keep, state, new)

    return _patched(stepmod, "step", step)


def reset_skipped():
    """Finished worlds are not reset: the reset select returns the state
    it was given."""
    from gpudrive_lab_torch.core import step as stepmod

    return _patched(stepmod, "select_worlds",
                    lambda done, fresh, state: state)


def obs_altered():
    """One entry of the observation altered where it is produced: agent
    0's speed in world 0, in the port's ego observation."""
    from gpudrive_lab_torch.core import observations as obsmod

    program = obsmod.self_observation

    def self_observation(*args, **kwargs):
        so = program(*args, **kwargs).clone()
        so.view(-1)[0] += 0.25
        return so

    return _patched(obsmod, "self_observation", self_observation)


def update_unchanged():
    """The optimizer's step leaves the parameters unchanged: the trainer's
    gradients are zeroed where it clips them, before Adam sees them."""
    from gpudrive_lab_torch.ppo import ppo

    def clip(parameters, max_norm):
        for p in parameters:
            if p.grad is not None:
                p.grad.zero_()

    return _patched(ppo, "clip_by_global_norm", clip)


def loss_half_batch():
    """Half of each minibatch left out of the loss, the mean taken over
    the rest."""
    from gpudrive_lab_torch.ppo import ppo

    program = ppo.PPO.loss

    def loss(self, mb, ent_coef):
        mb = dict(mb)
        m = mb["mask"].clone()
        m[m.shape[0] // 2:] = False
        mb["mask"] = m
        return program(self, mb, ent_coef)

    return _patched(ppo.PPO, "loss", loss)


def logprob_altered():
    """One rollout log-probability altered by 0.05 where it is produced."""
    from gpudrive_lab_torch.ppo import ppo

    program = ppo.sample_logits

    def sample(gen, logits, action=None, deterministic=False):
        a, logp, ent = program(gen, logits, action, deterministic)
        if action is None:
            logp = logp.clone()
            logp.view(-1)[0] += 0.05
        return a, logp, ent

    return _patched(ppo, "sample_logits", sample)


SIM = {"step_unchanged": step_unchanged, "step_half_batch": step_half_batch,
       "obs_altered": obs_altered, "reset_skipped": reset_skipped}
TRAIN = {"update_unchanged": update_unchanged,
         "loss_half_batch": loss_half_batch,
         "step_unchanged": step_unchanged,
         "logprob_altered": logprob_altered,
         "reset_skipped": reset_skipped}

