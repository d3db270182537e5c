"""The controls of the correctness check: the plain reference put in the
program's place and computed in the nearest precision below the one the
configuration states.  A limit is sound only where its control comes out
as not correct.

- The simulator (float32, no products): the reference's step, observation
  and reset select on its own scene with every float tensor of the scene
  and the state in bfloat16, in place of ``bench.bench_step`` and of the
  observation entry the driver reads.
- Training (float32 with TF32 off): the reference's trainer with every
  product on TF32-rounded operands, drawing its own actions and minibatch
  order from the seed, in place of ``build_trainer``'s trainer.

Each is a context manager that installs the control where the drivers
look the program up, and restores the program on exit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace

import torch

from . import common
from .reference import env_obs as rob
from .reference import step as rstep
from .reference import types as rtypes
from .reference.policy import LateFusionNet
from .reference.ppo import Learner

BF16 = torch.bfloat16


def _cast(obj, dtype):
    """A copy of a tensor dataclass with its float tensors in ``dtype``
    (nested dataclasses too)."""
    if obj is None:
        return None
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _cast(v, dtype)
        elif torch.is_tensor(v) and v.dtype.is_floating_point:
            v = v.to(dtype)
        out[f.name] = v
    return type(obj)(**out)


def _state_to(state, dtype):
    return rtypes.SimState(**{
        f.name: (getattr(state, f.name).to(dtype)
                 if getattr(state, f.name).dtype.is_floating_point
                 else getattr(state, f.name))
        for f in dataclasses.fields(state)})


@contextlib.contextmanager
def sim_control(cell, device, dtype=BF16):
    """``bench.bench_step`` and the observation entry the driver reads,
    ``env_torch.flat_observation``, replaced by the reference in
    ``dtype``."""
    from gpudrive_lab_torch import bench
    from gpudrive_lab_torch.env import env_torch

    paths = common.scene_paths(cell.traffic["scenes"])
    rparams = rob.params_from_env(cell.config["env"])
    scene = common.compile_scenes_reference(
        paths, rparams, device, int(cell.traffic.get("reference_workers", 0)))
    scene = dataclasses.replace(_cast(scene, dtype), rtiles=None)
    fresh = rstep.reset(scene, None, rparams)
    table = rob.classic_action_table(device).to(dtype)

    def control_obs(_scene, state, _params, _spec, _weights, *args,
                    **kwargs):
        s = _state_to(state, dtype)
        W, A = s.pos.shape[:2]
        obs = rob.flat_observation(
            scene, s, rparams, rob.ObsSpec(),
            torch.zeros((W, A, 3), dtype=dtype, device=s.pos.device))[0]
        return obs.float(), None, None

    def control_step(_scene, _fresh, _table, _weights, state, idx, acc,
                     _params, _spec, **_sensors):
        W, A = idx.shape
        s = _state_to(state, dtype)
        act = torch.zeros((W, A, 10), dtype=dtype, device=idx.device)
        act[..., :3] = table[idx.long()]
        s1 = rstep.step(scene, s, act, rparams)
        done = ((s1.done != 0) | ~scene.agents.valid).all(dim=1)
        s2 = rstep.select_worlds(done, fresh, s1)
        return _state_to(s2, torch.float32), acc + s2.pos[0, 0, 0].float()

    programs = bench.bench_step, env_torch.flat_observation
    bench.bench_step, env_torch.flat_observation = control_step, control_obs
    try:
        yield
    finally:
        bench.bench_step, env_torch.flat_observation = programs


class ControlTrainer:
    """The reference trainer in the program's place: the attributes the
    training driver reads of ``build_trainer``'s PPO."""

    def __init__(self, cell, device, seed: int, tf32: bool = True):
        cfg = cell.config
        env = cfg["env"]
        paths = common.scene_paths(cell.traffic["scenes"])
        rparams = rob.params_from_env(env)
        scene = common.compile_scenes_reference(
            paths, rparams, device,
            int(cell.traffic.get("reference_workers", 0)))
        W, A = scene.agents.valid.shape
        rw = torch.tensor([env["collision_weight"],
                           env["goal_achieved_weight"],
                           env["off_road_weight"]], device=device).expand(
                               W, A, 3).contiguous()
        self.policy = LateFusionNet(
            actions=cfg["policy"]["action_dim"]).to(device)
        self.policy.set_tf32(tf32)
        p = cfg["ppo"]
        self.learner = Learner(scene, rparams, rob.ObsSpec(),
                               rob.classic_action_table(device),
                               env["reward_type"], rw, self.policy,
                               dict(p, reset_time_step=env["init_steps"]))
        self.optimizer = self.learner.optimizer
        self.ppo = p
        self.fresh = rstep.reset(scene, None, rparams)
        self.carry = SimpleNamespace(
            state=self.fresh,
            world_time_steps=torch.full((W,), env["init_steps"],
                                        dtype=torch.int32, device=device))
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.perm_gen = torch.Generator().manual_seed(seed + 1)

    def rollout(self, carry):
        state, wts, ro = self.learner.rollout(
            carry.state, carry.world_time_steps, self.fresh,
            self.ppo["rollout_len"], self.gen)
        traj = SimpleNamespace(action=ro.action, logprob=ro.logprob,
                               value=ro.value, mask=ro.mask, ro=ro)
        return SimpleNamespace(state=state, world_time_steps=wts), traj

    def minibatch_order(self):
        T, M = self.ppo["rollout_len"], self.ppo["num_minibatches"]
        perms = [torch.randperm(T, generator=self.perm_gen).reshape(
            M, T // M).tolist() for _ in range(self.ppo["update_epochs"])]
        return perms, [[0] * M for _ in perms]

    def learn(self, traj):
        """The minibatch epochs; each loss term per minibatch, [E, M]."""
        perms, _ = self.minibatch_order()
        terms = self.learner.learn(traj.ro, traj.action, perms,
                                   self.ppo["ent_coef"])
        E = self.ppo["update_epochs"]
        return {k: torch.tensor([t[k] for t in terms]).reshape(E, -1)
                for k in terms[0]}

    def train_fn(self, _scene, carry, _fresh, _rw, ent_coef=None):
        carry, traj = self.rollout(carry)
        out = {k: v.mean() for k, v in self.learn(traj).items()}
        out["samples"] = traj.mask.sum().float()
        return carry, out


@contextlib.contextmanager
def train_control(cell, device, seed: int):
    """``build_trainer`` replaced by the reference trainer in TF32."""
    from gpudrive_lab_torch.ppo import train as program_train

    def build(env, ppo_config, seed=seed, **_kw):
        ctrl = ControlTrainer(cell, device, seed)
        return ctrl, ctrl.carry, ctrl.fresh, ctrl.train_fn

    program = program_train.build_trainer
    program_train.build_trainer = build
    try:
        yield
    finally:
        program_train.build_trainer = program


