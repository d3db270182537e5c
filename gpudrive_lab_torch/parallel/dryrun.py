"""World-parallel training across processes checked against one process:
the counterpart of ``__graft_entry__.dryrun_multichip``.

``dryrun_multiprocess(n_procs, device)`` runs the JAX dryrun's three
learner configurations on ``n_procs * worlds_per_rank`` pool_v3 worlds,
first in this process over all the worlds, then in ``n_procs`` ranks
(processes started with ``spawn``, since this process may hold CUDA) that
each hold a contiguous block of them, and asserts the dryrun's bars:

  1. dense world-mode PPO in float32: metrics and every parameter within
     1e-5;
  2. flat block-local compaction (``compact_blocks`` = n), the bf16
     policy, the split bf16 observation store, ``road_gather="dot"`` and
     ``unroll``, with one scene swap in which each rank compiles only its
     own block's paths (``shard_scene_paths``): within 5e-3, the JAX
     dryrun's bar for this configuration (bf16 GEMMs and the cross-rank
     sums reorder the float reductions);
  3. the recurrent learner in flat mode over every controlled agent
     (``compact`` = their count, so each rank's row count is its own
     controlled count): within 1e-5.

Each configuration trains ``ITERATIONS`` iterations of ``ROLLOUT_LEN``
steps.  The single process
samples its actions; each rank is handed its slice of them through the
rollouts' ``actions=`` (a sub-batch's draw is not a slice of the whole
batch's).  Every rank's parameters must be bitwise equal at the end.

Run on the cards as ``python -m gpudrive_lab_torch.parallel.dryrun --procs
2`` (rank r on card r, over NCCL), on one card (the ranks share it, over
gloo: NCCL refuses two ranks on one device), or on the CPU with ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gpudrive_lab_torch.core import kernels
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.networks import fused_embed as fe
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionLSTMPolicy,
    LateFusionPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.parallel import distributed as dist
from gpudrive_lab_torch.parallel.mesh import replicate, shard_worlds
from gpudrive_lab_torch.ppo.ppo import PPO, EnvCarry, PPOConfig
from gpudrive_lab_torch.ppo.ppo_rnn import RnnPPO, start_carry
from gpudrive_lab_torch.rollout import SLICE_CONFIG, pool_scene_paths
from gpudrive_lab_torch.scene.compiler import build_scene

SEED = 0
ROLLOUT_LEN = 4
ITERATIONS = 2
CONFIGS = ("dense", "flat+bf16+dot+swap", "rnn-flat")
BARS = {"dense": 1e-5, "flat+bf16+dot+swap": 5e-3, "rnn-flat": 1e-5}


def _counts() -> dict:
    return {"K1": kernels.agent_road_hits_tiled.launches,
            "K2": kernels.agent_road_hits_dense.launches,
            "K3": fe.fused_embed_pool_fwd.launches,
            "K4": fe.fused_embed_pool_bwd.launches,
            "K3-bf16": fe.fused_embed_pool_fwd.bf16_launches,
            "K4-bf16": fe.fused_embed_pool_bwd.bf16_launches}


def _plan(root: str, n: int, worlds_per_rank: int) -> dict:
    """The scene batches of every configuration (lists of paths over all
    the worlds; the swap's batch rotated by one, as the JAX dryrun's)."""
    paths = pool_scene_paths(root)
    W = n * worlds_per_rank
    return {"a": [paths[w % len(paths)] for w in range(W)],
            "b": [paths[(w + 1) % len(paths)] for w in range(W)]}


def _env_config(**kw):
    return EnvConfig(**{**SLICE_CONFIG, **kw})


def _policy_config(env, widths: dict, **kw):
    return PolicyConfig(action_dim=env.action_space_n, **widths, **kw)


class _Learner:
    """One configuration's env, trainer and carry in this process: over
    every world (``group`` None) or over this rank's block."""

    def __init__(self, name: str, spec: dict, device, group=None):
        self.name, self.spec, self.device, self.group = name, spec, device, group
        n, wpr = spec["procs"], spec["worlds_per_rank"]
        plan = spec["plan"]

        def paths(batch):
            if group is None:
                return plan[batch]
            return dist.shard_scene_paths(plan[batch], wpr, group.rank, n)

        gen = torch.Generator().manual_seed(SEED)
        perm = torch.Generator().manual_seed(SEED + 1)
        base = dict(rollout_len=ROLLOUT_LEN, num_minibatches=2,
                    update_epochs=1)
        if name == "dense":
            # every world compiled, then this rank's block taken
            self.env = GPUDriveTorchEnv(_env_config(), plan["a"],
                                        device=device)
            self.scene, self.weights = self.env.scene, self.env.reward_weights
            if group is not None:
                self.scene = shard_worlds(self.scene, group)
                self.weights = shard_worlds(self.weights, group)
            policy = LateFusionPolicy(
                _policy_config(self.env, spec["widths"], fused_embed=True),
                device=device, generator=gen)
            cfg = PPOConfig(**base)
        elif name == "flat+bf16+dot+swap":
            self.env = GPUDriveTorchEnv(_env_config(road_gather="dot"),
                                        paths("a"), device=device)
            self.scene, self.weights = self.env.scene, self.env.reward_weights
            policy = LateFusionPolicy(
                _policy_config(self.env, spec["widths"], fused_embed=True,
                               dtype=torch.bfloat16),
                device=device, generator=gen)
            cfg = PPOConfig(
                **base, remat_obs=False, obs_store="split",
                obs_store_dtype="bfloat16", policy_dtype="bfloat16",
                compact=spec["flat_compact"], compact_mode="flat",
                compact_blocks=n, unroll=True)
        else:
            self.env = GPUDriveTorchEnv(_env_config(), paths("a"),
                                        device=device)
            self.scene, self.weights = self.env.scene, self.env.reward_weights
            policy = LateFusionLSTMPolicy(
                _policy_config(self.env, spec["widths"]),
                lstm_hidden=spec["lstm_hidden"], device=device,
                generator=gen)
            cfg = PPOConfig(**base, compact=spec["rnn_compact"],
                            compact_mode="flat")
        if group is not None:
            replicate(policy, group)
        args = (policy, self.env.params, self.env.spec,
                self.env.action_keys, self.env.config.reward_type, cfg)
        self.rnn = name == "rnn-flat"
        self.trainer = (RnnPPO if self.rnn else PPO)(
            *args, perm_generator=perm, group=group)
        self.rng = (dist.rank_generator(SEED, group) if group is not None
                    else torch.Generator(device=device).manual_seed(SEED))
        self.reset_carry()

    def reset_carry(self):
        fresh = stepmod.reset(self.scene, None, self.env.params)
        wts = torch.zeros(self.scene.num_worlds, dtype=torch.int32,
                          device=self.device)
        self.fresh = fresh
        if self.rnn:
            self.carry = start_carry(self.trainer, self.scene, fresh, wts,
                                     self.rng)
        else:
            self.carry = EnvCarry(fresh, wts, self.rng)

    def swap(self):
        """The swap of configuration 2: the next batch, this rank's block
        of it compiled here."""
        plan, n = self.spec["plan"], self.spec["procs"]
        paths = plan["b"] if self.group is None else dist.shard_scene_paths(
            plan["b"], self.spec["worlds_per_rank"], self.group.rank, n)
        self.env.swap_data_batch(paths)
        self.scene, self.weights = self.env.scene, self.env.reward_weights
        self.reset_carry()

    def iteration(self, actions=None):
        """One rollout and update; ``actions`` are one process's, sliced
        here to this rank's rows.  Returns (actions taken, metrics)."""
        t = self.trainer
        if actions is not None and self.group is not None:
            actions = actions.index_select(1, t.global_rows(self.scene))
        if actions is not None:
            actions = actions.to(self.device)
        init_lstm = self.carry.lstm if self.rnn else None
        self.carry, traj = t.rollout(self.scene, self.carry, self.fresh,
                                     self.weights, actions=actions)
        if self.rnn:
            m = t.update(self.scene, self.carry, traj, self.weights,
                         init_lstm)
        else:
            m = t.update(self.scene, self.carry, traj, self.weights)
        return traj.action.cpu(), {k: float(v) for k, v in m.items()}

    def run(self, actions=None):
        """The configuration's iterations: two on one batch, or (the swap
        configuration) one on each batch.  Returns (actions per iteration,
        metrics per iteration, parameters on the host)."""
        acts, metrics = [], []
        for i in range(ITERATIONS):
            if self.name == "flat+bf16+dot+swap" and i == 1:
                self.swap()
            a, m = self.iteration(None if actions is None else actions[i])
            acts.append(a)
            metrics.append(m)
        params = {k: v.detach().cpu()
                  for k, v in self.trainer.policy.state_dict().items()}
        return acts, metrics, params


def _flat_compact(plan: dict, n: int) -> dict:
    """Configuration 2's compact (n blocks of the largest block's
    controlled count over both batches, at least 2) and configuration 3's
    (every controlled agent of the first batch)."""
    params = _env_config().sim_params()
    cap, rnn = 2, None
    for key in ("a", "b"):
        ctrl = build_scene(plan[key], params, device="cpu").agents.controlled
        cap = max(cap, int(ctrl.reshape(n, -1).sum(1).max()))
        if rnn is None:
            rnn = int(ctrl.sum())
    return {"flat_compact": n * cap, "rnn_compact": rnn}


def _rank_main(rank: int, spec: dict) -> dict:
    """A rank: join the group, run each configuration on its block with
    its slice of one process's actions, count the kernel launches; returns
    (metrics, parameters, launches) per configuration."""
    device = torch.device(spec["devices"][rank])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group = dist.initialize(spec["backend"], spec["init_method"],
                            spec["procs"], rank, device)
    result = {"backend": torch.distributed.get_backend()}
    for name in CONFIGS:
        for f in (kernels.agent_road_hits_tiled,
                  kernels.agent_road_hits_dense):
            f.launches = 0
        for f in (fe.fused_embed_pool_fwd, fe.fused_embed_pool_bwd):
            f.launches = f.bf16_launches = 0
        t0 = time.perf_counter()
        learner = _Learner(name, spec, device, group)
        _, metrics, params = learner.run(spec["actions"][name])
        if device.type == "cuda":
            torch.cuda.synchronize()
        result[name] = {"metrics": metrics, "params": params,
                        "launches": _counts(),
                        "seconds": time.perf_counter() - t0,
                        "rows": len(learner.trainer.global_rows(
                            learner.scene))}
        del learner
    dist.shutdown()
    return result


def _compare(name: str, single: tuple, ranks: list, bar: float) -> dict:
    """The dryrun's bars: every metric of every iteration within bar +
    bar * |single|, every parameter within bar, and every rank's
    parameters bitwise equal.  Returns the readings."""
    _, s_metrics, s_params = single
    worst_m = 0.0
    for r, res in enumerate(ranks):
        for i, (want, got) in enumerate(zip(s_metrics, res["metrics"])):
            for k, a in want.items():
                b = got[k]
                if not (np.isfinite(b) and abs(a - b) <= bar + bar * abs(a)):
                    raise AssertionError(
                        f"[{name}] rank {r} iteration {i} metric {k}: "
                        f"sharded {b} != single {a}")
                worst_m = max(worst_m, abs(a - b))
    max_dp = max(float((s_params[k].float() - ranks[0]["params"][k].float())
                       .abs().max()) for k in s_params)
    if max_dp > bar:
        raise AssertionError(f"[{name}] updated parameters diverge: max "
                             f"|d| = {max_dp}")
    for r, res in enumerate(ranks[1:], 1):
        for k, v in res["params"].items():
            if not torch.equal(v, ranks[0]["params"][k]):
                raise AssertionError(f"[{name}] rank {r}'s {k} differs from "
                                     "rank 0's: replication broke")
    return {"max_param_delta": max_dp, "max_metric_delta": worst_m,
            "metrics": ranks[0]["metrics"][-1]}


def dryrun_multiprocess(n_procs: int, device=None, worlds_per_rank: int = 2,
                        root: str | None = None, widths: dict | None = None,
                        lstm_hidden: int = 128, backend: str | None = None,
                        timeout: float = 600.0) -> dict:
    """Run the three configurations of the module docstring in this
    process over ``n_procs * worlds_per_rank`` worlds on ``device`` (CUDA
    unless the caller names another), then sharded over ``n_procs`` ranks
    (``distributed.rank_devices``: rank r on card r where the host has
    ``n_procs`` cards, else every rank on ``device``), and assert the bars.
    ``widths`` are PolicyConfig widths (input_dim, hidden_dim; the full
    width by default).  ``backend`` defaults to NCCL where each rank has a
    card of its own, else gloo (ranks that share a card, or the CPU).
    Ranks still running after
    ``timeout`` seconds are killed and the call raises.  Returns per
    configuration the readings, the single process's and each rank's
    seconds, and each rank's kernel launches."""
    devices = dist.rank_devices(device, n_procs)
    if backend is None and len(set(devices)) < len(devices):
        backend = "gloo"  # NCCL refuses two ranks on one card
    backend = dist.rank_backend(backend, devices)
    device = devices[0]
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    plan = _plan(root, n_procs, worlds_per_rank)
    spec = dict(procs=n_procs, worlds_per_rank=worlds_per_rank, plan=plan,
                widths=dict(widths or {}), lstm_hidden=lstm_hidden,
                devices=[str(d) for d in devices], backend=backend)
    spec.update(_flat_compact(plan, n_procs))

    singles, report = {}, {}
    for name in CONFIGS:
        t0 = time.perf_counter()
        singles[name] = _Learner(name, spec, device).run()
        if device.type == "cuda":
            torch.cuda.synchronize()
        report[name] = {"single_s": time.perf_counter() - t0}

    spec["actions"] = {name: singles[name][0] for name in CONFIGS}
    ranks = dist.run_ranks(_rank_main, n_procs, spec, timeout)
    for name in CONFIGS:
        report[name].update(_compare(
            name, singles[name], [r[name] for r in ranks], BARS[name]))
        report[name]["rank_s"] = [r[name]["seconds"] for r in ranks]
        report[name]["rank_rows"] = [r[name]["rows"] for r in ranks]
        report[name]["launches"] = [r[name]["launches"] for r in ranks]
    report["backend"] = ranks[0]["backend"]
    report["devices"] = spec["devices"]
    return report


def parse_args(argv=None, description: str | None = None):
    """The dry run's flags (shared with ``python -m
    gpudrive_lab_torch.entry``)."""
    p = argparse.ArgumentParser(
        description=description or __doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--device", "--platform", dest="device", default=None,
                   help="torch device or JAX platform name; CUDA "
                        "unless another is named (cpu for the CPU); the run "
                        "fails without CUDA otherwise")
    p.add_argument("--worlds-per-rank", type=int, default=2)
    p.add_argument("--backend", default=None,
                   help="process-group backend (default: NCCL where each "
                        "rank has a card of its own, else gloo)")
    p.add_argument("--timeout", type=float, default=600.0)
    return p.parse_args(argv)


def run(args) -> dict:
    """The dry run of parsed ``args``; prints each configuration's bars
    and the report's JSON, and returns the report."""
    report = dryrun_multiprocess(args.procs, args.device,
                                 args.worlds_per_rank, backend=args.backend,
                                 timeout=args.timeout)
    for name in CONFIGS:
        r = report[name]
        print(f"dryrun[{name}]: sharded == unsharded (max param delta "
              f"{r['max_param_delta']:.2e}, max metric delta "
              f"{r['max_metric_delta']:.2e}; rows per rank {r['rank_rows']})")
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("backend", "devices")}, default=str))
    return report


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
