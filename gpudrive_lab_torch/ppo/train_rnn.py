"""Recurrent-PPO (LSTM, BPTT) training entry point (port of
``scripts/train_rnn.py``; reference: the use_rnn path of
integrations/puffer/ppo.py:59-73, 156-163).

Draws one batch of ``--num-worlds`` scenes from ``--data-dir`` with
replacement (``SceneDataLoader(dataset_size=1000, seed=--seed)``), warms the
worlds up with ``--init-steps`` of expert playback, and trains the
late-fusion LSTM policy with ``ppo_rnn.RnnPPO``; a finished world restarts
from the t=0 reset state, as in the JAX script.  Writes
``<checkpoint-path>/rnn.metrics.jsonl`` every 5 iterations and ``policy.pt``
(the policy's and Adam's state_dict, the global step and the architecture)
every 25 and at the end; ``--continue-training`` resumes from ``policy.pt``
or from the JAX script's ``policy.pkl``.

Run (on the card by default; ``--device cpu`` for a small CPU run):

    python -m gpudrive_lab_torch.ppo.train_rnn --num-worlds 16
    python -m gpudrive_lab_torch.ppo.train_rnn --device cpu --num-worlds 2 \\
        --total-timesteps 2000 --rollout-len 8 --num-minibatches 2

``--unroll`` is accepted and gives the same result (one eager mode here).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionLSTMPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.ppo.ppo import PPOConfig
from gpudrive_lab_torch.ppo.ppo_rnn import RnnPPO, start_carry
from gpudrive_lab_torch.ppo.train import check_compact_capacity

ROOT = Path(__file__).resolve().parents[2]
CHECKPOINT = "policy.pt"
JAX_CHECKPOINT = "policy.pkl"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", "--platform", dest="device", default=None,
                   help="torch device or JAX platform name; CUDA unless "
                        "another is named (cpu for the CPU); the run fails "
                        "without CUDA otherwise")
    p.add_argument("--data-dir", default=str(ROOT / "data" / "pool_v3"))
    p.add_argument("--num-worlds", type=int, default=16)
    p.add_argument("--total-timesteps", type=int, default=200_000)
    p.add_argument("--rollout-len", type=int, default=32)
    p.add_argument("--num-minibatches", type=int, default=4,
                   help="minibatches over worlds (dense) or flat rows; "
                        "must divide that axis")
    p.add_argument("--update-epochs", type=int, default=2)
    p.add_argument("--lstm-hidden", type=int, default=128)
    p.add_argument("--ent-coef", type=float, default=1e-3)
    p.add_argument("--entropy-floor", type=float, default=0.0,
                   help="raise the entropy coefficient (x1.5, at most 0.1) "
                        "while the entropy is below this floor, relax it "
                        "(/1.2, not below --ent-coef) above twice the "
                        "floor; 0 = off")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--init-steps", type=int, default=11)
    p.add_argument("--compact", type=int, default=0,
                   help="flat layout: N rows holding exactly the batch's "
                        "controlled agents (0 = dense [W, A] layout)")
    p.add_argument("--policy-dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--obs-store", choices=["f32", "bf16"], default="f32")
    p.add_argument("--unroll", action="store_true",
                   help="accepted alias: same result")
    p.add_argument("--agent-bucket", default=None,
                   help="'auto' (or an int) buckets the sim's agent axis "
                        "to the batch max")
    p.add_argument("--checkpoint-path", default="runs/rnn")
    p.add_argument("--continue-training", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def save_checkpoint(ckpt_dir, rnn: RnnPPO, global_step: int, arch: dict):
    """<ckpt_dir>/policy.pt through a temporary file and a rename."""
    tmp = Path(ckpt_dir) / (CHECKPOINT + ".tmp")
    torch.save({"policy": rnn.policy.state_dict(),
                "optimizer": rnn.optimizer.state_dict(),
                "global_step": global_step, "arch": arch}, tmp)
    tmp.replace(Path(ckpt_dir) / CHECKPOINT)


def load_checkpoint(ckpt_dir, rnn: RnnPPO) -> int | None:
    """Restore the policy and Adam from <ckpt_dir>/policy.pt, or else from
    the JAX script's policy.pkl; the global step, or None without a
    checkpoint."""
    from gpudrive_lab_torch.networks import convert

    ckpt_dir = Path(ckpt_dir)
    if (ckpt_dir / CHECKPOINT).exists():
        ckpt = torch.load(ckpt_dir / CHECKPOINT, map_location="cpu")
        rnn.policy.load_state_dict(ckpt["policy"])
        rnn.optimizer.load_state_dict(ckpt["optimizer"])
        return int(ckpt.get("global_step", 0))
    if (ckpt_dir / JAX_CHECKPOINT).exists():
        return convert.load_jax_checkpoint(ckpt_dir / JAX_CHECKPOINT,
                                           rnn.policy, rnn.optimizer)
    return None


def build(args):
    """(env, rnn, carry, fresh) for the parsed flags."""
    device = resolve_device(args.device)
    loader = SceneDataLoader(
        root=args.data_dir, batch_size=args.num_worlds, dataset_size=1000,
        sample_with_replacement=True, seed=args.seed,
    )
    bucket = args.agent_bucket
    if bucket is not None and bucket != "auto":
        bucket = int(bucket)
    env = GPUDriveTorchEnv(
        EnvConfig(
            reward_type="weighted_combination",
            collision_weight=-0.75, off_road_weight=-0.75,
            goal_achieved_weight=1.0,
            dynamics_model="classic", collision_behavior="ignore",
            init_steps=args.init_steps, agent_bucket=bucket,
        ),
        data_loader=loader, device=device,
    )
    pc = PolicyConfig(
        action_dim=env.action_space_n,
        dtype=torch.bfloat16 if args.policy_dtype == "bf16"
        else torch.float32,
    )
    policy = LateFusionLSTMPolicy(
        pc, lstm_hidden=args.lstm_hidden, device=env.device,
        generator=torch.Generator().manual_seed(args.seed))
    cfg = PPOConfig(
        rollout_len=args.rollout_len, num_minibatches=args.num_minibatches,
        update_epochs=args.update_epochs, ent_coef=args.ent_coef,
        learning_rate=args.lr, compact=args.compact,
        compact_mode="flat" if args.compact else "world",
        obs_store_dtype="bfloat16" if args.obs_store == "bf16"
        else "float32",
        unroll=args.unroll,
    )
    if args.compact:
        check_compact_capacity(env, args.compact, "flat")
    rnn = RnnPPO(policy, env.params, env.spec, env.action_keys,
                 env.config.reward_type, cfg,
                 perm_generator=torch.Generator().manual_seed(args.seed + 1))
    fresh = stepmod.reset(env.scene, None, env.params)
    # from the env's warmed-up state (init_steps of expert playback)
    carry = start_carry(
        rnn, env.scene, env.state, env.world_time_steps,
        torch.Generator(device=env.device).manual_seed(args.seed + 1))
    return env, rnn, carry, fresh


def main(argv=None):
    """Train with the flags ``argv``; returns (env, rnn, carry, fresh), the
    carry after the last iteration's rollout, for callers in process."""
    args = parse_args(argv)
    env, rnn, carry, fresh = build(args)
    arch = {"lstm_hidden": args.lstm_hidden,
            "action_dim": rnn.policy.config.action_dim}
    ckpt_dir = Path(args.checkpoint_path)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    global_step = 0
    if args.continue_training:
        resumed = load_checkpoint(ckpt_dir, rnn)
        if resumed is not None:
            global_step = resumed
            print(json.dumps({"resumed_from": global_step}), flush=True)

    iteration = 0
    t_start = time.time()
    ent_coef = args.ent_coef
    with open(ckpt_dir / "rnn.metrics.jsonl", "a") as logf:
        while global_step < args.total_timesteps:
            carry, metrics = rnn.train_step(env.scene, carry, fresh,
                                            env.reward_weights, ent_coef)
            # one host read of the iteration's metrics
            names = sorted(metrics)
            host = torch.stack([metrics[k].detach().double()
                                for k in names]).cpu().tolist()
            m = dict(zip(names, host))
            global_step += int(m.pop("samples"))
            if args.entropy_floor > 0.0:
                if m["entropy"] < args.entropy_floor:
                    ent_coef = min(ent_coef * 1.5, 0.1)
                elif m["entropy"] > 2.0 * args.entropy_floor:
                    ent_coef = max(ent_coef / 1.2, args.ent_coef)
                m["ent_coef"] = ent_coef
            iteration += 1
            last = global_step >= args.total_timesteps
            if iteration % 5 == 0 or last:
                rec = dict(
                    _t=round(time.time(), 3), iteration=iteration,
                    global_step=global_step,
                    sps=round(global_step / (time.time() - t_start), 1),
                    **{k: round(v, 5) for k, v in m.items()},
                )
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
                print(json.dumps(rec), flush=True)
            if iteration % 25 == 0 or last:
                save_checkpoint(ckpt_dir, rnn, global_step, arch)
    print(json.dumps({"final_global_step": global_step}))
    return env, rnn, carry, fresh


if __name__ == "__main__":
    main()
