"""Closed-loop evaluation of a policy checkpoint (port of
``scripts/eval_checkpoint.py``): deterministic (argmax) rollouts over full
episodes, reporting goal / collision / off-road rates over controlled
agents (reference: baselines/il/test/simulation.py closed-loop harness and
env_puffer.py episode stats).

The checkpoint is either a released reference policy (a ``.pt``, ``.bin``
or ``.safetensors`` file, a hub-layout directory or a hub repo id; through
``networks.convert.load_pretrained``) or the port trainer's own
``policy.pt`` (``ppo/train.py:save_checkpoint``; the file or its
directory), also the JAX trainer's ``policy.pkl``.  Runs on the card
unless ``--device cpu`` asks for the CPU.  Kernels: K2 on every step.

    python -m gpudrive_lab_torch.utils.eval_checkpoint \\
        --checkpoint runs/policy.pt --scenes-dir data/pool_v3
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from gpudrive_lab_torch.agents import PolicyActor
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.networks.late_fusion import PolicyConfig
from gpudrive_lab_torch.ppo.train import CHECKPOINT, JAX_CHECKPOINT
from gpudrive_lab_torch.utils.multi_policy_rollout import multi_policy_rollout

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def trainer_checkpoint(ck: str) -> str | None:
    """The trainer checkpoint file ``ck`` names (the port trainer's
    ``policy.pt`` or the JAX trainer's ``policy.pkl``, or a directory
    holding one), or None when ``ck`` is not one."""
    if os.path.isdir(ck):
        for name in (CHECKPOINT, JAX_CHECKPOINT):
            if os.path.exists(os.path.join(ck, name)):
                return os.path.join(ck, name)
        return None
    return ck if os.path.basename(ck) in (CHECKPOINT, JAX_CHECKPOINT) else None


def is_reference_checkpoint(ck: str) -> bool:
    """A released reference policy: a torch file, a hub-layout directory,
    or (when no such path exists) a hub repo id."""
    return (
        ck.endswith((".pt", ".bin", ".safetensors"))
        or (os.path.isdir(ck)
            and os.path.exists(os.path.join(ck, "model.safetensors")))
        or (not os.path.exists(ck) and "/" in ck)
    )


def build_actor(ck: str, action_dim: int, deterministic: bool,
                device) -> PolicyActor:
    """The actor for checkpoint ``ck`` on ``device``: the trainer's own
    checkpoint first, else a reference policy, else any file
    ``PolicyActor`` loads."""
    path = trainer_checkpoint(ck)
    if path is None and is_reference_checkpoint(ck):
        from gpudrive_lab_torch.networks.convert import load_pretrained

        policy, pc = load_pretrained(ck, device=device)
        if pc.action_dim != action_dim:
            raise ValueError(f"checkpoint action_dim {pc.action_dim} != env "
                             f"{action_dim}")
        return PolicyActor(
            None, variables=policy.state_dict(), policy_config=pc,
            deterministic=deterministic, device=device)
    return PolicyActor(
        None, checkpoint_path=path or ck,
        policy_config=PolicyConfig(action_dim=action_dim),
        deterministic=deterministic, device=device)


def main(argv=None) -> dict:
    """Evaluate; prints (and returns) the aggregate JSON."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--scenes-dir",
                   default=os.path.join(ROOT, "data", "processed",
                                        "examples"),
                   help="directory of scene .json files (default: the "
                        "reference's data/processed/examples under the "
                        "repository)")
    p.add_argument("--num-worlds", type=int, default=8,
                   help="scene paths are tiled to this many worlds")
    p.add_argument("--episodes", type=int, default=1,
                   help="independent episodes (fresh resets) to average")
    p.add_argument("--stochastic", action="store_true",
                   help="sample actions instead of argmax")
    p.add_argument("--init-steps", type=int, default=11,
                   help="expert log-playback warmup applied at reset; "
                        "default matches the campaign / reference config")
    p.add_argument("--device", "--platform", dest="device", default=None,
                   help="torch device or JAX platform name; CUDA "
                        "unless another is named (cpu for the CPU); the run "
                        "fails without CUDA otherwise")
    p.add_argument("--keep-non-vehicles", action="store_true",
                   help="create pedestrian/cyclist agents (match a "
                        "campaign trained with --keep-non-vehicles)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    paths = sorted(
        os.path.join(args.scenes_dir, f)
        for f in os.listdir(args.scenes_dir)
        if f.endswith(".json")
    )
    if not paths:
        raise SystemExit(f"no scene .json files found in {args.scenes_dir}")
    paths = (paths * ((args.num_worlds // len(paths)) + 1))[: args.num_worlds]
    # Mirror the training env configuration (ppo/train.py main): the
    # checkpoint's action head is sized for the classic 13x7 action grid.
    env = GPUDriveTorchEnv(
        EnvConfig(
            num_worlds=args.num_worlds,
            reward_type="weighted_combination",
            collision_weight=-0.75,
            off_road_weight=-0.75,
            goal_achieved_weight=1.0,
            dynamics_model="classic",
            collision_behavior="ignore",
            init_steps=args.init_steps,
            remove_non_vehicles=not args.keep_non_vehicles,
        ),
        scene_paths=paths, device=device,
    )
    actor = build_actor(args.checkpoint, env.action_space_n,
                        not args.stochastic, device)
    mask = env.cont_agent_mask

    episodes = args.episodes
    if not args.stochastic and episodes > 1:
        # argmax actions + deterministic reset -> every episode would be
        # bit-identical; don't waste rollouts pretending to average
        print(json.dumps({"note": "deterministic mode: episodes forced to 1"}))
        episodes = 1

    per_ep = []
    for ep in range(episodes):
        actor.generator = torch.Generator(device=device).manual_seed(ep)
        m = multi_policy_rollout(env, {"policy": actor}, {"policy": mask})
        per_ep.append(m["policy"])

    agg = {
        k: sum(m[k] for m in per_ep) / len(per_ep)
        for k in ("goal_achieved", "collided", "off_road")
    }
    agg.update(
        episodes=episodes,
        controlled_agents=int(mask.sum()),
        num_worlds=args.num_worlds,
        deterministic=not args.stochastic,
        checkpoint=args.checkpoint,
    )
    print(json.dumps(agg), flush=True)
    return agg


if __name__ == "__main__":
    main()
