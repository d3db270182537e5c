"""Tutorial 3 on the PyTorch port: roll out (mixed) policies and render.

Counterpart of examples/03_policy_rollout.py (reference: the viz_rollouts /
show_agent_behaviors examples, examples/experimental/).  Runs on the GPU;
``--device cpu`` runs it on the CPU.
"""

import argparse
import importlib.util
import os
import tempfile

import torch

from gpudrive_lab_torch.agents import PolicyActor, RandomActor
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.networks.late_fusion import PolicyConfig
from gpudrive_lab_torch.utils.multi_policy_rollout import multi_policy_rollout

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenes-dir",
                   default=os.path.join(ROOT, "data", "pool_v3"))
    p.add_argument("--checkpoint", default=None,
                   help="policy.pt of ppo/train (or a JAX policy.pkl); "
                        "random policy if omitted")
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is named")
    args = p.parse_args()

    paths = sorted(
        os.path.join(args.scenes_dir, f)
        for f in os.listdir(args.scenes_dir)
        if f.endswith(".json")
    )[:2]
    env = GPUDriveTorchEnv(EnvConfig(num_worlds=2), scene_paths=paths,
                           device=args.device)

    ctrl = env.cont_agent_mask
    ids = torch.nonzero(ctrl.reshape(-1))[:, 0]
    half = len(ids) // 2
    m1 = torch.zeros(ctrl.numel(), dtype=torch.bool, device=env.device)
    m1[ids[:half]] = True
    m2 = torch.zeros_like(m1)
    m2[ids[half:]] = True

    if args.checkpoint:
        actor_a = PolicyActor(
            None, checkpoint_path=args.checkpoint,
            policy_config=PolicyConfig(action_dim=env.action_space_n),
            device=env.device,
        )
    else:
        actor_a = RandomActor(None, env.action_space_n, seed=1)
    actor_b = RandomActor(None, env.action_space_n, seed=2)

    metrics = multi_policy_rollout(
        env,
        {"policy_a": actor_a, "policy_b": actor_b},
        {"policy_a": m1.reshape(ctrl.shape),
         "policy_b": m2.reshape(ctrl.shape)},
    )
    for name, m in metrics.items():
        print(name, {k: round(v, 3) for k, v in m.items()})

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib absent: no frame drawn")
        return
    import matplotlib.pyplot as plt

    out = os.path.join(tempfile.gettempdir(), "rollout.png")
    plt.imsave(out, env.render(0, zoom_radius=80))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
