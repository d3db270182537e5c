"""Tutorial 2 on the PyTorch port: replay logged experts and validate
goal-reaching.

Counterpart of examples/02_expert_replay.py (reference: the expert-replay
tutorial, examples/tutorials/04); also demonstrates the inverse-dynamics
actions.  Runs on the GPU; ``--device cpu`` runs it on the CPU.
"""

import argparse
import os

from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default=os.path.join(
        ROOT, "tests", "data", "tfrecord_synthetic_0.json"))
    p.add_argument("--controlled", type=int, default=0,
                   help="0 = all-expert replay; N = N agents replay their "
                        "inverse actions through the dynamics model")
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is named")
    args = p.parse_args()

    env = GPUDriveTorchEnv(
        EnvConfig(
            num_worlds=1,
            dynamics_model="delta_local",
            max_controlled_agents=args.controlled,
            dist_to_goal_threshold=1.0,
        ),
        scene_paths=[args.scene],
        device=args.device,
    )
    expert_actions, log_pos, log_vel, log_yaw, valids = env.get_expert_actions()
    env.reset()
    for t in range(env.episode_len):
        env.step_dynamics(expert_actions[:, :, t])
        if bool(env.get_dones().all()):
            break
    infos = env.get_infos()
    valid = env.scene.agents.valid
    print("agents:", int(valid.sum()))
    print("reached goal:", int((infos["goal_achieved"] * valid).sum()))
    print("collisions:", int((infos["collided"] * valid).sum()
                             + (infos["off_road"] * valid).sum()))


if __name__ == "__main__":
    main()
