"""Tutorial 6 on the PyTorch port: VBD diffusion sim agents driving
uncontrolled traffic.

Counterpart of examples/06_vbd_sim_agents.py and of the reference's
pretrained-sim-agent tutorial (reference:
examples/tutorials/04_use_pretrained_sim_agent.ipynb), which loads a VBD
checkpoint and lets the diffusion model denoise future trajectories for the
non-policy agents.  No pretrained weights ship with this repository, so the
example runs a denoiser with seeded random weights end to end: sample batch
construction -> reverse diffusion -> trajectory source ->
``env.set_vbd_trajectories`` -> VBD obs block + distance-to-trajectory
reward.  ``--checkpoint`` takes a ``VBDModel`` state dict saved with
``torch.save``.  Runs on the GPU; ``--device cpu`` runs it on the CPU.
"""

import argparse
import os

import torch

from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.vbd.integration import VBDTrajectorySource
from gpudrive_lab_torch.vbd.model import DDPMScheduler, VBDConfig, VBDModel

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_source(checkpoint: str | None, seed: int = 0, device=None):
    """A TrajectorySource backed by the port's VBD denoiser on
    ``device`` (the GPU unless another is named)."""
    cfg = VBDConfig(
        future_len=20, agents_len=8, action_len=5, diffusion_steps=4,
        encoder_layers=1, hidden_dim=64, num_heads=2,
    )
    # untrained weights unless a checkpoint is given: they demonstrate
    # the pipeline, not driving quality
    model = VBDModel(cfg, device=device,
                     generator=torch.Generator().manual_seed(seed))
    if checkpoint and os.path.exists(checkpoint):
        model.load_state_dict(torch.load(checkpoint, map_location="cpu"))
    scheduler = DDPMScheduler(cfg.diffusion_steps)
    return VBDTrajectorySource(model, scheduler, cfg, seed=seed)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenes-dir",
                   default=os.path.join(ROOT, "data", "pool_v3"))
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is named")
    args = p.parse_args()

    loader = SceneDataLoader(root=args.scenes_dir, batch_size=1,
                             dataset_size=1)
    env = GPUDriveTorchEnv(
        EnvConfig(num_worlds=1, reward_type="distance_to_vdb_trajs",
                  use_vbd=True, vbd_in_obs=True),
        data_loader=loader, device=args.device,
    )
    env.reset()

    # denoise once for the episode; re-call after swap_data_batch()
    env.set_vbd_trajectories(build_source(args.checkpoint,
                                          device=env.device))

    expert_actions = env.get_expert_actions()[0]  # [W, A, T, 10]
    for t in range(args.steps):
        # everyone follows the logged experts; the reward now measures
        # distance to the *denoised* trajectories instead
        env.step_dynamics(expert_actions[:, :, t])
        r = env.get_rewards()
        print(f"step {t:2d}  mean vbd-distance reward "
              f"{float(r[env.cont_agent_mask].mean()):+.3f}")

    # the 455-dim egocentric VBD obs block is appended when enabled
    obs = env.get_obs()
    print("obs dim with VBD block:", obs.shape[-1])


if __name__ == "__main__":
    main()
