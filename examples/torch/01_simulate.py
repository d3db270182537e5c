"""Tutorial 1 on the PyTorch port: load scenes, step the simulator, inspect
observations.

Counterpart of examples/01_simulate.py (reference: examples/tutorials/
01-03).  Runs on the GPU; ``--device cpu`` runs it on the CPU.
Run from the repository root:
    PYTHONPATH=. python examples/torch/01_simulate.py [--scenes-dir DIR]
"""

import argparse
import importlib.util
import os
import tempfile

import numpy as np
import torch

from gpudrive_lab_torch.core import observations as obsmod
from gpudrive_lab_torch.datatypes.observation import LocalEgoState
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenes-dir",
                   default=os.path.join(ROOT, "data", "pool_v3"))
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is named")
    args = p.parse_args()

    loader = SceneDataLoader(
        root=args.scenes_dir, batch_size=2, dataset_size=100
    )
    env = GPUDriveTorchEnv(EnvConfig(num_worlds=2), data_loader=loader,
                           device=args.device)

    obs = env.reset()
    print("scenes:", env.get_env_filenames())
    print("obs shape:", tuple(obs.shape))  # (worlds, agents, 3368)
    print("controlled per world:",
          env.cont_agent_mask.sum(1).cpu().numpy())

    rng = np.random.default_rng(0)
    for t in range(10):
        actions = rng.integers(0, env.action_space_n,
                               (env.num_worlds, env.max_agent_count))
        env.step_dynamics(torch.as_tensor(actions, device=env.device))
    print("rewards:", float(env.get_rewards().sum()))
    infos = env.get_infos()
    print("collisions so far:", int(infos["collided"].sum()))

    # named views over the raw observation collectors
    ego = LocalEgoState.from_array(
        obsmod.self_observation(env.scene, env.state))
    print("max speed on the road:", float(ego.speed.max()))

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib absent: no frame drawn")
        return
    import matplotlib.pyplot as plt

    out = os.path.join(tempfile.gettempdir(), "sim_state.png")
    plt.imsave(out, env.render(0, zoom_radius=80))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
