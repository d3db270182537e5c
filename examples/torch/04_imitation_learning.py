"""Tutorial 4 on the PyTorch port: the imitation-learning pipeline end to
end.

Generate expert state-action pairs by log replay, train the attention BC
policy with the GMM loss, and evaluate closed-loop in the simulator
(counterpart of examples/04_imitation_learning.py; reference: the IL
tutorials and baselines/il/il.py).  Runs on the GPU; ``--device cpu`` runs
it on the CPU.
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.il.data_generation import generate_state_action_pairs
from gpudrive_lab_torch.il.dataset import ExpertDataset
from gpudrive_lab_torch.il.networks import BCConfig, EarlyFusionAttnBCNet
from gpudrive_lab_torch.il.train import (
    BCTrainConfig,
    evaluate_closed_loop,
    make_bc_train_step,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default=os.path.join(
        ROOT, "tests", "data", "tfrecord_synthetic_0.json"))
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is named")
    args = p.parse_args()

    env_cfg = EnvConfig(
        num_worlds=1, dynamics_model="delta_local",
        max_controlled_agents=0,  # all-expert for data generation
    )
    env = GPUDriveTorchEnv(env_cfg, scene_paths=[args.scene],
                           device=args.device)
    data = generate_state_action_pairs(env)
    data["controlled_mask"] = data["valid_mask"]
    ds = ExpertDataset(data, rollout_len=3, device=env.device)
    print(f"dataset: {len(ds)} samples")

    bc_cfg = BCConfig(num_stack=3, network_dim=64, num_head=4,
                      num_fusion_layers=1)
    model = EarlyFusionAttnBCNet(bc_cfg, device=env.device,
                                 generator=torch.Generator().manual_seed(0))
    cfg = BCTrainConfig(batch_size=64, epochs=args.epochs, rollout_len=3)
    _, train_step = make_bc_train_step(model, cfg)
    rng = np.random.default_rng(0)
    for epoch in range(cfg.epochs):
        losses = [float(train_step(b))
                  for b in ds.iter_batches(cfg.batch_size, rng)]
        print(f"epoch {epoch}: gmm nll {np.mean(losses):.3f}")

    eval_env = GPUDriveTorchEnv(
        dataclasses.replace(env_cfg, max_controlled_agents=128),
        scene_paths=[args.scene], device=env.device,
    )
    print(json.dumps(evaluate_closed_loop(eval_env, model, bc_cfg)))


if __name__ == "__main__":
    main()
