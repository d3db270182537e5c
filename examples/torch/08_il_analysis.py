"""IL policy analysis on the PyTorch port: importance weights, linear-probe
intervention, replay.

Counterpart of examples/08_il_analysis.py and of the fork's analysis
scripts (reference: baselines/il/test/importance_weight.py,
intervention.py, simulation.py):

  1. generate expert data and quick-train a BC policy,
  2. roll it out closed-loop collecting attention importance and tokens,
  3. train ego/partner future-position probes on the frozen tokens,
  4. run the intervention experiment (push a partner-probe class direction
     into the ego token and watch the ego prediction move),
  5. write the overlay figures (matplotlib): per-head importance, probe
     grid with predicted paths, policy-vs-log replay comparison.

Runs on the GPU; ``--device cpu`` runs it on the CPU.  From the
repository root:
    PYTHONPATH=. python examples/torch/08_il_analysis.py --scenes-dir <dir> --out runs/il_analysis
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenes-dir",
                   default=os.path.join(ROOT, "data", "pool_v3"))
    p.add_argument("--num-worlds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--future-step", type=int, default=10)
    p.add_argument("--rollout-steps", type=int, default=30)
    p.add_argument("--intervention-label", type=int, default=10)
    p.add_argument("--out", default="runs/il_analysis")
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is named")
    args = p.parse_args()
    if not os.path.isdir(args.scenes_dir):
        args.scenes_dir = os.path.join(ROOT, "tests", "data")

    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.dataset import SceneDataLoader
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.il import analysis
    from gpudrive_lab_torch.il.data_generation import (
        generate_state_action_pairs,
    )
    from gpudrive_lab_torch.il.dataset import ExpertDataset
    from gpudrive_lab_torch.il.linear_probing import ProbeConfig
    from gpudrive_lab_torch.il.networks import BCConfig, EarlyFusionAttnBCNet
    from gpudrive_lab_torch.il.train import BCTrainConfig, make_bc_train_step

    os.makedirs(args.out, exist_ok=True)
    loader = SceneDataLoader(
        root=args.scenes_dir, batch_size=args.num_worlds, dataset_size=100
    )
    env_cfg = EnvConfig(
        num_worlds=args.num_worlds, dynamics_model="delta_local",
        collision_behavior="ignore", max_controlled_agents=0,
    )
    env = GPUDriveTorchEnv(env_cfg, data_loader=loader, device=args.device)
    data = generate_state_action_pairs(env)
    data["controlled_mask"] = data["valid_mask"]
    cfg = BCTrainConfig(epochs=args.epochs, batch_size=128)
    ds = ExpertDataset(data, rollout_len=cfg.rollout_len, device=env.device)
    print(f"dataset: {len(ds)} samples")

    bc_cfg = BCConfig(num_stack=cfg.rollout_len)
    model = EarlyFusionAttnBCNet(bc_cfg, device=env.device,
                                 generator=torch.Generator().manual_seed(0))
    _, train_step = make_bc_train_step(model, cfg)
    rng = np.random.default_rng(0)
    for epoch in range(cfg.epochs):
        losses = [float(train_step(batch))
                  for batch in ds.iter_batches(cfg.batch_size, rng)]
        print(json.dumps({"epoch": epoch,
                          "bc_loss": round(float(np.mean(losses)), 4)}))

    # ---- probes on frozen tokens ------------------------------------------
    tokens = analysis.extract_token_dataset(model, ds)
    labels = analysis.probe_labels_from_positions(ds, args.future_step)
    t, w, a = ds.index_t.unbind(1)
    partner_valid = ds.data["partner_mask"][t, w, a] == 0
    ego_probe, other_probe, probe_metrics = analysis.train_position_probes(
        tokens, labels, partner_valid, ProbeConfig(epochs=2)
    )
    print(json.dumps({"probes": probe_metrics}))

    # ---- closed-loop rollout with analysis collection ---------------------
    eval_env = GPUDriveTorchEnv(
        dataclasses.replace(env_cfg, max_controlled_agents=128),
        scene_paths=env.scene_paths, device=env.device,
    )
    result = analysis.closed_loop_rollout(
        eval_env, model, bc_cfg, max_steps=args.rollout_steps,
        collect_importance=True, collect_tokens=True, collect_states=True,
    )
    print(json.dumps({"closed_loop": result.metrics}))

    # ---- intervention ------------------------------------------------------
    ctrl = eval_env.cont_agent_mask.to(torch.int8)
    ego_rows = torch.argmax(ctrl, dim=1)  # first controlled agent per world
    w_idx = 0
    ego = int(ego_rows[w_idx])
    ego_tok_t = result.ego_tokens[:, w_idx, ego]  # [T, D]
    iv = analysis.intervention_effect(
        ego_probe, other_probe, ego_tok_t, args.intervention_label
    )
    changed = float((iv["ego_pred"] != iv["ego_pred_prime"]).float().mean())
    print(json.dumps({"intervention_changed_frac": changed}))

    # ---- overlay figures ---------------------------------------------------
    import matplotlib.pyplot as plt

    vis = eval_env.vis
    state = eval_env.state
    imgs = vis.plot_importance_weight(
        state, w_idx, result.importance[-1, w_idx].cpu().numpy(), ego,
        zoom_radius=50.0,
    )
    for h, img in enumerate(imgs):
        plt.imsave(os.path.join(args.out, f"importance_head{h}.png"), img)

    ro_tok_t = result.ro_tokens[-1, w_idx, ego]  # [A-1, D]
    partner_cells = analysis.predict_partner_cells(other_probe, ro_tok_t)
    horizon = 3
    img = vis.plot_linear_probing(
        state, w_idx, ego,
        ego_pred=[int(iv["ego_pred"][-1])] * horizon,
        ego_pred_prime=[int(iv["ego_pred_prime"][-1])] * horizon,
        partner_pred=[int(partner_cells[0])] * horizon,
    )
    plt.imsave(os.path.join(args.out, "linear_probing.png"), img)

    img = vis.plot_log_replay_comparison(result.positions.cpu().numpy(),
                                         w_idx)
    plt.imsave(os.path.join(args.out, "log_replay_comparison.png"), img)
    print(f"figures written to {args.out}")


if __name__ == "__main__":
    main()
