"""Behavior-cloning trainer (port of ``gpudrive_lab_tpu/il/train.py``;
reference: baselines/il/il.py:182-367).

AdamW over the attention BC net with the GMM negative log-likelihood (or a
smooth-L1 loss on the heaviest component's mean), and closed-loop
evaluation in the simulator (goal, collision and off-road rates;
reference: baselines/il/test/simulation.py).

Run (on the card by default; ``--device cpu`` for a small CPU run):

    python -m gpudrive_lab_torch.il.train --num-worlds 16 --num-batches 2
    python -m gpudrive_lab_torch.il.train --device cpu --num-worlds 2 \\
        --epochs 1

It rolls out ``--num-batches`` batches of ``--num-worlds`` scenes with
every agent replaying its log (delta_local dynamics), trains on every valid
agent's samples, writes ``--out`` (``bc_policy.pt``: the state_dict and the
BCConfig) and evaluates the policy closed-loop on the first batch and, with
``--eval-heldout``, on the loader's next batch when none of it was trained
on.  A JAX ``bc_policy.pkl`` loads with
``networks.convert.load_jax_checkpoint``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.il.data_generation import generate_state_action_pairs
from gpudrive_lab_torch.il.dataset import ExpertDataset
from gpudrive_lab_torch.il.networks import (
    BCConfig,
    EarlyFusionAttnBCNet,
    gmm_log_prob,
    gmm_sample,
)

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class BCTrainConfig:
    lr: float = 3e-4
    weight_decay: float = 1e-4
    batch_size: int = 256
    epochs: int = 10
    rollout_len: int = 5
    loss: str = "gmm"  # gmm | l1


def make_bc_train_step(model: EarlyFusionAttnBCNet, config: BCTrainConfig):
    """(optimizer, train_step): AdamW (optax.adamw's defaults: betas 0.9,
    0.999, eps 1e-8, decoupled weight decay on every parameter) and
    ``train_step(batch) -> loss``, one update of ``model`` in place."""
    opt = torch.optim.AdamW(model.parameters(), lr=config.lr,
                            weight_decay=config.weight_decay, eps=1e-8)
    # a parameter the loss does not reach (the l1 loss's variance and
    # mixture heads) has a zero gradient, not none, so that AdamW decays
    # it and counts its step as optax does
    for p in model.parameters():
        p.grad = torch.zeros_like(p)

    def loss_fn(batch):
        _, (means, variances, weights) = model(
            batch["obs"], batch["partner_mask"], batch["road_mask"])
        actions = batch["actions"][:, 0]  # pred_len = 1
        if config.loss == "gmm":
            return -gmm_log_prob(actions, means, variances, weights).mean()
        pred = gmm_sample(None, means, variances, weights, True)
        diff = torch.abs(pred - actions)
        return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).mean()

    def train_step(batch):
        loss = loss_fn(batch)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, train_step


def stacked_inputs(env: GPUDriveTorchEnv, frames: list, ns: int):
    """The last ``ns`` frames side by side per agent row [W*A, ns*D] and
    the partner (bool, set where not a live partner) and road masks."""
    W, A = env.num_worlds, env.max_agent_count
    stacked = torch.cat(frames[-ns:], dim=-1).reshape(W * A, -1)
    pm = env.get_partner_mask().reshape(W * A, -1) != 0
    rm = env.get_road_mask().reshape(W * A, -1)
    return stacked, pm, rm


@torch.no_grad()
def evaluate_closed_loop(env: GPUDriveTorchEnv, model: EarlyFusionAttnBCNet,
                         bc_config: BCConfig, max_steps: int = 91,
                         generator: torch.Generator | None = None) -> dict:
    """Drive the env's agents with actions drawn from the BC policy's
    mixture and report the controlled agents' goal, collision and off-road
    rates (reference: baselines/il/test/simulation.py).  The draws come
    from ``generator`` (on the env's device; seeded 0 by default)."""
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    obs = env.reset()
    ns = bc_config.num_stack
    W, A = env.num_worlds, env.max_agent_count
    frames = [obs] * ns
    for _ in range(max_steps):
        _, (means, variances, weights) = model(
            *stacked_inputs(env, frames, ns))
        act = gmm_sample(generator, means, variances, weights)
        env.step_dynamics(act.reshape(W, A, 3))
        frames = frames[1:] + [env.get_obs()]
        if bool(env.get_dones().all()):
            break
    infos = env.get_infos()
    ctrl = env.cont_agent_mask.to(torch.float32)
    n = torch.clamp(ctrl.sum(), min=1)
    rates = torch.stack([(infos[k] * ctrl).sum() / n for k in (
        "goal_achieved", "collided", "off_road")]).cpu().tolist()
    return dict(zip(("goal_rate", "collision_rate", "off_road_rate"), rates))


def _concat_data_batches(parts: list) -> dict:
    """Per-batch rollout dicts joined along the world axis: [T, W, ...]
    entries on axis 1, the [W, A] masks on axis 0."""
    out = {}
    for k in parts[0]:
        axis = 0 if k in ("controlled_mask", "valid_mask") else 1
        cat = torch.cat if isinstance(parts[0][k], torch.Tensor) \
            else np.concatenate
        out[k] = cat([p[k] for p in parts], axis)
    return out


def save_policy(path, model: EarlyFusionAttnBCNet):
    """``path`` (bc_policy.pt): the state_dict and the BCConfig."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cfg = dataclasses.asdict(model.config)
    cfg["dtype"] = str(cfg["dtype"])
    torch.save({"policy": model.state_dict(), "config": cfg}, path)


def load_policy(path, device=None) -> EarlyFusionAttnBCNet:
    """The BC net saved by ``save_policy`` (a ``.pt``), or by the JAX
    trainer (a ``.pkl`` with ``variables`` and ``config``)."""
    from gpudrive_lab_torch.networks import convert

    if str(path).endswith(".pkl"):
        cfg = dict(convert.read_jax_pickle(path)["config"])
        cfg.pop("dtype", None)
        model = EarlyFusionAttnBCNet(BCConfig(**cfg), device=device)
        convert.load_jax_checkpoint(path, model)
        return model
    ckpt = torch.load(path, map_location="cpu")
    cfg = dict(ckpt["config"])
    cfg.pop("dtype", None)
    model = EarlyFusionAttnBCNet(BCConfig(**cfg), device=device)
    model.load_state_dict(ckpt["policy"])
    return model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device; the run fails without CUDA unless "
                        "another device is named (e.g. cpu)")
    p.add_argument("--data-dir", default=str(ROOT / "data" / "pool_v3"))
    p.add_argument("--num-worlds", type=int, default=2)
    p.add_argument("--num-batches", type=int, default=1,
                   help="scene batches rolled out for expert data "
                        "(num_worlds scenes each, advanced with "
                        "swap_data_batch)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--agent-bucket", type=int, default=None,
                   help="pad the agent axis to this bucket")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--eval-heldout", action="store_true",
                   help="also evaluate closed-loop on the loader's next "
                        "(unseen) scene batch")
    p.add_argument("--out", default="runs/bc_policy.pt")
    args = p.parse_args(argv)

    loader = SceneDataLoader(root=args.data_dir, batch_size=args.num_worlds,
                             dataset_size=100000)
    env_cfg = EnvConfig(
        dynamics_model="delta_local", collision_behavior="ignore",
        max_controlled_agents=0,  # every agent replays its log
        agent_bucket=args.agent_bucket,
    )
    env = GPUDriveTorchEnv(env_cfg, data_loader=loader, device=args.device)
    dev = env.device
    parts = [generate_state_action_pairs(env)]
    first_batch_paths = list(env.scene_paths)
    trained_paths = set(first_batch_paths)
    for b in range(1, args.num_batches):
        env.swap_data_batch()
        trained_paths.update(env.scene_paths)
        parts.append(generate_state_action_pairs(env))
        print(f"data batch {b + 1}/{args.num_batches} collected", flush=True)
    data = _concat_data_batches(parts)
    del parts
    # every valid agent's log is supervision
    data["controlled_mask"] = data["valid_mask"]
    cfg = BCTrainConfig(batch_size=args.batch_size, epochs=args.epochs,
                        lr=args.lr)
    ds = ExpertDataset(data, rollout_len=cfg.rollout_len, device=dev)
    del data
    print(f"dataset: {len(ds)} samples "
          f"({args.num_batches * args.num_worlds} scenes)")

    # the flat obs keeps 127 partner slots whatever the agent bucket, so
    # BCConfig keeps its defaults
    bc_cfg = BCConfig(num_stack=cfg.rollout_len)
    model = EarlyFusionAttnBCNet(bc_cfg, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    _, train_step = make_bc_train_step(model, cfg)

    t0 = time.time()
    for epoch in range(cfg.epochs):
        losses = [train_step(b) for b in ds.iter_batches(cfg.batch_size,
                                                         rng)]
        mean = float(torch.stack(losses).mean()) if losses else float("nan")
        print(json.dumps(dict(epoch=epoch, loss=round(mean, 4),
                              elapsed=round(time.time() - t0, 1))),
              flush=True)

    save_policy(args.out, model)
    # closed-loop evaluation with the policy in control (the data env was
    # all-expert): the first training batch, and with --eval-heldout the
    # loader's next batch when none of it was trained on
    eval_cfg = dataclasses.replace(env_cfg, max_controlled_agents=128)
    eval_env = GPUDriveTorchEnv(eval_cfg, first_batch_paths, device=dev)
    metrics = evaluate_closed_loop(eval_env, model, bc_cfg)
    print(json.dumps({"split": "train", **metrics}))
    if args.eval_heldout:
        # an exhausted or wrapped-around loader has no heldout batch: say
        # so rather than mislabel trained scenes
        try:
            heldout_paths = next(env.data_iterator)
        except StopIteration:
            print(json.dumps({"split": "heldout",
                              "skipped": "data loader exhausted"}))
            heldout_paths = None
        if heldout_paths is not None:
            overlap = trained_paths.intersection(heldout_paths)
            if overlap:
                print(json.dumps({
                    "split": "heldout",
                    "skipped": f"{len(overlap)} of {len(heldout_paths)} "
                               "candidate scenes were trained on "
                               "(loader wrapped around)"}))
            else:
                heldout_env = GPUDriveTorchEnv(eval_cfg, heldout_paths,
                                               device=dev)
                metrics = evaluate_closed_loop(heldout_env, model, bc_cfg)
                print(json.dumps({"split": "heldout", **metrics}))


if __name__ == "__main__":
    main()
