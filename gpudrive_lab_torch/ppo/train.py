"""PPO training entry point (port of ``gpudrive_lab_tpu/ppo/train.py``;
reference: baselines/ppo/ppo_pufferlib.py).

Builds the env over scene batches drawn from ``--data-dir`` by
``SceneDataLoader`` (with replacement, seeded with ``--seed``, as the JAX
CLI draws them), the late-fusion policy and the PPO trainer, then trains
with periodic checkpoints (the policy's and Adam's ``state_dict``),
optional resume, and the entropy-floor controller.  ``--resample-interval``
N swaps in the loader's next batch every N agent-steps; the rollout's
action generator runs on across swaps.

Run (on the card by default; ``--device cpu`` for a small CPU run):

    python -m gpudrive_lab_torch.ppo.train --num-worlds 4 --rollout-len 16

``--policy-dtype bf16`` runs the policy in bf16 (K3 and K4 in their bf16
compute mode with ``--fused-embed``); ``--obs-store bf16`` or
``split-bf16`` with it is the JAX package's production pairing.

``--video-interval N`` renders ``--video-worlds`` worlds every N
iterations with the current policy into ``<checkpoint-path>/videos/``
(matplotlib; the env's own state, not the trainer's carry; its time counts
under the profile's ``env`` phase).  ``--dashboard`` shows a live rich
table and silences the JSON lines on stdout.  The JAX package's dispatch
options ``--rollout-mode``, ``--iters-per-dispatch`` and ``--packed-io``
are accepted: this trainer has one eager mode, and they give the same
samples and metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import (
    GPUDriveTorchEnv,
    expert_log_playback,
)
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.ppo.ppo import PPO, EnvCarry, PPOConfig

ROOT = Path(__file__).resolve().parents[2]
CHECKPOINT = "policy.pt"
JAX_CHECKPOINT = "policy.pkl"
_MODES = ("scan", "unroll", "loop", "dispatch")


def make_fresh(env: GPUDriveTorchEnv):
    """The auto-reset's select target: the t=0 reset state, advanced by
    ``init_steps`` of expert log playback when configured (reference:
    env_torch.py:403-451; ppo_base_puffer.yaml trains with init_steps=11)."""
    fresh = stepmod.reset(env.scene, None, env.params)
    k = env.config.init_steps
    if k:
        fresh, _ = expert_log_playback(
            env.scene, fresh,
            torch.zeros(env.num_worlds, dtype=torch.int32, device=env.device),
            env.params, env.config.dynamics_model, k,
        )
    return fresh


def fresh_carry(env: GPUDriveTorchEnv, fresh, rng: torch.Generator):
    """The trainer's env carry at the start of the env's scene batch:
    ``fresh`` with every clock at ``init_steps``, drawing actions from
    ``rng``.  After a swap ``rng`` is the live generator, not a reseeded
    one, which would replay spent exploration noise."""
    return EnvCarry(
        state=fresh,
        world_time_steps=torch.full((env.num_worlds,), env.config.init_steps,
                                    dtype=torch.int32, device=env.device),
        rng=rng,
    )


def check_compact_capacity(env: GPUDriveTorchEnv, compact: int | None,
                           compact_mode: str = "world",
                           compact_blocks: int = 0):
    """Every controlled agent must fit in the compact rows: an overflow
    agent would drive with action 0 every step and never enter the loss.
    Reads the controlled mask on the host, once, at build time."""
    if not compact:
        return
    ctrl = env.scene.agents.controlled.cpu()
    if compact_mode == "flat":
        if compact_blocks and compact_blocks > 1:
            per_block = ctrl.reshape(compact_blocks, -1).sum(dim=1)
            cap = compact // compact_blocks
            if int(per_block.max()) > cap:
                raise ValueError(
                    f"compact={compact} over {compact_blocks} blocks "
                    f"(cap {cap}/block) would drop controlled agents "
                    f"(block totals {per_block.tolist()})"
                )
            return
        total = int(ctrl.sum())
        if compact < total:
            raise ValueError(
                f"compact={compact} (flat) would drop controlled agents "
                f"(scene batch total {total})"
            )
        return
    max_ctrl = int(ctrl.sum(dim=1).max())
    if compact < max_ctrl:
        raise ValueError(
            f"compact={compact} would drop controlled agents "
            f"(scene batch max {max_ctrl} per world)"
        )


def build_trainer(env: GPUDriveTorchEnv, ppo_config: PPOConfig,
                  policy_config: PolicyConfig | None = None, seed: int = 42,
                  rollout_mode: str = "scan", iters_per_dispatch: int = 1,
                  packed_io: bool = False):
    """Returns (ppo, carry, fresh, train_fn).

    ``ppo.policy`` and ``ppo.optimizer`` are trained in place by
    ``train_fn(scene, carry, fresh, reward_weights, ent_coef=None) ->
    (carry, metrics)``.  The policy's weights come from ``seed``, the
    action draws from a generator on the env's device seeded with ``seed``
    and the minibatch order from a host generator seeded with ``seed + 1``.

    ``rollout_mode``, ``iters_per_dispatch`` and ``packed_io`` are the JAX
    package's dispatch options, accepted as aliases of the one eager mode
    under the same rules; with ``iters_per_dispatch`` = K > 1 one call runs
    K iterations and every metric gains a leading [K] axis."""
    if rollout_mode not in _MODES:
        raise ValueError(f"rollout_mode must be one of {_MODES}")
    if packed_io and rollout_mode in ("dispatch", "loop"):
        raise ValueError("--packed-io requires a single-program rollout "
                         "mode (scan/unroll)")
    if iters_per_dispatch > 1 and rollout_mode in ("dispatch", "loop"):
        raise ValueError("--iters-per-dispatch requires a single-program "
                         "rollout mode (scan/unroll)")
    if env.config.init_steps:
        ppo_config = dataclasses.replace(
            ppo_config, reset_time_step=env.config.init_steps)
    check_compact_capacity(env, ppo_config.compact, ppo_config.compact_mode,
                           ppo_config.compact_blocks)
    policy_config = policy_config or PolicyConfig(
        action_dim=env.action_space_n,
        embed_remat=ppo_config.embed_remat,
        fused_embed=ppo_config.fused_embed,
        dtype=(torch.bfloat16 if ppo_config.policy_dtype == "bfloat16"
               else torch.float32),
    )
    policy = LateFusionPolicy(policy_config, device=env.device,
                              generator=torch.Generator().manual_seed(seed))
    ppo = PPO(policy, env.params, env.spec, env.action_keys,
              env.config.reward_type, ppo_config,
              perm_generator=torch.Generator().manual_seed(seed + 1))
    fresh = make_fresh(env)
    carry = fresh_carry(env, fresh,
                        torch.Generator(device=env.device).manual_seed(seed))
    if iters_per_dispatch <= 1:
        return ppo, carry, fresh, ppo.train_step

    def train_fn(scene, carry, fresh, reward_weights, ent_coef=None):
        stacked = []
        for _ in range(iters_per_dispatch):
            carry, m = ppo.train_step(scene, carry, fresh, reward_weights,
                                      ent_coef)
            stacked.append(m)
        return carry, {k: torch.stack([m[k] for m in stacked])
                       for k in stacked[0]}

    return ppo, carry, fresh, train_fn


def save_checkpoint(ckpt_dir, policy, optimizer, iteration, global_step):
    """Write <ckpt_dir>/policy.pt through a temporary file and a rename:
    the policy's and Adam's state_dict, the iteration and the global step
    (reference: integrations/puffer/ppo.py:695-737)."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / (CHECKPOINT + ".tmp")
    torch.save({"policy": policy.state_dict(),
                "optimizer": optimizer.state_dict(),
                "iteration": iteration, "global_step": global_step}, tmp)
    tmp.replace(ckpt_dir / CHECKPOINT)


def load_checkpoint(ckpt_dir, policy, optimizer=None) -> int | None:
    """Restore the policy (and Adam, when ``optimizer`` is given) from
    <ckpt_dir>/policy.pt, or else from the JAX trainer's
    <ckpt_dir>/policy.pkl.  Returns the checkpoint's global step, or None
    when there is no checkpoint."""
    from gpudrive_lab_torch.networks import convert

    ckpt_dir = Path(ckpt_dir)
    if (ckpt_dir / CHECKPOINT).exists():
        ckpt = torch.load(ckpt_dir / CHECKPOINT, map_location="cpu")
        policy.load_state_dict(ckpt["policy"])
        if optimizer is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        return int(ckpt.get("global_step", 0))
    if (ckpt_dir / JAX_CHECKPOINT).exists():
        return convert.load_jax_checkpoint(ckpt_dir / JAX_CHECKPOINT, policy,
                                           optimizer)
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device; the run fails without CUDA unless "
                        "another device is named (e.g. cpu)")
    p.add_argument("--data-dir", default=str(ROOT / "data" / "pool_v3"),
                   help="directory of tfrecord*.json scenes; batches of "
                        "--num-worlds are drawn from them with replacement")
    p.add_argument("--num-worlds", type=int, default=4)
    p.add_argument("--dataset-size", type=int, default=1000,
                   help="use at most this many scenes of --data-dir "
                        "(sorted)")
    p.add_argument("--total-timesteps", type=int, default=2_000_000)
    p.add_argument("--rollout-len", type=int, default=32)
    p.add_argument("--resample-interval", type=int, default=0,
                   help="agent-steps between scene-batch swaps (0 = never)")
    p.add_argument("--log-interval", type=int, default=10,
                   help="iterations between metric lines")
    p.add_argument("--checkpoint-path", default="runs")
    p.add_argument("--checkpoint-interval", type=int, default=200)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--continue-training", action="store_true",
                   help="resume from <checkpoint-path>/policy.pt (or the "
                        "JAX trainer's policy.pkl)")
    p.add_argument("--rollout-mode", choices=_MODES, default="scan",
                   help="accepted alias: one eager mode here")
    p.add_argument("--iters-per-dispatch", type=int, default=1,
                   help="K iterations per train_fn call (same samples and "
                        "metrics as K calls)")
    p.add_argument("--packed-io", action="store_true",
                   help="accepted alias: no effect here")
    p.add_argument("--agent-bucket", default=None,
                   help="'auto' (or an int) buckets the sim's agent axis "
                        "to the scene batch max instead of 128 rows")
    p.add_argument("--road-gather", choices=["take", "dot"], default="take",
                   help="accepted alias: one exact gather here")
    p.add_argument("--max-roads", type=int, default=None,
                   help="pin the road-axis bucket (rounded up to 256)")
    p.add_argument("--init-steps", type=int, default=0,
                   help="expert log-playback warm-up steps at every reset; "
                        "the reference trains with 11")
    p.add_argument("--ent-coef", type=float, default=1e-4)
    p.add_argument("--entropy-floor", type=float, default=0.0,
                   help="raise the entropy coefficient (x1.5) while the "
                        "policy entropy is below this floor, relax it back "
                        "toward --ent-coef above twice the floor; 0 = off")
    p.add_argument("--num-minibatches", type=int, default=4)
    p.add_argument("--epoch-preshuffle", action="store_true",
                   help="accepted alias: same minibatches")
    p.add_argument("--minibatch-rows", type=int, default=0,
                   help="flat mode: also slice minibatches to this many "
                        "rows of the flat agent axis (0 = time only)")
    p.add_argument("--update-epochs", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--compact", type=int, default=0,
                   help="learner compaction rows (0 = dense)")
    p.add_argument("--compact-mode", choices=["world", "flat"],
                   default="world")
    p.add_argument("--compact-blocks", type=int, default=0)
    p.add_argument("--keep-non-vehicles", action="store_true",
                   help="create pedestrian/cyclist agents")
    p.add_argument("--obs-store",
                   choices=["remat", "f32", "bf16", "split-f32",
                            "split-bf16"], default="remat",
                   help="recompute observations from stored states, or store "
                        "them flat or split, in f32 or bf16")
    p.add_argument("--policy-dtype", choices=["f32", "bf16"], default="f32",
                   help="policy compute dtype; parameters stay float32")
    p.add_argument("--embed-remat", action="store_true")
    p.add_argument("--fused-embed", action="store_true",
                   help="partner/road embed+pool through kernels K3/K4")
    p.add_argument("--video-interval", type=int, default=0,
                   help="iterations between rollout videos rendered with "
                        "the current policy into <checkpoint-path>/videos/ "
                        "(0 = off; needs matplotlib; reference: "
                        "env_puffer.py:405-483 wandb video pipeline)")
    p.add_argument("--video-worlds", type=int, default=1,
                   help="how many worlds to render per video interval")
    p.add_argument("--dashboard", action="store_true",
                   help="live rich-console dashboard (reference: "
                        "integrations/puffer/logging.py); the JSON lines "
                        "on stdout are silenced while it is on")
    args = p.parse_args(argv)
    if args.video_interval:
        # videos need matplotlib: fail here, not after the first iteration
        import matplotlib  # noqa: F401

        from gpudrive_lab_torch.visualize.video import render_training_videos

    from gpudrive_lab_torch.utils.dashboard import Dashboard
    from gpudrive_lab_torch.utils.logging import MetricsLogger
    from gpudrive_lab_torch.utils.profiling import Profile, Utilization

    loader = SceneDataLoader(
        root=args.data_dir, batch_size=args.num_worlds,
        dataset_size=args.dataset_size, sample_with_replacement=True,
        seed=args.seed,
    )
    cfg = EnvConfig(
        reward_type="weighted_combination", collision_weight=-0.75,
        off_road_weight=-0.75, goal_achieved_weight=1.0,
        dynamics_model="classic", collision_behavior="ignore",
        init_steps=args.init_steps,
        remove_non_vehicles=not args.keep_non_vehicles,
        road_gather=args.road_gather,
        agent_bucket=(int(args.agent_bucket) if args.agent_bucket
                      and args.agent_bucket != "auto" else args.agent_bucket),
    )
    env = GPUDriveTorchEnv(cfg, data_loader=loader,
                           max_roads=args.max_roads, device=args.device)
    ppo_cfg = PPOConfig(
        rollout_len=args.rollout_len, num_minibatches=args.num_minibatches,
        ent_coef=args.ent_coef, update_epochs=args.update_epochs,
        learning_rate=args.lr, compact=args.compact,
        compact_mode=args.compact_mode, compact_blocks=args.compact_blocks,
        remat_obs=args.obs_store == "remat",
        obs_store_dtype="bfloat16" if args.obs_store.endswith("bf16")
        else "float32",
        obs_store="split" if args.obs_store.startswith("split") else "flat",
        minibatch_rows=args.minibatch_rows,
        epoch_preshuffle=args.epoch_preshuffle,
        embed_remat=args.embed_remat, fused_embed=args.fused_embed,
        policy_dtype="bfloat16" if args.policy_dtype == "bf16" else "float32",
    )
    ppo, carry, fresh, train_fn = build_trainer(
        env, ppo_cfg, seed=args.seed, rollout_mode=args.rollout_mode,
        iters_per_dispatch=args.iters_per_dispatch, packed_io=args.packed_io,
    )
    ckpt_dir = Path(args.checkpoint_path)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    start_step = 0
    if args.continue_training:
        resumed = load_checkpoint(ckpt_dir, ppo.policy, ppo.optimizer)
        if resumed is not None:
            start_step = resumed
            print(json.dumps({"resumed_from": start_step}), flush=True)

    logger = MetricsLogger(args.checkpoint_path, exp_id="ppo",
                           echo=not args.dashboard)
    profile = Profile()
    util = Utilization()
    util.start()
    dash = Dashboard(args.total_timesteps) if args.dashboard else None
    global_step = start_step
    iteration = 0
    resampled_at = start_step
    resample_count = 0
    resample_time_s = 0.0
    ent_coef = args.ent_coef
    ep_win_keys = ("perc_goal_achieved", "perc_collisions", "perc_off_road")
    ep_win = dict.fromkeys(("episodes",) + ep_win_keys, 0.0)
    if dash is not None:
        dash.__enter__()
    try:
        while global_step < args.total_timesteps:
            if (args.resample_interval
                    and global_step - resampled_at >= args.resample_interval):
                env_before = profile.elapsed["env"]
                with profile.phase("env"):
                    env.swap_data_batch()
                    check_compact_capacity(env, ppo_cfg.compact,
                                           ppo_cfg.compact_mode,
                                           ppo_cfg.compact_blocks)
                    fresh = make_fresh(env)
                    carry = fresh_carry(env, fresh, carry.rng)
                resampled_at = global_step
                resample_count += 1
                # this swap's duration (profile.elapsed is cumulative)
                resample_time_s = profile.elapsed["env"] - env_before
            with profile.phase("learn"):
                carry, metrics = train_fn(env.scene, carry, fresh,
                                          env.reward_weights, ent_coef)
                # one host read of the iteration's metrics
                names = sorted(metrics)
                host = torch.stack([metrics[k].detach().double().reshape(-1)
                                    for k in names]).cpu()
                fetched = dict(zip(names, host))
                samples = int(fetched.pop("samples").sum())
                m = {k: float(v.mean()) for k, v in fetched.items()}
                # episode-weighted sums over the logging window
                ep = fetched["episodes"]
                ep_win["episodes"] += float(ep.sum())
                for key in ep_win_keys:
                    ep_win[key] += float((fetched[key] * ep).sum())
            if args.entropy_floor > 0.0:
                if m["entropy"] < args.entropy_floor:
                    ent_coef = min(ent_coef * 1.5, 0.1)
                elif m["entropy"] > 2.0 * args.entropy_floor:
                    ent_coef = max(ent_coef / 1.2, args.ent_coef)
                m["ent_coef"] = ent_coef
            global_step += samples
            profile.account(samples, env.num_worlds * env.max_agent_count
                            * args.rollout_len * args.iters_per_dispatch)
            prev_iteration = iteration
            iteration += args.iters_per_dispatch
            if (iteration // args.log_interval
                    != prev_iteration // args.log_interval):
                n_ep = max(ep_win["episodes"], 1.0)
                m["episodes"] = ep_win["episodes"]
                for key in ep_win_keys:
                    m[key] = ep_win[key] / n_ep
                ep_win = dict.fromkeys(ep_win, 0.0)
                rec = dict(iteration=iteration, global_step=global_step,
                           resamples=resample_count,
                           resample_time_s=round(resample_time_s, 4),
                           **{k: round(v, 5) for k, v in m.items()},
                           **profile.summary(), **util.summary())
                logger.log(rec, step=global_step)
                if dash is not None:
                    dash.update(global_step, rec)
            if args.video_interval and (
                    iteration // args.video_interval
                    != prev_iteration // args.video_interval):
                with profile.phase("env"):
                    paths = render_training_videos(
                        env, ppo.policy, ckpt_dir / "videos", global_step,
                        num_worlds=args.video_worlds)
                logger.log({"videos": paths, "global_step": global_step},
                           step=global_step)
            if (iteration // args.checkpoint_interval
                    != prev_iteration // args.checkpoint_interval):
                save_checkpoint(ckpt_dir, ppo.policy, ppo.optimizer,
                                iteration, global_step)
        save_checkpoint(ckpt_dir, ppo.policy, ppo.optimizer, iteration,
                        global_step)
    finally:
        if dash is not None:
            dash.__exit__(None, None, None)
        util.stop()
        util.join()
        logger.close()
    print(json.dumps({"final_global_step": global_step}))


if __name__ == "__main__":
    main()
