"""Headless throughput benchmark (port of the repository's ``bench.py``;
reference: src/headless.cpp:125-155).

Sim mode steps a batch of worlds with random discrete actions and reports
**agent-normalized steps/s** = steps x sum(per-world created agents) / wall
time, the reference's headline metric ("1M FPS", README.md:10).  Each step
(``bench_step``): random indices into the classic action table -> the sim
step (movement, collision, reward, done) -> the flat policy observation
(self + partner + K-nearest road graph; off with ``--no-obs``) -> the lidar,
BEV and camera when asked for -> reset-as-select of the finished worlds.
A scalar accumulator consumes every step's output, each sensor's through a
full reduction, and the clock is read only after the device has finished
(``torch.cuda.synchronize``): eager PyTorch returns before its kernels run.

``--train`` instead times full PPO iterations (rollout, GAE, minibatch
epochs) of the port's trainer and reports controlled-agent samples
consumed per second of wall time.

Prints ONE JSON line on stdout and the run's details on stderr:

  {"metric": "agent_steps_per_sec", "value": N, "unit": "agent-steps/s",
   "vs_baseline": N / 1e6}

Runs on the card unless ``--device cpu`` (or ``--platform cpu``) asks for
the CPU; ``--smoke`` is a tiny CPU run.  Kernels: K2 on every step of the
default buckets, K1 under ``--tiles on`` or at road buckets >= 2048; in
``--train`` mode also K3/K4 with ``--fused-embed`` (their bf16 compute mode
with ``--policy-dtype bf16``).

    python -m gpudrive_lab_torch.bench --scenes-dir data/pool_v3
    python -m gpudrive_lab_torch.bench --scenes-dir data/pool_v3 --train \\
        --fused-embed
    python -m gpudrive_lab_torch.bench --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.bev import bev_observation
from gpudrive_lab_torch.core.lidar import lidar_observation
from gpudrive_lab_torch.core.render import CameraConfig, batch_render
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import ObsSpec, flat_observation
from gpudrive_lab_torch.scene.compiler import build_scene
from gpudrive_lab_torch.utils.profiling import span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's own scene layout; tests/data when it is absent
DEFAULT_SCENES = os.path.join(ROOT, "data", "processed", "examples")
FALLBACK_SCENES = os.path.join(ROOT, "tests", "data")
TILES = {"auto": None, "on": True, "off": False}


def scenes_dir_or_fallback(scenes_dir: str) -> str:
    """``scenes_dir``; the bundled fixtures of tests/data when it is the
    default and the WOMD examples are not there (as bench.py falls back).
    A directory the caller named that does not exist is an error."""
    if os.path.isdir(scenes_dir):
        return scenes_dir
    if scenes_dir == DEFAULT_SCENES:
        return FALLBACK_SCENES
    raise SystemExit(f"--scenes-dir {scenes_dir} is not a directory")


def agent_bucket(value):
    """--agent-bucket: 'auto', None or an explicit row count."""
    return int(value) if value and value != "auto" else value


def action_table(cfg: EnvConfig, device) -> torch.Tensor:
    """The classic [n_actions, 3] (accel, steer, head tilt) table, the
    cartesian product in the reference's order."""
    a, b, c = np.meshgrid(cfg.accel_actions, cfg.steer_actions,
                          cfg.head_tilt_actions, indexing="ij")
    return torch.as_tensor(np.stack([a.ravel(), b.ravel(), c.ravel()],
                                    axis=-1), dtype=torch.float32,
                           device=device)


def bench_step(scene, fresh, table, weights, state, idx, acc, params,
               spec: ObsSpec, obs: bool = True, lidar: bool = False,
               bev: bool = False, camera: int | None = None):
    """One benched env step with the action indices ``idx`` [W, A] into
    ``table``: the sim step, the observation and sensors asked for, each
    consumed into the scalar ``acc``, and the finished worlds reset to
    ``fresh``.  Returns (state, acc)."""
    with span("bench.step"):
        W, A = idx.shape
        act = torch.zeros((W, A, C.ACTION_DIM), dtype=torch.float32,
                          device=idx.device)
        act[..., :3] = table[idx]
        state = stepmod.step(scene, state, act, params)
        if obs:
            o, _, _ = flat_observation(scene, state, params, spec, weights)
            acc = acc + o[0, 0, 0] + state.reward[0, 0]
        else:
            acc = acc + state.reward[0, 0]
        # each sensor through a FULL reduction of its output
        if lidar:
            acc = acc + lidar_observation(scene, state, params,
                                          act)[..., 0].sum()
        if bev:
            acc = acc + bev_observation(scene, state, params).sum()
        if camera:
            rgb, depth = batch_render(
                scene, state, CameraConfig(height=camera, width=camera))
            acc = acc + depth.sum() + rgb[..., 0].sum(dtype=torch.float32)
        return (stepmod.select_worlds(stepmod.world_done(scene, state), fresh,
                                      state), acc)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_meta(device: torch.device) -> dict:
    cuda = device.type == "cuda"
    return {"backend": "gpu" if cuda else "cpu",
            "device_name": (torch.cuda.get_device_name(device) if cuda
                            else "cpu")}


def bench_train(args, device: torch.device) -> tuple[dict, dict]:
    """End-to-end PPO training throughput: CONTROLLED-AGENT SAMPLES
    consumed by the learner per second of wall time over full train
    iterations (rollout + GAE + minibatch update), comparable to the
    reference's PufferLib "Training SPS" of 100-300K (reference:
    README.md:178).  Best of ``--repeats``; each repetition's action
    generator is reseeded outside the timed region.  Returns (meta,
    result)."""
    from gpudrive_lab_torch.env.dataset import SceneDataLoader
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.ppo.ppo import PPOConfig
    from gpudrive_lab_torch.ppo.train import build_trainer

    worlds = args.worlds or (2 if args.smoke else 128)
    scenes_dir = scenes_dir_or_fallback(args.scenes_dir)
    loader = SceneDataLoader(
        root=scenes_dir, batch_size=worlds,
        dataset_size=1000, sample_with_replacement=True, seed=0,
    )
    cfg = EnvConfig(
        num_worlds=worlds,
        reward_type="weighted_combination",
        collision_weight=-0.75, off_road_weight=-0.75,
        goal_achieved_weight=1.0,
        dynamics_model="classic", collision_behavior="ignore",
        init_steps=args.init_steps,
        road_gather=args.road_gather,
        approx_top_k=args.train_approx_top_k,
        use_tile_collision=TILES[args.tiles],
        agent_bucket=agent_bucket(args.agent_bucket),
    )
    env = GPUDriveTorchEnv(cfg, data_loader=loader, max_roads=args.max_roads,
                           device=device)
    t0 = time.time()
    ppo_cfg = PPOConfig(
        rollout_len=args.rollout_len,
        num_minibatches=args.num_minibatches,
        update_epochs=args.update_epochs,
        remat_obs=args.obs_store == "remat",
        obs_store_dtype="bfloat16" if args.obs_store.endswith("bf16")
        else "float32",
        obs_store="split" if args.obs_store.startswith("split") else "flat",
        compact=args.compact,
        compact_mode=args.compact_mode,
        compact_blocks=args.compact_blocks,
        policy_dtype="bfloat16" if args.policy_dtype == "bf16"
        else "float32",
        minibatch_rows=args.minibatch_rows,
        epoch_preshuffle=args.epoch_preshuffle,
        embed_remat=args.embed_remat,
        fused_embed=args.fused_embed,
    )
    _, carry, fresh, train_fn = build_trainer(
        env, ppo_cfg, seed=0, rollout_mode=args.rollout_mode,
        iters_per_dispatch=args.iters_per_dispatch, packed_io=args.packed_io,
    )
    iters = 2 if args.smoke else args.train_iters

    def reseed(carry, seed: int):
        return carry._replace(
            rng=torch.Generator(device=device).manual_seed(seed))

    def run(carry):
        samples = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(iters):
            carry, metrics = train_fn(env.scene, carry, fresh,
                                      env.reward_weights, args.ent_coef)
            # with --iters-per-dispatch K, metrics have a leading [K] axis
            samples = samples + metrics["samples"].sum()
            # one wait per iteration, as bench.py blocks once per iteration
            _sync(device)
        return carry, float(samples)

    carry, _ = run(reseed(carry, 0))  # warm-up
    compile_s = time.time() - t0

    best = None
    best_samples = 0.0
    for rep in range(args.repeats):
        carry = reseed(carry, 1 + rep)  # untimed
        t0 = time.time()
        carry, samples = run(carry)
        dt = time.time() - t0
        if best is None or samples / dt > best_samples / best:
            best, best_samples = dt, samples

    sps = best_samples / best
    meta = {
        "mode": "train",
        "worlds": worlds,
        "rollout_len": args.rollout_len,
        "iters": iters,
        "samples_per_iter": round(best_samples / iters),
        "scenes_dir": scenes_dir,
        **_device_meta(device),
        "compile_s": round(compile_s, 2),
        "elapsed_s": round(best, 3),
    }
    result = {
        "metric": "train_agent_steps_per_sec",
        "value": round(sps),
        "unit": "agent-steps/s",
        # vs the reference PufferLib IPPO training SPS upper bound (300K)
        "vs_baseline": round(sps / 300_000, 4),
    }
    return meta, result


class SimBench(NamedTuple):
    """What the sim bench steps: the scene of ``paths``, its Params and
    ObsSpec, the action table, the (zero) reward weights, the reset state
    that finished worlds return to, and ``bench_step``'s sensor options."""

    paths: list
    scene: object
    params: object
    spec: ObsSpec
    table: torch.Tensor
    weights: torch.Tensor
    fresh: object
    sensors: dict


def sim_config(args) -> EnvConfig:
    """The sim bench's EnvConfig from its flags."""
    return EnvConfig(
        num_worlds=args.worlds,
        dynamics_model="classic",
        collision_behavior="ignore",
        road_obs_algorithm="k_nearest_roadpoints"
        if args.road_obs == "knn" else "linear",
        road_gather=args.road_gather,
        collision_top_k=args.collision_top_k,
        approx_top_k=not args.exact,
        use_collision_grid=args.grid,
        use_tile_collision=TILES[args.tiles],
    )


def sim_setup(args, device: torch.device) -> SimBench:
    """Compile ``args.worlds`` worlds (the scenes of ``--scenes-dir`` tiled
    in sorted order) on ``device`` and build what ``bench_step`` needs."""
    cfg = sim_config(args)
    params = cfg.sim_params()
    scenes_dir = scenes_dir_or_fallback(args.scenes_dir)
    base = sorted(os.path.join(scenes_dir, f) for f in os.listdir(scenes_dir)
                  if f.endswith(".json"))
    if not base:
        print(json.dumps({"error": f"no scenes in {scenes_dir}"}))
        sys.exit(1)
    paths = [base[i % len(base)] for i in range(args.worlds)]
    scene = build_scene(paths, params, max_roads=args.max_roads,
                        max_agents=agent_bucket(args.agent_bucket),
                        device=device)
    return SimBench(
        paths=paths, scene=scene, params=params, spec=ObsSpec(),
        table=action_table(cfg, device),
        weights=torch.zeros((args.worlds, scene.agents.valid.shape[1], 3),
                            dtype=torch.float32, device=device),
        fresh=stepmod.reset(scene, None, params),
        sensors=dict(obs=not args.no_obs, lidar=args.lidar, bev=args.bev,
                     camera=args.camera_size if args.camera else None),
    )


def bench_sim(args, device: torch.device) -> tuple[dict, dict]:
    """Agent-steps/s of ``bench_step`` over ``--steps`` steps: best of
    ``--repeats`` after a 2-step warm-up, the action generator seeded 0 for
    the warm-up and 1 + rep for each repetition.  Returns (meta, result)."""
    steps = args.steps
    t0 = time.time()
    sb = sim_setup(args, device)
    compile_scene_s = time.time() - t0
    scene = sb.scene
    num_agents = int(scene.num_agents.sum())

    def run(n_steps: int, seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        state = sb.fresh
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n_steps):
            idx = torch.randint(0, sb.table.shape[0],
                                scene.agents.valid.shape, generator=gen,
                                device=device)
            state, acc = bench_step(scene, sb.fresh, sb.table, sb.weights,
                                    state, idx, acc, sb.params, sb.spec,
                                    **sb.sensors)
        _sync(device)
        return state, acc

    t0 = time.time()
    run(2, 0)  # warm-up: the allocator, cuBLAS handles, the kernels' build
    warmup_s = time.time() - t0

    best = None
    for rep in range(args.repeats):
        t0 = time.time()
        run(steps, 1 + rep)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    elapsed = best

    agent_steps_per_sec = steps * num_agents / elapsed
    result = {
        "metric": "agent_steps_per_sec",
        "value": round(agent_steps_per_sec),
        "unit": "agent-steps/s",
        "vs_baseline": round(agent_steps_per_sec / 1_000_000, 4),
    }
    meta = {
        "worlds": args.worlds,
        "steps": steps,
        "total_agents": num_agents,
        "scenes_dir": os.path.dirname(sb.paths[0]),
        "world_steps_per_sec": round(steps * args.worlds / elapsed),
        **_device_meta(device),
        "max_roads_bucket": scene.max_roads,
        "scene_compile_s": round(compile_scene_s, 2),
        "warmup_s": round(warmup_s, 2),
        "elapsed_s": round(elapsed, 3),
        "obs": not args.no_obs,
        "lidar": args.lidar,
        "bev": args.bev,
        "camera": (args.camera_size if args.camera else False),
    }
    return meta, result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worlds", type=int, default=None)
    p.add_argument("--steps", type=int, default=91)
    p.add_argument("--scenes-dir", default=DEFAULT_SCENES,
                   help="directory of scene .json files (default: the "
                        "reference's data/processed/examples under the "
                        "repository, else tests/data; the directory used "
                        "is in the details line)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny CPU run: 2 worlds, 10 steps (2 iterations "
                        "with --train), on the CPU unless --device names "
                        "another device")
    p.add_argument("--no-obs", action="store_true", help="dynamics only")
    p.add_argument("--exact", action="store_true",
                   help="exact all-pairs collision + exact top-k (the port's "
                        "top-k is exact either way)")
    p.add_argument("--device", "--platform", dest="device", default=None,
                   help="torch device or JAX platform name; CUDA "
                        "unless another is named (cpu for the CPU); the run "
                        "fails without CUDA otherwise")
    p.add_argument("--repeats", type=int, default=3,
                   help="timing repetitions; best is reported")
    p.add_argument("--grid", action="store_true",
                   help="use the spatial-hash collision path")
    p.add_argument("--train-approx-top-k", action="store_true",
                   help="train mode: approximate top-k road selection in "
                        "the JAX package; exact here")
    p.add_argument("--road-gather", choices=["take", "dot"], default="take",
                   help="K-winner road-row fetch (one exact gather here)")
    p.add_argument("--road-obs", choices=["knn", "linear"], default="knn",
                   help="road-observation algorithm for the benched obs "
                        "path: KNN top-K (the headline config) or the "
                        "reference's default first-K-within-radius linear "
                        "scan")
    p.add_argument("--collision-top-k", type=int, default=None,
                   help="prune agent-road SAT to K distance-ranked candidates"
                        " (for large --max-roads buckets)")
    p.add_argument("--agent-bucket", default="auto",
                   help="'auto' (default) buckets the sim's agent axis to "
                        "the batch max instead of the fixed 128 rows, with "
                        "the same results on real rows; pass 128 for the "
                        "reference's fixed layout")
    p.add_argument("--max-roads", type=int, default=None,
                   help="force the road bucket (e.g. 10240 to stress the "
                        "full kMaxRoadEntityCount regime)")
    p.add_argument("--tiles", choices=["auto", "on", "off"], default="auto",
                   help="tile-skip agent-road narrow phase, kernel K1 "
                        "(auto = on for road buckets >= 2048)")
    p.add_argument("--lidar", action="store_true",
                   help="also collect the 3-plane x 50-ray lidar each step "
                        "(reference: src/sim.cpp:394-460)")
    p.add_argument("--bev", action="store_true",
                   help="also rasterize the per-agent BEV type grid each "
                        "step (reference: src/rasterizer.hpp:27-78)")
    p.add_argument("--camera", action="store_true",
                   help="also render every agent's RGBD camera each step "
                        "(batch-renderer equivalent, core/render.py)")
    p.add_argument("--camera-size", type=int, default=64,
                   help="camera height=width in pixels (--camera)")
    p.add_argument("--train", action="store_true",
                   help="benchmark the full PPO train step (rollout + GAE + "
                        "minibatch epochs) instead of the raw simulator")
    p.add_argument("--rollout-len", type=int, default=32)
    p.add_argument("--train-iters", type=int, default=8,
                   help="train steps per timing repetition (--train)")
    p.add_argument("--epoch-preshuffle", action="store_true",
                   help="per-epoch time-axis shuffle (the same minibatches "
                        "here)")
    p.add_argument("--minibatch-rows", type=int, default=0,
                   help="flat mode: also slice minibatches to this many "
                        "rows of the flat agent axis (0 = time-only)")
    p.add_argument("--num-minibatches", type=int, default=16,
                   help="PPO minibatches per epoch (--train)")
    p.add_argument("--update-epochs", type=int, default=4,
                   help="PPO epochs over the rollout (--train); 1 isolates "
                        "the rollout share of the iteration")
    p.add_argument("--compact", type=int, default=0,
                   help="restrict the learner's obs/policy path to the "
                        "first N controlled slots per world (0 = dense "
                        "over all padded slots)")
    p.add_argument("--compact-mode", choices=["world", "flat"],
                   default="world",
                   help="'flat' uses ONE cross-world agent axis of "
                        "--compact rows holding exactly the batch's "
                        "controlled agents; 'world' pads every world to "
                        "--compact")
    p.add_argument("--compact-blocks", type=int, default=0,
                   help="flat mode: block-local compaction over this "
                        "many contiguous world groups (0 = global)")
    p.add_argument("--obs-store",
                   choices=["remat", "f32", "bf16", "split-f32",
                            "split-bf16"],
                   default="remat",
                   help="rollout obs handling (--train): recompute from the "
                        "stored states in the update, or store f32/bf16 obs")
    p.add_argument("--iters-per-dispatch", type=int, default=1,
                   help="K train iterations per train_fn call (--train; the "
                        "same samples and metrics as K calls)")
    p.add_argument("--init-steps", type=int, default=0,
                   help="expert log-playback warmup at every (auto-)reset "
                        "(--train; the reference trains with 11)")
    p.add_argument("--ent-coef", type=float, default=1e-3,
                   help="entropy coefficient passed to every iteration")
    p.add_argument("--policy-dtype", choices=["f32", "bf16"], default="f32",
                   help="policy compute dtype (--train); parameters and "
                        "logits stay f32")
    p.add_argument("--embed-remat", action="store_true",
                   help="recompute the partner/road embed+pool activations "
                        "in the update's backward pass (--train)")
    p.add_argument("--fused-embed", action="store_true",
                   help="partner/road embed+pool through kernels K3/K4 "
                        "(--train)")
    p.add_argument("--packed-io", action="store_true",
                   help="accepted alias (--train): no effect here")
    p.add_argument("--rollout-mode",
                   choices=["scan", "unroll", "loop", "dispatch"],
                   default="unroll",
                   help="accepted alias (--train): one eager mode here")
    args = p.parse_args(argv)
    if args.smoke and args.device is None:
        args.device = "cpu"
    if not args.train:
        args.worlds = args.worlds or (2 if args.smoke else 512)
        if args.smoke and args.steps == 91:
            args.steps = 10
    return args


def main(argv=None) -> dict:
    """Run the benchmark; prints the result line on stdout and the details
    on stderr, and returns the result with the details under "meta"."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    meta, result = (bench_train if args.train else bench_sim)(args, device)
    print(json.dumps(meta), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return dict(result, meta=meta)


if __name__ == "__main__":
    main()
