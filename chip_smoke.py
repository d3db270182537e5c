#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpudrive_lab_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (into gpudrive_lab_torch/_build/),
holds each kernel against its plain PyTorch version at the shapes of the main
path, drives the main paths (a 91-step late-fusion policy rollout over the 512
worlds of data/pool_v3 with 128 agent rows; 10 steps of the padded 2048-road
tiled path; PPO training over the same 512 worlds through build_trainer, with
a checkpoint round trip and one dense iteration), checks the outputs, and
prints:

  * the card's name and power limit (nvidia-smi);
  * per phase: kernel and plain times, the rollout's ms per step split into
    simulator and policy, agent-steps/s (steps x created agents / wall time),
    per train iteration the rollout, GAE and update ms and train samples/s
    (controlled-agent samples consumed / wall time), and the device-time
    breakdown of one profiled train iteration;
  * one JSON line with every kernel (name, route, source, the TPU kernel it
    replaces, launches on the main path, max_abs_err, ms, plain_ms, bound_ms,
    bound_by, library_ms);
  * last, {"ok": true, "device": {...}}.

Any failed check exits non-zero without the last line.  Without CUDA, or
without the rest of the repository beside it, it exits non-zero at once.
It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s and
# fp32 (non-tensor-core) operations/s.  The kernels here run on fp32 cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

SEED = 0
STEPS = 91
TILED_STEPS = 10
TRAIN_ITERS = 3  # timed PPO iterations, after one warm-up
DENSE_WORLDS = 64  # worlds of the dense (uncompacted) training iteration


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k4_check(ppo, env, traj, gen) -> dict:
    """K4 against its plain version at the update's minibatch shapes: the
    partner and road slices, taken in place, of the observation that the
    update recomputes for one minibatch (rollout_len / num_minibatches
    steps of the flat compacted rows), with the argmax K3 gives on them
    and a random pooled cotangent."""
    import torch

    from gpudrive_lab_torch.env.env_torch import flat_observation
    from gpudrive_lab_torch.networks import fused_embed as fe

    cfg = ppo.config
    cidx = ppo.ctrl_slots(env.scene)
    states = traj.env_state
    obs = torch.stack([
        flat_observation(
            env.scene,
            type(states)(**{f: getattr(states, f)[t]
                            for f in states.__dataclass_fields__}),
            env.params, env.spec, env.reward_weights, cidx)[0]
        for t in range(cfg.rollout_len // cfg.num_minibatches)
    ]).reshape(-1, 3368)
    policy = ppo.policy
    blocks = {
        "partner": (policy.partner_embed,
                    obs[:, 6:768].unflatten(-1, (127, 6))),
        "road": (policy.road_map_embed, obs[:, 768:].unflatten(-1, (200, 13))),
    }
    k4 = dict(name="K4 fused_embed_pool_bwd", route="cuda",
              source="gpudrive_lab_torch/csrc/fused_embed_bwd.cu",
              replaces="gpudrive_lab_tpu/networks/fused_embed.py:251",
              library_ms=None, ms=0.0, plain_ms=0.0, bound_ms=0.0,
              max_abs_err=0.0,
              parity="each gradient's max abs err <= 1e-4 x its max abs "
                     "value; two launches bitwise equal")
    worst_bound = {}
    with torch.no_grad():
        for bname, (emb, x) in blocks.items():
            lin1, ln, _, _, lin2 = emb
            w = (lin1.weight.t().contiguous(), lin1.bias, ln.weight, ln.bias,
                 lin2.weight.t().contiguous(), lin2.bias)
            _, arg = fe.fused_embed_pool_fwd(x, *w, "tanh")
            dpool = torch.randn(arg.shape, generator=gen, device=x.device)
            got = fe.fused_embed_pool_bwd(x, *w, arg, dpool, "tanh")
            again = fe.fused_embed_pool_bwd(x, *w, arg, dpool, "tanh")
            want = fe.reference_embed_pool_bwd(x, *w, arg, dpool, "tanh")
            err, rel = 0.0, 0.0
            for gname, a, b, c in zip(("dw1", "db1", "dg", "dbe", "dw2",
                                       "db2"), got, again, want):
                check(torch.equal(a, b), f"K4 {bname} {gname}: two launches "
                      f"differ")
                e = float((a - c).abs().max())
                err = max(err, e)
                rel = max(rel, e / max(float(c.abs().max()), 1e-30))
            del want
            check(rel <= 1e-4, f"K4 {bname}: max abs err {rel:.3g} of the "
                  f"gradient's max abs value")
            B, Ent, F = x.shape
            s = arg.sort(dim=1).values
            winners = B + int((s[:, 1:] != s[:, :-1]).sum())
            ms = time_ms(lambda: fe.fused_embed_pool_bwd(
                x, *w, arg, dpool, "tanh"), 20)
            plain = time_ms(lambda: fe.reference_embed_pool_bwd(
                x, *w, arg, dpool, "tanh"), 3, warmup=1)
            n_out = F * 64 + 64 * 64 + 4 * 64
            bms, by = bound(4 * (winners * F + 2 * B * 64 + 2 * n_out),
                            fe.bwd_flops(F, B, winners))
            k4["ms"] += ms
            k4["plain_ms"] += plain
            k4["bound_ms"] += bms
            k4["max_abs_err"] = max(k4["max_abs_err"], err)
            worst_bound[bname] = by
            print(f"[K4] {bname} [{B},{Ent},{F}]: {winners / B:.1f} winners "
                  f"per row, max abs err {err:.3g} ({rel:.3g} of the "
                  f"largest gradient); kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bms:.4f} ms ({by})")
    k4["bound_by"] = worst_bound["road"]
    n = obs.shape[0]
    k4["shape"] = (f"partner [{n},127,6] + road [{n},200,13] per "
                   "minibatch backward")
    return k4


def train_phase(env, scenes, gen) -> dict:
    """PPO on the slice's 512 worlds through build_trainer: one warm-up
    iteration, K4 against its plain version, TRAIN_ITERS timed iterations
    with the launch counts read around them, one iteration under
    torch.profiler, a checkpoint round trip, and one dense iteration on the
    first DENSE_WORLDS worlds.  Returns K4's kernel record."""
    import dataclasses
    import tempfile

    import torch
    from torch.profiler import record_function

    from gpudrive_lab_torch.networks import fused_embed as fe
    from gpudrive_lab_torch.networks.late_fusion import LateFusionPolicy
    from gpudrive_lab_torch.ppo.ppo import PPOConfig
    from gpudrive_lab_torch.ppo.train import (
        build_trainer,
        load_checkpoint,
        save_checkpoint,
    )
    from gpudrive_lab_torch.rollout import slice_env
    from gpudrive_lab_torch.utils.profiling import (
        device_breakdown,
        device_trace,
    )

    n_ctrl = int(env.scene.agents.controlled.sum())
    cfg = PPOConfig(rollout_len=32, update_epochs=4, num_minibatches=4,
                    fused_embed=True, compact_mode="flat",
                    compact=-(-n_ctrl // 64) * 64)
    per_iter = 2 * cfg.update_epochs * cfg.num_minibatches
    ppo, carry, fresh, _ = build_trainer(env, cfg, seed=SEED)
    rw = env.reward_weights
    print(f"[train] {env.num_worlds} worlds, {n_ctrl} controlled agents, "
          f"flat compaction to {cfg.compact} rows; T={cfg.rollout_len}, "
          f"{cfg.update_epochs} epochs x {cfg.num_minibatches} minibatches, "
          f"fused_embed, remat_obs={cfg.remat_obs}")
    # warm-up iteration; its trajectory feeds the kernel check
    carry, traj = ppo.rollout(env.scene, carry, fresh, rw)
    global_step = float(ppo.update(env.scene, carry, traj, rw)["samples"])
    k4 = k4_check(ppo, env, traj, gen)
    del traj

    before = [p.detach().clone() for p in ppo.policy.parameters()]
    torch.cuda.synchronize()
    fe.fused_embed_pool_bwd.launches = 0
    fe.fused_embed_pool_fwd.launches = 0
    rates = []
    for it in range(TRAIN_ITERS):
        n0 = fe.fused_embed_pool_bwd.launches
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.time()
        # the iteration never waits on the card: a synchronizing operation
        # inside it raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            ev[0].record()
            carry, traj = ppo.rollout(env.scene, carry, fresh, rw)
            ev[1].record()
            batch = ppo.prepare(env.scene, carry, traj, rw)
            ev[2].record()
            losses = ppo.learn(env.scene, batch, traj, rw)
            ev[3].record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.time() - t0
        samples = float(ppo.episode_metrics(traj)["samples"])
        check(samples == float(traj.mask.sum()) > 0,
              f"iteration {it}: samples {samples} != mask sum")
        loss = {k: v.mean().item() for k, v in losses.items()}
        check(all(torch.isfinite(v).all() for v in losses.values()),
              f"iteration {it}: a loss is not finite: {loss}")
        n4 = fe.fused_embed_pool_bwd.launches - n0
        check(n4 == per_iter, f"iteration {it}: K4 launched {n4} times, "
              f"expected {per_iter}")
        global_step += samples
        rates.append(samples / wall)
        print(f"[train] iteration {it}: rollout {ev[0].elapsed_time(ev[1]):.3f}"
              f" ms, gae {ev[1].elapsed_time(ev[2]):.3f} ms, update "
              f"{ev[2].elapsed_time(ev[3]):.3f} ms (CUDA events); wall "
              f"{wall * 1e3:.3f} ms, {samples:.0f} samples, train samples/s "
              f"{samples / wall:.1f}; K4 launches {n4}; "
              + ", ".join(f"{k} {v:.5f}" for k, v in loss.items()))
    k4["launches"] = fe.fused_embed_pool_bwd.launches
    print(f"[train] {TRAIN_ITERS} iterations: mean train samples/s "
          f"{sum(rates) / len(rates):.1f}; launches K4 {k4['launches']}, "
          f"K3 {fe.fused_embed_pool_fwd.launches}")

    # one more iteration under torch.profiler: where the device time goes
    phases = ("rollout", "gae", "update")
    with device_trace() as prof:
        t0 = time.time()
        with record_function("rollout"):
            carry, traj = ppo.rollout(env.scene, carry, fresh, rw)
        with record_function("gae"):
            batch = ppo.prepare(env.scene, carry, traj, rw)
        with record_function("update"):
            ppo.learn(env.scene, batch, traj, rw)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    global_step += float(traj.mask.sum())
    busy, by_name, by_phase = device_breakdown(prof, phases)
    busy /= 1e3
    print(f"[train profile] wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(busy share {busy / wall:.3f}), "
          f"{sum(c for _, c in by_name.values())} device activities; device "
          + ", ".join(f"{p} {us / 1e3:.3f} ms" for p, us in by_phase.items()))
    for name, (us, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:12]:
        print(f"[train profile] {us / 1e3:10.3f} ms {cnt:6d}x  {name}")
    after = list(ppo.policy.parameters())
    check(all(bool(torch.isfinite(p).all()) for p in after),
          "a parameter is not finite after training")
    check(any(not torch.equal(a, b) for a, b in zip(after, before)),
          "training did not change the parameters")

    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, ppo.policy, ppo.optimizer, TRAIN_ITERS + 1,
                        int(global_step))
        other = LateFusionPolicy(ppo.policy.config, device=env.device)
        opt = torch.optim.Adam(other.parameters(), lr=cfg.learning_rate,
                               eps=1e-5)
        step = load_checkpoint(tmp, other, opt)
    check(step == int(global_step), f"checkpoint global step {step}")
    for k, v in ppo.policy.state_dict().items():
        check(torch.equal(v, other.state_dict()[k]), f"checkpoint: {k}")
    mine, theirs = ppo.optimizer.state_dict(), opt.state_dict()
    for i, st in mine["state"].items():
        for k, v in st.items():
            check(torch.equal(v, theirs["state"][i][k]),
                  f"checkpoint: Adam {k} of parameter {i}")
    print(f"[train] checkpoint round trip: {len(mine['state'])} parameters "
          f"and their Adam state equal, global step {step}")

    denv = slice_env(scenes[:DENSE_WORLDS], device=env.device)
    dppo, dcarry, dfresh, dtrain = build_trainer(
        denv, dataclasses.replace(cfg, compact=0), seed=SEED)
    n0 = fe.fused_embed_pool_bwd.launches
    t0 = time.time()
    dcarry, dm = dtrain(denv.scene, dcarry, dfresh, denv.reward_weights)
    torch.cuda.synchronize()
    wall = time.time() - t0
    dm = {k: float(v) for k, v in dm.items()}
    check(all(v == v and abs(v) != float("inf") for v in dm.values()),
          f"dense iteration: a metric is not finite: {dm}")
    check(dm["samples"] > 0, "dense iteration: no samples")
    n4 = fe.fused_embed_pool_bwd.launches - n0
    check(n4 == per_iter, f"dense iteration: K4 launched {n4} times")
    print(f"[train] dense iteration, {DENSE_WORLDS} worlds x "
          f"{denv.max_agent_count} rows: {wall * 1e3:.3f} ms wall (first "
          f"iteration of this trainer), {dm['samples']:.0f} samples, "
          f"pg_loss {dm['pg_loss']:.5f}, v_loss {dm['v_loss']:.5f}; "
          f"K4 launches {n4}")
    return k4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import gpudrive_lab_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the gpudrive_lab_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    from gpudrive_lab_torch.rollout import (
        pool_scene_paths,
        rollout,
        slice_env,
        slice_policy,
    )

    scenes = pool_scene_paths(root)
    if len(scenes) != 512:
        print(f"chip_smoke: expected 512 scenes in data/pool_v3, found "
              f"{len(scenes)}", file=sys.stderr)
        return 2

    from gpudrive_lab_torch import cuda_build
    from gpudrive_lab_torch.core import collision, kernels
    from gpudrive_lab_torch.core import step as stepmod
    from gpudrive_lab_torch.networks import fused_embed as fe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: device and build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    logs = cuda_build.build()
    print(f"[build] {time.time() - t0:.1f} s for {sorted(logs) or 'cached'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- phase 2: the slice's env and the kernels against their plain
    # versions at the main path's shapes -----------------------------------
    t0 = time.time()
    env = slice_env(scenes, device=dev)
    torch.cuda.synchronize()
    W, A, R = env.num_worlds, env.max_agent_count, env.scene.max_roads
    n_agents = int(env.scene.num_agents.sum())
    print(f"[env] W={W} A={A} R={R} created agents {n_agents} "
          f"built in {time.time() - t0:.1f} s")
    check((W, A, R) == (512, 128, 256), f"slice shape {(W, A, R)}")
    check(env.scene.rtiles is None, "the R=256 slice must take the dense path")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def road_inputs(e):
        s, scene = e.state, e.scene
        cur = stepmod.current_step_index(s)
        active = ~collision._skip_mask(scene, s, cur)
        feat = collision.agent_features(
            scene, s, active, collision.agent_half_extents(scene))
        return feat, collision.road_features_t(scene)

    results = {}
    k2 = dict(name="K2 agent_road_hits_dense", route="cuda",
              source="gpudrive_lab_torch/csrc/agent_road.cu",
              replaces="gpudrive_lab_tpu/core/pallas_kernels.py:185",
              library_ms=None, parity="bitwise equal to plain")
    for when in ("reset", "after 5 random steps"):
        if when != "reset":
            for _ in range(5):
                env.step_dynamics(torch.randint(
                    0, env.action_space_n, (W, A), generator=gen, device=dev))
        feat, roads_t = road_inputs(env)
        got = kernels.agent_road_hits_dense(feat, roads_t)
        want = kernels.agent_road_hits_dense_plain(feat, roads_t)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K2 differs from its plain version "
              f"at {when}: {int((got != want).sum())} agents")
        print(f"[K2] {when}: bitwise equal, {int(got.sum())} agents hit")
    k2["ms"] = time_ms(lambda: kernels.agent_road_hits_dense(feat, roads_t), 50)
    k2["plain_ms"] = time_ms(
        lambda: kernels.agent_road_hits_dense_plain(feat, roads_t), 5)
    k2["bound_ms"], k2["bound_by"] = bound(
        4 * (W * A * 8 + W * 8 * R + W * A),
        W * A * R * kernels.SAT_FLOPS)
    k2["max_abs_err"] = 0.0
    k2["shape"] = f"agents [{W},{A},8], roads [{W},8,{R}]"
    results["K2"] = k2
    print(f"[K2] {k2['shape']}: kernel {k2['ms']:.4f} ms, plain "
          f"{k2['plain_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms "
          f"({k2['bound_by']})")

    policy = slice_policy(device=dev, seed=SEED)
    obs = env.get_obs()
    check(tuple(obs.shape) == (W, A, 3368), f"obs shape {tuple(obs.shape)}")
    check(bool(torch.isfinite(obs).all()), "obs not finite")
    flat = obs.reshape(W * A, -1)
    E0, P = 6, 127 * 6
    blocks = {
        "partner": (policy.partner_embed,
                    flat[:, E0:E0 + P].unflatten(-1, (127, 6))),
        "road": (policy.road_map_embed,
                 flat[:, E0 + P:].unflatten(-1, (200, 13))),
    }
    k3 = dict(name="K3 fused_embed_pool_fwd", route="cuda",
              source="gpudrive_lab_torch/csrc/fused_embed.cu",
              replaces="gpudrive_lab_tpu/networks/fused_embed.py:207",
              library_ms=None, ms=0.0, plain_ms=0.0, bound_ms=0.0,
              max_abs_err=0.0,
              parity="pooled max abs err <= 1e-4; argmax equal where the "
                     "top two differ by > 1e-5")
    worst_bound = {}
    with torch.no_grad():
        for bname, (emb, x) in blocks.items():
            lin1, ln, _, _, lin2 = emb
            w = (lin1.weight.t().contiguous(), lin1.bias, ln.weight, ln.bias,
                 lin2.weight.t().contiguous(), lin2.bias)
            pooled, arg = fe.fused_embed_pool_fwd(x, *w, "tanh")
            y = fe._embed(x, *w, "tanh")  # [B, E, 64] plain activations
            want, _ = y.max(dim=1)
            top2 = y.topk(2, dim=1)
            clear = (top2.values[:, 0] - top2.values[:, 1]) > 1e-5
            err = float((pooled - want).abs().max())
            arg_ok = torch.equal(arg.long()[clear], top2.indices[:, 0][clear])
            del y, top2
            check(err <= 1e-4, f"K3 {bname}: pooled max abs err {err}")
            check(arg_ok, f"K3 {bname}: argmax differs where the top two "
                  f"differ by more than 1e-5")
            B, Ent, F = x.shape
            ms = time_ms(lambda: fe.fused_embed_pool_fwd(x, *w, "tanh"), 20)
            plain = time_ms(
                lambda: fe.reference_embed_pool_argmax(x, *w, "tanh"), 3)
            bms, by = bound(4 * (B * Ent * F + F * 64 + 64 * 64 + 4 * 64)
                            + 8 * B * 64, B * Ent * fe.embed_flops(F))
            k3["ms"] += ms
            k3["plain_ms"] += plain
            k3["bound_ms"] += bms
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
            worst_bound[bname] = by
            print(f"[K3] {bname} [{B},{Ent},{F}]: max abs err {err:.3g}, "
                  f"argmax equal on {int(clear.sum())}/{clear.numel()} "
                  f"clear rows; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {bms:.4f} ms ({by})")
    k3["bound_by"] = worst_bound["road"]
    k3["shape"] = (f"partner [{W * A},127,6] + road [{W * A},200,13] "
                   "per policy forward")
    results["K3"] = k3

    # ---- phase 3: the main path, a 91-step policy rollout ----------------
    env.reset()
    rollout(env, policy, 2, gen)  # warm-up (allocator, cuBLAS handles)
    env.reset()
    torch.cuda.synchronize()
    kernels.agent_road_hits_dense.launches = 0
    kernels.agent_road_hits_tiled.launches = 0
    fe.fused_embed_pool_fwd.launches = 0
    t0 = time.time()
    res = rollout(env, policy, STEPS, gen)
    torch.cuda.synchronize()
    wall = time.time() - t0
    k2["launches"] = kernels.agent_road_hits_dense.launches
    k3["launches"] = fe.fused_embed_pool_fwd.launches
    tiled_in_main = kernels.agent_road_hits_tiled.launches
    print(f"[rollout] {STEPS} steps x {W} worlds: {wall * 1e3 / STEPS:.3f} "
          f"ms/step wall; sim {res.sim_ms / STEPS:.3f} ms/step, policy "
          f"{res.policy_ms / STEPS:.3f} ms/step (device events)")
    print(f"[rollout] agent-steps/s {STEPS * n_agents / wall:.1f} "
          f"({n_agents} created agents); launches K2 {k2['launches']} "
          f"K3 {k3['launches']} K1 {tiled_in_main}")
    check(k2["launches"] > 0 and k3["launches"] > 0,
          "the rollout did not launch K2 and K3")
    check(tuple(res.actions.shape) == (STEPS, W, A), "actions shape")
    check(bool(((res.actions >= 0) & (res.actions < 91)).all()),
          "actions out of range")
    check(bool(torch.isfinite(res.rewards).all()), "rewards not finite")
    check(bool(res.dones[-1][env.scene.agents.valid].all()),
          "not every agent was done at the horizon")
    check(int(env.world_time_steps.max()) == 0,
          "finished worlds were not reset")

    # ---- phase 4: the tiled path, padded to 2048 roads -------------------
    tenv = slice_env(scenes, device=dev, max_roads=2048,
                     use_tile_collision=True)
    rt = tenv.scene.rtiles
    check(rt is not None and tenv.scene.max_roads == 2048, "no road tiles")
    T, RT = rt.feat.shape[1], rt.feat.shape[3]
    for _ in range(5):
        tenv.step_dynamics(torch.randint(
            0, tenv.action_space_n, (W, A), generator=gen, device=dev))
    feat, roads_t = road_inputs(tenv)
    feat_s, mask, inv_perm = collision.tile_mask_and_order(
        tenv.scene, tenv.state, feat)
    got = kernels.agent_road_hits_tiled(feat_s, rt.feat, mask)
    want = kernels.agent_road_hits_tiled_plain(feat_s, rt.feat, mask)
    dense = kernels.agent_road_hits_dense(feat, roads_t)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K1 differs from its plain version")
    check(torch.equal(torch.gather(got, 1, inv_perm), dense),
          "K1 differs from K2 on the same state")
    live = int(mask.sum())
    print(f"[K1] tiles [{W},{T},8,{RT}], {live}/{mask.numel()} live "
          f"block-tiles: bitwise equal to plain and to K2, "
          f"{int(got.sum())} agents hit")
    k1 = dict(name="K1 agent_road_hits_tiled", route="cuda",
              source="gpudrive_lab_torch/csrc/agent_road.cu",
              replaces="gpudrive_lab_tpu/core/pallas_kernels.py:157",
              library_ms=None, max_abs_err=0.0,
              parity="bitwise equal to plain and to K2",
              shape=f"agents [{W},{A},8], tiles [{W},{T},8,{RT}], "
                    f"{live} live block-tiles")
    k1["ms"] = time_ms(
        lambda: kernels.agent_road_hits_tiled(feat_s, rt.feat, mask), 50)
    k1["plain_ms"] = time_ms(
        lambda: kernels.agent_road_hits_tiled_plain(feat_s, rt.feat, mask), 3)
    live_tiles = int(mask.amax(dim=1).sum())  # (world, tile) pairs read
    k1["bound_ms"], k1["bound_by"] = bound(
        4 * (W * A * 8 + mask.numel() + live_tiles * 8 * RT + W * A),
        live * 16 * RT * kernels.SAT_FLOPS)
    k2_2048 = time_ms(lambda: kernels.agent_road_hits_dense(feat, roads_t), 20)
    print(f"[K1] kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, "
          f"bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}); K2 on the "
          f"same 2048 roads {k2_2048:.4f} ms")
    results["K1"] = k1

    tenv.reset()
    torch.cuda.synchronize()
    kernels.agent_road_hits_tiled.launches = 0
    kernels.agent_road_hits_dense.launches = 0
    fe.fused_embed_pool_fwd.launches = 0
    t0 = time.time()
    tres = rollout(tenv, policy, TILED_STEPS, gen)
    torch.cuda.synchronize()
    twall = time.time() - t0
    k1["launches"] = kernels.agent_road_hits_tiled.launches
    print(f"[tiled rollout] {TILED_STEPS} steps: {twall * 1e3 / TILED_STEPS:.3f}"
          f" ms/step wall; sim {tres.sim_ms / TILED_STEPS:.3f}, policy "
          f"{tres.policy_ms / TILED_STEPS:.3f} ms/step; agent-steps/s "
          f"{TILED_STEPS * n_agents / twall:.1f}; launches K1 {k1['launches']}"
          f" K2 {kernels.agent_road_hits_dense.launches} K3 "
          f"{fe.fused_embed_pool_fwd.launches}")
    check(k1["launches"] > 0, "the tiled rollout did not launch K1")
    check(bool(torch.isfinite(tres.rewards).all()), "tiled rewards not finite")
    del tenv, tres

    # ---- phase 5: the training path, PPO over the 512 worlds -------------
    results["K4"] = train_phase(env, scenes, gen)

    # ---- phase 6: the card's path against the CPU path, small input ------
    small = scenes[:4]
    genv = slice_env(small, device=dev)
    cenv = slice_env(small, device="cpu")
    cpol = slice_policy(device="cpu")
    cpol.load_state_dict({k: v.cpu() for k, v in policy.state_dict().items()})
    ctrl = cenv.scene.agents.controlled
    worst = 0.0
    for t in range(10):
        gobs, cobs = genv.get_obs().cpu(), cenv.get_obs()
        # road rows may come in another order inside K where distances
        # tie; the ego and partner blocks are ordered
        worst = max(worst, float((gobs[..., :768] - cobs[..., :768]).abs().max()))
        g = rollout(genv, policy, 1, None, deterministic=True)
        c = rollout(cenv, cpol, 1, None, deterministic=True)
        check(torch.equal(g.actions[0].cpu()[ctrl], c.actions[0][ctrl]),
              f"small input: actions differ from the CPU path at step {t}")
        check(torch.equal(g.dones[0].cpu(), c.dones[0]),
              f"small input: dones differ from the CPU path at step {t}")
    check(worst <= 1e-4, f"small input: obs differ from the CPU path by {worst}")
    print(f"[small] 10 argmax steps on 4 worlds: card and CPU agree "
          f"(obs max abs diff {worst:.3g})")

    line = {"kernels": []}
    for key in ("K1", "K2", "K3", "K4"):
        r = results[key]
        line["kernels"].append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "parity",
            "shape")})
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
