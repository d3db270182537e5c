#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpudrive_lab_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (into gpudrive_lab_torch/_build/)
and prints each kernel's registers per thread, holds each kernel against its
plain PyTorch version at the shapes of the main path (K3 and K4 also against
a second launch, bit for bit), times K3 at the row counts the main path gives
it (65,536, 35,328 and 4,416), drives the main paths (a 91-step late-fusion
policy rollout over the 512 worlds of data/pool_v3 with 128 agent rows; 10
steps of the padded 2048-road tiled path; PPO training over the same 512
worlds through build_trainer, with a checkpoint round trip and one dense
iteration, and K6 over the 8 stacked time steps of the update's observation
recompute, one minibatch's 8 x 4,416 rows with LINEAR roads, bit for bit
against its plain version;
then PPO with the bf16 policy dtype, K3 and K4 in their bf16 compute
mode, on the same worlds: phase 5b), holds K1 and K2 on a seeded
synthetic large map (10,240 roads, scene/large_map.py; phase 4) and K6,
the env step's observation with KNEAREST roads, at the sim cells' shapes
(the 512 pool worlds and 256 large-map worlds, agent bucket 32) against
its plain version, runs the
sensors (lidar, BEV and camera on
every step of a policy rollout over the same 512 worlds, then each sensor
against the same port function on the CPU for the first 4 worlds: the
sensor phase), then the dataset phase (the PPO CLI on 512-world batches
drawn from data/pool_v3 with a swap before every iteration, swap timings
cold, warm and behind PrefetchingSceneLoader, VecGPUDriveEnv with a
resample, evaluate_policy and multi_policy_rollout with a PolicyActor from
the CLI's checkpoint, and IPPO over SB3MultiAgentEnv with a resample; K2,
K3 and K4 held against their plain versions after a swap), then the il
phase (the behavior-cloning CLI on 16 worlds x 2 batches of expert data,
closed-loop evaluation, closed_loop_rollout with importance and tokens,
the linear probes, the BC net on the card against the CPU) and the rnn
phase (the recurrent PPO CLI on 512 worlds, 3 or more float32 iterations
and one bf16, an LSTM step on the card against the CPU, one profiled
iteration) and the vbd phase (VBD diffusion sim agents on 64 worlds: the
official model at full width, 50 diffusion steps, through
set_vbd_trajectories; 91 env steps with the VBD obs and reward; the
TPU-first denoiser, the three guided samplers and denoise_loss training;
the full-width encoder and a denoise step against the CPU) and the
periphery phase (the versions of matplotlib, imageio, rich, yaml and
safetensors; with matplotlib, worlds 0-3 of the 512 rendered on the card in
2-D and 3-D and held against the host render of the same state; a seeded
reference NeuralNet state dict through load_pretrained onto the card, 91
argmax steps of it with fused_embed over the 512 worlds, its logits
against the CPU, a utils/checkpoint round trip; the PPO CLI at 512 worlds
with --fused-embed --dashboard and, with matplotlib, --video-interval 1)
and the ingest phase (the native scene compiler, csrc/scene_compiler.cpp,
built with g++ in phase 1 and compiling every phase's scenes: the 512
pool_v3 scenes compiled cold natively and with the Python path, no
fallback, every array within 2e-4; cold and prefetched 512-world swaps both
ways; seeded synthetic WOMD scenarios through a TFRecord shard and the
vendored proto where protobuf is present, the converter, post_processing,
detect_behavior, the native compiler and 91 expert steps on the card
against the CPU; the examples of examples/torch/ on the card, 05 and 08
only with matplotlib), then the collision phase (the grid and top-K
agent-road paths: the 512 pool worlds for 91 steps of seeded random
actions under dense K2, the grid and top-K with K = 32, flags equal at
every step; one pass on a 64-world large map under K1, K2, the grid and
top-K at K = 256 and 32, the card against the CPU on 4 worlds; ms per
collision pass and peak memory of each path at both sizes) and the multi
phase (parallel/dryrun.py: the JAX dryrun's three learner configurations
over 2 gloo ranks sharing the card, 128 worlds each, against one process
at the dryrun's bars, the ranks' parameters bitwise equal; what NCCL says
to two ranks on one card; the scaling harness through its main(argv) at
the JAX script's workload, 1 and 2 ranks on the card over gloo, its
bench_scaling.py lines checked, and world-steps/s of the pool workload at
1 and 2 ranks x 128 worlds; both labelled as a shared card: not scaling
evidence) and the entry phase (the port's entry
points run through their main(argv) in process: the sim bench on the 512
pool worlds for 91 steps, tiled at 2048 roads and with each sensor on 64
worlds; the train bench at phase 5's shape with --fused-embed in float32
and bf16; the trainer CLI's checkpoint and a seeded reference checkpoint
through eval_checkpoint; one bench_sb3 window; 16 pool scenes generated
equal to data/pool_v3 and validated on the card; the entry CLI at its
defaults, 2 ranks sharing the card over gloo; entry() and bench_step on
the card against the CPU; the bench CLI once in a subprocess), checks
the outputs, and prints:

  * the card's name and power limit (nvidia-smi);
  * per phase: kernel and plain times (K1's and K2's wrapper time per call
    read where their inputs are made, before any torch.profiler session;
    their device time per launch from torch.profiler read last, in phase
    7), the live pairs and their SAT operations that bound K1 and K2, the
    rollout's ms per step split into simulator and policy, agent-steps/s
    (steps x created agents / wall time),
    per train iteration the rollout, GAE and update ms and train samples/s
    (controlled-agent samples consumed / wall time), the device-time
    breakdown of one profiled train iteration, and per sensor its ms per
    call (CUDA events), its peak memory, its output's bytes / 3.35 TB/s as
    a floor and the samples, cells or pixels where card and CPU differ;
  * one JSON line with every kernel (K1, K2, K3, K4, K3 and K4 in
    their bf16 compute mode, K6 for the env step and K6 over the update's
    stacked time steps ("K6, 35,328 rows"), their device times read in phase
    7: name, route, source, the TPU kernel it replaces, launches on the
    main path, max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms;
    for K1, K2 and K6 also wrapper_ms; for K1, K2 and K6 their
    large-map reading; for K6 its two kernels' device ms (select_ms,
    step_ms); for K3 also its fp32-core bound and its time at
    each row count; for K2 and K3 also their launches in the sensor
    rollout; for every kernel its launches in the dataset, il, rnn, vbd,
    periphery, ingest, collision, multi and entry phases, the multi
    phase's counted inside its ranks);
  * last, {"ok": true, "device": {...}}.

Any failed check exits non-zero without the last line.  Without CUDA, or
without the rest of the repository beside it, it exits non-zero at once.
It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s,
# fp32 operations/s outside the tensor cores (an FMA counted as two), and
# TF32 and bf16 tensor-core operations/s.  K3's float32 products run on
# TF32, three passes each in 3xTF32; the bf16 mode's products are bf16 x
# bf16, which the card's bf16 tensor-core rate bounds whatever unit a
# kernel runs them on.  K1 and K2 build with --fmad=false: each multiply
# and add is its own instruction, so their rate is half the FMA rate.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_FP32_NOFMA = 33.5e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12

SEED = 0
STEPS = 91
TILED_STEPS = 10
TRAIN_ITERS = 3  # timed PPO iterations, after one warm-up
KERNEL_REPS = 100  # launches per device-time reading of K1 and K2
K6_ROWS = "K6, 35,328 rows"  # K6 over a train minibatch's 8 time steps
PLAIN_WORLDS = 16  # large map: worlds held against the plain versions
DENSE_WORLDS = 64  # worlds of the dense (uncompacted) training iteration
SENSOR_STEPS = 3  # timed rollout steps with every sensor, after one warm-up
SENSOR_CPU_WORLDS = 4  # worlds whose sensors are held against the CPU
# K3/K4 in the bf16 compute mode against their plain bf16 versions: both
# sum exact bf16 products in float32, in another order, so a float32 value
# they round to bf16 (t before layer 2) can land on either side of a
# rounding boundary.  Every pooled entry within BF16_FLIPS such flips
# (fused_embed.bf16_flip_bound each), at most 1% of entries beyond 1e-5,
# the kernel's winner within that bar of the plain maximum, the argmax equal
# where the top two differ by more than twice it; K4's db1, dg, dbe, db2
# within 1e-4 of their largest magnitude, dw1 and dw2 (products of
# bf16-rounded dpre and t) within fused_embed.BF16_PRODUCT_BAR of their
# terms' root-sum-square, a bar that controls skipping a rounding must
# exceed (k4_bf16_check).
BF16_FLIPS = 4


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def bound(nbytes: float, flops: float, tf32_flops: float = 0.0,
          fp32_peak: float = PEAK_FP32, bf16_flops: float = 0.0):
    """Least time in ms for ``nbytes`` of traffic, ``flops`` fp32 operations
    at ``fp32_peak``, ``tf32_flops`` TF32 and ``bf16_flops`` bf16
    tensor-core operations, and what sets it."""
    t_b = nbytes / PEAK_BYTES
    t_f = max(flops / fp32_peak, tf32_flops / PEAK_TF32,
              bf16_flops / PEAK_BF16)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time per call of ``fn`` over ``reps`` back-to-back calls, from
    CUDA events: for a kernel of a few microseconds this is the host's
    dispatch rate (checks, allocation, launch), not the kernel's time."""
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


def road_inputs(env):
    """K2's inputs at the env's state: the active agents' boxes and the
    road segments."""
    from gpudrive_lab_torch.core import collision
    from gpudrive_lab_torch.core import step as stepmod

    s, scene = env.state, env.scene
    active = ~collision._skip_mask(scene, s, stepmod.current_step_index(s))
    feat = collision.agent_features(
        scene, s, active, collision.agent_half_extents(scene))
    return feat, collision.road_features_t(scene)


def k2_bound(kernels, agents, roads_t):
    """K2's bound (ms, what sets it, operations): each input read once and
    the output written once, or the live pairs' SAT operations (each
    stopped where the first two axis tests separate its boxes) at the
    no-FMA rate."""
    W, A, _ = agents.shape
    R = roads_t.shape[2]
    ops = kernels.live_pair_ops(agents, roads_t)
    return (*bound(4 * (W * A * 8 + W * 8 * R + W * A), ops,
                   fp32_peak=PEAK_FP32_NOFMA), ops)


def k1_bound(kernels, agents_s, tiles, mask):
    """K1's bound (ms, what sets it, operations): the agents, the mask, the
    tiles live for some agent block and the output, or the SAT operations
    of the live pairs inside the live [agent-block, tile] pairs at the
    no-FMA rate."""
    W, A, _ = agents_s.shape
    RT = tiles.shape[3]
    live_tiles = int(mask.amax(dim=1).sum())  # (world, tile) pairs read
    ops = kernels.live_pair_ops_tiled(agents_s, tiles, mask)
    return (*bound(
        4 * (W * A * 8 + mask.numel() + live_tiles * 8 * RT + W * A), ops,
        fp32_peak=PEAK_FP32_NOFMA), ops)


def twice(fn, what: str):
    """fn's result, after checking that a second call gives the same
    bits."""
    import torch

    first, second = fn(), fn()
    check(torch.equal(first, second), f"{what}: two launches differ")
    return first


def k3_check(x, w, what: str) -> float:
    """K3 on ``x`` against its plain version (the max over the plain
    activations, as reference_embed_pool_argmax takes it): pooled max abs
    error <= 1e-4, the argmax equal where the top two differ by more than
    1e-5, two launches bitwise equal.  Returns the max abs error."""
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    pooled, arg = fe.fused_embed_pool_fwd(x, *w, "tanh")
    again, arg2 = fe.fused_embed_pool_fwd(x, *w, "tanh")
    check(torch.equal(pooled, again) and torch.equal(arg, arg2),
          f"{what}: two launches differ")
    y = fe._embed(x, *w, "tanh")  # [B, E, 64] plain activations
    want, _ = y.max(dim=1)
    top2 = y.topk(2, dim=1)
    clear = (top2.values[:, 0] - top2.values[:, 1]) > 1e-5
    err = float((pooled - want).abs().max())
    arg_ok = torch.equal(arg.long()[clear], top2.indices[:, 0][clear])
    del y, top2
    check(err <= 1e-4, f"{what}: pooled max abs err {err}")
    check(arg_ok, f"{what}: argmax differs where the top two differ by "
          f"more than 1e-5")
    print(f"{what} {list(x.shape)}: max abs err {err:.3g}, argmax equal on "
          f"{int(clear.sum())}/{clear.numel()} clear units, two launches "
          f"bitwise equal")
    return err


def k4_grad_check(x, w, arg, dpool, what: str) -> tuple[float, float]:
    """K4 on ``x`` against its plain version: each gradient's max abs
    error <= 1e-4 of its largest value, two launches bitwise equal.
    Returns (max abs error, that error over the gradient's largest)."""
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    got = fe.fused_embed_pool_bwd(x, *w, arg, dpool, "tanh")
    again = fe.fused_embed_pool_bwd(x, *w, arg, dpool, "tanh")
    want = fe.reference_embed_pool_bwd(x, *w, arg, dpool, "tanh")
    err, rel = 0.0, 0.0
    for gname, a, b, c in zip(("dw1", "db1", "dg", "dbe", "dw2", "db2"),
                              got, again, want):
        check(torch.equal(a, b), f"{what} {gname}: two launches differ")
        e = float((a - c).abs().max())
        err = max(err, e)
        rel = max(rel, e / max(float(c.abs().max()), 1e-30))
    check(rel <= 1e-4, f"{what}: max abs err {rel:.3g} of the gradient's "
          f"max abs value")
    return err, rel


def k3_bf16_check(x, w, what: str) -> float:
    """K3 in its bf16 compute mode on x (float32 or bf16, as stored)
    against its plain bf16 version at the bars of BF16_FLIPS, two launches
    bitwise equal.  Returns the pooled max abs error."""
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    bf = torch.bfloat16
    pooled, arg = fe.fused_embed_pool_fwd(x, *w, "tanh", bf)
    again, arg2 = fe.fused_embed_pool_fwd(x, *w, "tanh", bf)
    check(torch.equal(pooled, again) and torch.equal(arg, arg2),
          f"K3-bf16 {what}: two launches differ")
    y = fe._embed(x, *w, "tanh", bf)  # [B, E, 64] plain activations
    want = y.amax(dim=1)
    bar = BF16_FLIPS * fe.bf16_flip_bound("tanh", w[2], w[3], w[4])
    err = (pooled - want).abs()
    loose = float((err > 1e-5).float().mean())
    picked = torch.gather(y, 1, arg.long()[:, None]).squeeze(1)
    pick_err = float((want - picked).abs().max())
    top2 = y.topk(2, dim=1)
    clear = (top2.values[:, 0] - top2.values[:, 1]) > 2 * bar
    arg_ok = torch.equal(arg.long()[clear], top2.indices[:, 0][clear])
    n_clear = int(clear.sum())
    del y, top2, picked
    emax = float(err.max())
    check(emax <= bar, f"K3-bf16 {what}: pooled max abs err {emax} > {bar}")
    check(loose <= 0.01, f"K3-bf16 {what}: {loose:.4f} of the entries "
          f"beyond 1e-5")
    check(pick_err <= bar, f"K3-bf16 {what}: the kernel's winner is "
          f"{pick_err} below the plain maximum")
    check(arg_ok, f"K3-bf16 {what}: argmax differs where the top two "
          f"differ by more than {2 * bar:.3g}")
    print(f"[K3-bf16] {what} {list(x.shape)} {str(x.dtype)[6:]}: max abs "
          f"err {emax:.3g} (bar {bar:.3g}), {loose:.2e} of entries beyond "
          f"1e-5, argmax equal on {n_clear}/{clear.numel()} clear units, "
          f"two launches bitwise equal")
    return emax


def k3_bf16_time(x, w):
    """(ms, bound ms, bound by) of K3's bf16 mode on x: x read at its
    stored width, the bf16 products at the bf16 tensor-core rate, the rest
    of embed_flops on the fp32 cores."""
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    B, Ent, F = x.shape
    ms = time_ms(lambda: fe.fused_embed_pool_fwd(x, *w, "tanh",
                                                 torch.bfloat16), 20)
    nbytes = (x.element_size() * B * Ent * F
              + 4 * (F * 64 + 64 * 64 + 4 * 64) + 8 * B * 64)
    mma = B * Ent * fe.embed_mma_flops(F)
    bms, by = bound(nbytes, B * Ent * fe.embed_flops(F) - mma,
                    bf16_flops=mma)
    return ms, bms, by


def k4_bf16_check(x, w, arg, dpool, what: str) -> tuple[float, dict]:
    """K4 in its bf16 compute mode against its plain bf16 version, two
    launches bitwise equal: db1, dg, dbe, db2 within 1e-4 of their largest
    magnitude; dw1 and dw2 within fused_embed.BF16_PRODUCT_BAR of their
    terms' root-sum-square.  The controls on the same inputs, K4's float32
    mode and the plain version with t or dpre left unrounded, must exceed
    that bar on the gradient whose rounding they skip.  Returns (max abs
    error, the dw1/dw2 readings of the kernel and of each control)."""
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    bf = torch.bfloat16
    got = fe.fused_embed_pool_bwd(x, *w, arg, dpool, "tanh", bf)
    again = fe.fused_embed_pool_bwd(x, *w, arg, dpool, "tanh", bf)
    want = fe.reference_embed_pool_bwd(x, *w, arg, dpool, "tanh", bf)
    rss = fe.bwd_product_rss(x, *w, arg, dpool, "tanh", bf)
    bar = fe.BF16_PRODUCT_BAR
    names = ("dw1", "db1", "dg", "dbe", "dw2", "db2")
    err, reading = 0.0, {}
    for gname, a, b, c in zip(names, got, again, want):
        check(torch.equal(a, b), f"K4-bf16 {what} {gname}: two launches "
              f"differ")
        e = float((a - c).abs().max())
        err = max(err, e)
        if gname in ("dw1", "dw2"):
            reading[f"kernel {gname}"] = r = fe.bf16_product_error(
                a, c, rss[gname == "dw2"])
            check(r <= bar, f"K4-bf16 {what} {gname}: {r:.3g} of the terms'"
                  f" root-sum-square > {bar:.3g}")
        else:
            rel = e / max(float(c.abs().max()), 1e-30)
            check(rel <= 1e-4, f"K4-bf16 {what} {gname}: max abs err "
                  f"{rel:.3g} of the gradient's max abs value > 1e-4")
    controls = {
        "float32 mode": (fe.fused_embed_pool_bwd(x.float(), *w, arg, dpool,
                                                 "tanh"), ("dw1", "dw2")),
        "t unrounded": (fe.reference_embed_pool_bwd(
            x, *w, arg, dpool, "tanh", bf, unrounded=("t",)), ("dw2",)),
        "dpre unrounded": (fe.reference_embed_pool_bwd(
            x, *w, arg, dpool, "tanh", bf, unrounded=("dpre",)), ("dw1",)),
    }
    for cname, (grads, skipped) in controls.items():
        for gname in skipped:
            i = names.index(gname)
            reading[f"{cname} {gname}"] = r = fe.bf16_product_error(
                grads[i], want[i], rss[gname == "dw2"])
            check(r > bar, f"K4-bf16 {what}: the control ({cname}) reads "
                  f"{r:.3g} on {gname}, within the bar {bar:.3g}")
    print(f"[K4-bf16] {what} {list(x.shape)} {str(x.dtype)[6:]}: max abs err "
          f"{err:.3g}; dw1/dw2 error over the terms' root-sum-square (bar "
          f"{bar:.3g}): " + ", ".join(f"{k} {v:.3g}"
                                      for k, v in reading.items())
          + "; two launches bitwise equal")
    return err, reading


def large_map_phase(kernels, dev) -> dict:
    """K1 and K2 on the seeded synthetic large map (scene/large_map.py):
    K1 after inv_perm against K2 at full width, both against their plain
    versions on the first PLAIN_WORLDS worlds, two launches each, then
    their wrapper times and bounds.  Returns {kernel: record}; phase 7
    builds the map again from its seed and adds the device times.  Nothing
    of the map stays on the card, so training starts as it would without
    this phase."""
    import torch

    from gpudrive_lab_torch.scene.large_map import LARGE_MAP, large_map

    t0 = time.time()
    m = large_map(**LARGE_MAP, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"[large map] {m.describe()}; built in {time.time() - t0:.1f} s")
    tiles = m.rtiles.feat
    W, A, _ = m.agents.shape
    T, RT = tiles.shape[1], tiles.shape[3]
    dense = twice(lambda: kernels.agent_road_hits_dense(m.agents, m.roads_t),
                  "large map K2")
    tiled = twice(lambda: kernels.agent_road_hits_tiled(
        m.agents_s, tiles, m.mask), "large map K1")
    check(torch.equal(torch.gather(tiled, 1, m.inv_perm), dense),
          "large map: K1 differs from K2")
    n = PLAIN_WORLDS
    check(torch.equal(dense[:n], kernels.agent_road_hits_dense_plain(
        m.agents[:n], m.roads_t[:n])), "large map: K2 differs from plain")
    check(torch.equal(tiled[:n], kernels.agent_road_hits_tiled_plain(
        m.agents_s[:n], tiles[:n], m.mask[:n])),
        "large map: K1 differs from plain")
    print(f"[large map] {int(m.mask.sum())}/{m.mask.numel()} live "
          f"block-tiles, {int(m.mask.amax(dim=1).sum())}/{W * T} live "
          f"tiles; K1 = K2 at full width, both = plain on {n} worlds, two "
          f"launches equal; {int(dense.sum())} agents hit")
    out = {}
    for key, fn, (bms, by, ops), pairs, shape in (
            ("K2", lambda: kernels.agent_road_hits_dense(m.agents, m.roads_t),
             k2_bound(kernels, m.agents, m.roads_t),
             kernels.live_pairs(m.agents, m.roads_t),
             f"agents [{W},{A},8], roads [{W},8,{T * RT}]"),
            ("K1", lambda: kernels.agent_road_hits_tiled(
                m.agents_s, tiles, m.mask),
             k1_bound(kernels, m.agents_s, tiles, m.mask),
             kernels.live_pairs_tiled(m.agents_s, tiles, m.mask),
             f"agents [{W},{A},8], tiles [{W},{T},8,{RT}], "
             f"{int(m.mask.sum())} live block-tiles")):
        wms = time_ms(fn, KERNEL_REPS)
        out[key] = dict(shape=shape, wrapper_ms=wms, bound_ms=bms,
                        bound_by=by)
        print(f"[large map] {key} {shape}: {pairs} live pairs, {ops} SAT "
              f"operations; wrapper {wms:.4f} ms per call, bound {bms:.4f} "
              f"ms ({by})")
    del m, tiles, dense, tiled
    torch.cuda.empty_cache()
    return out


def k4_check(ppo, env, traj, gen) -> tuple[dict, float]:
    """K4 against its plain version at the update's minibatch shapes: the
    partner and road slices, taken in place, of the observation that the
    update recomputes for one minibatch (rollout_len / num_minibatches
    steps of the flat compacted rows), with the argmax K3 gives on them
    and a random pooled cotangent.  K4's bf16 mode is held on the same
    float32 x beside it.  Returns K4's record and K4-bf16's max abs error
    on float32 x."""
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
    k4 = dict(name="K4 fused_embed_pool_bwd", route="cuda",
              source="gpudrive_lab_torch/csrc/fused_embed_bwd.cu",
              replaces="gpudrive_lab_tpu/networks/fused_embed.py:251",
              library_ms=None, ms=0.0, plain_ms=0.0, bound_ms=0.0,
              max_abs_err=0.0,
              parity="each gradient's max abs err <= 1e-4 x its max abs "
                     "value; two launches bitwise equal")
    worst_bound = {}
    bf16_err = 0.0
    with torch.no_grad():
        for bname, w, x in embed_blocks(ppo.policy, obs):
            _, arg = fe.fused_embed_pool_fwd(x, *w, "tanh")
            dpool = torch.randn(arg.shape, generator=gen, device=x.device)
            err, rel = k4_grad_check(x, w, arg, dpool, f"K4 {bname}")
            _, barg = fe.fused_embed_pool_fwd(x, *w, "tanh", torch.bfloat16)
            bf16_err = max(bf16_err, k4_bf16_check(
                x, w, barg, dpool, f"{bname} minibatch, float32 x")[0])
            bms16 = time_ms(lambda: fe.fused_embed_pool_bwd(
                x, *w, barg, dpool, "tanh", torch.bfloat16), 20)
            print(f"[K4-bf16] {bname} float32 x, K3-bf16's argmax: kernel "
                  f"{bms16:.4f} ms (float32 mode on the same x below)")
            B, Ent, F = x.shape
            winners = int(fe.winner_table(arg, Ent)[0].sum())
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
    return k4, bf16_err


def k6_rows_check(ppo, env, traj) -> dict:
    """K6 over the stacked time steps of the update's minibatch: the rows
    of rollout_len / num_minibatches time steps of the flat compacted
    selection, the roads selected LINEAR as the benchmark's train cell
    selects them, against the plain version (bitwise, two calls equal);
    its time from CUDA events beside its bound (the output written once)
    and the plain version's.  Returns its record, with a function under
    "args" that gives the arguments of one call for its device time in
    phase 7: the time steps it reads wait on the host until then, so that
    the phases in between hold no more on the card than they would
    without this check."""
    import dataclasses

    import torch

    from gpudrive_lab_torch.core.types import RoadObsAlgorithm, SimState
    from gpudrive_lab_torch.env import flat_obs_kernel as k6

    cfg = ppo.config
    params = dataclasses.replace(env.params,
                                 road_obs_algorithm=RoadObsAlgorithm.LINEAR)
    t_idx = list(range(cfg.rollout_len // cfg.num_minibatches))
    slots = ppo.ctrl_slots(env.scene)
    args = (env.scene, traj.env_state, t_idx, slots, params, env.spec,
            env.reward_weights)
    got = twice(lambda: k6.flat_obs_rows(*args), "K6 rows")
    want = k6.flat_obs_rows_plain(*args)
    torch.cuda.synchronize()
    n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(n_diff == 0, f"K6 rows differ from the plain version in {n_diff} "
          f"of {got.numel()} floats")
    rows = got.shape[0]
    del got, want
    wrapper = time_ms(lambda: k6.flat_obs_rows(*args), 20)
    plain = time_ms(lambda: k6.flat_obs_rows_plain(*args), 3, warmup=1)
    bms, by = bound(4 * rows * k6.OBS_DIM, 0)
    rec = dict(name="K6 flat_obs_rows", route="cuda",
               source="gpudrive_lab_torch/csrc/flat_obs.cu",
               replaces="none: XLA fuses the JAX recompute "
                        "(gpudrive_lab_tpu/ppo/ppo.py, env_jax.py:"
                        "flat_observation)",
               library_ms=None, ms=0.0, wrapper_ms=wrapper, plain_ms=plain,
               bound_ms=bms, bound_by=by, max_abs_err=0.0,
               parity="bitwise equal to plain; two calls bitwise equal",
               shape=f"[{rows},3368] ({len(t_idx)} steps x "
                     f"{rows // len(t_idx)} flat rows, LINEAR roads)")
    dev = traj.env_state.pos.device
    held = [getattr(traj.env_state, f.name)[:len(t_idx)].cpu()
            for f in dataclasses.fields(SimState)]
    slots = tuple(c.cpu() for c in slots)  # the flat (world, agent) pairs
    rec["args"] = lambda: (
        env.scene, SimState(*(x.to(dev) for x in held)), t_idx,
        tuple(c.to(dev) for c in slots), params, env.spec,
        env.reward_weights)
    print(f"[K6 rows] {rec['shape']}: bitwise equal to plain, two calls "
          f"equal; wrapper {wrapper:.4f} ms per call (CUDA events), plain "
          f"{plain:.3f} ms, bound {bms:.4f} ms ({by})")
    return rec


def k6_inputs(root: str, dev) -> list:
    """K6's inputs at the sim cells' shapes, roads selected KNEAREST in a
    50 m radius as the cells select them: (label, scene, state, params) of
    the 512 pool worlds (agent bucket 32) after 5 random steps, and of 256
    large-map worlds of 10,240 roads (bucket 32, 24 vehicles)."""
    import torch

    from gpudrive_lab_torch.core.types import Params, RoadObsAlgorithm
    from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env
    from gpudrive_lab_torch.scene.large_map import LARGE_MAP, large_map_scene

    env = slice_env(pool_scene_paths(root), device=dev, agent_bucket="auto",
                    road_obs_algorithm="k_nearest_roadpoints",
                    obs_radius=50.0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for _ in range(5):
        env.step_dynamics(torch.randint(
            0, env.action_space_n, env.scene.agents.valid.shape,
            generator=gen, device=dev))
    scene, state, _ = large_map_scene(**dict(LARGE_MAP, W=256, A=32),
                                      seed=SEED, device=dev, grid=False)
    params = Params(road_obs_algorithm=RoadObsAlgorithm.KNEAREST,
                    observation_radius=50.0)
    return [("pool", env.scene, env.state, env.params),
            ("large map", scene, state, params)]


def k6_in_radius(scene, state, params):
    """Per agent row [W, A]: the valid roads within the radius (none for a
    padded row), and whether two of the 201 nearest of them share a d2
    (where torch.topk may order them, or keep another road, otherwise than
    K6's lower index first)."""
    import torch

    W = scene.agents.valid.shape[0]
    n, tie = [], []
    for w in range(0, W, 16):
        d = (scene.roads.pos[w:w + 16, None, :, :2]
             - state.pos[w:w + 16, :, None])
        d2 = (d * d).sum(-1)
        within = (scene.roads.valid[w:w + 16, None]
                  & scene.agents.valid[w:w + 16, :, None]
                  & (d2 <= params.observation_radius ** 2))
        n.append(within.sum(-1))
        top = torch.topk(torch.where(within, d2, float("inf")),
                         min(201, d2.shape[-1]), dim=-1, largest=False).values
        tie.append(((top[..., :-1] == top[..., 1:])
                    & torch.isfinite(top[..., 1:])).any(-1))
    return torch.cat(n), torch.cat(tie)


def k6_check(root: str, dev) -> dict:
    """K6 at the sim cells' shapes (k6_inputs), every agent row: two calls
    bitwise equal and against flat_observation_plain bit for bit, the
    partner_mask everywhere, the rows and their road_mask but where two of
    an ego's 201 nearest roads share a d2 (counted apart); the wrapper's
    time per call (CUDA events),
    the plain version's and the bound: the rows and masks written once,
    the indices written and read once.  Returns K6's record, the
    large map's under "large_map"; phase 7 adds the device times."""
    import torch

    from gpudrive_lab_torch.env import flat_obs_kernel as k6
    from gpudrive_lab_torch.env.env_torch import (
        ObsSpec,
        flat_observation_plain,
    )

    spec = ObsSpec()
    rec = dict(name="K6 flat_obs_step", route="cuda",
               source="gpudrive_lab_torch/csrc/flat_obs.cu",
               replaces="none: XLA fuses the JAX package's observation "
                        "(gpudrive_lab_tpu/env/env_jax.py:flat_observation)",
               library_ms=None, ms=0.0, max_abs_err=0.0,
               parity="rows, partner_mask and road_mask bitwise equal to "
                      "plain but in rows where two roads tie in d2; two "
                      "calls bitwise equal")
    for label, scene, state, params in k6_inputs(root, dev):
        got = k6.flat_obs_step(scene, state, params, spec)
        again = k6.flat_obs_step(scene, state, params, spec)
        want = flat_observation_plain(scene, state, params, spec, None)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"K6 {label}: two calls differ")
        obs = got[0]
        check(torch.equal(got[1], want[1]),
              f"K6 {label}: partner_mask differs from plain")
        same = ((obs.view(torch.int32) == want[0].view(torch.int32)).all(-1)
                & (got[2] == want[2]).all(-1)).reshape(-1)
        in_radius, tie = k6_in_radius(scene, state, params)
        tie = tie.reshape(-1)
        check(bool((same | tie).all()), f"K6 {label}: "
              f"{int((~same & ~tie).sum())} rows differ from plain")
        valid = scene.agents.valid
        entries = int(in_radius.clamp(max=200)[valid].sum())
        W, A = valid.shape
        rows = W * A
        bms, by = bound(rows * (4 * k6.OBS_DIM + 4 * 127 + 200)
                        + 4 * (rows + int(valid.sum())) + 8 * entries, 0)
        del got, again, want
        wrapper = time_ms(lambda: k6.flat_obs_step(scene, state, params,
                                                   spec), 20)
        plain = time_ms(lambda: flat_observation_plain(
            scene, state, params, spec, None), 3, warmup=1)
        shape = (f"[{W},{A},3368] + masks, {scene.roads.valid.shape[1]} "
                 f"roads, KNEAREST")
        out = dict(shape=shape, wrapper_ms=wrapper, plain_ms=plain,
                   bound_ms=bms, bound_by=by,
                   rows_over_200=int((in_radius[valid] > 200).sum()),
                   tie_rows=int(tie.sum()))
        if label == "pool":
            rec.update(out)
        else:
            rec["large_map"] = out
        print(f"[K6] {label} {shape}: bitwise equal to plain but in "
              f"{out['tie_rows']} rows with a d2 tie, two calls equal; "
              f"{out['rows_over_200']} of {int(valid.sum())} egos see more "
              f"than 200 roads; wrapper "
              f"{wrapper:.4f} ms per call (CUDA events), plain "
              f"{plain:.3f} ms, bound {bms:.4f} ms ({by})")
    return rec


def timed_iteration(ppo, env, carry, fresh, what: str):
    """One PPO iteration that must not wait on the card, timed: (carry,
    samples, wall s, (rollout, gae, update) ms from CUDA events, the mean
    losses)."""
    import torch

    rw = env.reward_weights
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t0 = time.time()
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
          f"{what}: samples {samples} != mask sum")
    loss = {k: v.mean().item() for k, v in losses.items()}
    check(all(torch.isfinite(v).all() for v in losses.values()),
          f"{what}: a loss is not finite: {loss}")
    return (carry, samples, wall,
            tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3)), loss)


def train_phase(env, scenes, gen) -> tuple[dict, float, dict, dict]:
    """PPO on the slice's 512 worlds through build_trainer: one warm-up
    iteration, K4 and K6 over stacked times against their plain versions,
    TRAIN_ITERS timed
    iterations with the launch counts read around them, one iteration
    under torch.profiler, a checkpoint round trip, and one dense iteration
    on the first DENSE_WORLDS worlds.  Returns K4's kernel record,
    K4-bf16's error on float32 x (k4_check), the timed iterations' summary
    and the record of K6 over stacked times (k6_rows_check)."""
    import dataclasses
    import tempfile

    import torch
    from torch.profiler import record_function

    from gpudrive_lab_torch.env import flat_obs_kernel
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
    k4, k4_bf16_f32x_err = k4_check(ppo, env, traj, gen)
    k6_rows = uncounted(lambda: k6_rows_check(ppo, env, traj))
    del traj

    before = [p.detach().clone() for p in ppo.policy.parameters()]
    torch.cuda.synchronize()
    for f in (fe.fused_embed_pool_fwd, fe.fused_embed_pool_bwd):
        f.launches = f.bf16_launches = 0
    flat_obs_kernel.flat_obs_step.launches = 0
    rates, splits = [], []
    for it in range(TRAIN_ITERS):
        n0 = fe.fused_embed_pool_bwd.launches
        carry, samples, wall, split, loss = timed_iteration(
            ppo, env, carry, fresh, f"iteration {it}")
        n4 = fe.fused_embed_pool_bwd.launches - n0
        check(n4 == per_iter, f"iteration {it}: K4 launched {n4} times, "
              f"expected {per_iter}")
        global_step += samples
        rates.append(samples / wall)
        splits.append(split)
        print(f"[train] iteration {it}: rollout {split[0]:.3f} ms, gae "
              f"{split[1]:.3f} ms, update {split[2]:.3f} ms (CUDA events); "
              f"wall {wall * 1e3:.3f} ms, {samples:.0f} samples, train "
              f"samples/s {samples / wall:.1f}; K4 launches {n4}; "
              + ", ".join(f"{k} {v:.5f}" for k, v in loss.items()))
    k4["launches"] = fe.fused_embed_pool_bwd.launches
    # a K6 launch pair per rollout step, one for the bootstrap value
    # (prepare) and one per minibatch of the update
    k6_rows["launches"] = flat_obs_kernel.flat_obs_step.launches
    n6 = (TRAIN_ITERS * (cfg.rollout_len + 1
                         + cfg.update_epochs * cfg.num_minibatches)
          if flat_obs_kernel.step_supports(env.spec, env.params) else 0)
    check(k6_rows["launches"] == n6, f"K6 launched {k6_rows['launches']} "
          f"pairs in the timed iterations, expected {n6}")
    check(fe.fused_embed_pool_fwd.bf16_launches == 0
          and fe.fused_embed_pool_bwd.bf16_launches == 0,
          "the float32 iterations launched the bf16 mode")
    summary = dict(rates=rates, splits=splits,
                   k3_per_iter=fe.fused_embed_pool_fwd.launches / TRAIN_ITERS,
                   k4_per_iter=k4["launches"] / TRAIN_ITERS)
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (us, cnt)) in enumerate(ranked):
        if rank < 12 or "embed_pool" in name:  # the top 12, and K3 and K4
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
    return k4, k4_bf16_f32x_err, summary, k6_rows


def bf16_train_phase(env, gen, f32: dict) -> tuple[dict, dict]:
    """PPO with the bf16 policy dtype on the slice's 512 worlds through
    build_trainer, in the JAX package's production pairing (the split bf16
    obs store, fused embed), so K3 and K4 run their bf16 mode on bf16 x:
    one warm-up iteration; K3-bf16 on the store's x at the rollout's and a
    minibatch's row counts and K4-bf16 on a minibatch's, against their
    plain versions, with K4-bf16's times; TRAIN_ITERS timed iterations
    (launch counts set to 0 before and read after, each iteration's
    checked equal to the float32 phase's ``f32``), printed beside the
    float32 numbers.  Returns (K3-bf16's additions, K4-bf16's record)."""
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe
    from gpudrive_lab_torch.ppo.ppo import PPOConfig
    from gpudrive_lab_torch.ppo.train import build_trainer

    n_ctrl = int(env.scene.agents.controlled.sum())
    cfg = PPOConfig(rollout_len=32, update_epochs=4, num_minibatches=4,
                    fused_embed=True, compact_mode="flat",
                    compact=-(-n_ctrl // 64) * 64, policy_dtype="bfloat16",
                    remat_obs=False, obs_store="split",
                    obs_store_dtype="bfloat16")
    ppo, carry, fresh, _ = build_trainer(env, cfg, seed=SEED)
    check(ppo.policy.config.dtype == torch.bfloat16, "policy dtype")
    rw = env.reward_weights
    print(f"[train bf16] {env.num_worlds} worlds, compaction to "
          f"{cfg.compact} rows, policy_dtype bfloat16, split bfloat16 obs "
          f"store, fused_embed; T={cfg.rollout_len}, {cfg.update_epochs} "
          f"epochs x {cfg.num_minibatches} minibatches")
    carry, traj = ppo.rollout(env.scene, carry, fresh, rw)
    check(isinstance(traj.obs, tuple)
          and all(o.dtype == torch.bfloat16 for o in traj.obs),
          "the obs store is not split bfloat16")
    store = sum(o.numel() * o.element_size() for o in traj.obs)
    print(f"[train bf16] obs store {store / 1e9:.4f} GB "
          f"({[list(o.shape) for o in traj.obs]})")
    ppo.update(env.scene, carry, traj, rw)

    policy = ppo.policy
    mb = cfg.rollout_len // cfg.num_minibatches
    k3 = dict(store_err=0.0)
    k4 = dict(name="K4-bf16 fused_embed_pool_bwd, bf16 compute mode",
              route="cuda",
              source="gpudrive_lab_torch/csrc/fused_embed_bwd_bf16.cu",
              replaces="gpudrive_lab_tpu/networks/fused_embed.py:251",
              library_ms=None, ms=0.0, plain_ms=0.0, bound_ms=0.0,
              max_abs_err=0.0, bar_readings={},
              parity="db1, dg, dbe, db2 max abs err <= 1e-4 x each "
                     "gradient's max abs value; dw1, dw2 error <= 2^-12 "
                     "of their terms' root-sum-square, where K4's float32 "
                     "mode and the plain version without the rounding of "
                     "t or dpre must exceed it; two launches bitwise "
                     "equal")
    worst_bound = {}
    with torch.no_grad():
        for bname, emb, blk in (
                ("partner", policy.partner_embed, traj.obs[1]),
                ("road", policy.road_map_embed, traj.obs[2])):
            lin1, ln, _, _, lin2 = emb
            w = (lin1.weight.t().contiguous(), lin1.bias, ln.weight, ln.bias,
                 lin2.weight.t().contiguous(), lin2.bias)
            x = blk[:mb].reshape((-1,) + blk.shape[2:])
            for what, xr in (("rollout step, store", blk[0]),
                             ("minibatch, store", x)):
                k3["store_err"] = max(k3["store_err"], k3_bf16_check(
                    xr, w, f"{bname} {what}"))
            _, arg = fe.fused_embed_pool_fwd(x, *w, "tanh", torch.bfloat16)
            dpool = torch.randn(arg.shape, generator=gen, device=x.device)
            err, k4["bar_readings"][bname] = k4_bf16_check(
                x, w, arg, dpool, f"{bname} minibatch, store")
            B, Ent, F = x.shape
            winners = int(fe.winner_table(arg, Ent)[0].sum())
            ms = time_ms(lambda: fe.fused_embed_pool_bwd(
                x, *w, arg, dpool, "tanh", torch.bfloat16), 20)
            plain = time_ms(lambda: fe.reference_embed_pool_bwd(
                x, *w, arg, dpool, "tanh", torch.bfloat16), 3, warmup=1)
            n_out = F * 64 + 64 * 64 + 4 * 64
            mma = fe.bwd_mma_flops(F, B, winners)
            bms, by = bound(2 * winners * F + 4 * (2 * B * 64 + 2 * n_out),
                            fe.bwd_flops(F, B, winners) - mma,
                            bf16_flops=mma)
            k4["ms"] += ms
            k4["plain_ms"] += plain
            k4["bound_ms"] += bms
            k4["max_abs_err"] = max(k4["max_abs_err"], err)
            worst_bound[bname] = by
            print(f"[K4-bf16] {bname} [{B},{Ent},{F}] bfloat16 x: "
                  f"{winners / B:.1f} winners per row; kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
    k4["bound_by"] = worst_bound["road"]
    n = mb * traj.obs[1].shape[1]
    k4["shape"] = (f"partner [{n},127,6] + road [{n},200,13] bfloat16 per "
                   "minibatch backward")
    del traj

    before = [p.detach().clone() for p in policy.parameters()]
    torch.cuda.synchronize()
    for f in (fe.fused_embed_pool_fwd, fe.fused_embed_pool_bwd):
        f.launches = f.bf16_launches = 0
    rates, splits = [], []
    for it in range(TRAIN_ITERS):
        n3, n4 = (fe.fused_embed_pool_fwd.bf16_launches,
                  fe.fused_embed_pool_bwd.bf16_launches)
        carry, samples, wall, split, loss = timed_iteration(
            ppo, env, carry, fresh, f"bf16 iteration {it}")
        n3 = fe.fused_embed_pool_fwd.bf16_launches - n3
        n4 = fe.fused_embed_pool_bwd.bf16_launches - n4
        check((n3, n4) == (f32["k3_per_iter"], f32["k4_per_iter"]),
              f"bf16 iteration {it}: K3-bf16 {n3}, K4-bf16 {n4} launches, "
              f"the float32 iterations {f32['k3_per_iter']}, "
              f"{f32['k4_per_iter']}")
        rates.append(samples / wall)
        splits.append(split)
        print(f"[train bf16] iteration {it}: rollout {splits[-1][0]:.3f} ms,"
              f" gae {splits[-1][1]:.3f} ms, update {splits[-1][2]:.3f} ms "
              f"(CUDA events); wall {wall * 1e3:.3f} ms, {samples:.0f} "
              f"samples, train samples/s {samples / wall:.1f}; K3-bf16 "
              f"launches {n3}, K4-bf16 {n4}; "
              + ", ".join(f"{k} {v:.5f}" for k, v in loss.items()))
    check(fe.fused_embed_pool_fwd.launches
          == fe.fused_embed_pool_fwd.bf16_launches
          and fe.fused_embed_pool_bwd.launches
          == fe.fused_embed_pool_bwd.bf16_launches,
          "the bf16 iterations launched the float32 mode")
    after = list(policy.parameters())
    check(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
              for p in after), "a parameter is not finite float32")
    check(any(not torch.equal(a, b) for a, b in zip(after, before)),
          "bf16 training did not change the parameters")
    k3["launches"] = fe.fused_embed_pool_fwd.bf16_launches
    k4["launches"] = fe.fused_embed_pool_bwd.bf16_launches

    def mean(v):
        return sum(v) / len(v)

    for name, r, sp in (("float32 (phase 5)", f32["rates"], f32["splits"]),
                        ("bfloat16", rates, splits)):
        print(f"[train bf16] {name}: train samples/s {mean(r):.1f} (runs "
              + ", ".join(f"{v:.1f}" for v in r) + "); rollout "
              f"{mean([x[0] for x in sp]):.3f}, gae "
              f"{mean([x[1] for x in sp]):.3f}, update "
              f"{mean([x[2] for x in sp]):.3f} ms per iteration (CUDA "
              "events, means)")
    return k3, k4


def take_worlds(obj, n: int, device):
    """A Scene or SimState cut to its first n worlds, on ``device``."""
    import dataclasses

    return type(obj)(**{
        f.name: None if v is None
        else take_worlds(v, n, device) if dataclasses.is_dataclass(v)
        else v[:n].to(device)
        for f in dataclasses.fields(obj)
        for v in (getattr(obj, f.name),)})


def check_rows(name, outs, valid) -> None:
    """Every output of a sensor finite, zero on the rows of agents that
    were not created, and not all zero on the others; read from per-row
    extremes, without a copy of a 10 GB output."""
    import torch

    for t in outs:
        hi, lo = t.flatten(2).amax(-1), t.flatten(2).amin(-1)
        check(bool(torch.isfinite(hi.float()).all()
                   and torch.isfinite(lo.float()).all()),
              f"{name}: not finite")
        nz = (hi != 0) | (lo != 0)
        check(not bool(nz[~valid].any()), f"{name}: a row of an agent that "
              f"was not created is not zero")
        check(bool(nz[valid].any()), f"{name}: nothing seen")


def sensor_phase(env, policy, gen) -> dict:
    """The lidar, BEV and camera on every step of a policy rollout over the
    slice's worlds (K2 and K3 launched on that path), each sensor's ms per
    call, peak memory and output floor, and the card's outputs for the first
    SENSOR_CPU_WORLDS worlds against the same port functions on the CPU:
    every difference must be a boundary case (utils/sensor_parity.py).
    Returns the launches of K2 and K3 in the sensor rollout."""
    import torch

    from gpudrive_lab_torch.core import kernels
    from gpudrive_lab_torch.core.bev import bev_observation
    from gpudrive_lab_torch.core.lidar import lidar_observation
    from gpudrive_lab_torch.core.render import CameraConfig, batch_render
    from gpudrive_lab_torch.networks import fused_embed as fe
    from gpudrive_lab_torch.rollout import rollout
    from gpudrive_lab_torch.utils import sensor_parity

    W, A = env.num_worlds, env.max_agent_count
    n_agents = int(env.scene.num_agents.sum())
    env.reset()
    rollout(env, policy, 1, gen, sensors=True)  # warm-up
    env.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.agent_road_hits_dense.launches = 0
    kernels.agent_road_hits_tiled.launches = 0
    fe.fused_embed_pool_fwd.launches = 0
    t0 = time.time()
    res = rollout(env, policy, SENSOR_STEPS, gen, sensors=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n2 = kernels.agent_road_hits_dense.launches
    n3 = fe.fused_embed_pool_fwd.launches
    n1 = kernels.agent_road_hits_tiled.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"[sensors] {SENSOR_STEPS} rollout steps x {W} worlds with lidar, "
          f"BEV and camera: {wall * 1e3 / SENSOR_STEPS:.3f} ms/step wall; "
          f"sim {res.sim_ms / SENSOR_STEPS:.3f}, policy "
          f"{res.policy_ms / SENSOR_STEPS:.3f}, "
          + ", ".join(f"{k} {v / SENSOR_STEPS:.3f}"
                      for k, v in res.sensor_ms.items())
          + f" ms/step (CUDA events); agent-steps/s "
          f"{SENSOR_STEPS * n_agents / wall:.1f}; peak memory "
          f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before); "
          f"launches K2 {n2} K3 {n3} K1 {n1}")
    check(n2 > 0 and n3 > 0, "the sensor rollout did not launch K2 and K3")
    check(bool(torch.isfinite(res.sensor_sum)) and float(res.sensor_sum) > 0,
          f"sensor checksum {float(res.sensor_sum)}")
    check(bool(torch.isfinite(res.rewards).all()), "sensor rollout rewards")

    act = env.action_values(res.actions[-1])
    cfg = CameraConfig()
    calls = (("lidar", lambda: env.get_lidar_obs(act)),
             ("bev", env.get_bev_obs),
             ("camera", lambda: env.get_camera_obs(cfg)))
    card, valid = {}, env.scene.agents.valid
    for name, fn in calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        outs = out if isinstance(out, tuple) else (out,)
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        check_rows(name, outs, valid)
        ms = res.sensor_ms[name] / SENSOR_STEPS
        shapes = " + ".join(str(list(t.shape)) for t in outs)
        print(f"[sensors] {name} {shapes}: {ms:.3f} ms per call (CUDA "
              f"events over {SENSOR_STEPS} rollout steps, output reduced "
              f"included); peak memory "
              f"{extra / 2**30:.3f} GiB above the {before / 2**30:.3f} GiB "
              f"held; output {nbytes / 1e9:.4f} GB, floor "
              f"{nbytes / PEAK_BYTES * 1e3:.4f} ms (output bytes / 3.35 TB/s)")
        card[name] = tuple(t[:SENSOR_CPU_WORLDS].cpu() for t in outs)
        del out, outs

    n = SENSOR_CPU_WORLDS
    cpu = torch.device("cpu")
    scene, state = (take_worlds(x, n, cpu) for x in (env.scene, env.state))
    act = act[:n].cpu()
    t0 = time.time()
    host = {
        "lidar": (lidar_observation(scene, state, env.params, act),),
        "bev": (bev_observation(scene, state, env.params),),
        "camera": batch_render(scene, state, cfg),
    }
    cpu_s = time.time() - t0
    reports = {
        "lidar": sensor_parity.lidar_diff(scene, state, act, card["lidar"][0],
                                          host["lidar"][0], depth_tol=1e-3),
        "bev": sensor_parity.bev_diff(scene, state, env.params,
                                      card["bev"][0], host["bev"][0]),
        "camera": sensor_parity.camera_diff(scene, state, cfg, card["camera"],
                                            host["camera"], depth_tol=1e-3),
    }
    units = {"lidar": "samples", "bev": "cells", "camera": "pixels"}
    for name, rep in reports.items():
        total = card[name][0][..., 0].numel()
        differ = sum((a != b).reshape(total, -1).any(-1)
                     for a, b in zip(card[name], host[name]))
        differ = int((differ > 0).sum())
        print(f"[sensors] card against CPU, {n} worlds, {name}: "
              f"{rep['mismatches']} mismatching {units[name]} of {total} "
              f"({len(rep['unexplained'])} not a boundary case); "
              f"{differ} differ in any bit")
        for u in rep["unexplained"][:5]:
            print(f"[sensors]   {name} fault: {u}")
        check(not rep["unexplained"], f"{name}: card and CPU differ away "
              f"from any box edge at {len(rep['unexplained'])} {units[name]}")
    print(f"[sensors] the CPU took {cpu_s:.1f} s for the {n} worlds")
    return {"K2": n2, "K3": n3}


# the dataset phase: PPO CLI iterations, swaps and the other steps
DATASET_WORLDS = 512  # worlds per batch
DATASET_STEPS = 100  # vec env steps, past the 91-step episode
DATASET_SWAP_AT = 95  # the vec env's resample, after the first episodes
PREFETCH_STEPS = 5  # rollout steps that overlap a prefetch


def counts() -> dict:
    """Every kernel's launch count."""
    from gpudrive_lab_torch.core import kernels
    from gpudrive_lab_torch.env import flat_obs_kernel
    from gpudrive_lab_torch.networks import fused_embed as fe

    return {"K1": kernels.agent_road_hits_tiled.launches,
            "K2": kernels.agent_road_hits_dense.launches,
            "K3": fe.fused_embed_pool_fwd.launches,
            "K4": fe.fused_embed_pool_bwd.launches,
            "K3-bf16": fe.fused_embed_pool_fwd.bf16_launches,
            "K4-bf16": fe.fused_embed_pool_bwd.bf16_launches,
            "K6": flat_obs_kernel.flat_obs_step.launches}


def set_counts(c: dict) -> None:
    from gpudrive_lab_torch.core import kernels
    from gpudrive_lab_torch.env import flat_obs_kernel
    from gpudrive_lab_torch.networks import fused_embed as fe

    flat_obs_kernel.flat_obs_step.launches = c["K6"]
    kernels.agent_road_hits_tiled.launches = c["K1"]
    kernels.agent_road_hits_dense.launches = c["K2"]
    fe.fused_embed_pool_fwd.launches = c["K3"]
    fe.fused_embed_pool_bwd.launches = c["K4"]
    fe.fused_embed_pool_fwd.bf16_launches = c["K3-bf16"]
    fe.fused_embed_pool_bwd.bf16_launches = c["K4-bf16"]


def uncounted(fn):
    """fn's result, its kernel launches (checks against the plain
    versions) left out of the counts."""
    before = counts()
    try:
        return fn()
    finally:
        set_counts(before)


def embed_blocks(policy, rows):
    """(name, K3/K4 weights, x) of the partner and road blocks of the
    flat observation rows [N, 3368]."""
    out = []
    for bname, emb, x in (
            ("partner", policy.partner_embed,
             rows[:, 6:768].unflatten(-1, (127, 6))),
            ("road", policy.road_map_embed,
             rows[:, 768:].unflatten(-1, (200, 13)))):
        lin1, ln, _, _, lin2 = emb
        out.append((bname, (lin1.weight.t().contiguous(), lin1.bias,
                            ln.weight, ln.bias, lin2.weight.t().contiguous(),
                            lin2.bias), x))
    return out


def k3_against_plain(policy, rows, what: str) -> float:
    """K3 on the partner and road slices of ``rows`` against its plain
    version at phase 2's bars; returns the max abs error."""
    import torch

    with torch.no_grad():
        return max(k3_check(x, w, f"[dataset] K3 {what}, {bname}")
                   for bname, w, x in embed_blocks(policy, rows))


def k2_against_plain(env, what: str, tag: str = "[dataset]") -> None:
    """K2 at ``env``'s state (anything with .scene and .state) against its
    plain version, bit for bit, and against a second launch."""
    import torch

    from gpudrive_lab_torch.core import kernels

    feat, roads_t = road_inputs(env)
    got = twice(lambda: kernels.agent_road_hits_dense(feat, roads_t),
                f"K2 {what}")
    want = kernels.agent_road_hits_dense_plain(feat, roads_t)
    check(torch.equal(got, want), f"K2 {what}: differs from its plain "
          f"version at {int((got != want).sum())} agents")
    print(f"{tag} K2 {what}: bitwise equal to plain, two launches equal, "
          f"{int(got.sum())} agents hit")


class PhaseTimer:
    """A PPO trainer's rollout, GAE and update ms per iteration, for a
    CLI's iterations: the trainer's own ``ppo.rollout``, ``ppo.prepare``
    and ``ppo.learn`` spans, which alone record while the timer is entered
    (stream ms on a card), read at its exit."""

    PHASES = {"ppo.rollout": "rollout", "ppo.prepare": "gae",
              "ppo.learn": "update"}

    def __enter__(self):
        from gpudrive_lab_torch.utils import profiling

        self._recording = profiling.recording(self.PHASES)
        self._first = self._recording.__enter__()
        return self

    def __exit__(self, *exc):
        from gpudrive_lab_torch.utils import profiling

        ms = [profiling.span_ms(n, start=self._first) for n in self.PHASES]
        self._iters = [dict(zip(self.PHASES.values(), it))
                       for it in zip(*ms)]
        return self._recording.__exit__(*exc)

    def iterations(self) -> list:
        """[{rollout, gae, update} ms] per iteration."""
        return self._iters


def dataset_phase(root: str, dev, gen) -> dict:
    """The dataset-driven path at full width: 512 worlds drawn with
    replacement from the 512 pool_v3 scenes, 128 agent rows, the default
    policy widths with fused_embed.  (1) the PPO CLI in process, a swap
    before every iteration after the first, with each iteration's rollout,
    GAE and update ms, samples/s and the swap count; one swap cold and one
    warm, and a swap behind PrefetchingSceneLoader against a plain one;
    (2) VecGPUDriveEnv for DATASET_STEPS steps with the fused policy and one
    resample, K2 and K3 held against their plain versions on the first step
    after it; (3) evaluate_policy over 2 batches with a PolicyActor loaded
    from the CLI's policy.pt, and multi_policy_rollout with that actor and a
    RandomActor; (4) IPPO over SB3MultiAgentEnv, one learn call with one
    resample, K4 held against its plain version on a minibatch after it.
    The launch counts are set to 0 at the start; the checks' launches are
    left out.  Returns {kernel: launches, ...} and the phase's numbers."""
    import tempfile

    import numpy as np
    import torch

    from gpudrive_lab_torch.agents import PolicyActor, RandomActor
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.dataset import SceneDataLoader
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.env.env_vec import VecGPUDriveEnv
    from gpudrive_lab_torch.env.wrappers.sb3_learner import IPPO, IPPOConfig
    from gpudrive_lab_torch.env.wrappers.sb3_wrapper import SB3MultiAgentEnv
    from gpudrive_lab_torch.networks.late_fusion import (
        PolicyConfig,
        sample_logits,
    )
    from gpudrive_lab_torch.ppo import train
    from gpudrive_lab_torch.rollout import SLICE_CONFIG, rollout, slice_policy
    from gpudrive_lab_torch.scene.compiler import compile_world
    from gpudrive_lab_torch.scene.loader import load_map
    from gpudrive_lab_torch.scene.prefetch import PrefetchingSceneLoader
    from gpudrive_lab_torch.utils.evaluation import evaluate_policy
    from gpudrive_lab_torch.utils.multi_policy_rollout import (
        multi_policy_rollout,
    )

    pool = os.path.join(root, "data", "pool_v3")
    W, seed = DATASET_WORLDS, 42

    def loader(s=seed):
        return SceneDataLoader(pool, W, 1000, sample_with_replacement=True,
                               seed=s)

    # --compact: the most controlled agents of the first 8 batches the
    # CLI's loader draws (seed 42), rounded up to 64; check_compact_capacity
    # refuses a run that reaches a batch where it falls short.  With a swap
    # before every iteration after the first (--resample-interval 1),
    # --total-timesteps one above the most samples the first 3 batches can
    # give (controlled agents x 32 steps) runs at least 4 iterations.
    cli_cfg = EnvConfig(
        reward_type="weighted_combination", collision_weight=-0.75,
        off_road_weight=-0.75, goal_achieved_weight=1.0,
        dynamics_model="classic", collision_behavior="ignore")
    params = cli_cfg.sim_params()
    it = iter(loader())
    totals = [sum(int(compile_world(p, params, frozenset()).agent[
        "controlled"].sum()) for p in next(it)) for _ in range(8)]
    compact = -(-max(totals) // 64) * 64
    timesteps = 32 * sum(totals[:3]) + 1
    print(f"[dataset] controlled agents of the CLI's first 8 batches "
          f"(seed {seed}): {totals}; --compact {compact}, --total-timesteps "
          f"{timesteps}")

    set_counts(dict.fromkeys(counts(), 0))
    results = {}
    # ---- (1) the PPO CLI ---------------------------------------------------
    with tempfile.TemporaryDirectory() as ckpt, PhaseTimer() as timer:
        argv = ["--device", dev.type, "--data-dir", pool, "--num-worlds",
                str(W), "--fused-embed", "--compact", str(compact),
                "--compact-mode", "flat", "--rollout-len", "32",
                "--update-epochs", "4", "--num-minibatches", "4",
                "--resample-interval", "1",
                "--total-timesteps", str(timesteps),
                "--log-interval", "1", "--checkpoint-path", ckpt]
        print(f"[dataset] ppo.train.main {' '.join(argv[:-1])} <tmp>")
        t0 = time.time()
        train.main(argv)
        torch.cuda.synchronize()
        cli_s = time.time() - t0
        with open(os.path.join(ckpt, "ppo.metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f]
        ckpt_state = torch.load(os.path.join(ckpt, train.CHECKPOINT),
                                map_location="cpu")
    iters = timer.iterations()
    check(len(iters) == len(logs) >= 4, f"the CLI ran {len(iters)} "
          f"iterations ({len(logs)} logged), expected at least 4")
    check(logs[-1]["resamples"] == len(logs) - 1 >= 3, f"the CLI swapped "
          f"{logs[-1]['resamples']} times in {len(logs)} iterations")
    prev, rates = 0, []
    for rec, ph in zip(logs, iters):
        samples = rec["global_step"] - prev
        prev = rec["global_step"]
        ms = sum(ph.values())
        rates.append(samples / ms * 1e3)
        check(all(np.isfinite(rec[k]) for k in ("pg_loss", "v_loss",
                                                 "entropy")),
              f"iteration {rec['iteration']}: a loss is not finite")
        print(f"[dataset] iteration {rec['iteration']}: rollout "
              f"{ph['rollout']:.3f} ms, gae {ph['gae']:.3f} ms, update "
              f"{ph['update']:.3f} ms (CUDA events); {samples} samples, "
              f"train samples/s {rates[-1]:.1f}; resamples "
              f"{rec['resamples']}, resample_time_s {rec['resample_time_s']}")
    cli = counts()
    results["cli"] = dict(iterations=len(iters), resamples=logs[-1]
                          ["resamples"], rates=rates, compact=compact,
                          wall_s=cli_s, launches=cli)
    print(f"[dataset] CLI: {len(iters)} iterations, {logs[-1]['resamples']} "
          f"swaps, {cli_s:.2f} s wall (env build included); mean train "
          f"samples/s {sum(rates) / len(rates):.1f}; launches so far "
          f"{cli}")

    # ---- swap timings ------------------------------------------------------
    env = GPUDriveTorchEnv(cli_cfg, data_loader=loader(seed + 1), device=dev)
    policy = slice_policy(device=dev, seed=SEED)

    def timed_swap(batch=None) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env.swap_data_batch(batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def clear_caches():
        """Forget every compiled world and parsed JSON file."""
        compile_world.cache_clear()
        load_map.cache_clear()

    batch = next(iter(loader(seed + 2)))
    clear_caches()
    cold = timed_swap(batch)  # parse and compile every world
    compile_world.cache_clear()
    cold_compile = timed_swap(batch)  # compile every world, files parsed
    warm = timed_swap(batch)
    gen_local = torch.Generator(device=dev).manual_seed(SEED)
    # the same batch behind the same PREFETCH_STEPS rollout steps, both
    # caches cleared before each: a plain swap after the steps, and a swap
    # of the batch a PrefetchingSceneLoader compiled during them
    clear_caches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rollout(env, policy, PREFETCH_STEPS, gen_local)
    torch.cuda.synchronize()
    steps_plain = time.perf_counter() - t0
    plain_swap = timed_swap(batch)
    clear_caches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pf = PrefetchingSceneLoader(loader(seed + 2), env.params)
    try:
        rollout(env, policy, PREFETCH_STEPS, gen_local)
        torch.cuda.synchronize()
        steps_pf = time.perf_counter() - t0
        t1 = time.perf_counter()
        paths = pf.next_batch()
        wait = time.perf_counter() - t1
    finally:
        pf.close()
    check(paths == batch, "the prefetched batch is not the loader's first")
    pf_swap = timed_swap(paths)
    swaps = dict(cold_s=cold, cold_compile_s=cold_compile, warm_s=warm,
                 plain_steps_s=steps_plain, plain_swap_s=plain_swap,
                 prefetch_steps_s=steps_pf, prefetch_wait_s=wait,
                 prefetch_swap_s=pf_swap)
    results["swaps"] = swaps
    print(f"[dataset] swap of {W} worlds ({len(set(batch))} distinct "
          f"scenes): cold {cold:.3f} s (files parsed and compiled), "
          f"{cold_compile:.3f} s (compile_world's cache cleared, files "
          f"parsed), warm {warm:.3f} s; {PREFETCH_STEPS} rollout steps then "
          f"a plain cold swap {steps_plain:.3f} + {plain_swap:.3f} = "
          f"{steps_plain + plain_swap:.3f} s; the same steps while "
          f"PrefetchingSceneLoader compiles {steps_pf:.3f} + wait "
          f"{wait:.3f} + swap {pf_swap:.3f} = {steps_pf + wait + pf_swap:.3f}"
          f" s")
    del env

    # ---- (2) VecGPUDriveEnv --------------------------------------------------
    venv = VecGPUDriveEnv(EnvConfig(**SLICE_CONFIG), loader(seed + 3),
                          device=dev)
    obs = venv.reset()
    stats = []
    with torch.no_grad():
        for t in range(DATASET_STEPS):
            if t == DATASET_SWAP_AT:
                venv.resample_scenario_batch()
                obs = venv.reset()
                uncounted(lambda: k2_against_plain(
                    venv.env, "vec env, first state after the swap"))
                results["K3_err"] = uncounted(lambda: k3_against_plain(
                    policy, obs, "vec env, first step after the swap"))
            logits, _ = policy(obs)
            action, _, _ = sample_logits(gen, logits)
            obs, rew, term, trunc, info = venv.step(action)
            stats += info["episode_stats"]
    check(bool(torch.isfinite(rew).all()) and obs.shape == (
        venv.num_agents, 3368), "vec env: bad rewards or obs")
    check(len(stats) >= W // 2, f"vec env: {len(stats)} episode records")
    mean = {k: sum(s[k] for s in stats) / len(stats) for k in (
        "perc_goal_achieved", "perc_veh_collisions", "perc_off_road",
        "perc_truncated")}
    results["vec"] = dict(episodes=len(stats), coverage=len(
        venv.data_coverage), **mean)
    print(f"[dataset] vec env: {DATASET_STEPS} steps, resample at step "
          f"{DATASET_SWAP_AT}, {len(stats)} episode records ("
          + ", ".join(f"{k} {v:.4f}" for k, v in mean.items())
          + f"), {len(venv.data_coverage)} scenes covered, "
          f"{venv.num_agents} agents after the swap")
    del venv, obs

    # ---- (3) evaluation ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, train.CHECKPOINT)
        torch.save(ckpt_state, path)
        actor = PolicyActor(None, checkpoint_path=path,
                            policy_config=PolicyConfig(fused_embed=True),
                            deterministic=True, device=dev)
    eenv = GPUDriveTorchEnv(cli_cfg, data_loader=loader(seed + 4),
                            device=dev)
    t0 = time.time()
    ev = evaluate_policy(eenv, actor.policy, num_batches=2)
    torch.cuda.synchronize()
    ev_s = time.time() - t0
    check(len(ev["per_scene"]) == 2 * W, "evaluation: per-scene records")
    check(all(0.0 <= ev[k] <= 1.0 for k in ("goal_achieved", "collided",
                                             "off_road")),
          f"evaluation rates out of range: {ev}")
    ctrl = eenv.cont_agent_mask
    flat = torch.nonzero(ctrl.reshape(-1))[:, 0]
    half = torch.zeros(ctrl.numel(), dtype=torch.bool, device=dev)
    half[flat[::2]] = True
    half = half.reshape(ctrl.shape)
    masks = {"policy": half & ctrl, "random": ~half & ctrl}
    mp = multi_policy_rollout(
        eenv, {"policy": actor, "random": RandomActor(
            None, eenv.action_space_n, seed=SEED)}, masks)
    results["eval"] = dict(ev={k: ev[k] for k in ("goal_achieved",
                                                  "collided", "off_road")},
                           seconds=ev_s, multi=mp)
    print(f"[dataset] evaluate_policy, 2 batches of {W} worlds with a swap, "
          f"the CLI's policy.pt (argmax): goal {ev['goal_achieved']:.4f}, "
          f"collided {ev['collided']:.4f}, off-road {ev['off_road']:.4f}; "
          f"{ev_s:.2f} s")
    print(f"[dataset] multi_policy_rollout, PolicyActor and RandomActor on "
          f"halves of the controlled agents: {mp}")
    del eenv

    # ---- (4) IPPO ------------------------------------------------------------
    senv = SB3MultiAgentEnv(cli_cfg, loader(seed + 5), device=dev)
    icfg = IPPOConfig(n_steps=16, n_epochs=1, batch_size=8192,
                      resample_freq=1)
    ippo = IPPO(senv, icfg, PolicyConfig(fused_embed=True), seed=SEED)
    n0 = senv.num_envs
    t0 = time.time()
    hist = ippo.learn(total_timesteps=n0 * icfg.n_steps + 1)
    torch.cuda.synchronize()
    ippo_s = time.time() - t0
    check(len(hist) == 2, f"IPPO: {len(hist)} rollouts, expected 2")
    check(all(np.isfinite(v) for m in hist for v in m.values()),
          f"IPPO: a metric is not finite: {hist}")
    mb = next(ippo.buffer.get(icfg.batch_size, np.random.default_rng(0)))
    k4 = uncounted(lambda: k4_against_plain(ippo.policy, mb["obs"], gen))
    results["ippo"] = dict(rollouts=hist, seconds=ippo_s, agents=(
        n0, senv.num_envs), K4_err=k4)
    print(f"[dataset] IPPO: {len(hist)} rollouts of {icfg.n_steps} steps, "
          f"{n0} then {senv.num_envs} agents (one resample), {ippo_s:.2f} s; "
          + "; ".join(", ".join(f"{k} {v:.5g}" for k, v in m.items())
                      for m in hist))
    del senv, ippo, mb

    results["launches"] = counts()
    print(f"[dataset] launches in the phase: {results['launches']}")
    for k in ("K2", "K3", "K4"):
        check(results["launches"][k] > 0, f"the dataset phase did not "
              f"launch {k}")
    return results


# the rnn phase: the recurrent PPO CLI at full width
RNN_WORLDS = 512
RNN_COMPACT = 4416  # >= the controlled agents of the CLI's batch (seed 42)
RNN_CPU_ROWS = 4416  # rows of the policy step held against the CPU


def rnn_phase(root: str, dev) -> dict:
    """Recurrent PPO through ``train_rnn.main`` in process: 512 worlds
    drawn with replacement (seed 42), the flat layout on RNN_COMPACT rows,
    T=32, 4 minibatches x 2 epochs, default PolicyConfig widths and
    lstm_hidden 128; at least 3 float32 iterations
    (--total-timesteps one above twice the most samples an iteration can
    give), then one iteration with --policy-dtype bf16 --obs-store bf16.
    Per iteration the rollout, GAE and update ms (CUDA events), samples
    and train samples/s; the peak memory of each run beside the reckoned
    one; one policy step on the last state's 4,416 rows against the CPU;
    K2 against its plain version at the last state; one more float32
    iteration under torch.profiler for the device's busy share.  K3 and K4
    must not launch.  The launch counts are set to 0 at the start; the
    checks' launches are left out.  Returns {launches, ...}."""
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch
    from torch.profiler import record_function

    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.dataset import SceneDataLoader
    from gpudrive_lab_torch.env.env_torch import flat_observation
    from gpudrive_lab_torch.networks.late_fusion import (
        LateFusionLSTMPolicy,
        PolicyConfig,
    )
    from gpudrive_lab_torch.ppo import train_rnn
    from gpudrive_lab_torch.scene.compiler import compile_world
    from gpudrive_lab_torch.utils.profiling import (
        device_breakdown,
        device_trace,
    )

    pool = os.path.join(root, "data", "pool_v3")
    W, T, M, E = RNN_WORLDS, 32, 4, 2
    params = EnvConfig(dynamics_model="classic",
                       collision_behavior="ignore").sim_params()
    batch = next(iter(SceneDataLoader(pool, W, 1000,
                                      sample_with_replacement=True,
                                      seed=42)))
    n_ctrl = sum(int(compile_world(p, params, frozenset()).agent[
        "controlled"].sum()) for p in batch)
    timesteps = 2 * T * n_ctrl + 1
    rows = RNN_COMPACT * T // M
    # saved for the backward pass per minibatch, float32: the road block's
    # first Linear's output, its LayerNorm's input statistics and the tanh
    # output ([rows, 200, 64] each), the partner block's likewise ([rows,
    # 127, 64]), the second Linear's output before the max (transient)
    gb = rows * 64 * 4 / 1e9
    reckoned = 3 * gb * (200 + 127) + gb * 200 + rows * 3368 * 4 / 1e9
    print(f"[rnn] {W} worlds, {n_ctrl} controlled agents, --compact "
          f"{RNN_COMPACT}; minibatch {RNN_COMPACT // M} rows x T {T} = "
          f"{rows} rows; one [{rows}, 200, 64] float32 activation "
          f"{gb * 200:.2f} GB; reckoned update peak about {reckoned:.1f} GB "
          f"beyond the env and the stored trajectory")
    set_counts(dict.fromkeys(counts(), 0))
    results = {"runs": []}
    with tempfile.TemporaryDirectory() as ckpt:
        for what, extra in (
                ("float32", ["--total-timesteps", str(timesteps)]),
                ("bf16", ["--total-timesteps", "1", "--policy-dtype", "bf16",
                          "--obs-store", "bf16"])):
            argv = ["--device", dev.type, "--data-dir", pool, "--num-worlds",
                    str(W), "--compact", str(RNN_COMPACT), "--rollout-len",
                    str(T), "--num-minibatches", str(M), "--update-epochs",
                    str(E), "--checkpoint-path",
                    os.path.join(ckpt, what)] + extra
            print(f"[rnn] train_rnn.main {' '.join(argv)}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with PhaseTimer() as timer:
                t0 = time.time()
                trained = train_rnn.main(argv)
                torch.cuda.synchronize()
                wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            iters = timer.iterations()
            with open(os.path.join(ckpt, what, "rnn.metrics.jsonl")) as f:
                logs = [json.loads(line) for line in f]
            rec = logs[-1]
            check(all(np.isfinite(rec[k]) for k in ("pg_loss", "v_loss",
                                                     "entropy")),
                  f"rnn {what}: a loss is not finite: {rec}")
            steps = rec["global_step"]
            for i, ph in enumerate(iters):
                print(f"[rnn] {what} iteration {i}: rollout "
                      f"{ph['rollout']:.3f} ms, gae {ph['gae']:.3f} ms, "
                      f"update {ph['update']:.3f} ms (CUDA events)")
            print(f"[rnn] {what}: {len(iters)} iterations, {steps} samples, "
                  f"mean train samples/s {steps / sum(sum(p.values()) for p in iters) * 1e3:.1f}"
                  f" (samples / the iterations' event time), wall "
                  f"{wall:.2f} s (env build included); peak memory "
                  f"{peak:.2f} GB; last losses pg {rec['pg_loss']}, v "
                  f"{rec['v_loss']}, entropy {rec['entropy']}")
            results["runs"].append(dict(dtype=what, iterations=iters,
                                        samples=steps, peak_gb=peak,
                                        wall_s=wall))
            if what == "float32":
                check(len(iters) >= 3, f"rnn: {len(iters)} float32 "
                      "iterations, expected at least 3")
                # the CLI's env, trainer and carry after its last rollout
                rnn_env, rnn, carry, fresh = trained
                scene, rw = rnn_env.scene, rnn_env.reward_weights
                ckpt_f32 = torch.load(os.path.join(ckpt, what,
                                                   train_rnn.CHECKPOINT),
                                      map_location="cpu")
            else:
                check(len(iters) == 1, f"rnn bf16: {len(iters)} iterations")
            del timer, trained
    launches = counts()
    results["launches"] = launches
    print(f"[rnn] launches in the phase: {launches}")
    check(launches["K2"] > 0, "the rnn phase did not launch K2")
    for k in ("K1", "K3", "K4", "K3-bf16", "K4-bf16"):
        check(launches[k] == 0, f"the rnn phase launched {k}")

    # one policy step on the last state's rows, card against CPU
    cidx = rnn.ctrl_slots(scene)
    obs = flat_observation(scene, carry.state, rnn.params, rnn.spec, rw,
                           cidx)[0][:RNN_CPU_ROWS]
    lstm = tuple(x[:RNN_CPU_ROWS] for x in carry.lstm)
    done = rnn.reset_signal(carry.state, carry.just_reset, cidx)[
        :RNN_CPU_ROWS]
    outs = []
    for device in (dev, torch.device("cpu")):
        pol = LateFusionLSTMPolicy(PolicyConfig(), device=device)
        pol.load_state_dict(ckpt_f32["policy"])
        with torch.no_grad():
            (c, h), logits, value = pol(obs.to(device),
                                        tuple(x.to(device) for x in lstm),
                                        done.to(device))
        outs.append([x.cpu() for x in (c, h, logits, value)])
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    check(err <= 1e-4, f"rnn: the policy step on the card differs from the "
          f"CPU by {err}")
    results["cpu_err"] = err
    print(f"[rnn] one LSTM policy step on {RNN_CPU_ROWS} rows of the last "
          f"state, the trained weights: card against CPU max abs diff "
          f"{err:.3g} (carries, logits, value; bar 1e-4)")
    uncounted(lambda: k2_against_plain(
        SimpleNamespace(scene=scene, state=carry.state),
        "at the rnn CLI's last state", "[rnn]"))

    # one more float32 iteration under torch.profiler: the busy share
    phases = ("rollout", "gae", "update")
    init_lstm = carry.lstm
    with device_trace() as prof:
        t0 = time.time()
        with record_function("rollout"):
            carry, traj = rnn.rollout(scene, carry, fresh, rw)
        with record_function("gae"):
            batch = rnn.prepare(scene, carry, traj, rw)
        with record_function("update"):
            rnn.learn(batch, init_lstm)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    busy, by_name, by_phase = device_breakdown(prof, phases)
    busy /= 1e3
    results["profile"] = dict(wall_ms=wall, busy_ms=busy,
                              by_phase={p: us / 1e3 for p, us in
                                        by_phase.items()},
                              activities=sum(c for _, c in by_name.values()))
    print(f"[rnn profile] wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(busy share {busy / wall:.3f}), "
          f"{results['profile']['activities']} device activities; device "
          + ", ".join(f"{p} {us / 1e3:.3f} ms" for p, us in by_phase.items()))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, cnt) in ranked[:10]:
        print(f"[rnn profile] {us / 1e3:10.3f} ms {cnt:6d}x  {name}")
    return results


# the il phase: the BC CLI, closed-loop analysis and probes
IL_WORLDS = 16
IL_CPU_ROWS = 512  # BC net rows held against the CPU
IL_CLOSED_LOOP_STEPS = 46  # half an episode keeps the two phases near 60 s


def il_phase(root: str, dev) -> dict:
    """Behavior cloning at full width through ``il.train.main`` in process:
    --num-worlds 16 --num-batches 2 --epochs 1 --batch-size 256
    --eval-heldout (91 all-expert delta_local steps of data generation per
    batch, a swap between them; the default BCConfig, num_stack 5,
    network_dim 128, 4 heads); then, with the saved policy, the first
    batch's data generated again, ``closed_loop_rollout`` over it for
    IL_CLOSED_LOOP_STEPS steps with importance, tokens and states, ``probe_action_and_position`` and the
    position probes with an intervention; the BC net on 512 dataset rows
    (8 of them with every partner masked) against the CPU; K2 against its
    plain version.  The launch counts are set to 0 at the start; the
    checks' launches are left out.  Returns {launches, ...}."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import numpy as np
    import torch

    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.dataset import SceneDataLoader
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.il import analysis
    from gpudrive_lab_torch.il import data_generation as gen_mod
    from gpudrive_lab_torch.il import train as il_train
    from gpudrive_lab_torch.il.dataset import ExpertDataset
    from gpudrive_lab_torch.il.linear_probing import (
        ProbeConfig,
        probe_action_and_position,
    )

    pool = os.path.join(root, "data", "pool_v3")
    set_counts(dict.fromkeys(counts(), 0))
    results = {}
    timings = {"gen": [], "steps": []}
    real_gen = gen_mod.generate_state_action_pairs
    real_make = il_train.make_bc_train_step

    def timed_gen(env, *a, **k):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real_gen(env, *a, **k)
        torch.cuda.synchronize()
        timings["gen"].append(time.time() - t0)
        return out

    def timed_make(model, cfg):
        opt, step = real_make(model, cfg)

        def step_timed(batch):
            loss = step(batch)
            timings["steps"].append(loss)
            return loss
        return opt, step_timed

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bc_policy.pt")
        argv = ["--device", dev.type, "--data-dir", pool, "--num-worlds",
                str(IL_WORLDS), "--num-batches", "2", "--epochs", "1",
                "--batch-size", "256", "--eval-heldout", "--out", out]
        print(f"[il] il.train.main {' '.join(argv[:-1])} <tmp>")
        il_train.generate_state_action_pairs = timed_gen
        il_train.make_bc_train_step = timed_make
        buf = io.StringIO()
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                il_train.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            il_train.generate_state_action_pairs = real_gen
            il_train.make_bc_train_step = real_make
        printed = buf.getvalue().splitlines()
        for line in printed:
            print(f"[il] | {line}")
        model = il_train.load_policy(out, device=dev)
    lines = [json.loads(x) for x in printed if x.startswith("{")]
    epoch = [x for x in lines if "epoch" in x]
    evals = {x["split"]: x for x in lines if "split" in x}
    check(len(epoch) == 1 and np.isfinite(epoch[0]["loss"]),
          f"il: epoch lines {epoch}")
    check("train" in evals and "heldout" in evals, f"il: evaluations {evals}")
    check("skipped" not in evals["heldout"], f"il: heldout {evals}")
    for split in ("train", "heldout"):
        check(all(0.0 <= evals[split][k] <= 1.0 for k in (
            "goal_rate", "collision_rate", "off_road_rate")),
            f"il: {split} rates out of range")
    n_steps = len(timings["steps"])
    check(n_steps > 0, "il: no BC step ran")
    gen_s = sum(timings["gen"])
    results.update(gen_s=timings["gen"], bc_steps=n_steps, wall_s=wall,
                   evals=evals, loss=epoch[0]["loss"],
                   train_s=epoch[0]["elapsed"])
    print(f"[il] CLI: data generation {', '.join(f'{t:.3f}' for t in timings['gen'])}"
          f" s per batch of {IL_WORLDS} worlds x 91 steps; {n_steps} BC "
          f"steps of 256 in {epoch[0]['elapsed']} s ({n_steps / max(epoch[0]['elapsed'], 1e-9):.1f} steps/s, "
          f"the CLI's clock); wall {wall:.2f} s in all (data, training, "
          f"two 91-step evaluations); train {evals['train']}; heldout "
          f"{evals['heldout']}")

    # the first batch again: data, dataset, closed loop, probes
    batch = next(iter(SceneDataLoader(pool, IL_WORLDS, 100000)))
    cfg = EnvConfig(dynamics_model="delta_local",
                    collision_behavior="ignore", max_controlled_agents=0)
    env = GPUDriveTorchEnv(cfg, batch, device=dev)
    data = gen_mod.generate_state_action_pairs(env)
    data["controlled_mask"] = data["valid_mask"]
    ds = ExpertDataset(data, rollout_len=model.config.num_stack, device=dev)
    eval_env = GPUDriveTorchEnv(dataclasses.replace(
        cfg, max_controlled_agents=128), batch, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    res = analysis.closed_loop_rollout(eval_env, model, model.config,
                                       max_steps=IL_CLOSED_LOOP_STEPS,
                                       collect_importance=True,
                                       collect_tokens=True,
                                       collect_states=True)
    torch.cuda.synchronize()
    cl_s = time.time() - t0
    imp = res.importance
    check(bool(torch.isfinite(imp).all()) and float(
        (imp.sum(-1) - 1).abs().max()) <= 1e-4,
        "il: importance weights do not sum to 1")
    check(all(0.0 <= res.metrics[k] <= 1.0 for k in (
        "goal_rate", "collision_rate", "off_road_rate", "goal_progress")),
        f"il: closed-loop metrics {res.metrics}")
    results["closed_loop"] = dict(metrics=res.metrics, seconds=cl_s,
                                  steps=imp.shape[0])
    print(f"[il] closed_loop_rollout, {IL_WORLDS} worlds x {imp.shape[0]} "
          f"steps with importance {list(imp.shape)}, tokens "
          f"{list(res.ro_tokens.shape)} and states: {cl_s:.2f} s; "
          f"{res.metrics}")
    del res
    pcfg = ProbeConfig(epochs=1)
    t0 = time.time()
    probes = probe_action_and_position(model, ds, None, pcfg)
    tokens = analysis.extract_token_dataset(model, ds)
    labels = analysis.probe_labels_from_positions(ds, future_step=5)
    t, w, a = ds.index_t.unbind(1)
    valid = ds.data["partner_mask"][t, w, a] == 0
    ego_probe, other_probe, pm = analysis.train_position_probes(
        tokens, labels, valid, pcfg)
    iv = analysis.intervention_effect(ego_probe, other_probe,
                                      tokens["ego"][:256], 10)
    torch.cuda.synchronize()
    probe_s = time.time() - t0
    for name, m in list(probes.items()) + list(pm.items()):
        check(np.isfinite(m["loss"]) and 0.0 <= m["accuracy"] <= 1.0,
              f"il: probe {name} {m}")
    moved = float((iv["ego_pred"] != iv["ego_pred_prime"]).float().mean())
    results["probes"] = dict(action_position=probes, position=pm,
                             intervention_moved=moved, seconds=probe_s,
                             samples=len(ds))
    print(f"[il] probes on {len(ds)} samples: {probes}; position probes "
          f"{pm}; intervention moved {moved:.4f} of 256 ego predictions; "
          f"{probe_s:.2f} s")

    # the BC net on 512 rows, card against CPU
    rows = ds.batch(np.arange(0, len(ds), max(len(ds) // IL_CPU_ROWS, 1))[
        :IL_CPU_ROWS])
    rows["partner_mask"][:8] = True
    cpu = il_train.EarlyFusionAttnBCNet(model.config, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    outs = []
    for net, device in ((model, dev), (cpu, torch.device("cpu"))):
        with torch.no_grad():
            ctx, gmm, rec = net(rows["obs"].to(device),
                                rows["partner_mask"].to(device),
                                rows["road_mask"].to(device), record=True)
        outs.append([x.cpu() for x in (ctx, *gmm,
                                       rec["attn"]["ego_ro_cross.attn"])])
    err = max(float((a - b).abs().max() / max(1.0, float(b.abs().max())))
              for a, b in zip(*outs))
    check(err <= 1e-4, f"il: the BC net on the card differs from the CPU "
          f"by {err}")
    uni = outs[0][-1][:8]
    check(float((uni - 1 / 127).abs().max()) <= 1e-6,
          "il: rows with no live partner do not get uniform attention")
    results["cpu_err"] = err
    print(f"[il] BC net on {len(rows['obs'])} dataset rows (8 with every "
          f"partner masked): card against CPU max diff {err:.3g} of the "
          f"largest magnitude (context, means, variances, weights, "
          f"ego->partner attention; bar 1e-4); masked rows uniform")
    uncounted(lambda: k2_against_plain(eval_env, "at the closed loop's "
                                       "last state", "[il]"))
    launches = counts()
    results["launches"] = launches
    print(f"[il] launches in the phase: {launches}")
    check(launches["K2"] > 0, "the il phase did not launch K2")
    return results


def k4_against_plain(policy, obs, gen) -> float:
    """K4 on a minibatch's partner and road slices against its plain
    version at phase 5's bar; returns the max abs error."""
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    err = 0.0
    with torch.no_grad():
        for bname, w, x in embed_blocks(policy, obs):
            _, arg = fe.fused_embed_pool_fwd(x, *w, "tanh")
            dpool = torch.randn(arg.shape, generator=gen, device=x.device)
            e, rel = k4_grad_check(x, w, arg, dpool, f"K4 IPPO {bname}")
            err = max(err, e)
            print(f"[dataset] K4 IPPO minibatch after the resample, {bname} "
                  f"{list(x.shape)}: {rel:.3g} of the largest gradient, two "
                  f"launches bitwise equal")
    return err


# the vbd phase: diffusion sim agents at the official model's full width
VBD_WORLDS = 64  # worlds of the env and of the official model's batch
VBD_GUIDED_WORLDS = 4  # worlds of each guided sampler's run
VBD_CPU_WORLDS = 2  # worlds whose encoder and denoise step meet the CPU's
VBD_TRAIN_STEPS = 20  # Adam steps on denoise_loss
# the card against the CPU in a half compute dtype: the bar of
# tests/test_torch_vbd_dtype.py's model outputs, 6 units of roundoff (the
# same one-ulp rounding flips where sums run in another order)
VBD_DTYPE_CPU_BAR = {"bfloat16": 6 * 2.0 ** -8, "float16": 6 * 2.0 ** -11}


class CallTimer:
    """CUDA events around each call of the named callables while
    installed: ``targets`` holds (name, owner, attribute); an instance
    attribute set here is removed again on exit."""

    def __init__(self, targets):
        self.targets = targets
        self.marks = []

    def __enter__(self):
        import torch

        self.saved = []
        for name, owner, attr in self.targets:
            orig = getattr(owner, attr)
            own = attr in vars(owner)

            def timed(*a, _f=orig, _n=name, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _f(*a, **k)
                end.record()
                self.marks.append((_n, start, end))
                return out
            setattr(owner, attr, timed)
            self.saved.append((owner, attr, orig, own))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig, own in self.saved:
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)

    def totals(self) -> dict:
        """{name: (ms summed over the calls, calls)}."""
        import torch

        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.marks:
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + a.elapsed_time(b), n + 1)
        return out


def vbd_tpu_first_sample(env, vcfg, dev) -> tuple:
    """A VBDTrajectorySource of the TPU-first model at ``vcfg`` (its
    compute dtype; weights seeded SEED, the same in every dtype) into
    env.set_vbd_trajectories on the env's worlds: the sample batch (host),
    each encoder and denoiser call and the whole sample timed with CUDA
    events, peak memory beside.  Checks the trajectories finite, one
    denoiser call a diffusion step and at least one agent row predicted.
    Returns (the model, its record)."""
    import torch

    from gpudrive_lab_torch.vbd import integration
    from gpudrive_lab_torch.vbd import model as vmodel

    name = str(vcfg.dtype).removeprefix("torch.")
    vbd = vmodel.VBDModel(vcfg, device=dev,
                          generator=torch.Generator().manual_seed(SEED))
    vbd.eval()
    src = integration.VBDTrajectorySource(
        vbd, vmodel.DDPMScheduler(vcfg.diffusion_steps), vcfg, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9
    with CallTimer([("batch", integration, "process_scenario_data"),
                    ("sample", integration, "sample_denoiser"),
                    ("encode", vbd.encoder, "forward"),
                    ("denoise", vbd.denoiser, "forward")]) as ct:
        t0 = time.time()
        env.set_vbd_trajectories(src)
        torch.cuda.synchronize()
        wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    tot = ct.totals()
    traj = env.vbd_trajectories
    check(tuple(traj.shape) == (env.num_worlds, env.max_agent_count, 91, 5)
          and traj.dtype == torch.float32 and bool(torch.isfinite(traj).all()),
          f"vbd: {name} VBDTrajectorySource trajectories")
    rows = int((traj.abs().sum((-1, -2)) > 0).sum())
    check(rows > 0, f"vbd: {name}: no agent row was predicted")
    check(tot["denoise"][1] == vcfg.diffusion_steps,
          f"vbd: {name}: {tot['denoise'][1]} denoiser calls")
    rec = dict(dtype=name, wall_s=wall, peak_gb=peak, base_gb=base,
               batch_ms=tot["batch"][0], sample_ms=tot["sample"][0],
               encode_ms=tot["encode"][0] / tot["encode"][1],
               denoise_step_ms=tot["denoise"][0] / tot["denoise"][1],
               steps=tot["denoise"][1], rows=rows)
    print(f"[vbd] VBDTrajectorySource, VBDConfig(dtype={name}) "
          f"({vcfg.encoder_layers} layers, {vcfg.hidden_dim} wide, "
          f"{vcfg.num_heads} heads, {vcfg.agents_len} agents, "
          f"{vcfg.diffusion_steps} steps) on {env.num_worlds} worlds: sample "
          f"batch {rec['batch_ms']:.1f} ms (host), sample "
          f"{rec['sample_ms']:.2f} ms: encode {rec['encode_ms']:.3f} ms and "
          f"denoise {rec['denoise_step_ms']:.3f} ms a step (the sampler "
          f"encodes at every step; CUDA events); wall {wall:.3f} s; peak "
          f"memory {peak:.3f} GB ({base:.3f} GB held before); {rows} agent "
          f"rows predicted")
    return vbd, rec


def vbd_dtype_against_cpu(batch, dev, dtype) -> dict:
    """VBDConfig()'s encoder and one denoiser forward in compute dtype
    ``dtype`` on the card and on the CPU, the same seeded weights and
    inputs: max |card - CPU| over max |CPU| of the tokens and of the
    denoised actions (float32 both), held to VBD_DTYPE_CPU_BAR."""
    import torch

    from gpudrive_lab_torch.vbd import model as vmodel

    cfg = vmodel.VBDConfig(dtype=dtype)
    name = str(dtype).removeprefix("torch.")
    card = vmodel.VBDModel(cfg, device=dev,
                           generator=torch.Generator().manual_seed(SEED))
    cpu = vmodel.VBDModel(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    n = VBD_CPU_WORLDS
    x = torch.randn((n, cfg.agents_len, cfg.action_blocks, 2),
                    generator=torch.Generator().manual_seed(SEED))
    step = torch.full((n, cfg.agents_len), cfg.diffusion_steps - 1)
    outs = []
    for m, d in ((card, dev), (cpu, torch.device("cpu"))):
        b = {k: v[:n].to(d) for k, v in batch.items()}
        with torch.no_grad():
            tokens, valid = m.encode(b)
            den = m.denoiser(tokens, valid, x.to(d), step.to(d))
        outs.append({"tokens": tokens.cpu(), "denoise": den.cpu()})
    errs = {k: float((outs[0][k] - v).abs().max() / v.abs().max())
            for k, v in outs[1].items()}
    bar = VBD_DTYPE_CPU_BAR[name]
    mm = torch.backends.cuda.matmul
    check(all(v == v for v in errs.values()) and max(errs.values()) <= bar,
          f"vbd: {name} on the card differs from the CPU: {errs}")
    print(f"[vbd] VBDConfig(dtype={name}) encoder and one denoise step on "
          f"{n} worlds, card against CPU: max |diff| / max |CPU| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (bar {bar:.3g}: tests/test_torch_vbd_dtype.py's 6 u); "
          f"cuBLAS reduced-precision reductions allowed: bf16 "
          f"{mm.allow_bf16_reduced_precision_reduction}, fp16 "
          f"{mm.allow_fp16_reduced_precision_reduction}")
    return errs


def vbd_phase(root: str, dev) -> dict:
    """VBD diffusion sim agents on the card.  The env on the first
    VBD_WORLDS pool_v3 worlds, 128 agent rows, use_vbd with vbd_in_obs and
    the distance_to_vdb_trajs reward.  (1) set_vbd_trajectories with an
    OfficialVBDSource at full width (OfficialVBDConfig(): 6 layers, 256
    wide, 8 heads, 32 agents, 50 diffusion steps; seeded random weights):
    the sample batch, the encode, the 50 denoise steps and the scatter
    timed with CUDA events, peak memory beside the phase's reckoning;
    (2) 91 env steps on expert actions with the VBD obs and reward, K2
    against its plain version at the last state; (3) a VBDTrajectorySource
    with VBDConfig() (10 steps), then (3b) with VBDConfig(dtype=bfloat16),
    each timed (encode, each denoise step, the sample; peak memory), and
    91 expert env steps on the bf16 trajectories (K2 counted); (4) one
    ctg, one waymo and one ibr run on VBD_GUIDED_WORLDS worlds, (4b) ctg in
    bf16; (5) VBD_TRAIN_STEPS Adam steps on denoise_loss (finite, falling),
    (5b) the same in bf16 (float32 parameters); (6) on VBD_CPU_WORLDS
    worlds the full-width official encoder and one denoise step on the card
    against the same functions on the CPU, TF32 off (1e-4 of the largest
    magnitude), (6b) VBDConfig()'s encoder and one denoise step in bf16 and
    in float16 likewise (VBD_DTYPE_CPU_BAR).  The launch counts are set to
    0 at the start and again before (3b)'s env steps; the checks' launches
    are left out.  Returns {launches (the phase's), bf16_launches (3b's
    steps), ...}."""
    import torch

    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import (
        GPUDriveTorchEnv,
        expert_actions,
    )
    from gpudrive_lab_torch.rollout import SLICE_CONFIG, pool_scene_paths
    from gpudrive_lab_torch.vbd import guidance, integration
    from gpudrive_lab_torch.vbd import guidance_metrics as gm
    from gpudrive_lab_torch.vbd import model as vmodel
    from gpudrive_lab_torch.vbd import model_official as vofficial
    from gpudrive_lab_torch.vbd.data_utils import (
        VBDSampleConfig,
        official_inputs,
        process_scenario_data,
    )

    W = VBD_WORLDS
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[vbd] every time below on {card}")
    set_counts(dict.fromkeys(counts(), 0))
    results = {"card": card}
    env = GPUDriveTorchEnv(EnvConfig(**dict(
        SLICE_CONFIG, use_vbd=True, vbd_in_obs=True,
        reward_type="distance_to_vdb_trajs")),
        pool_scene_paths(root)[:W], device=dev)
    A = env.max_agent_count
    check(A == 128, f"vbd: {A} agent rows, expected 128")
    ocfg = vofficial.OfficialVBDConfig()
    sample = VBDSampleConfig(max_agents=ocfg.agents_len)
    S = ocfg.agents_len + sample.max_polylines + 16
    rel_gb = W * S * S * 256 * 4 / 1e9
    print(f"[vbd] OfficialVBD at full width: {ocfg.encoder_layers} layers, "
          f"256 wide, {ocfg.num_heads} heads, {ocfg.agents_len} agents, "
          f"{ocfg.diffusion_steps} diffusion steps; {W} worlds, S = "
          f"{ocfg.agents_len} + {sample.max_polylines} + 16 = {S} tokens; "
          f"the relation encodings [{W}, {S}, {S}, 256] float32 {rel_gb:.2f}"
          f" GB; reckoned peak about {4 * rel_gb:.1f} GB (the relation "
          f"encoder's running sum, one MLP stage's input and output, and a "
          f"copy of the relations for the relative terms)")
    model = vofficial.OfficialVBD(
        ocfg, device=dev, generator=torch.Generator().manual_seed(SEED)).eval()
    source = integration.OfficialVBDSource(model, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9
    with CallTimer([("batch", integration, "process_scenario_data"),
                    ("inputs", integration, "official_inputs"),
                    ("encode", model, "encode"),
                    ("denoise", model, "denoise"),
                    ("scatter", integration, "scatter_trajectories")]) as ct:
        t0 = time.time()
        env.set_vbd_trajectories(source)
        torch.cuda.synchronize()
        wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    tot = ct.totals()
    check(tot["denoise"][1] == ocfg.diffusion_steps,
          f"vbd: {tot['denoise'][1]} denoise calls")
    traj = env.vbd_trajectories
    check(tuple(traj.shape) == (W, A, 91, 5) and bool(
        torch.isfinite(traj).all()), "vbd: official trajectories")
    rows = int((traj.abs().sum((-1, -2)) > 0).sum())
    check(rows > 0, "vbd: no agent row was predicted")
    results["official"] = dict(
        wall_s=wall, peak_gb=peak, base_gb=base, reckoned_gb=4 * rel_gb,
        **{f"{k}_ms": v[0] for k, v in tot.items()},
        denoise_step_ms=tot["denoise"][0] / tot["denoise"][1], rows=rows)
    print(f"[vbd] OfficialVBDSource on {W} worlds: sample batch "
          f"{tot['batch'][0]:.1f} ms (host), inputs and relations "
          f"{tot['inputs'][0]:.1f} ms, encode {tot['encode'][0]:.1f} ms, "
          f"{tot['denoise'][1]} denoise steps {tot['denoise'][0]:.1f} ms "
          f"({results['official']['denoise_step_ms']:.2f} ms a step), "
          f"scatter {tot['scatter'][0]:.3f} ms (CUDA events); wall "
          f"{wall:.2f} s; peak memory {peak:.2f} GB ({base:.2f} GB held "
          f"before; reckoned {4 * rel_gb:.1f}); {rows} agent rows predicted")

    # (2) 91 env steps on expert actions with the VBD obs and reward
    acts = expert_actions(env.scene, "classic")
    torch.cuda.synchronize()
    t0 = time.time()
    for t in range(STEPS):
        env.step_dynamics(acts[:, :, t])
        obs = env.get_obs()
        rew = env.get_rewards()
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3 / STEPS
    check(tuple(obs.shape) == (W, A, 3368 + 455), f"vbd obs {obs.shape}")
    check(bool(torch.isfinite(obs).all() and torch.isfinite(rew).all()),
          "vbd: obs or rewards not finite")
    results["env_step_ms"] = step_ms
    print(f"[vbd] {STEPS} expert steps with the VBD obs and reward: "
          f"{step_ms:.3f} ms a step (step, obs, reward; host clock); reward "
          f"sum at the last step {float(rew.sum()):.3f}")
    results["launches"] = counts()
    uncounted(lambda: k2_against_plain(env, "at the vbd env's last state",
                                       "[vbd]"))

    # (3) the TPU-first denoiser at VBDConfig() defaults, float32
    vcfg = vmodel.VBDConfig()
    vbd, results["tpu_first"] = vbd_tpu_first_sample(env, vcfg, dev)
    results["vbd_source_s"] = results["tpu_first"]["wall_s"]
    # (3b) the same model, weights and state in bf16
    bcfg = vmodel.VBDConfig(dtype=torch.bfloat16)
    vbd_bf16, results["tpu_first_bf16"] = vbd_tpu_first_sample(env, bcfg,
                                                                dev)
    f32, b16 = results["tpu_first"], results["tpu_first_bf16"]
    print(f"[vbd] bf16 over float32: sample "
          f"{b16['sample_ms'] / f32['sample_ms']:.3f}x, encode "
          f"{b16['encode_ms'] / f32['encode_ms']:.3f}x, denoise step "
          f"{b16['denoise_step_ms'] / f32['denoise_step_ms']:.3f}x, peak "
          f"memory above the held {(b16['peak_gb'] - b16['base_gb']):.3f} "
          f"against {(f32['peak_gb'] - f32['base_gb']):.3f} GB")
    # 91 expert env steps on the bf16 trajectories, K2 counted
    env.reset()
    set_counts(dict.fromkeys(counts(), 0))
    torch.cuda.synchronize()
    t0 = time.time()
    for t in range(STEPS):
        env.step_dynamics(acts[:, :, t])
        obs = env.get_obs()
        rew = env.get_rewards()
    torch.cuda.synchronize()
    results["bf16_env_step_ms"] = (time.time() - t0) * 1e3 / STEPS
    results["bf16_launches"] = counts()
    check(bool(torch.isfinite(obs).all() and torch.isfinite(rew).all()),
          "vbd: obs or rewards on the bf16 trajectories not finite")
    check(results["bf16_launches"]["K2"] > 0,
          "vbd: the env steps on the bf16 trajectories did not launch K2")
    print(f"[vbd] {STEPS} expert steps on the bf16 trajectories: "
          f"{results['bf16_env_step_ms']:.3f} ms a step (host clock); reward "
          f"sum at the last step {float(rew.sum()):.3f}; launches "
          f"{results['bf16_launches']}")
    results["launches"] = {k: v + results["bf16_launches"][k]
                           for k, v in results["launches"].items()}

    # (4) the guided samplers on a few worlds
    batch = process_scenario_data(env.scene, env.state, 0,
                                  VBDSampleConfig(max_agents=vcfg.agents_len))
    small = {k: v[:VBD_GUIDED_WORLDS] for k, v in batch.items()}
    ids = small["agents_id"].long().clamp(min=0)
    goals = torch.gather(
        env.scene.agents.traj_pos[:VBD_GUIDED_WORLDS, :, vcfg.future_len],
        1, ids[..., None].expand(-1, -1, 2))
    sched = vmodel.DDPMScheduler(vcfg.diffusion_steps)
    results["guided_s"] = {}
    for mode, kw in (
            ("ctg", dict(guidance=[guidance.goal_guidance(goals),
                                   guidance.collision_guidance()],
                         guidance_iter=2)),
            ("waymo", dict(rewards=[gm.overlap_reward(), gm.onroad_reward()],
                           guidance_iter=2)),
            ("ibr", dict(ego_idx=0, adv_idx=1, ego_iter=2, adv_iter=2,
                         guidance_iter=2))):
        torch.cuda.synchronize()
        t0 = time.time()
        out = guidance.GUIDANCE_MODES[mode](
            vbd, sched, small, vcfg,
            torch.Generator(dev).manual_seed(SEED), **kw)
        torch.cuda.synchronize()
        results["guided_s"][mode] = time.time() - t0
        check(all(bool(torch.isfinite(v).all()) for v in out.values()),
              f"vbd: the {mode} sampler's output is not finite")
        print(f"[vbd] {mode} guided sampling on {VBD_GUIDED_WORLDS} worlds, "
              f"{vcfg.diffusion_steps} steps, {kw.get('guidance_iter')} "
              f"guidance iterations: {results['guided_s'][mode]:.3f} s")
    # (4b) ctg in bf16
    torch.cuda.synchronize()
    t0 = time.time()
    out = guidance.sample_denoiser_guided(
        vbd_bf16, sched, small, bcfg, torch.Generator(dev).manual_seed(SEED),
        guidance=[guidance.goal_guidance(goals),
                  guidance.collision_guidance()], guidance_iter=2)
    torch.cuda.synchronize()
    results["guided_s"]["ctg_bf16"] = time.time() - t0
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          "vbd: the bf16 ctg sampler's output is not finite")
    print(f"[vbd] ctg guided sampling in bf16 on {VBD_GUIDED_WORLDS} worlds: "
          f"{results['guided_s']['ctg_bf16']:.3f} s")

    # (5) denoise_loss with Adam: the log's future as ground truth
    ag = env.scene.agents
    ids = batch["agents_id"].long().clamp(min=0)
    fut = torch.cat([ag.traj_pos, ag.traj_yaw[..., None], ag.traj_vel], -1)
    fut = torch.gather(fut[:, :, 1:vcfg.future_len + 1], 1, ids[
        ..., None, None].expand(-1, -1, vcfg.future_len, 5))
    gt = vmodel.inverse_roll_out(fut, vmodel.current_states(
        batch, vcfg.agents_len), action_len=vcfg.action_len)
    for key, m, cfg in (("train", vbd, vcfg), ("train_bf16", vbd_bf16, bcfg)):
        m.train()
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        gen = torch.Generator(dev).manual_seed(SEED)
        losses = []
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(VBD_TRAIN_STEPS):
            loss = vmodel.denoise_loss(m, sched, batch, gt, cfg, gen)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        train_s = time.time() - t0
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        name = str(cfg.dtype).removeprefix("torch.")
        check(all(torch.isfinite(torch.tensor(losses))) and last < first,
              f"vbd: {name} denoise_loss did not fall: {losses}")
        check(all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                  for p in m.parameters() if p.grad is not None),
              f"vbd: {name} parameters or gradients not float32")
        results[key] = dict(losses=losses, s=train_s)
        print(f"[vbd] {VBD_TRAIN_STEPS} Adam steps on denoise_loss ({W} "
              f"worlds, VBDConfig(dtype={name}); float32 parameters): loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (means of the first and "
              f"last 5: {first:.4f}, {last:.4f}); {train_s:.2f} s")

    # (6) the full-width encoder and one denoise step, card against CPU
    n = VBD_CPU_WORLDS
    inputs = official_inputs({k: v[:n] for k, v in batch.items()})
    cpu = vofficial.OfficialVBD(ocfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.randn((n, ocfg.agents_len, ocfg.seq_len, 2),
                    generator=torch.Generator().manual_seed(SEED))
    step = torch.full((n, ocfg.agents_len), ocfg.diffusion_steps - 1)
    outs = []
    for m, d in ((model, dev), (cpu, torch.device("cpu"))):
        with torch.no_grad():
            enc = m.encode({k: v.to(d) for k, v in inputs.items()})
            den = m.denoise(enc, x.to(d), step.to(d))
        outs.append({"encodings": enc["encodings"].cpu(),
                     "relation_encodings": enc["relation_encodings"].cpu(),
                     "denoise": den.cpu()})
    errs = {k: float((outs[0][k] - v).abs().max() / v.abs().max())
            for k, v in outs[1].items()}
    results["cpu_err"] = errs
    check(max(errs.values()) <= 1e-4, f"vbd: the card differs from the CPU: "
          f"{errs}")
    print(f"[vbd] full-width encoder and one denoise step on {n} worlds, "
          f"card against CPU (TF32 off): max |diff| / max |CPU| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + " (bar 1e-4)")
    # (6b) the TPU-first model in bf16 and float16, card against CPU
    results["dtype_cpu_err"] = {
        str(dt).removeprefix("torch."): vbd_dtype_against_cpu(batch, dev, dt)
        for dt in (torch.bfloat16, torch.float16)}
    launches = results["launches"]
    print(f"[vbd] launches in the phase: {launches}")
    check(launches["K2"] > 0, "the vbd phase did not launch K2")
    for k in ("K1", "K3", "K4", "K3-bf16", "K4-bf16"):
        check(launches[k] == 0, f"the vbd phase launched {k}")
    return results


# the periphery phase: rendering, the reference-checkpoint loader, the CLI
# with its video hook and dashboard
PERIPHERY_WORLDS = 512  # worlds of the CLI's batches
PERIPHERY_STEPS = 10  # expert steps before the frames are drawn
PERIPHERY_RENDER_WORLDS = 4  # worlds drawn in 2-D and 3-D
PERIPHERY_CPU_WORLDS = 4  # worlds whose step-0 logits meet the CPU's
PERIPHERY_PACKAGES = (("matplotlib", "matplotlib"), ("imageio", "imageio"),
                      ("rich", "rich"), ("yaml", "PyYAML"),
                      ("safetensors", "safetensors"))


def package_versions(packages=PERIPHERY_PACKAGES) -> dict:
    """{module: its distribution's version, or "absent"} of (module,
    distribution) pairs."""
    import importlib.metadata
    import importlib.util

    out = {}
    for mod, dist in packages:
        try:
            found = importlib.util.find_spec(mod) is not None
        except ModuleNotFoundError:  # the parent package is missing
            found = False
        if not found:
            out[mod] = "absent"
            continue
        try:
            out[mod] = importlib.metadata.version(dist)
        except importlib.metadata.PackageNotFoundError:
            out[mod] = "present"
    return out


def reference_state_dict(seed: int) -> dict:
    """A seeded state dict in the reference NeuralNet layout at the
    released policy's widths (the key set of
    examples/09_pretrained_policy.py::synth_checkpoint: embeds 6/6/13 ->
    64, shared 192 -> 128, 91 actions), made with torch."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(o, i, name):
        sd[f"{name}.weight"] = torch.randn((o, i), generator=g) / i ** 0.5
        sd[f"{name}.bias"] = 0.1 * torch.randn(o, generator=g)

    for name, ind in (("ego_embed", 6), ("partner_embed", 6),
                      ("road_map_embed", 13)):
        lin(64, ind, f"{name}.0")
        sd[f"{name}.1.weight"] = 1 + 0.1 * torch.randn(64, generator=g)
        sd[f"{name}.1.bias"] = 0.1 * torch.randn(64, generator=g)
        lin(64, 64, f"{name}.4")
    lin(128, 192, "shared_embed.0")
    lin(91, 128, "actor")
    lin(1, 128, "critic")
    return sd


def periphery_render(root: str, dev) -> dict:
    """(b) The 512-world env on the card after PERIPHERY_STEPS expert steps:
    worlds 0-3 rendered with env.render in 2-D and 3-D, each frame held
    against the CPU visualizer's figure of the same scene and state copied
    to the host (identical: the same floats through the same matplotlib
    calls); ms per frame and the share of it in the state's
    device-to-host copy; the fraction of pixels that differ from a CPU env
    of the same worlds stepped on its own with the same actions (float32
    ulps move anti-aliased edges; reported, not gated)."""
    import numpy as np
    import torch

    from gpudrive_lab_torch.env.config import RenderConfig
    from gpudrive_lab_torch.env.env_torch import expert_actions
    from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env
    from gpudrive_lab_torch.visualize.core import (
        MatplotlibVisualizer,
        state_rows,
    )

    scenes = pool_scene_paths(root)
    n = PERIPHERY_RENDER_WORLDS
    env = slice_env(scenes, device=dev)
    cenv = slice_env(scenes[:n], device="cpu")
    acts = expert_actions(env.scene, "classic")
    for t in range(PERIPHERY_STEPS):
        env.step_dynamics(acts[:, :, t])
        cenv.step_dynamics(acts[:n, :, t].cpu())
    torch.cuda.synchronize()
    # one config for the card's, the CPU env's and the host's visualizers
    cfg = env.render_config = cenv.render_config = RenderConfig()
    t0 = time.time()
    env.vis  # the scene's host copies, once per scene
    build_s = time.time() - t0
    scene_h = take_worlds(env.scene, n, "cpu")
    state_h = take_worlds(env.state, n, "cpu")
    host = MatplotlibVisualizer(scene_h, cfg)
    frame_s, copy_s, diff, frames = [], [], [], 0
    for render_3d in (False, True):
        cfg.render_3d = render_3d
        for w in range(n):
            torch.cuda.synchronize()
            t0 = time.time()
            state_rows(env.state, [w])
            copy_s.append(time.time() - t0)
            t0 = time.time()
            got = env.render(w)
            frame_s.append(time.time() - t0)
            want = host.plot_simulator_state(state_h, [w])[0]
            check(got.dtype == np.uint8 and got.ndim == 3
                  and np.array_equal(got, want),
                  f"periphery: the card's frame of world {w} (3-D "
                  f"{render_3d}) differs from the host render of the same "
                  f"state")
            diff.append(float((got != cenv.render(w)).any(-1).mean()))
            frames += 1
    ms = sum(frame_s) / frames * 1e3
    share = sum(copy_s) / sum(frame_s)
    print(f"[periphery] render: {frames} frames of worlds 0-{n - 1} (2-D "
          f"and 3-D, {got.shape[1]}x{got.shape[0]}) after "
          f"{PERIPHERY_STEPS} expert steps on 512 worlds: each equal to the "
          f"host render of the same state; {ms:.2f} ms a frame (host "
          f"clock), {share:.4f} of it the state's device-to-host copy; the "
          f"visualizer's scene copy {build_s * 1e3:.1f} ms once")
    print(f"[periphery] render: pixels differing from a CPU env stepped on "
          f"its own with the same actions, per frame: "
          + ", ".join(f"{d:.2e}" for d in diff) + " (reported, not gated)")
    return dict(frames=frames, ms_per_frame=ms, copy_share=share,
                scene_copy_ms=build_s * 1e3, cpu_env_pixel_diff=diff)


def periphery_checkpoint(root: str, dev, tmp: str, has_st: bool) -> dict:
    """(c) A seeded reference state dict written as model.pt (and
    model.safetensors where safetensors is present); load_pretrained(dir,
    device=dev), the card, of each (equal tensors); the policy rebuilt with
    fused_embed through dataclasses.replace; 91 argmax steps over the 512
    worlds (K2, K3); the step-0 logits and values of PERIPHERY_CPU_WORLDS
    worlds against the same weights on the CPU (plain embed), within the
    1e-4 of phase 3's K3 bar; the policy saved and loaded through
    utils/checkpoint with its sidecar, bit for bit."""
    import dataclasses

    import torch

    from gpudrive_lab_torch.networks.convert import load_pretrained
    from gpudrive_lab_torch.networks.late_fusion import LateFusionPolicy
    from gpudrive_lab_torch.rollout import (
        pool_scene_paths,
        rollout,
        slice_env,
    )
    from gpudrive_lab_torch.utils import checkpoint

    sd = reference_state_dict(SEED)
    dirs = {"pt": os.path.join(tmp, "pt")}
    os.makedirs(dirs["pt"])
    torch.save(sd, os.path.join(dirs["pt"], "model.pt"))
    if has_st:
        from safetensors.torch import save_file

        dirs["safetensors"] = os.path.join(tmp, "st")
        os.makedirs(dirs["safetensors"])
        save_file(sd, os.path.join(dirs["safetensors"], "model.safetensors"))
    loaded = {}
    for fmt, d in dirs.items():
        torch.cuda.synchronize()
        t0 = time.time()
        policy, cfg = load_pretrained(d, device=dev)
        torch.cuda.synchronize()
        loaded[fmt] = (policy, cfg, (time.time() - t0) * 1e3)
        check(next(policy.parameters()).device.type == dev.type,
              f"periphery: the {fmt} policy is not on the card")
    policy, cfg, _ = loaded["pt"]
    for fmt, (other, ocfg, _) in loaded.items():
        check(ocfg == cfg and all(
            torch.equal(v, other.state_dict()[k])
            for k, v in policy.state_dict().items()),
            f"periphery: the {fmt} checkpoint loads other weights")
    fcfg = dataclasses.replace(cfg, fused_embed=True)
    fused = LateFusionPolicy(fcfg, device=dev)
    fused.load_state_dict(policy.state_dict())
    print(f"[periphery] load_pretrained: {cfg}; "
          + ", ".join(f"{fmt} {ms:.1f} ms" for fmt, (_, _, ms)
                      in loaded.items()) + " (host clock, to the card)")

    env = slice_env(pool_scene_paths(root), device=dev)
    W, A = env.num_worlds, env.max_agent_count
    n_agents = int(env.scene.num_agents.sum())
    obs0 = env.get_obs()
    cpu, _ = load_pretrained(dirs["pt"], device="cpu")
    n = PERIPHERY_CPU_WORLDS

    def against_cpu():
        with torch.no_grad():
            got = [t.cpu() for t in fused(obs0[:n])]
            want = cpu(obs0[:n].cpu())
        return [float((a - b).abs().max()) for a, b in zip(got, want)]

    errs = uncounted(against_cpu)
    check(max(errs) <= 1e-4, f"periphery: the card's step-0 logits/values "
          f"differ from the CPU's by {errs}")
    torch.cuda.synchronize()
    t0 = time.time()
    res = rollout(env, fused, STEPS, None, deterministic=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check(bool(((res.actions >= 0) & (res.actions < 91)).all())
          and bool(torch.isfinite(res.rewards).all()),
          "periphery: the checkpoint policy's rollout is out of range")
    check(bool(res.dones[-1][env.scene.agents.valid].all()),
          "periphery: not every agent was done at the horizon")
    print(f"[periphery] the checkpoint policy (fused_embed) on {W} worlds x "
          f"{STEPS} argmax steps: {wall * 1e3 / STEPS:.3f} ms/step wall, "
          f"agent-steps/s {STEPS * n_agents / wall:.1f}; step-0 logits and "
          f"values of {n} worlds x {A} rows against the CPU (plain embed): "
          f"max abs diff {errs[0]:.3g}, {errs[1]:.3g} (bar 1e-4)")

    rounds = {}
    for suffix, opt in ((".pt", torch.optim.Adam(fused.parameters())),
                        (".safetensors", None)):
        if suffix == ".safetensors" and not has_st:
            continue
        path = os.path.join(tmp, "policy" + suffix)
        checkpoint.save_checkpoint(path, fused, opt, metadata=dict(
            policy_config=fcfg, source="reference state dict, seed 0"))
        back = checkpoint.load_checkpoint(path, map_location=dev)
        meta = checkpoint.load_metadata(path)
        same = all(torch.equal(back["state"][k], v)
                   for k, v in fused.state_dict().items())
        check(same and meta["policy_config"]["hidden_dim"] == 128
              and meta["policy_config"]["fused_embed"] is True,
              f"periphery: the {suffix} checkpoint does not round-trip")
        rounds[suffix] = os.path.getsize(path)
    print(f"[periphery] utils/checkpoint round trip with the sidecar, bit "
          f"for bit: " + ", ".join(f"{k} {v} bytes"
                                   for k, v in rounds.items()))
    return dict(logits_err=errs[0], value_err=errs[1],
                step_ms=wall * 1e3 / STEPS,
                agent_steps_per_s=STEPS * n_agents / wall,
                load_ms={k: v[2] for k, v in loaded.items()},
                round_trip=sorted(rounds))


def periphery_cli(root: str, dev, tmp: str, has_mpl: bool) -> dict:
    """(d) ppo.train.main at 512 worlds with --fused-embed --dashboard (and
    --video-interval 1 --video-worlds 1 where matplotlib is present) for 2
    iterations (K2, K3, K4): the hook's 91-step video of world 0 after each
    iteration, its seconds against the iterations', and the trainer's carry
    handed to the next iteration as the last one left it.  Without
    matplotlib, --video-interval must stop the CLI before any training."""
    import torch

    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.dataset import SceneDataLoader
    from gpudrive_lab_torch.ppo import ppo as tppo
    from gpudrive_lab_torch.ppo import train
    from gpudrive_lab_torch.scene.compiler import compile_world

    import numpy as np

    pool = os.path.join(root, "data", "pool_v3")
    W = PERIPHERY_WORLDS
    params = EnvConfig(dynamics_model="classic",
                       collision_behavior="ignore").sim_params()
    batch = next(iter(SceneDataLoader(pool, W, 1000,
                                      sample_with_replacement=True, seed=42)))
    total = sum(int(compile_world(p, params, frozenset()).agent[
        "controlled"].sum()) for p in batch)
    compact = -(-total // 64) * 64
    ckpt = os.path.join(tmp, "cli")
    argv = ["--device", dev.type, "--data-dir", pool, "--num-worlds",
            str(W), "--fused-embed", "--compact", str(compact),
            "--compact-mode", "flat", "--rollout-len", "32",
            "--update-epochs", "4", "--num-minibatches", "4",
            "--total-timesteps", str(32 * total + 1), "--log-interval", "1",
            "--dashboard", "--checkpoint-path", ckpt]
    if not has_mpl:
        before = counts()
        try:
            train.main(argv + ["--video-interval", "1"])
        except ModuleNotFoundError as e:
            check("matplotlib" in str(e) and counts() == before,
                  f"periphery: --video-interval failed after training began "
                  f"({e})")
            print("[periphery] --video-interval without matplotlib stops "
                  "the CLI before training (ModuleNotFoundError); the CLI "
                  "runs below without it")
        else:
            raise CheckFailed("periphery: --video-interval ran without "
                              "matplotlib")
    else:
        argv += ["--video-interval", "1", "--video-worlds", "1"]
    from gpudrive_lab_torch.visualize import video

    hook_s, carries = [], []
    real_hook = video.render_training_videos
    real_step = tppo.PPO.train_step

    def timed_hook(*a, **k):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real_hook(*a, **k)
        torch.cuda.synchronize()
        hook_s.append(time.time() - t0)
        return out

    def snap(c):
        return [c.state.pos.clone(), c.world_time_steps.clone(),
                c.rng.get_state()]

    def spy_step(self, scene, carry, *a, **k):
        before = snap(carry)
        out = real_step(self, scene, carry, *a, **k)
        carries.append((carry, before, out[0], snap(out[0])))
        return out

    print("[periphery] ppo.train.main "
          + " ".join("<tmp>" if a == ckpt else a for a in argv))
    tppo.PPO.train_step = spy_step
    if has_mpl:
        video.render_training_videos = timed_hook
    try:
        with PhaseTimer() as timer:
            t0 = time.time()
            train.main(argv)
            torch.cuda.synchronize()
            cli_s = time.time() - t0
    finally:
        tppo.PPO.train_step = real_step
        if has_mpl:
            video.render_training_videos = real_hook
    iters = timer.iterations()
    with open(os.path.join(ckpt, "ppo.metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    steps = [r for r in logs if "iteration" in r]
    check(len(iters) == len(steps) >= 2 and all(
        all(np.isfinite(r[k]) for k in ("pg_loss", "v_loss", "entropy"))
        for r in steps), f"periphery: the CLI ran {len(iters)} iterations")
    for (_, _, out, after), (nxt, before, _, _) in zip(carries, carries[1:]):
        check(nxt is out and all(torch.equal(a, b)
                                 for a, b in zip(after, before)),
              "periphery: the carry changed between two iterations")
    it_s = [sum(ph.values()) / 1e3 for ph in iters]
    out = dict(iterations=len(iters), wall_s=cli_s, iteration_s=it_s,
               hook_s=hook_s)
    line = (f"[periphery] CLI: {len(iters)} iterations of "
            + ", ".join(f"{s:.3f}" for s in it_s)
            + " s (rollout + GAE + update, CUDA events)")
    if has_mpl:
        videos = sorted(os.listdir(os.path.join(ckpt, "videos")))
        check(len(videos) == len(iters) == len(hook_s) and all(
            v.startswith("world0_step") and v.endswith(".gif")
            and os.path.getsize(os.path.join(ckpt, "videos", v)) > 0
            for v in videos), f"periphery: videos {videos}")
        line += (f"; the video hook (91 steps of world 0, {len(videos)} "
                 f"GIFs) " + ", ".join(f"{s:.3f}" for s in hook_s)
                 + " s (host clock), "
                 f"{sum(hook_s) / sum(it_s):.2f}x the iterations' time")
        out["videos"] = videos
    else:
        line += "; the video hook not run (matplotlib absent)"
    print(line + f"; the carry handed on unchanged; {cli_s:.2f} s wall")
    return out


def periphery_phase(root: str, dev) -> dict:
    """The periphery at full width (the phase-3 configuration: the 512
    pool_v3 worlds, 128 agent rows, road bucket 256).  (a) the versions of
    matplotlib, imageio, rich, yaml and safetensors on this machine; (b)
    with matplotlib, rendering on the card (periphery_render); (c) the
    reference-checkpoint loader (periphery_checkpoint); (d) the PPO CLI
    with its video hook and dashboard (periphery_cli).  Without matplotlib
    (b) and the hook's videos are left out and said so; (c) and (d) run
    either way.  The launch counts are set to 0 at the start; the checks'
    launches are left out.  Returns {launches, ...}."""
    import tempfile

    t0 = time.time()
    versions = package_versions()
    print("[periphery] packages: " + ", ".join(
        f"{k} {v}" for k, v in versions.items()))
    has_mpl = versions["matplotlib"] != "absent"
    has_st = versions["safetensors"] != "absent"
    if not has_mpl:
        print("[periphery] matplotlib absent: figures held on the CPU only")
    set_counts(dict.fromkeys(counts(), 0))
    results = {"packages": versions}
    if has_mpl:
        results["render"] = periphery_render(root, dev)
    with tempfile.TemporaryDirectory() as tmp:
        results["checkpoint"] = periphery_checkpoint(root, dev, tmp, has_st)
        if versions["yaml"] != "absent":
            from gpudrive_lab_torch.utils.config import (
                apply_overrides,
                load_config,
            )

            path = os.path.join(tmp, "exp.yaml")
            with open(path, "w") as f:
                f.write("train:\n  lr: 0.0003\n")
            cfg = apply_overrides(load_config(path), ["train.lr=0.001"])
            check(cfg.train.lr == 0.001, "periphery: the yaml config")
        print(f"[periphery] ran: the .pt round trip"
              + (", the safetensors round trip" if has_st else "")
              + (", the yaml config load" if versions["yaml"] != "absent"
                 else ""))
        results["cli"] = periphery_cli(root, dev, tmp, has_mpl)
    launches = counts()
    results["launches"] = launches
    print(f"[periphery] launches in the phase: K2 {launches['K2']}, K3 "
          f"{launches['K3']}, K4 {launches['K4']} (all: {launches}); the "
          f"phase took {time.time() - t0:.1f} s")
    check(launches["K2"] > 0 and launches["K3"] > 0 and launches["K4"] > 0,
          "the periphery phase did not launch K2, K3 and K4")
    for k in ("K1", "K3-bf16", "K4-bf16"):
        check(launches[k] == 0, f"the periphery phase launched {k}")
    return results


# the ingest phase: the native scene compiler, the WOMD data utilities and
# the examples
INGEST_SCENARIOS = 16  # synthetic WOMD scenarios (2 carry traffic lights)
INGEST_TRACKS = 64  # tracks of 91 states per scenario
INGEST_CPU_WORLDS = 4  # worlds whose expert replay meets the CPU's
INGEST_PACKAGES = (("google.protobuf", "protobuf"),
                   ("matplotlib", "matplotlib"),
                   ("safetensors", "safetensors"))
# each example at the arguments of tests/test_examples.py, on the card:
# (file, arguments, a key its output must hold or None for 05, which
# prints nothing, whether it needs matplotlib)
INGEST_EXAMPLES = (
    ("01_simulate.py", ["--scenes-dir", "{data}"], "obs shape:", False),
    ("02_expert_replay.py", ["--scene", "{scene}"], "reached goal:", False),
    ("03_policy_rollout.py", ["--scenes-dir", "{data}"], "policy_b", False),
    ("04_imitation_learning.py", ["--scene", "{scene}", "--epochs", "1"],
     "goal_rate", False),
    ("05_interactive_viewer.py", ["--scene", "{scene}"], None, True),
    ("06_vbd_sim_agents.py", ["--scenes-dir", "{data}", "--steps", "2"],
     "obs dim with VBD block: 3823", False),
    ("07_behavior_diversity.py", ["--scenes-dir", "{data}"], "u-turns:",
     False),
    ("08_il_analysis.py", ["--scenes-dir", "{data}", "--epochs", "1",
                           "--rollout-steps", "5", "--out", "{tmp}/il"],
     "figures written", True),
    ("09_pretrained_policy.py", ["--scenes-dir", "{data}", "--steps", "5",
                                 "--out", "{tmp}/frame.png"],
     "action_dim=91", False),
)


@contextlib.contextmanager
def compile_path(path: str):
    """compile_world takes ``path`` in the block: "native", or "python"
    (GPUDRIVE_TORCH_NO_NATIVE set)."""
    from gpudrive_lab_torch import native

    if path == "python":
        os.environ[native.NO_NATIVE_ENV] = "1"
    try:
        yield
    finally:
        os.environ.pop(native.NO_NATIVE_ENV, None)


def ingest_compile(scenes, params) -> dict:
    """(b) The scenes compiled cold with the native compiler and with the
    Python path (GPUDRIVE_TORCH_NO_NATIVE), compile_world's and load_map's
    caches cleared before each: seconds of each, no fallback, every array
    within 2e-4 of the Python path's."""
    import numpy as np

    from gpudrive_lab_torch import native
    from gpudrive_lab_torch.scene.compiler import compile_world
    from gpudrive_lab_torch.scene.loader import load_map

    worlds, secs = {}, {}
    native.reset_fallbacks()
    for path in ("native", "python"):
        compile_world.cache_clear()
        load_map.cache_clear()
        with compile_path(path):
            t0 = time.perf_counter()
            worlds[path] = [compile_world(p, params, frozenset())
                            for p in scenes]
            secs[path] = time.perf_counter() - t0
    compile_world.cache_clear()
    load_map.cache_clear()
    check(native.fallbacks() == 0, f"ingest: the native compiler declined "
          f"{native.fallbacks()} of the {len(scenes)} pool scenes")
    worst, exact, arrays = {}, 0, 0
    for n, p in zip(worlds["native"], worlds["python"]):
        check((n.num_agents, n.num_roads) == (p.num_agents, p.num_roads),
              "ingest: native and Python counts differ")
        pairs = [(f"agent[{k}]", n.agent[k], p.agent[k]) for k in n.agent]
        pairs += [(f"road[{k}]", n.road[k], p.road[k]) for k in n.road]
        pairs += [("mean", n.mean, p.mean), ("map_name", n.map_name,
                                             p.map_name),
                  ("scenario_id", n.scenario_id, p.scenario_id)]
        for k, a, b in pairs:
            d = float(np.abs(a.astype(np.float64) - b.astype(np.float64)
                             ).max()) if a.size else 0.0
            worst[k] = max(worst.get(k, 0.0), d)
            exact += bool(np.array_equal(a, b))
            arrays += 1
    bad = {k: v for k, v in worst.items() if not v <= 2e-4}
    check(not bad, f"ingest: native arrays differ from the Python path's "
          f"beyond 2e-4: {bad}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    print(f"[ingest] {len(scenes)} pool_v3 scenes compiled cold: native "
          f"{secs['native']:.3f} s, Python path {secs['python']:.3f} s "
          f"({secs['python'] / secs['native']:.1f}x); 0 fallbacks; "
          f"{exact} of {arrays} arrays equal, the largest differences "
          + ", ".join(f"{k} {v:.3g}" for k, v in top) + " (bar 2e-4)")
    return dict(native_s=secs["native"], python_s=secs["python"],
                exact=exact, arrays=arrays, worst=worst)


def ingest_swaps(root: str, dev) -> dict:
    """(c) A cold swap_data_batch of 512 worlds and one behind
    PrefetchingSceneLoader (PREFETCH_STEPS policy rollout steps while it
    compiles), each with the native compiler and with the Python path."""
    import torch

    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.dataset import SceneDataLoader
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.rollout import SLICE_CONFIG, rollout, slice_policy
    from gpudrive_lab_torch.scene.compiler import compile_world
    from gpudrive_lab_torch.scene.loader import load_map
    from gpudrive_lab_torch.scene.prefetch import PrefetchingSceneLoader

    pool = os.path.join(root, "data", "pool_v3")

    def loader(seed):
        return SceneDataLoader(pool, DATASET_WORLDS, 1000,
                               sample_with_replacement=True, seed=seed)

    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), data_loader=loader(1),
                           device=dev)
    policy = slice_policy(device=dev, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = next(iter(loader(2)))
    # warm-up: a process's first rollout pays one-time set-up (5.3 s
    # against 0.2 s when this phase ran alone without it)
    rollout(env, policy, 1, gen)

    def clear():
        compile_world.cache_clear()
        load_map.cache_clear()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    out = {}
    for path in ("native", "python"):
        with compile_path(path):
            clear()
            cold, _ = timed(lambda: env.swap_data_batch(batch))
            clear()
            pf = PrefetchingSceneLoader(loader(2), env.params)
            try:
                steps, _ = timed(lambda: rollout(env, policy,
                                                 PREFETCH_STEPS, gen))
                wait, paths = timed(pf.next_batch)
            finally:
                pf.close()
            check(paths == batch, "ingest: the prefetched batch is not the "
                  "loader's first")
            swap, _ = timed(lambda: env.swap_data_batch(paths))
        out[path] = dict(cold_s=cold, prefetch_steps_s=steps,
                         prefetch_wait_s=wait, prefetch_swap_s=swap)
        print(f"[ingest] {path}: cold swap of {DATASET_WORLDS} worlds "
              f"{cold:.3f} s; {PREFETCH_STEPS} rollout steps while "
              f"PrefetchingSceneLoader compiles {steps:.3f} + wait "
              f"{wait:.3f} + swap {swap:.3f} = {steps + wait + swap:.3f} s")
    clear()
    print("[ingest] beside the dataset phase's Python-path cold swap of "
          "PR 8 (1.9-2.2 s on an H100): native cold swap "
          f"{out['native']['cold_s']:.3f} s, Python path in this run "
          f"{out['python']['cold_s']:.3f} s")
    return out


def ingest_chain(dev, tmp: str, has_pb: bool) -> dict:
    """(d) Seeded synthetic WOMD scenarios through the port's chain: with
    protobuf a TFRecord shard of vendored-proto messages and
    process_tfrecord, else scenario_to_dict on the plain form (the two give
    the same JSON: tests/test_torch_data_utils.py); post_processing's
    validation and detect_behavior's tags (2 worker processes each); the
    native compiler and an env on the card; 91 expert steps, the first
    INGEST_CPU_WORLDS worlds against the CPU after 90."""
    import torch

    from gpudrive_lab_torch import native
    from gpudrive_lab_torch.data_utils import detect_behavior, post_processing
    from gpudrive_lab_torch.data_utils.synthetic_womd import (
        synthetic_scenarios,
    )
    from gpudrive_lab_torch.data_utils.waymo_converter import scenario_to_dict
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv

    kw = dict(seed=SEED, num_tracks=INGEST_TRACKS, num_lanes=6, points=101)
    out_dir = os.path.join(tmp, "json")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    if has_pb:
        from gpudrive_lab_torch.data_utils import tfrecord
        from gpudrive_lab_torch.data_utils.process_waymo_files import (
            process_tfrecord,
        )
        from gpudrive_lab_torch.data_utils.waymo_protos import (
            scenario_lite_pb2,
        )

        shard = os.path.join(tmp, "training.tfrecord-00000-of-00001")
        tfrecord.write_tfrecord(shard, [s.SerializeToString() for s in (
            synthetic_scenarios(INGEST_SCENARIOS, pb2=scenario_lite_pb2,
                                **kw))])
        _, written, filtered = process_tfrecord((shard, out_dir))
    else:
        written = filtered = 0
        for i, sc in enumerate(synthetic_scenarios(INGEST_SCENARIOS, **kw)):
            d = scenario_to_dict(sc, f"tfrecord-synthetic_{i}.json")
            if d is None:
                filtered += 1
                continue
            with open(os.path.join(out_dir, d["name"]), "w") as f:
                json.dump(d, f)
            written += 1
    convert_s = time.perf_counter() - t0
    check(written == INGEST_SCENARIOS - INGEST_SCENARIOS // 8 and filtered
          == INGEST_SCENARIOS // 8, f"ingest: wrote {written}, filtered "
          f"{filtered}")
    t0 = time.perf_counter()
    valid, invalid = post_processing.process_directory(out_dir, num_workers=2)
    tags = detect_behavior.process_directory(out_dir, 10, num_workers=2)
    host_s = time.perf_counter() - t0
    check((valid, invalid) == (written, 0), f"ingest: post_processing "
          f"{valid} valid, {invalid} removed")
    check(tags["total_uturns"] > 0 and tags["total_reversing"] > 0,
          f"ingest: behavior tags {tags}")
    paths = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir))
    native.reset_fallbacks()
    t0 = time.perf_counter()
    env = GPUDriveTorchEnv(EnvConfig(), paths, device=dev)
    torch.cuda.synchronize()
    env_s = time.perf_counter() - t0
    check(native.fallbacks() == 0, "ingest: a synthetic scene fell back")
    cenv = GPUDriveTorchEnv(EnvConfig(), paths[:INGEST_CPU_WORLDS],
                            device="cpu")
    expert = env.get_expert_actions()[0]
    cexpert = cenv.get_expert_actions()[0]
    env.reset()
    cenv.reset()
    t0 = time.perf_counter()
    for t in range(STEPS - 1):
        env.step_dynamics(expert[:, :, t])
        cenv.step_dynamics(cexpert[:, :, t])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    n = INGEST_CPU_WORLDS
    pos_err = float((env.state.pos[:n].cpu() - cenv.state.pos).abs().max())
    infos, cinfos = env.get_infos(), cenv.get_infos()
    flips = {k: int((infos[k][:n].cpu() != cinfos[k]).sum())
             for k in ("goal_achieved", "collided", "off_road")}
    check(pos_err <= 1e-3 and flips["goal_achieved"] == 0,
          f"ingest: card and CPU differ after {STEPS - 1} expert steps: "
          f"positions by {pos_err}, flags {flips}")
    env.step_dynamics(expert[:, :, STEPS - 1])
    obs = env.get_obs()
    check(bool(torch.isfinite(obs).all()), "ingest: obs not finite")
    uncounted(lambda: k2_against_plain(env, "ingest env after the expert "
                                       "replay", "[ingest]"))
    W, A, R = env.num_worlds, env.max_agent_count, env.scene.max_roads
    agents = int(env.scene.num_agents.sum())
    print(f"[ingest] chain: {INGEST_SCENARIOS} synthetic scenarios x "
          f"{INGEST_TRACKS} tracks ({'TFRecord + vendored proto' if has_pb else 'plain objects, no protobuf'}): "
          f"{written} written, {filtered} filtered (traffic lights) in "
          f"{convert_s:.2f} s; post_processing + detect_behavior "
          f"{host_s:.2f} s ({tags['total_agents']} vehicles, "
          f"{tags['total_uturns']} u-turns, {tags['total_reversing']} "
          f"reversing); env W={W} A={A} R={R}, {agents} agents, native, in "
          f"{env_s:.2f} s; {STEPS} expert steps ({step_s:.2f} s for "
          f"{STEPS - 1} beside the CPU); card vs CPU on {n} worlds: "
          f"positions {pos_err:.3g} m, flag differences {flips}")
    return dict(written=written, filtered=filtered, convert_s=convert_s,
                host_s=host_s, env_s=env_s, step_s=step_s, pos_err=pos_err,
                flips=flips, tags={k: v for k, v in tags.items()
                                   if k != "flagged_scenes"},
                shape=[W, A, R])


def ingest_examples(root: str, tmp: str, versions: dict) -> dict:
    """(e) The port's examples in process on the card at their tests'
    arguments; those that need matplotlib only where it is present."""
    import io
    import runpy

    has_mpl = versions["matplotlib"] != "absent"
    data = os.path.join(root, "tests", "data")
    fill = dict(data=data, tmp=tmp,
                scene=os.path.join(data, "tfrecord_synthetic_0.json"))
    out = {}
    for name, argv, key, needs_mpl in INGEST_EXAMPLES:
        if needs_mpl and not has_mpl:
            out[name] = "skipped: matplotlib absent"
            continue
        if name.startswith("09") and versions["safetensors"] == "absent":
            out[name] = "skipped: safetensors absent"
            continue
        args = [a.format(**fill) for a in argv]
        before = counts()
        buf = io.StringIO()
        old = sys.argv
        sys.argv = [name] + args
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(os.path.join(root, "examples", "torch", name),
                               run_name="__main__")
        finally:
            sys.argv = old
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        check(key is None or key in text, f"ingest: example {name} printed "
              f"no {key!r}:\n{text[-2000:]}")
        k2 = counts()["K2"] - before["K2"]
        # 05 headless steps nothing; 07 reads JSON files on the host
        check(k2 > 0 or name.startswith(("05", "07")),
              f"ingest: example {name} did not launch K2")
        out[name] = dict(seconds=secs, K2=k2)
        last = text.strip().splitlines()[-1][:160] if text.strip() else ""
        print(f"[ingest] example {name} {' '.join(args)}: {secs:.2f} s, K2 "
              f"launches {k2} | {last}")
    return out


def ingest_phase(root: str, dev, native_build_s: float | None = None
                 ) -> dict:
    """The ingest path at full size: (a) the native scene compiler's build;
    (b) the 512 pool_v3 scenes compiled cold both ways (ingest_compile);
    (c) cold and prefetched 512-world swaps both ways (ingest_swaps); (d)
    synthetic WOMD scenarios through the data utilities, the native
    compiler and an expert replay on the card (ingest_chain); (e) the
    port's examples on the card (ingest_examples).  The launch counts are
    set to 0 at the start; the checks' launches are left out.  Returns
    {launches, ...}."""
    import tempfile

    from gpudrive_lab_torch import native
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.rollout import SLICE_CONFIG, pool_scene_paths

    t0 = time.time()
    versions = package_versions(INGEST_PACKAGES)
    print("[ingest] packages: " + ", ".join(
        f"{dist} {versions[mod]}" for mod, dist in INGEST_PACKAGES)
        + ("; without matplotlib examples 05 and 08 and 09's figure do "
           "not run" if versions["matplotlib"] == "absent" else ""))
    tb = time.perf_counter()
    log = native.build()
    build_s = time.perf_counter() - tb
    if log is None:
        build_s = native_build_s
        print(f"[ingest] native scene compiler built earlier in this run"
              + (f" ({native_build_s:.2f} s)" if native_build_s else "")
              + f": {native.library_path().name}")
    else:
        print(f"[ingest] native scene compiler built in {build_s:.2f} s: "
              f"{native.library_path().name}")
    set_counts(dict.fromkeys(counts(), 0))
    results = {"packages": versions, "build_s": build_s}
    scenes = pool_scene_paths(root)
    results["compile"] = ingest_compile(
        scenes, EnvConfig(**SLICE_CONFIG).sim_params())
    results["swaps"] = ingest_swaps(root, dev)
    with tempfile.TemporaryDirectory() as tmp:
        results["chain"] = ingest_chain(
            dev, tmp, versions["google.protobuf"] != "absent")
        results["examples"] = ingest_examples(root, tmp, versions)
    launches = counts()
    results["launches"] = launches
    print(f"[ingest] launches in the phase: {launches}; the phase took "
          f"{time.time() - t0:.1f} s")
    check(launches["K2"] > 0, "the ingest phase did not launch K2")
    for k in ("K1", "K3-bf16", "K4-bf16"):
        check(launches[k] == 0, f"the ingest phase launched {k}")
    return results


COLLISION_STEPS = 91  # steps of the 512-world rollouts under each path
COLLISION_TOP_K = 32  # top-K on the pool worlds (the JAX test's K)
COLLISION_LARGE = dict(W=64, A=128, R=10240, n_active=24)  # (b)'s map
COLLISION_LARGE_KS = (256, 32)  # top-K on the large map: required, printed
COLLISION_CPU_WORLDS = 4  # large-map worlds held against the CPU
COLLISION_REPS = 20  # collision passes per time reading


def collision_pass_ms(scene, state, params, cur) -> tuple[float, int]:
    """(ms per collision pass from CUDA events, the peak device memory the
    pass adds in bytes), its launches left out of the counts."""
    import torch

    from gpudrive_lab_torch.core.collision import collision_system

    def one():
        return collision_system(scene, state, params, cur)

    def measure():
        ms = time_ms(one, COLLISION_REPS)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        one()
        torch.cuda.synchronize()
        return ms, torch.cuda.max_memory_allocated() - base

    return uncounted(measure)


def collision_rollouts(root: str, dev, params) -> dict:
    """(a): the 512 pool worlds, COLLISION_STEPS steps of seeded random
    continuous actions under dense K2, the grid and top-K (K = 32), the
    flags equal to dense's at every step, positions within 1e-6; the
    launches of K1/K2 under each; then (c)'s passes at this size on the
    rollout's last state, with K1 over forced road tiles."""
    import dataclasses

    import numpy as np
    import torch

    from gpudrive_lab_torch import constants as C
    from gpudrive_lab_torch.core import step as stepmod
    from gpudrive_lab_torch.rollout import pool_scene_paths
    from gpudrive_lab_torch.scene.compiler import build_scene, compile_world
    from gpudrive_lab_torch.scene.grid import build_collision_grid

    paths = pool_scene_paths(root)
    grid_p = dataclasses.replace(params, use_collision_grid=True)
    topk_p = dataclasses.replace(params, collision_top_k=COLLISION_TOP_K)
    t0 = time.perf_counter()
    worlds = [compile_world(p, params, frozenset()) for p in paths]
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_collision_grid(worlds, device=dev)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    dense = build_scene(paths, params, device=dev)
    grid = build_scene(paths, grid_p, device=dev)
    g = grid.grid
    print(f"[collision] (a) {dense.num_worlds} pool worlds, R "
          f"{dense.max_roads}; grid table {list(g.table.shape)} (K = the "
          f"batch's largest cell); grid build {grid_s:.3f} s host for the "
          f"{len(worlds)} compiled worlds (compile_world {compile_s:.3f} s, "
          "cached)")
    rng = np.random.default_rng(SEED)
    W, A = dense.agents.valid.shape
    runs = {"dense": (dense, params), "grid": (grid, grid_p),
            "top-k": (dense, topk_p)}
    states = {k: stepmod.reset(s, None, p) for k, (s, p) in runs.items()}
    launches = {k: 0 for k in runs}
    hits = 0
    for t in range(COLLISION_STEPS):
        acts = np.zeros((W, A, C.ACTION_DIM), np.float32)
        acts[..., 0] = rng.uniform(-4, 4, (W, A))
        acts[..., 1] = rng.uniform(-0.5, 0.5, (W, A))
        a = torch.from_numpy(acts).to(dev)
        for k, (s, p) in runs.items():
            before = counts()
            states[k] = stepmod.step(s, states[k], a, p)
            after = counts()
            launches[k] += (after["K1"] - before["K1"]
                            + after["K2"] - before["K2"])
        d = states["dense"]
        for k in ("grid", "top-k"):
            s = states[k]
            for f in ("collided", "collided_road"):
                check(torch.equal(getattr(s, f), getattr(d, f)),
                      f"collision (a): {k} {f} differs from dense at step "
                      f"{t}")
            err = float((s.pos - d.pos).abs().max())
            check(err <= 1e-6, f"collision (a): {k} positions differ from "
                  f"dense by {err} at step {t}")
        hits += int(d.collided_road.sum())
    print(f"[collision] (a) {COLLISION_STEPS} steps: grid and top-K (K = "
          f"{COLLISION_TOP_K}) flags equal to dense at every step, positions "
          f"equal; collided_road summed over steps {hits}; K1+K2 launches "
          f"dense {launches['dense']}, grid {launches['grid']}, top-K "
          f"{launches['top-k']}")
    check(launches["dense"] > 0, "collision (a): dense launched no K2")
    check(launches["grid"] == 0 and launches["top-k"] == 0,
          "collision (a): the grid or top-K path launched K1/K2")
    check(hits > 0, "collision (a): the random drive hit no road")
    tiles = build_scene(paths, dataclasses.replace(
        params, use_tile_collision=True), device=dev)
    st = states["dense"]
    cur = stepmod.current_step_index(st)
    passes = {}
    for k, (s, p) in (("K2 dense", (dense, params)),
                      ("K1 tiled (forced tiles)", (tiles, params)),
                      ("grid", (grid, grid_p)),
                      (f"top-K {COLLISION_TOP_K}", (dense, topk_p))):
        passes[k] = collision_pass_ms(s, st, p, cur)
    return {"grid_build_s": grid_s, "passes": passes, "hits": hits,
            "launches": launches}


def collision_large(dev, params) -> dict:
    """(b): the large map as a Scene (scene/large_map.large_map_scene),
    one collision pass under K1, K2, the grid and top-K: the grid and top-K
    at K = 256 equal to K1 and K2, top-K at K = 32 and its misses printed;
    the grid and top-K against the port on the CPU on the first
    COLLISION_CPU_WORLDS worlds; then (c)'s passes at this size."""
    import dataclasses

    import torch

    from gpudrive_lab_torch.core.collision import collision_system
    from gpudrive_lab_torch.scene.large_map import large_map_scene

    t0 = time.perf_counter()
    scene, state, cur = large_map_scene(**COLLISION_LARGE, seed=SEED,
                                        device=dev, grid=False)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene, state, cur = large_map_scene(**COLLISION_LARGE, seed=SEED,
                                        device=dev)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0 - map_s
    print(f"[collision] (b) large map {COLLISION_LARGE}: grid table "
          f"{list(scene.grid.table.shape)}, its build {grid_s:.3f} s host "
          f"(the map alone {map_s:.3f} s)")
    variants = {"K1": params,
                "K2": dataclasses.replace(params, use_tile_collision=False),
                "grid": dataclasses.replace(params, use_collision_grid=True)}
    for k in COLLISION_LARGE_KS:
        variants[f"top-K {k}"] = dataclasses.replace(params,
                                                     collision_top_k=k)
    flags, launches = {}, {}
    for name, p in variants.items():
        before = counts()
        out = collision_system(scene, state, p, cur)
        after = counts()
        launches[name] = {k: after[k] - before[k] for k in ("K1", "K2")}
        flags[name] = out.collided_road
    want = flags["K2"]
    check(torch.equal(flags["K1"], want), "collision (b): K1 differs from K2")
    check(launches["K1"]["K1"] > 0 and launches["K2"]["K2"] > 0,
          "collision (b): K1 or K2 was not launched")
    for name in ("grid", f"top-K {COLLISION_LARGE_KS[0]}",
                 f"top-K {COLLISION_LARGE_KS[1]}"):
        check(sum(launches[name].values()) == 0,
              f"collision (b): {name} launched K1/K2")
    check(torch.equal(flags["grid"], want), "collision (b): the grid "
          "differs from K1 and K2")
    check(torch.equal(flags[f"top-K {COLLISION_LARGE_KS[0]}"], want),
          f"collision (b): top-K {COLLISION_LARGE_KS[0]} differs from dense")
    k32 = flags[f"top-K {COLLISION_LARGE_KS[1]}"]
    missed = int(((want != 0) & (k32 == 0)).sum())
    print(f"[collision] (b) one pass: {int(want.sum())} agents on a road, "
          f"grid = K1 = K2, top-K {COLLISION_LARGE_KS[0]} = dense; top-K "
          f"{COLLISION_LARGE_KS[1]} misses {missed} hits (printed, not "
          "required); K1/K2 launches " + ", ".join(
              f"{k} {sum(v.values())}" for k, v in launches.items()))
    n = COLLISION_CPU_WORLDS
    cscene, cstate = take_worlds(scene, n, "cpu"), take_worlds(state, n,
                                                               "cpu")
    for name in ("grid", f"top-K {COLLISION_LARGE_KS[0]}"):
        got = collision_system(cscene, cstate, variants[name],
                               cur[:n].cpu()).collided_road
        check(torch.equal(got, flags[name][:n].cpu()),
              f"collision (b): {name} on the card differs from the CPU")
    print(f"[collision] (b) grid and top-K {COLLISION_LARGE_KS[0]}: the card "
          f"equals the CPU on {n} worlds")
    passes = {name: collision_pass_ms(scene, state, p, cur)
              for name, p in variants.items()}
    return {"grid_build_s": grid_s, "passes": passes, "missed_top32": missed,
            "launches": launches}


def collision_phase(root: str, dev) -> dict:
    """The grid and top-K collision paths on the card: (a) the 512 pool
    worlds under dense K2, the grid and top-K for COLLISION_STEPS steps,
    (b) one pass on the large map under all four paths, (c) ms per
    collision pass (CUDA events) and the peak memory each adds, at both
    sizes, and the grid's host build seconds.  The launch counts are set to
    0 at the start; the timing launches are left out."""
    import torch

    from gpudrive_lab_torch.core.types import CollisionBehaviour
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.rollout import SLICE_CONFIG

    t0 = time.time()
    set_counts(dict.fromkeys(counts(), 0))
    params = EnvConfig(**SLICE_CONFIG).sim_params()
    check(params.collision_behaviour == CollisionBehaviour.IGNORE,
          "the slice's collision behaviour is not ignore")
    out = {"pool": collision_rollouts(root, dev, params)}
    torch.cuda.empty_cache()
    out["large"] = collision_large(dev, params)
    for size in ("pool", "large"):
        for name, (ms, peak) in out[size]["passes"].items():
            print(f"[collision] (c) {size}: {name} {ms:.4f} ms per "
                  f"collision pass, peak +{peak / 2**20:.1f} MiB")
    torch.cuda.empty_cache()
    out["launches"] = counts()
    print(f"[collision] launches in the phase: {out['launches']}; the phase "
          f"took {time.time() - t0:.1f} s")
    return out


MULTI_RANKS = 2
MULTI_WORLDS_PER_RANK = 128


def _nccl_probe(rank: int, spec: dict) -> str:
    """Two NCCL ranks on one card: the error NCCL gives, to the parent."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=spec["init_method"],
                                world_size=2, rank=rank)
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f"no error: all_reduce gave {float(t)}"
        dist.destroy_process_group()
    except Exception:  # the message is the finding
        msg = traceback.format_exc().strip().splitlines()[-1]
    return msg


def nccl_on_one_card(timeout: float = 60.0) -> list[str]:
    """What NCCL says to two ranks on cuda:0 (each rank's last line, or
    how the ranks ended where one hung or died)."""
    from gpudrive_lab_torch.parallel.distributed import run_ranks

    try:
        return run_ranks(_nccl_probe, 2, {}, timeout)
    except RuntimeError as e:  # a hang is a finding too, not a failure
        return [str(e).replace("\n", " ")]


def multi_phase(root: str, dev) -> dict:
    """World-parallel training across processes on the card:
    dryrun_multiprocess with MULTI_RANKS ranks sharing cuda:0 over gloo
    (NCCL refuses two ranks on one device: probed and printed), the full
    width late-fusion policy with fused_embed (K3/K4 and their bf16 modes
    in configurations 1 and 2) and the unfused LSTM policy (3),
    MULTI_WORLDS_PER_RANK worlds per rank, two iterations per
    configuration; then the scaling harness's JAX lines at 1 and
    MULTI_RANKS ranks (``scaling_harness``) and the world-steps/s of the
    pool workload's sharded step at the same counts, both labelled as a
    shared card.  Returns the ranks'
    launches summed over configurations and ranks."""
    from gpudrive_lab_torch.parallel.dryrun import CONFIGS, dryrun_multiprocess
    from gpudrive_lab_torch.parallel.scaling import measure_scaling

    t0 = time.time()
    set_counts(dict.fromkeys(counts(), 0))
    # every rank on card 0 (here and in the scaling below), whatever the
    # host has: the phase needs one card
    report = dryrun_multiprocess(MULTI_RANKS, "cuda:0", MULTI_WORLDS_PER_RANK,
                                 root=root, backend="gloo", timeout=600)
    dry_s = time.time() - t0
    total = dict.fromkeys(counts(), 0)
    for name in CONFIGS:
        r = report[name]
        print(f"[multi] dryrun[{name}]: {MULTI_RANKS} gloo ranks on one card "
              f"== one process over {MULTI_RANKS * MULTI_WORLDS_PER_RANK} "
              f"worlds: max param delta {r['max_param_delta']:.3g}, max "
              f"metric delta {r['max_metric_delta']:.3g}; rows per rank "
              f"{r['rank_rows']}; one process {r['single_s']:.1f} s, ranks "
              + ", ".join(f"{s:.1f}" for s in r["rank_s"]) + " s; launches "
              "per rank " + "; ".join(
                  ", ".join(f"{k} {v}" for k, v in n.items() if v)
                  for n in r["launches"]))
        for n in r["launches"]:
            check(n["K2"] > 0, f"multi {name}: a rank launched no K2")
            for k, v in n.items():
                total[k] += v
        if name == "dense":
            check(all(n["K3"] > 0 and n["K4"] > 0 for n in r["launches"]),
                  "multi dense: a rank launched no K3 or K4")
        if name.startswith("flat"):
            check(all(n["K3-bf16"] > 0 and n["K4-bf16"] > 0
                      for n in r["launches"]),
                  "multi flat+bf16: a rank launched no K3-bf16 or K4-bf16")
    print(f"[multi] backend {report['backend']} on {report['devices']}; "
          f"the dryrun took {dry_s:.1f} "
          "s; every rank's parameters bitwise equal in every configuration")
    said = nccl_on_one_card()
    print("[multi] NCCL with 2 ranks on cuda:0: " + " | ".join(said))
    t1 = time.time()
    harness = scaling_harness((1, MULTI_RANKS))
    t2 = time.time()
    sc = measure_scaling((1, MULTI_RANKS), "cuda:0", MULTI_WORLDS_PER_RANK,
                         backend="gloo", root=root, workload="pool")
    for k, v in sc["sps"].items():
        print(f"[multi] pool workload: sharded step at {k} rank(s) x "
              f"{MULTI_WORLDS_PER_RANK} pool worlds on {sc['devices'][k]}: "
              f"{v:.1f} world-steps/s, efficiency "
              f"{sc['efficiency'][k]:.3f} ({sc['label'] or 'one card a rank'})")
    print(f"[multi] scaling harness {t2 - t1:.1f} s, pool workload "
          f"{time.time() - t2:.1f} s; the phase took "
          f"{time.time() - t0:.1f} s; the ranks' launches {total}")
    return {"launches": total, "report": report, "nccl": said,
            "harness": harness, "scaling": sc}


def _json_keys(line: str) -> set:
    try:
        return set(json.loads(line))
    except ValueError:
        return set()


def scaling_harness(counts) -> dict:
    """``python -m gpudrive_lab_torch.parallel.scaling --platform cuda:0
    --counts <counts> --backend gloo`` through its main(argv), at the JAX
    script's workload and defaults, stdout and stderr captured:
    one line per count on stderr and bench_scaling.py's summary line, with
    bench_scaling.py's keys, as the last stdout line.  Returns the summary
    and the per-count lines."""
    import io

    from gpudrive_lab_torch.parallel import scaling

    argv = ["--platform", "cuda:0", "--counts", *map(str, counts),
            "--backend", "gloo"]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = scaling.main(argv)
    check(rc == 0, f"scaling harness exited {rc}")
    lines = out.getvalue().strip().splitlines()
    check(bool(lines), "scaling harness printed no summary line")
    summary = json.loads(lines[-1])
    keys = {"metric", "value", "unit", "vs_baseline", "per_device_counts",
            "valid"}
    check(keys <= set(summary) and summary["metric"] == "scaling_efficiency",
          f"scaling summary lacks bench_scaling.py's keys: {summary}")
    # ranks on one card: not scaling evidence, and the line says so
    check(summary["valid"] is False and "invalid_reason" in summary,
          f"scaling summary on a shared card: {summary}")
    per_count = [json.loads(x) for x in err.getvalue().splitlines()
                 if _json_keys(x) == {"devices", "worlds",
                                      "world_steps_per_sec"}]
    check([c["devices"] for c in per_count] == list(counts),
          f"scaling harness per-count lines {per_count}, counts {counts}")
    for c in per_count:
        print(f"[multi] scaling harness (synthetic workload, ranks on "
              f"cuda:0): {json.dumps(c)}")
    print(f"[multi] scaling harness summary: {lines[-1]}")
    return {"summary": summary, "per_count": per_count}


# the entry phase: the port's entry points outside the package, each run
# through its main(argv) in this process so that its launches are counted
ENTRY_SENSOR_WORLDS = 64  # the sensors' worlds (the camera is ~615x its
ENTRY_SENSOR_STEPS = 10   # floor at 512: PERF.md section 7)
ENTRY_TILED_STEPS = 10
ENTRY_CPU_WORLDS = 4  # worlds of bench_step on the card against the CPU
ENTRY_POOL_SCENES = 16
# the train bench at phase 5's shape: T 32, 4 epochs x 4 minibatches, flat
# compact 4416, observations recomputed; 2 timed iterations after 2
ENTRY_TRAIN = ["--train", "--worlds", "512", "--rollout-len", "32",
               "--num-minibatches", "4", "--update-epochs", "4",
               "--compact", "4416", "--compact-mode", "flat",
               "--train-iters", "2", "--repeats", "1", "--fused-embed"]


def run_main(main, argv) -> tuple:
    """``main(argv)`` in this process, its stdout and stderr captured, the
    launch counts set to 0 just before: (its return value, its stdout
    lines, its launches, wall s)."""
    import io

    set_counts(dict.fromkeys(counts(), 0))
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        ret = main(argv)
    return ret, out.getvalue().splitlines(), counts(), time.time() - t0


def entry_bench_against_cpu(root: str, dev) -> float:
    """bench_step on ENTRY_CPU_WORLDS pool worlds, 10 steps of the same
    action indices on the card and on the CPU: the flags and done equal,
    the float state within 1e-3 (the parity bar).  Returns the largest
    position difference."""
    import numpy as np
    import torch

    from gpudrive_lab_torch import bench

    args = bench.parse_args([
        "--scenes-dir", os.path.join(root, "data", "pool_v3"),
        "--worlds", str(ENTRY_CPU_WORLDS), "--lidar", "--bev", "--camera",
        "--camera-size", "16"])
    sides = [bench.sim_setup(args, d) for d in (dev, torch.device("cpu"))]
    states = [sb.fresh for sb in sides]
    accs = [torch.zeros((), device=sb.table.device) for sb in sides]
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for t in range(10):
        idx = torch.from_numpy(rng.integers(
            0, sides[1].table.shape[0], sides[1].scene.agents.valid.shape))
        for i, sb in enumerate(sides):
            states[i], accs[i] = bench.bench_step(
                sb.scene, sb.fresh, sb.table, sb.weights, states[i],
                idx.to(sb.table.device), accs[i], sb.params, sb.spec,
                **sb.sensors)
        card, cpu = states
        for f in ("done", "collided", "collided_road", "collided_vehicle",
                  "reached_goal", "steps_remaining"):
            check(torch.equal(getattr(card, f).cpu(), getattr(cpu, f)),
                  f"entry bench_step: {f} differs from the CPU at step {t}")
        worst = max(worst, float((card.pos.cpu() - cpu.pos).abs().max()))
    check(worst <= 1e-3, f"entry bench_step: positions differ from the CPU "
          f"by {worst}")
    a, b = float(accs[0]), float(accs[1])
    check(abs(a - b) <= 1e-3 * max(1.0, abs(b)),
          f"entry bench_step: accumulator {a} on the card, {b} on the CPU")
    return worst


def entry_phase(root: str, dev) -> dict:
    """The entry points of gpudrive_lab_torch that port the repository's
    root scripts, on the card: the sim bench (``python -m
    gpudrive_lab_torch.bench``) on the 512 pool_v3 worlds for 91 steps
    (K2), tiled at 2048 roads (K1), with each sensor on
    ENTRY_SENSOR_WORLDS worlds; the train bench at phase 5's shape with
    --fused-embed in float32 (K3/K4) and in bf16 with the split bf16 store
    (K3-bf16/K4-bf16); the trainer CLI writing a checkpoint and
    ``utils.eval_checkpoint`` on it and on a seeded reference checkpoint;
    one ``bench_sb3`` window; ``scene.pool`` writing ENTRY_POOL_SCENES
    scenes equal to data/pool_v3 and validating them on the card;
    ``entry.main`` at its defaults (the dry run's 2 ranks on the one
    card); ``entry.entry()`` on the card against the CPU;
    bench_step on the card against the CPU; and one run of the bench CLI
    in a subprocess.  Returns {launches (every part's summed), ...}."""
    import tempfile

    import torch

    from gpudrive_lab_torch import bench, bench_sb3, entry
    from gpudrive_lab_torch.ppo import train
    from gpudrive_lab_torch.scene import pool
    from gpudrive_lab_torch.utils import eval_checkpoint

    t_phase = time.time()
    scenes = os.path.join(root, "data", "pool_v3")
    total = dict.fromkeys(counts(), 0)
    results = {}

    def part(name, main, argv, need=(), none=()):
        ret, lines, n, wall = run_main(main, argv)
        for k, v in n.items():
            total[k] += v
        for k in need:
            check(n[k] > 0, f"entry {name}: launched no {k}")
        for k in none:
            check(n[k] == 0, f"entry {name}: launched {k}")
        results[name] = dict(ret=ret, launches=n, wall_s=wall)
        print(f"[entry] {name}: {wall:.1f} s; launches "
              + ", ".join(f"{k} {v}" for k, v in n.items() if v))
        return ret, lines

    worst = uncounted(lambda: entry_bench_against_cpu(root, dev))
    print(f"[entry] bench_step with every sensor, {ENTRY_CPU_WORLDS} worlds "
          f"x 10 steps: card equal to the CPU (flags, done), positions "
          f"within {worst:.3g}")

    def bench_line(name, argv, **kw):
        ret, lines = part(name, bench.main, argv, **kw)
        check(len(lines) == 1 and json.loads(lines[0]) == {
            k: ret[k] for k in ("metric", "value", "unit", "vs_baseline")},
            f"entry {name}: stdout is not the one result line: {lines}")
        check(ret["value"] > 0, f"entry {name}: no throughput")
        m = ret["meta"]
        print(f"[entry] {name}: {ret['metric']} {ret['value']} "
              f"({', '.join(f'{k} {v}' for k, v in m.items())})")
        return ret

    sim = ["--scenes-dir", scenes]
    bench_line("bench sim", sim + ["--worlds", "512"], need=("K2",),
               none=("K1",))
    bench_line("bench sim tiled", sim + [
        "--worlds", "512", "--steps", str(ENTRY_TILED_STEPS), "--repeats",
        "2", "--tiles", "on", "--max-roads", "2048"], need=("K1",))
    for sensor in ("--lidar", "--bev", "--camera"):
        bench_line(f"bench sim {sensor[2:]}", sim + [
            "--worlds", str(ENTRY_SENSOR_WORLDS), "--steps",
            str(ENTRY_SENSOR_STEPS), "--repeats", "2", sensor],
            need=("K2",))
    f32 = bench_line("bench train float32", sim + ENTRY_TRAIN,
                     need=("K2", "K3", "K4"), none=("K3-bf16", "K4-bf16"))
    bf16 = bench_line("bench train bf16", sim + ENTRY_TRAIN + [
        "--policy-dtype", "bf16", "--obs-store", "split-bf16"],
        need=("K2", "K3-bf16", "K4-bf16"))
    n = results["bench train bf16"]["launches"]
    check(n["K3"] == n["K3-bf16"] and n["K4"] == n["K4-bf16"],
          f"entry bench train bf16: float32 launches of K3/K4 ({n})")
    print(f"[entry] train samples/s bf16 / float32: "
          f"{bf16['value'] / f32['value']:.3f}")

    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        part("trainer CLI", train.main, [
            "--data-dir", scenes, "--num-worlds", "16", "--rollout-len", "8",
            "--num-minibatches", "2", "--update-epochs", "1",
            "--agent-bucket", "auto", "--total-timesteps", "1",
            "--fused-embed", "--checkpoint-path", run],
            need=("K2", "K3", "K4"))
        check(os.path.exists(os.path.join(run, train.CHECKPOINT)),
              "entry: the trainer wrote no checkpoint")
        ref = os.path.join(tmp, "reference", "model.pt")
        os.makedirs(os.path.dirname(ref))
        torch.save(reference_state_dict(SEED), ref)
        for name, ck in (("eval trainer checkpoint", run),
                         ("eval reference checkpoint", ref)):
            agg, _ = part(name, eval_checkpoint.main, [
                "--checkpoint", ck, "--scenes-dir", scenes, "--num-worlds",
                "64"], need=("K2",))
            check(agg["controlled_agents"] > 0 and all(
                0.0 <= agg[k] <= 1.0
                for k in ("goal_achieved", "collided", "off_road")),
                f"entry {name}: {agg}")
            print(f"[entry] {name}: " + json.dumps(agg))

        sb3, _ = part("bench_sb3", bench_sb3.main,
                      ["--scenes-dir", scenes, "--windows", "1"],
                      need=("K2",))
        check(sb3["meta"]["valid_samples"] > 0 and sb3["value"] > 0,
              f"entry bench_sb3: {sb3}")
        print(f"[entry] bench_sb3: {sb3['metric']} {sb3['value']} "
              f"({', '.join(f'{k} {v}' for k, v in sb3['meta'].items())})")

        out = os.path.join(tmp, "pool")
        paths, lines = part("scene pool", pool.main, [
            "--out", out, "--num", str(ENTRY_POOL_SCENES), "--validate",
            str(ENTRY_POOL_SCENES)], need=("K2",))
        for p in paths:
            with open(p, "rb") as f, open(os.path.join(
                    scenes, os.path.basename(p)), "rb") as g:
                check(f.read() == g.read(),
                      f"entry scene pool: {os.path.basename(p)} differs "
                      "from data/pool_v3")
        said = lines[-1]
        print(f"[entry] scene pool: {len(paths)} scenes equal to "
              f"data/pool_v3 byte for byte; {said}")
        check(said.startswith(f"validate: {ENTRY_POOL_SCENES} scenes")
              and said.endswith("collided 0"), f"entry scene pool: {said}")
        n_valid = said.split("goal ")[1].split(",")[0].split("/")
        check(n_valid[0] == n_valid[1], f"entry scene pool: {said}")

    # the entry CLI at its defaults: 2 ranks, which share the one card
    # over gloo, against one process; then entry()'s forward once
    _, lines = part("entry main", entry.main, [], need=("K2",))
    check(lines[-1].startswith("entry OK: [(128, 91), (128,)]"),
          f"entry main: {lines[-3:]}")
    print(f"[entry] entry main: {lines[-1]}")

    fn, (variables, obs) = entry.entry()
    cfn, (cvars, cobs) = entry.entry("cpu")
    x = torch.randn(obs.shape, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        got = [t.cpu() for t in fn(variables, x.to(dev))]
        want = cfn(cvars, x)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(tuple(got[0].shape) == (128, 91) and err <= 1e-4,
          f"entry(): shapes {[tuple(t.shape) for t in got]}, card against "
          f"CPU {err}")
    print(f"[entry] entry(): logits {tuple(got[0].shape)}, value "
          f"{tuple(got[1].shape)}; card against the CPU {err:.3g}")

    t0 = time.time()
    cli = subprocess.run(
        [sys.executable, "-m", "gpudrive_lab_torch.bench", "--scenes-dir",
         scenes, "--worlds", str(ENTRY_SENSOR_WORLDS), "--steps", "10",
         "--repeats", "1"],
        cwd=root, capture_output=True, text=True, timeout=300)
    lines = cli.stdout.splitlines()
    check(cli.returncode == 0 and len(lines) == 1
          and json.loads(lines[0])["metric"] == "agent_steps_per_sec",
          f"entry: the bench CLI exited {cli.returncode}: "
          f"{cli.stdout[-500:]} {cli.stderr[-1500:]}")
    print(f"[entry] python -m gpudrive_lab_torch.bench in a subprocess: "
          f"{lines[0]} ({time.time() - t0:.1f} s)")
    print(f"[entry] launches in the phase: {total}; the phase took "
          f"{time.time() - t_phase:.1f} s")
    results["launches"] = total
    return results


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
    from gpudrive_lab_torch.env import flat_obs_kernel
    from gpudrive_lab_torch.networks import fused_embed as fe
    from gpudrive_lab_torch.utils.profiling import kernel_time_ms

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
    # every phase compiles scenes with the native scene compiler
    from gpudrive_lab_torch import native

    t0 = time.time()
    native_log = native.build()
    native_build_s = time.time() - t0 if native_log is not None else None
    print(f"[build] native scene compiler (g++ {' '.join(native.FLAGS)}): "
          + (f"{native_build_s:.2f} s" if native_build_s is not None
             else "cached"))
    # ptxas -v: each kernel's (mangled) name, then its spills and registers
    for name, text in logs.items():
        for line in text.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line or "Performance Loss" in line):
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
        got = twice(lambda: kernels.agent_road_hits_dense(feat, roads_t),
                    f"K2 at {when}")
        want = kernels.agent_road_hits_dense_plain(feat, roads_t)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K2 differs from its plain version "
              f"at {when}: {int((got != want).sum())} agents")
        print(f"[K2] {when}: bitwise equal to plain, two launches equal, "
              f"{int(got.sum())} agents hit, "
              f"{kernels.live_pairs(feat, roads_t)} live pairs of "
              f"{W * A * R}")
    k2_in = (feat, roads_t)  # device time in phase 7
    k2["wrapper_ms"] = time_ms(
        lambda: kernels.agent_road_hits_dense(*k2_in), KERNEL_REPS)
    k2["plain_ms"] = time_ms(
        lambda: kernels.agent_road_hits_dense_plain(feat, roads_t), 5)
    k2["bound_ms"], k2["bound_by"], ops = k2_bound(kernels, feat, roads_t)
    k2["max_abs_err"] = 0.0
    k2["shape"] = f"agents [{W},{A},8], roads [{W},8,{R}]"
    results["K2"] = k2
    print(f"[K2] {k2['shape']}: wrapper {k2['wrapper_ms']:.4f} ms per call,"
          f" plain {k2['plain_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms "
          f"({k2['bound_by']}; {ops} SAT operations)")

    policy = slice_policy(device=dev, seed=SEED)
    obs = env.get_obs()
    check(tuple(obs.shape) == (W, A, 3368), f"obs shape {tuple(obs.shape)}")
    check(bool(torch.isfinite(obs).all()), "obs not finite")
    flat = obs.reshape(W * A, -1)
    k3 = dict(name="K3 fused_embed_pool_fwd", route="cuda",
              source="gpudrive_lab_torch/csrc/fused_embed.cu",
              replaces="gpudrive_lab_tpu/networks/fused_embed.py:207",
              library_ms=None, ms=0.0, plain_ms=0.0, bound_ms=0.0,
              bound_fp32_ms=0.0, max_abs_err=0.0,
              parity="pooled max abs err <= 1e-4; argmax equal where the "
                     "top two differ by > 1e-5; two launches bitwise equal")
    # K3's time at the main path's row counts: the rollout's 65,536 rows,
    # the update's 35,328-row minibatch and the PPO rollout's 4,416 rows
    k3_rows = {W * A: {}, 35328: {}, 4416: {}}
    worst_bound = {}
    # K3's bf16 compute mode on the same rows, x in float32 and as a bf16
    # store holds it; its record's ms, bound and plain time are those of a
    # minibatch of the bf16 store (35,328 rows, bf16 x)
    k3b = dict(name="K3-bf16 fused_embed_pool_fwd, bf16 compute mode",
               route="cuda",
               source="gpudrive_lab_torch/csrc/fused_embed_bf16.cu",
               replaces="gpudrive_lab_tpu/networks/fused_embed.py:207",
               library_ms=None, ms=0.0, plain_ms=0.0, bound_ms=0.0,
               max_abs_err=0.0,
               parity=f"pooled max abs err <= {BF16_FLIPS} bf16 flips of t "
                      "(fused_embed.bf16_flip_bound), <= 1% of entries beyond "
                      "1e-5, the winner within that bar of the plain "
                      "maximum, argmax equal where the top two differ by "
                      "more than twice it; two launches bitwise equal")
    # the same kernel at the PPO rollout's 4,416 rows, its own record
    k3b4 = dict(k3b, name="K3-bf16 fused_embed_pool_fwd, bf16 compute mode, "
                "4,416 rows")
    k3b_recs = {35328: k3b, 4416: k3b4}
    k3b_rows = {}
    k3b_by = {}
    with torch.no_grad():
        for bname, w, x in embed_blocks(policy, flat):
            err = k3_check(x, w, f"[K3] {bname}")
            B, Ent, F = x.shape
            for rows, rec in k3_rows.items():
                xr = x[:rows]
                ms = time_ms(lambda: fe.fused_embed_pool_fwd(xr, *w, "tanh"),
                             20)
                nbytes = (4 * (rows * Ent * F + F * 64 + 64 * 64 + 4 * 64)
                          + 8 * rows * 64)
                ent = rows * Ent
                mma = ent * fe.embed_mma_flops(F)
                bms, by = bound(nbytes, ent * fe.embed_flops(F) - mma, 3 * mma)
                fp32_ms, _ = bound(nbytes, ent * fe.embed_flops(F))
                rec[bname] = (ms, bms, fp32_ms)
                line = (f"[K3] {bname} [{rows},{Ent},{F}]: kernel {ms:.4f} ms,"
                        f" bound {bms:.4f} ms ({by}; 3xTF32 on the tensor "
                        f"cores), fp32-core bound {fp32_ms:.4f} ms")
                if rows == B:
                    plain = time_ms(lambda: fe.reference_embed_pool_argmax(
                        x, *w, "tanh"), 3)
                    k3["ms"] += ms
                    k3["plain_ms"] += plain
                    k3["bound_ms"] += bms
                    k3["bound_fp32_ms"] += fp32_ms
                    worst_bound[bname] = by
                    line += f", plain {plain:.4f} ms"
                print(line)
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
            for xd in (x, x.to(torch.bfloat16)):
                dname = str(xd.dtype)[6:]
                k3b["max_abs_err"] = max(k3b["max_abs_err"], k3_bf16_check(
                    xd, w, f"{bname} serving rollout"))
                for rows in k3_rows:
                    ms, bms, by = k3_bf16_time(xd[:rows], w)
                    k3b_rows.setdefault(f"{rows}/{dname}", {})[bname] = (
                        ms, bms)
                    line = (f"[K3-bf16] {bname} [{rows},{Ent},{F}] {dname} x:"
                            f" kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}; "
                            f"bf16 products at the bf16 tensor-core rate)")
                    if rows in k3b_recs and xd.dtype == torch.bfloat16:
                        xr = xd[:rows]
                        plain = time_ms(lambda: fe.reference_embed_pool_argmax(
                            xr, *w, "tanh", torch.bfloat16), 3)
                        rec = k3b_recs[rows]
                        rec["ms"] += ms
                        rec["bound_ms"] += bms
                        rec["plain_ms"] += plain
                        k3b_by[(rows, bname)] = by
                        line += f", plain {plain:.4f} ms"
                    print(line)
            del xd, xr  # the bf16 copy: nothing of it stays on the card
    for key, rec in k3b_rows.items():
        print(f"[K3-bf16] partner + road at {key.replace('/', ' rows, ')} "
              f"x: {sum(v[0] for v in rec.values()):.4f} ms, bound "
              f"{sum(v[1] for v in rec.values()):.4f} ms")
    k3b["ms_by_rows"] = {key: sum(v[0] for v in rec.values())
                         for key, rec in k3b_rows.items()}
    k3b["bound_by"] = k3b_by[(35328, "road")]
    k3b["shape"] = ("partner [35328,127,6] + road [35328,200,13] bfloat16 "
                    "per minibatch forward; checked at 65,536 rows in "
                    "float32 and bfloat16 x, and on the bf16 store at 4,416 "
                    "and 35,328 rows")
    k3b4["bound_by"] = k3b_by[(4416, "road")]
    k3b4["max_abs_err"] = k3b["max_abs_err"]
    k3b4["shape"] = ("partner [4416,127,6] + road [4416,200,13] bfloat16 "
                     "per PPO rollout step; launches are K3-bf16's, all row "
                     "counts")
    results["K3-bf16"] = k3b
    results["K3-bf16, 4,416 rows"] = k3b4
    for rows, rec in k3_rows.items():
        ms, bms, fms = (sum(v[i] for v in rec.values()) for i in range(3))
        print(f"[K3] partner + road at {rows} rows: {ms:.4f} ms, bound "
              f"{bms:.4f} ms, fp32-core bound {fms:.4f} ms")
    k3["ms_by_rows"] = {str(r): sum(v[0] for v in rec.values())
                        for r, rec in k3_rows.items()}
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
    flat_obs_kernel.flat_obs_step.launches = 0
    t0 = time.time()
    res = rollout(env, policy, STEPS, gen)
    torch.cuda.synchronize()
    wall = time.time() - t0
    k2["launches"] = kernels.agent_road_hits_dense.launches
    k3["launches"] = fe.fused_embed_pool_fwd.launches
    k6_main = flat_obs_kernel.flat_obs_step.launches
    tiled_in_main = kernels.agent_road_hits_tiled.launches
    print(f"[rollout] {STEPS} steps x {W} worlds: {wall * 1e3 / STEPS:.3f} "
          f"ms/step wall; sim {res.sim_ms / STEPS:.3f} ms/step, policy "
          f"{res.policy_ms / STEPS:.3f} ms/step (device events)")
    print(f"[rollout] agent-steps/s {STEPS * n_agents / wall:.1f} "
          f"({n_agents} created agents); launches K2 {k2['launches']} "
          f"K3 {k3['launches']} K1 {tiled_in_main} K6 {k6_main}")
    check(k2["launches"] > 0 and k3["launches"] > 0 and k6_main > 0,
          "the rollout did not launch K2, K3 and K6")
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
    got = twice(lambda: kernels.agent_road_hits_tiled(feat_s, rt.feat, mask),
                "K1 at 2048 roads")
    want = kernels.agent_road_hits_tiled_plain(feat_s, rt.feat, mask)
    dense = twice(lambda: kernels.agent_road_hits_dense(feat, roads_t),
                  "K2 at 2048 roads")
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K1 differs from its plain version")
    check(torch.equal(dense, kernels.agent_road_hits_dense_plain(
        feat, roads_t)), "K2 at 2048 roads differs from its plain version")
    check(torch.equal(torch.gather(got, 1, inv_perm), dense),
          "K1 differs from K2 on the same state")
    live = int(mask.sum())
    print(f"[K1] tiles [{W},{T},8,{RT}], {live}/{mask.numel()} live "
          f"block-tiles: bitwise equal to plain and to K2, two launches "
          f"equal, {int(got.sum())} agents hit")
    k1 = dict(name="K1 agent_road_hits_tiled", route="cuda",
              source="gpudrive_lab_torch/csrc/agent_road.cu",
              replaces="gpudrive_lab_tpu/core/pallas_kernels.py:157",
              library_ms=None, max_abs_err=0.0,
              parity="bitwise equal to plain and to K2",
              shape=f"agents [{W},{A},8], tiles [{W},{T},8,{RT}], "
                    f"{live} live block-tiles")
    k1_in, k2_2048_in = (feat_s, rt.feat, mask), (feat, roads_t)  # phase 7
    k1["wrapper_ms"] = time_ms(
        lambda: kernels.agent_road_hits_tiled(*k1_in), KERNEL_REPS)
    k1["plain_ms"] = time_ms(
        lambda: kernels.agent_road_hits_tiled_plain(feat_s, rt.feat, mask), 3)
    k1["bound_ms"], k1["bound_by"], ops = k1_bound(kernels, *k1_in)
    print(f"[K1] wrapper {k1['wrapper_ms']:.4f} ms per call, plain "
          f"{k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
          f"({k1['bound_by']}; {ops} SAT operations)")
    results["K1"] = k1
    k2_2048 = dict(shape=f"agents [{W},{A},8], roads [{W},8,{T * RT}]",
                   wrapper_ms=time_ms(lambda: kernels.agent_road_hits_dense(
                       *k2_2048_in), KERNEL_REPS))
    k2_2048["bound_ms"], k2_2048["bound_by"], ops = k2_bound(kernels,
                                                             *k2_2048_in)
    print(f"[K2] padded {k2_2048['shape']}: wrapper "
          f"{k2_2048['wrapper_ms']:.4f} ms per call, bound "
          f"{k2_2048['bound_ms']:.4f} ms ({k2_2048['bound_by']}; {ops} SAT "
          f"operations)")

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
    # the large map: checks and wrapper times here, device times in phase 7
    lrec = large_map_phase(kernels, dev)
    # K6 at the sim cells' shapes: checks, wrapper and plain times here,
    # device times in phase 7
    results["K6"] = uncounted(lambda: k6_check(root, dev))
    results["K6"]["launches"] = k6_main
    torch.cuda.empty_cache()

    # ---- phase 5: the training path, PPO over the 512 worlds -------------
    results["K4"], k4b_f32x_err, f32_train, results[K6_ROWS] = train_phase(
        env, scenes, gen)

    # ---- phase 5b: PPO with the bf16 policy dtype (K3/K4 bf16 mode) -------
    k3b_train, results["K4-bf16"] = bf16_train_phase(env, gen, f32_train)
    for key in ("K3-bf16", "K3-bf16, 4,416 rows"):
        results[key]["launches"] = k3b_train["launches"]
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"],
                                          k3b_train["store_err"])
    results["K4-bf16"]["max_abs_err"] = max(results["K4-bf16"]["max_abs_err"],
                                            k4b_f32x_err)

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

    # ---- the sensor phase: lidar, BEV and camera on the slice's worlds -----
    del genv, cenv, cpol
    for key, n in sensor_phase(env, policy, gen).items():
        results[key]["sensor_launches"] = n

    # ---- the dataset phase: training and evaluation on resampled batches --
    ds = dataset_phase(root, dev, gen)
    for key, rec in results.items():
        rec["dataset_launches"] = ds["launches"][key.split(",")[0]]
    results["K3"]["max_abs_err"] = max(results["K3"]["max_abs_err"],
                                       ds["K3_err"])
    results["K4"]["max_abs_err"] = max(results["K4"]["max_abs_err"],
                                       ds["ippo"]["K4_err"])

    # ---- the il phase: behavior cloning, closed-loop analysis, probes -------
    il = il_phase(root, dev)
    # ---- the rnn phase: recurrent PPO (its profiled iteration last) --------
    rnn = rnn_phase(root, dev)
    # ---- the vbd phase: diffusion sim agents at the official width ---------
    vbd = vbd_phase(root, dev)
    # ---- the periphery phase: rendering, reference checkpoints, the CLI's
    # video hook and dashboard -----------------------------------------------
    periphery = periphery_phase(root, dev)
    # ---- the ingest phase: the native compiler, the WOMD data utilities
    # and the examples ------------------------------------------------------
    ingest = ingest_phase(root, dev, native_build_s)
    # ---- the collision phase: the grid and top-K agent-road paths ----------
    collision_out = collision_phase(root, dev)
    # ---- the multi phase: world-parallel training across processes --------
    multi = multi_phase(root, dev)
    # ---- the entry phase: the benches, evaluation and generators ---------
    entry_out = entry_phase(root, dev)
    for key, rec in results.items():
        base = key.split(",")[0]
        rec["il_launches"] = il["launches"][base]
        rec["rnn_launches"] = rnn["launches"][base]
        rec["vbd_launches"] = vbd["launches"][base]
        rec["periphery_launches"] = periphery["launches"][base]
        rec["ingest_launches"] = ingest["launches"][base]
        rec["collision_launches"] = collision_out["launches"][base]
        rec["multi_launches"] = multi["launches"][base]
        rec["entry_launches"] = entry_out["launches"][base]

    # ---- phase 7: K1's and K2's device times ------------------------------
    # Last, because they run under torch.profiler: after a profiler session
    # each launch costs the host more, and the launch-bound train iterations
    # of phase 5 and the wrapper times would show it.
    from gpudrive_lab_torch.scene.large_map import LARGE_MAP, large_map

    lmap = large_map(**LARGE_MAP, seed=SEED, device=dev)
    tiles = lmap.rtiles.feat
    for what, rec, fn, args, kernel in (
            ("[K2]", results["K2"], kernels.agent_road_hits_dense, k2_in,
             "ar_dense_kernel"),
            ("[K1]", results["K1"], kernels.agent_road_hits_tiled, k1_in,
             "ar_tiled_kernel"),
            ("[K2] padded", k2_2048,
             kernels.agent_road_hits_dense, k2_2048_in, "ar_dense_kernel"),
            ("[large map] K2", lrec["K2"], kernels.agent_road_hits_dense,
             (lmap.agents, lmap.roads_t), "ar_dense_kernel"),
            ("[large map] K1", lrec["K1"], kernels.agent_road_hits_tiled,
             (lmap.agents_s, tiles, lmap.mask), "ar_tiled_kernel")):
        rec["ms"] = kernel_time_ms(lambda: fn(*args), KERNEL_REPS, kernel)
        print(f"{what} {rec['shape']}: kernel {rec['ms']:.4f} ms (device), "
              f"wrapper {rec['wrapper_ms']:.4f} ms per call, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    for key, rec in lrec.items():
        results[key]["large_map"] = rec
    del lmap, tiles
    from gpudrive_lab_torch.env.env_torch import ObsSpec

    k6 = results["K6"]
    calls = [(label, rec, functools.partial(flat_obs_kernel.flat_obs_step,
                                            scene, state, params, ObsSpec()))
             for (label, scene, state, params), rec in zip(
                 k6_inputs(root, dev), (k6, k6["large_map"]))]
    calls.append(("update rows", results[K6_ROWS], functools.partial(
        flat_obs_kernel.flat_obs_rows, *results[K6_ROWS].pop("args")())))
    for label, rec, fn in calls:
        rec["select_ms"] = kernel_time_ms(fn, KERNEL_REPS,
                                          "road_select_kernel")
        rec["step_ms"] = kernel_time_ms(fn, KERNEL_REPS, "obs_step_kernel")
        rec["ms"] = rec["select_ms"] + rec["step_ms"]
        print(f"[K6] {label} {rec['shape']}: kernel {rec['ms']:.4f} ms "
              f"(device: road_select {rec['select_ms']:.4f} + obs_step "
              f"{rec['step_ms']:.4f}), wrapper {rec['wrapper_ms']:.4f} ms "
              f"per call, plain {rec['plain_ms']:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")

    line = {"kernels": []}
    for key in ("K1", "K2", "K3", "K4", "K3-bf16", "K3-bf16, 4,416 rows",
                "K4-bf16", "K6", K6_ROWS):
        r = results[key]
        line["kernels"].append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "parity",
            "shape")})
        line["kernels"][-1].update({k: r[k] for k in (
            "wrapper_ms", "large_map", "bound_fp32_ms", "ms_by_rows",
            "sensor_launches", "dataset_launches", "il_launches",
            "rnn_launches", "vbd_launches", "periphery_launches",
            "ingest_launches", "collision_launches", "multi_launches",
            "entry_launches", "bar_readings", "select_ms", "step_ms")
            if k in r})
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
