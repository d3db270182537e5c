"""The port's headline bench (gpudrive_lab_torch/bench.py) against the JAX
package on the same inputs.

``bench.py``'s step is a closure inside its ``main``, so the JAX side is
composed here as it composes it: random indices into the classic action
table -> ``step`` -> ``flat_observation`` (unless ``--no-obs``) -> lidar,
BEV, camera (each consumed through a full reduction) -> the reset select of
finished worlds, jitted.  The port's ``bench_step`` takes the same indices.
Over 10 steps on 2 pool_v3 worlds, for each variant of the flags: the state's
flags and done exactly, its floats and the observation within 1e-3 (the
ROADMAP's parity bar; road rows as sets where distances tie), the
accumulator within 1e-3 of its magnitude.  Pallas runs in interpret mode on
the CPU, as the JAX package's own tests run it.

The CLI: ``--smoke`` and ``--smoke --train`` print exactly one stdout line
with bench.py's keys and metric names, and the train bench's samples per
iteration equal the JAX trainer's ``metrics["samples"]``.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core import step as jstep
from gpudrive_lab_tpu.core.bev import bev_observation as jbev
from gpudrive_lab_tpu.core.lidar import lidar_observation as jlidar
from gpudrive_lab_tpu.core.render import (
    CameraConfig as JaxCameraConfig,
    batch_render as jrender,
)
from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.env_jax import (
    ObsSpec as JaxObsSpec,
    flat_observation as jflat,
)
from gpudrive_lab_tpu.scene.compiler import build_scene as jbuild_scene
from gpudrive_lab_torch import bench
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.env.env_torch import flat_observation
from torch_parity import (
    PARTNER_DIM,
    ROOT,
    assert_states_match,
    match_rows,
)

POOL = os.path.join(ROOT, "data", "pool_v3")
STEPS = 10
VARIANTS = {
    "default": [],
    "no-obs": ["--no-obs"],
    "road-obs-linear": ["--road-obs", "linear"],
    "grid": ["--grid"],
    "collision-top-k": ["--collision-top-k", "32"],
    "tiles": ["--tiles", "on", "--max-roads", "2048"],
    "lidar": ["--lidar"],
    "bev": ["--bev"],
    "camera": ["--camera", "--camera-size", "16"],
}


def jax_config(args) -> JaxEnvConfig:
    """bench.py's EnvConfig for the same flags (bench.py:345-356)."""
    return JaxEnvConfig(
        num_worlds=args.worlds,
        dynamics_model="classic",
        collision_behavior="ignore",
        road_obs_algorithm="k_nearest_roadpoints"
        if args.road_obs == "knn" else "linear",
        road_gather=args.road_gather,
        collision_top_k=args.collision_top_k,
        approx_top_k=not args.exact,
        use_collision_grid=args.grid,
        use_tile_collision={"auto": None, "on": True,
                            "off": False}[args.tiles],
    )


def jax_bench_step(scene, fresh, table, weights, state, idx, acc, params,
                   spec, obs, lidar, bev, camera):
    """bench.py:411-443 with the indices handed in."""
    W, A = idx.shape
    act = jnp.zeros((W, A, C.ACTION_DIM), jnp.float32).at[..., :3].set(
        table[idx])
    state = jstep.step(scene, state, act, params)
    if obs:
        o, _, _ = jflat(scene, state, params, spec, weights)
        acc = acc + o[0, 0, 0] + state.reward[0, 0]
    else:
        acc = acc + state.reward[0, 0]
    if lidar:
        acc = acc + jlidar(scene, state, params, act)[..., 0].sum()
    if bev:
        acc = acc + jbev(scene, state, params).sum()
    if camera:
        rgb, depth = jrender(scene, state, JaxCameraConfig(height=camera,
                                                           width=camera))
        acc = acc + depth.sum() + rgb[..., 0].astype(jnp.float32).sum()
    world_done = jnp.all((state.done != 0) | ~scene.agents.valid, axis=1)
    blend = lambda f, s: jnp.where(  # noqa: E731
        world_done.reshape((-1,) + (1,) * (s.ndim - 1)), f, s)
    return jax.tree.map(blend, fresh, state), acc


def assert_obs_close(got, want, tol=1e-3):
    """Flat obs [W, A, D]: ego and partner blocks in order, the road rows
    as sets, within ``tol``."""
    got = got.numpy().reshape(-1, got.shape[-1])
    want = np.asarray(want).reshape(got.shape)
    head = C.EGO_FEAT_DIM + PARTNER_DIM
    np.testing.assert_allclose(got[:, :head], want[:, :head], rtol=0,
                               atol=tol)
    rows = (-1, C.MAX_AGENT_MAP_OBS, C.ROAD_GRAPH_FEAT_DIM)
    np.testing.assert_allclose(
        match_rows(got[:, head:].reshape(rows), want[:, head:].reshape(rows)),
        want[:, head:].reshape(rows), rtol=0, atol=tol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bench_step_matches_jax(variant):
    args = bench.parse_args(["--smoke", "--scenes-dir", POOL,
                             *VARIANTS[variant]])
    assert (args.worlds, args.steps, args.device) == (2, STEPS, "cpu")
    sb = bench.sim_setup(args, torch.device("cpu"))
    jcfg = jax_config(args)
    jparams = jcfg.sim_params()
    jscene = jbuild_scene(sb.paths, jparams, max_roads=args.max_roads,
                          max_agents=bench.agent_bucket(args.agent_bucket))
    assert jscene.agents.valid.shape == tuple(sb.scene.agents.valid.shape)
    assert (jscene.rtiles is None) == (sb.scene.rtiles is None)
    if variant == "tiles":
        assert sb.scene.rtiles is not None and sb.scene.max_roads == 2048
    if variant == "grid":
        assert sb.scene.grid is not None and jscene.grid is not None
    jspec = JaxObsSpec(**dataclasses.asdict(sb.spec))
    jtable = jnp.asarray(sb.table.numpy())
    jweights = jnp.asarray(sb.weights.numpy())
    jfresh = jstep.reset(jscene, None, jparams)
    step = jax.jit(functools.partial(
        jax_bench_step, params=jparams, spec=jspec, **sb.sensors))
    jobs_fn = jax.jit(lambda s: jflat(jscene, s, jparams, jspec, jweights)[0])

    rng = np.random.default_rng(7)
    state, jstate = sb.fresh, jfresh
    acc = torch.zeros(())
    jacc = jnp.float32(0)
    for t in range(STEPS):
        idx = rng.integers(0, sb.table.shape[0], sb.scene.agents.valid.shape)
        state, acc = bench.bench_step(
            sb.scene, sb.fresh, sb.table, sb.weights, state,
            torch.from_numpy(idx), acc, sb.params, sb.spec, **sb.sensors)
        jstate, jacc = step(jscene, jfresh, jtable, jweights, jstate,
                            jnp.asarray(idx), jacc)
        assert_states_match(jstate, state, where=f"{variant} step {t}")
        assert_obs_close(
            flat_observation(sb.scene, state, sb.params, sb.spec,
                             sb.weights)[0], jobs_fn(jstate))
    a, b = float(acc), float(jacc)
    assert np.isfinite(a) and abs(a - b) <= 1e-3 * max(1.0, abs(b)), (a, b)


def _one_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def test_smoke_prints_bench_line(capsys):
    got = bench.main(["--smoke"])
    line = _one_line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "agent_steps_per_sec"
    assert line["unit"] == "agent-steps/s" and line["value"] > 0
    assert got["meta"]["backend"] == "cpu"
    assert {"warmup_s", "device_name", "total_agents", "world_steps_per_sec",
            "max_roads_bucket", "scene_compile_s",
            "elapsed_s"} <= set(got["meta"])
    # the default directory, absent here, falls back to the fixtures, and
    # the details say which directory was measured
    assert not os.path.isdir(bench.DEFAULT_SCENES)
    assert got["meta"]["scenes_dir"] == bench.FALLBACK_SCENES


@pytest.mark.parametrize("train", [False, True])
def test_named_scenes_dir_must_exist(train, tmp_path):
    """A --scenes-dir the caller typed is used as given or refused; only
    the default falls back to the fixtures."""
    missing = str(tmp_path / "no-such-dir")
    with pytest.raises(SystemExit, match="no-such-dir"):
        bench.main(["--smoke", "--scenes-dir", missing]
                   + (["--train"] if train else []))


def test_smoke_train_prints_bench_line_and_counts_the_jax_samples(capsys):
    """``--smoke --train`` prints one line; its samples per iteration, on
    a 2-world batch with rollouts of 4, equal the JAX trainer's
    ``metrics["samples"]`` for one iteration on the same scenes."""
    from gpudrive_lab_tpu.env.dataset import SceneDataLoader as JaxLoader
    from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
    from gpudrive_lab_tpu.ppo.ppo import PPOConfig as JaxPPOConfig
    from gpudrive_lab_tpu.ppo.train import build_trainer as jbuild_trainer

    small = ["--rollout-len", "4", "--num-minibatches", "2",
             "--update-epochs", "1", "--repeats", "1"]
    got = bench.main(["--smoke", "--train", "--scenes-dir", POOL, *small])
    line = _one_line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "train_agent_steps_per_sec"
    assert line["unit"] == "agent-steps/s" and line["value"] > 0
    meta = got["meta"]
    assert (meta["mode"], meta["worlds"], meta["iters"]) == ("train", 2, 2)
    assert meta["scenes_dir"] == POOL

    loader = JaxLoader(root=POOL, batch_size=2, dataset_size=1000,
                       sample_with_replacement=True, seed=0)
    cfg = JaxEnvConfig(
        num_worlds=2, reward_type="weighted_combination",
        collision_weight=-0.75, off_road_weight=-0.75,
        goal_achieved_weight=1.0, dynamics_model="classic",
        collision_behavior="ignore", agent_bucket="auto")
    env = GPUDriveTPUEnv(cfg, data_loader=loader)
    _, variables, opt_state, carry, fresh, train_fn = jbuild_trainer(
        env, JaxPPOConfig(rollout_len=4, num_minibatches=2, update_epochs=1),
        seed=0, rollout_mode="scan")
    *_, metrics = train_fn(env.scene, variables, opt_state,
                           carry._replace(rng=jax.random.PRNGKey(1)), fresh,
                           env.reward_weights, jnp.float32(1e-3))
    assert meta["samples_per_iter"] == int(np.asarray(metrics["samples"]))
