"""Helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages are fed the same values: data is made with numpy from a seed,
and a Scene or SimState crosses between the packages as numpy arrays.  The
JAX package is used as it is; its native scene compiler is switched off
(``python_scene_compiler``) so that both packages compile scenes with the
same Python path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core import types as jtypes
from gpudrive_lab_tpu.scene import compiler as jcompiler
from gpudrive_lab_torch.core import types as ttypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC_SCENE = os.path.join(ROOT, "tests", "data", "tfrecord_synthetic_0.json")
POOL_SCENES = sorted(glob.glob(os.path.join(ROOT, "data", "pool_v3", "*.json")))
AGENT_AGENT = os.path.join(ROOT, "tests", "data", "agent_agent_collision.json")
ROAD_EDGE = os.path.join(ROOT, "tests", "data", "agent_road_edge_collision.json")

# The suite runs in several worker processes at once; torch's default of one
# thread per core in each of them oversubscribes the host several times over.
torch.set_num_threads(min(torch.get_num_threads(), 2))


@contextlib.contextmanager
def python_scene_compiler():
    """Make the JAX package compile scenes with its pure-Python path (the
    path the port carries) for the duration of the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcompiler, "_compile_world_native", lambda *a, **k: None)
        jcompiler.compile_world.cache_clear()
        try:
            yield
        finally:
            jcompiler.compile_world.cache_clear()


def jax_params(tparams: ttypes.Params) -> jtypes.Params:
    """The JAX Params with the same field values."""
    vals = {}
    for f in dataclasses.fields(tparams):
        v = getattr(tparams, f.name)
        if isinstance(v, int) and type(v) is not int and type(v) is not bool:
            v = getattr(jtypes, type(v).__name__)(int(v))
        vals[f.name] = v
    return jtypes.Params(**vals)


def to_jax(obj, cls):
    """A port tensor dataclass -> the JAX package's struct of the same
    name (``cls``), field by field through numpy."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = jnp.asarray(v.detach().cpu().numpy())
        elif v is None:
            out[f.name] = None
        else:
            out[f.name] = to_jax(v, getattr(jtypes, type(v).__name__))
    return cls(**out)


def scene_to_jax(scene: ttypes.Scene) -> jtypes.Scene:
    return to_jax(scene, jtypes.Scene)


def state_to_jax(state: ttypes.SimState) -> jtypes.SimState:
    return to_jax(state, jtypes.SimState)


def state_to_torch(state) -> ttypes.SimState:
    return ttypes.SimState(**{
        f.name: torch.from_numpy(np.array(getattr(state, f.name)))
        for f in dataclasses.fields(ttypes.SimState)
    })


def yaw_diff(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(np.arctan2(np.sin(d), np.cos(d)))


INT_FIELDS = ("done", "collided", "collided_road", "collided_vehicle",
              "collided_non_vehicle", "reached_goal", "steps_remaining")


def assert_states_match(js, ts, tol=1e-3, where=""):
    """Integer and flag fields exactly equal; pos, yaw and vel within
    ``tol`` (the reference's own per-step epsilon, ROADMAP "parity bar")."""
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(js, f)), getattr(ts, f).numpy(),
            err_msg=f"{f} {where}",
        )
    for f in ("pos", "vel"):
        np.testing.assert_allclose(
            np.asarray(getattr(js, f)), getattr(ts, f).numpy(),
            rtol=0, atol=tol, err_msg=f"{f} {where}",
        )
    assert yaw_diff(js.yaw, ts.yaw.numpy()).max() <= tol, f"yaw {where}"


def flax_variables(seed=0, act="tanh", action_dim=91):
    """A flax parameter tree of the late-fusion policy, every leaf drawn with
    numpy: kernels N(0, 1/fan_in), biases N(0, 0.1), LayerNorm scale
    1 + N(0, 0.1)."""
    import jax

    from gpudrive_lab_tpu.networks.late_fusion import (
        LateFusionPolicy as FlaxPolicy,
        PolicyConfig as FlaxPolicyConfig,
    )

    cfg = FlaxPolicyConfig(act_func=act, action_dim=action_dim)
    shapes = jax.eval_shape(lambda: FlaxPolicy(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.obs_dim))))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])
        elif "scale" in name:
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_ppo(env, config):
    """The JAX package's PPO functions for a port env and a port PPOConfig
    (the same fields): the policy and the inner functions of
    ``make_ppo_funcs`` that its ``jax.jit`` calls wrap, captured by name
    (``rollout_step``, ``update``, ``_prepare_batch``, ``_mb_update``), each
    jitted.  Returns (policy, {name: jitted function})."""
    import jax

    from gpudrive_lab_tpu.env.env_jax import ObsSpec as JaxObsSpec
    from gpudrive_lab_tpu.networks.late_fusion import (
        LateFusionPolicy as FlaxPolicy,
        PolicyConfig as FlaxPolicyConfig,
    )
    from gpudrive_lab_tpu.ppo import ppo as jppo

    policy = FlaxPolicy(FlaxPolicyConfig(
        action_dim=env.action_space_n, fused_embed=config.fused_embed,
        embed_remat=config.embed_remat))
    captured = {}
    real_jit = jax.jit

    def spy(fn, **kw):
        jitted = real_jit(fn, **kw)
        captured[getattr(fn, "__name__", "")] = jitted
        return jitted

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", spy)
        jppo.make_ppo_funcs(
            policy, jax_params(env.params),
            JaxObsSpec(**dataclasses.asdict(env.spec)),
            jnp.asarray(env.action_keys.cpu().numpy()),
            env.config.reward_type,
            jppo.PPOConfig(**dataclasses.asdict(config)),
        )
    return policy, captured


def _jnp(x):
    """A tensor as a jax array (bfloat16 through float32, exactly)."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.detach().cpu().numpy())


def traj_to_jax(traj):
    """A port Transition (stacked [T, ...]) as the JAX package's."""
    from gpudrive_lab_tpu.ppo.ppo import Transition

    out = {}
    for name in Transition._fields:
        v = getattr(traj, name)
        if v is None:
            out[name] = None
        elif isinstance(v, tuple):
            out[name] = tuple(_jnp(o) for o in v)
        elif isinstance(v, torch.Tensor):
            out[name] = _jnp(v)
        else:
            out[name] = state_to_jax(v)
    return Transition(**out)


def jax_minibatch_order(key, config):
    """The permutations (and row starts) that the JAX ``update`` draws from
    the carry's key (gpudrive_lab_tpu/ppo/ppo.py:547-565, 657-659), as numpy
    [E, M, Tm] (and [E, M])."""
    import jax

    T, M, E = config.rollout_len, config.num_minibatches, config.update_epochs
    rng_epochs, _ = jax.random.split(key)
    perms, starts = [], []
    for rng_e in jax.random.split(rng_epochs, E):
        if config.minibatch_rows:
            G = config.compact // config.minibatch_rows
            Mt = M // G
            rng_t, rng_p = jax.random.split(rng_e)
            perm = np.asarray(jax.random.permutation(rng_t, T)).reshape(
                Mt, T // Mt)
            pairs = np.asarray(jax.random.permutation(rng_p, M))
            perms.append(perm[pairs // G])
            starts.append((pairs % G) * config.minibatch_rows)
        else:
            perms.append(np.asarray(jax.random.permutation(rng_e, T))
                         .reshape(M, T // M))
            starts.append(np.zeros(M, np.int64))
    return np.stack(perms), np.stack(starts)


def sorted_rows(block: np.ndarray) -> np.ndarray:
    """Sort the rows of [..., K, D] lexicographically within each [K, D]
    set, so that two blocks holding the same rows in another order
    compare equal."""
    flat = block.reshape(-1, *block.shape[-2:])
    out = np.empty_like(flat)
    for i, rows in enumerate(flat):
        order = np.lexsort(np.round(rows, 4).T[::-1])
        out[i] = rows[order]
    return out.reshape(block.shape)
