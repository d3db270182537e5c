"""Helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages are fed the same values: data is made with numpy from a seed,
and a Scene or SimState crosses between the packages as numpy arrays.  The
JAX package is used as it is.  Where a test needs both packages to compile
scenes with the same Python path, ``python_scene_compiler`` switches off
both native compilers.

Both packages' native compilers build the same C++ source and give the same
bits; their Python paths differ from it in the last bit of some road yaws
and grid origins.  The JAX package's loader has g++ write its library in
place and falls back to the Python path for the rest of the process when a
load fails, which it does when several test workers build at once and one
loads a half-written file.  So importing this module makes the worker hold
that library, loaded (``hold_jax_native``), and the tests that hold compile
outputs of the two packages equal bit for bit first call
``assert_jax_native``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import glob
import hashlib
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu import native as jnative
from gpudrive_lab_tpu.core import types as jtypes
from gpudrive_lab_torch import constants as C
from gpudrive_lab_tpu.scene import compiler as jcompiler
from gpudrive_lab_torch import native as tnative
from gpudrive_lab_torch.core import types as ttypes
from gpudrive_lab_torch.scene import compiler as tcompiler
from gpudrive_lab_torch.networks.convert import (
    adam_state_from_optax,
    params_fn_for,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC_SCENE = os.path.join(ROOT, "tests", "data", "tfrecord_synthetic_0.json")
POOL_SCENES = sorted(glob.glob(os.path.join(ROOT, "data", "pool_v3", "*.json")))
AGENT_AGENT = os.path.join(ROOT, "tests", "data", "agent_agent_collision.json")
PARTNER_DIM = (C.MAX_AGENTS - 1) * C.PARTNER_FEAT_DIM
ROAD_EDGE = os.path.join(ROOT, "tests", "data", "agent_road_edge_collision.json")
# written only by hold_jax_native
JAX_NATIVE_DIR = os.path.join(ROOT, "tests", ".jax_native")

# The suite runs in several worker processes at once; torch's default of one
# thread per core in each of them oversubscribes the host several times over.
torch.set_num_threads(min(torch.get_num_threads(), 2))


def hold_jax_native() -> None:
    """Build the JAX package's native scene compiler into JAX_NATIVE_DIR,
    under the name its ``_build`` gives it, through a temporary file and
    ``os.replace`` (one worker at a time, under a file lock), point
    ``GPUDRIVE_TPU_NATIVE_CACHE`` there, and where this process has
    fallen back to the Python path, reset the loader, load again and drop
    the worlds compiled meanwhile.  A failed build leaves the fallback for
    ``assert_jax_native`` to report."""
    src = jnative._SRC
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = os.path.join(JAX_NATIVE_DIR, f"libscene_compiler_{tag}.so")
    os.makedirs(JAX_NATIVE_DIR, exist_ok=True)
    with open(os.path.join(JAX_NATIVE_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", "-O3", "-std=c++17", "-shared",
                                "-fPIC", str(src), "-o", tmp], check=True,
                               capture_output=True, timeout=300)
            except (subprocess.CalledProcessError, OSError,
                    subprocess.TimeoutExpired):
                if os.path.exists(tmp):
                    os.remove(tmp)
                return
            os.replace(tmp, out)
    os.environ["GPUDRIVE_TPU_NATIVE_CACHE"] = JAX_NATIVE_DIR
    if jnative._LIB is None:
        jnative._TRIED = False
        jnative._load()
        jcompiler.compile_world.cache_clear()


def assert_jax_native() -> None:
    """The JAX package compiles scenes with its native library, as the
    port does: else the two differ in the last bit of some road yaws."""
    hold_jax_native()
    assert jnative.available(), (
        "the JAX package's native scene compiler is not loaded in this "
        "worker (a failed build or a load of a half-written library makes "
        "it fall back to its Python path, whose road yaws differ from the "
        "native ones in the last bit)")


hold_jax_native()


@contextlib.contextmanager
def python_scene_compiler():
    """Make both packages compile scenes with their pure-Python paths for
    the duration of the block: the JAX package's native path is patched
    out and the port's switched off through its environment variable.
    Both ``compile_world`` caches are cleared on entry and on exit, so no
    world of the other path is served from them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcompiler, "_compile_world_native", lambda *a, **k: None)
        mp.setenv(tnative.NO_NATIVE_ENV, "1")
        jcompiler.compile_world.cache_clear()
        tcompiler.compile_world.cache_clear()
        try:
            yield
        finally:
            jcompiler.compile_world.cache_clear()
            tcompiler.compile_world.cache_clear()


@contextlib.contextmanager
def recorded_draws():
    """The arrays that ``jax.random.normal`` and ``jax.random.randint``
    return while the block runs, as numpy, in order: the draws a JAX
    sampler took, to hand to the port's (``vbd.model.Draws``)."""
    import jax

    draws = []
    real = {name: getattr(jax.random, name) for name in ("normal", "randint")}

    def spy(name):
        def fn(*a, **k):
            x = real[name](*a, **k)
            draws.append(np.asarray(x))
            return x
        return fn

    with pytest.MonkeyPatch.context() as mp:
        for name in real:
            mp.setattr(jax.random, name, spy(name))
        yield draws


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


def to_torch(obj, cls):
    """A JAX package struct -> the port's tensor dataclass ``cls``, field
    by field through numpy (the inverse of ``to_jax``)."""
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if v is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(v):
            out[f.name] = to_torch(v, getattr(ttypes, type(v).__name__))
        else:
            out[f.name] = torch.from_numpy(np.array(v))
    return cls(**out)


def scene_to_torch(scene) -> ttypes.Scene:
    return to_torch(scene, ttypes.Scene)


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
        embed_remat=config.embed_remat,
        dtype=(jnp.bfloat16 if config.policy_dtype == "bfloat16"
               else jnp.float32)))
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


def match_rows(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """``got`` [..., K, D] with the rows of each [K, D] set reordered to
    line up with their nearest rows of ``want`` (the assignment of least
    total squared distance), so that two blocks holding the same rows in
    another order compare equal.  Matching on the unrounded values keeps
    rows that differ by float noise together, wherever they fall against a
    rounding or sorting boundary."""
    from scipy.optimize import linear_sum_assignment

    assert got.shape == want.shape, (got.shape, want.shape)
    g = got.reshape(-1, *got.shape[-2:]).astype(np.float64)
    w = want.reshape(-1, *want.shape[-2:]).astype(np.float64)
    out = np.empty_like(got.reshape(g.shape))
    src = got.reshape(g.shape)
    for i in range(g.shape[0]):
        # most sets pair up in sorted order to float noise: take that
        # pairing when no entry moves by more than 1e-7 of the block's
        # scale, else solve the assignment
        og, ow = np.lexsort(g[i].T[::-1]), np.lexsort(w[i].T[::-1])
        scale = 1 + np.abs(w[i]).max()
        if np.abs(g[i][og] - w[i][ow]).max() <= 1e-7 * scale:
            out[i][ow] = src[i][og]
            continue
        cost = ((w[i][:, None, :] - g[i][None, :, :]) ** 2).sum(-1)
        rows, cols = linear_sum_assignment(cost)
        out[i][rows] = src[i][cols]
    return out.reshape(got.shape)


def assert_trainer_matches(ppo, jvars, jopt, tol=1e-4, loose=None):
    """Every parameter within tol of the JAX one; Adam's moments and step
    count beside them.  ``loose`` holds the bars of the bf16 policy dtype
    (``bf16_bars``), applied leaf by leaf: the leaf's update error
    ||p - p_jax|| / ||p_jax - p_start|| within ``update_rel``; at most
    ``fraction`` of its entries (and at least one allowed) beyond tol, and
    none beyond ``atol``; each moment within ``moment_rel`` of its largest
    magnitude."""
    want = params_fn_for(ppo.policy)(jvars)
    got = ppo.policy.state_dict()
    for k, v in want.items():
        a, b = got[k].numpy(), v.numpy()
        if loose is None:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
            continue
        err = np.abs(a - b)
        moved = np.linalg.norm(b - loose["start"][k].numpy())
        assert np.linalg.norm(a - b) <= loose["update_rel"] * moved, (
            k, float(np.linalg.norm(a - b) / moved))
        assert err.max() <= loose["atol"], (k, err.max())
        assert (err > tol).sum() <= max(1, loose["fraction"] * err.size), (
            k, int((err > tol).sum()), err.size)
    adam = adam_state_from_optax(jopt, ppo.policy)
    for i, (k, p) in enumerate(ppo.policy.named_parameters()):
        st = ppo.optimizer.state[p]
        assert float(st["step"]) == float(adam[i]["step"])
        for m in ("exp_avg", "exp_avg_sq"):
            a, b = st[m].numpy(), adam[i][m].numpy()
            if loose is None:
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6,
                                           err_msg=m)
            else:
                assert np.abs(a - b).max() <= loose["moment_rel"] * np.abs(
                    b).max(), (k, m)


def bf16_bars(cfg, start):
    """The bars of one update with the bf16 policy dtype against the JAX
    one, for ``assert_trainer_matches``; ``start`` is the policy's state
    dict before the update.  Both sides run the same bf16 operations but
    round and sum bf16 values in another order, so their gradients differ
    by a few bf16 ulps (2^-8 relative) of the terms they sum, and Adam,
    which moves an entry by about lr a step whatever its gradient's size,
    turns that into entries up to 2 lr a step apart (``atol``, the most
    Adam can move an entry).  Per leaf:

    * the update error, ||p - p_jax|| over the JAX update ||p_jax -
      p_start||, within 0.25.  Readings: at most 0.080 fused, 0.187
      unfused; a leaf left where it was reads 1, one moved the other way
      2.
    * at most 6% of the entries beyond 1e-4 fused (readings up to 3 of 64
      and 16 of 384) and 12% unfused (7 of 64).  Unfused, the partner and
      road blocks pool over tied bf16 maxima (the observation's padding
      rows), whose cotangent XLA on the CPU splits and sums in bf16, far
      from the exact sum (tests/test_torch_bf16.py).
    * Adam's moments within 0.25 of each one's largest magnitude (readings
      up to 0.014 fused, 0.168 unfused); a gradient off by a factor, which
      Adam's step hides, shows there.

    Entries beyond 1e-4 are not only those whose gradient was near zero:
    some had a JAX gradient at every step above 0.29 of their leaf's
    largest, so no per-entry rule on the gradient is used."""
    steps = cfg.update_epochs * cfg.num_minibatches
    return dict(start=start, update_rel=0.25,
                atol=2 * cfg.learning_rate * steps,
                fraction=0.06 if cfg.fused_embed else 0.12, moment_rel=0.25)


def _road_rows(road, road_mask):
    """[W, A, K, 14]: the 13 road features with the road mask beside."""
    road = road.reshape(road.shape[:-1] + (C.MAX_AGENT_MAP_OBS, 13))
    return np.concatenate([road, road_mask[..., None].astype(np.float32)], -1)


def assert_obs_match(env, jenv, obs, jobs, ordered_roads=False, tail=0):
    """Frame by frame (``num_stack`` frames, oldest first): the ego and
    partner blocks in order, the road rows as sets (with the road mask of
    the newest frame beside them) unless ``ordered_roads``, and the last
    ``tail`` features of each frame (the VBD block) in order, within 1e-5
    of the block's largest magnitude: its y = -sin * dx + cos * dy cancels
    terms of tens of metres, so an element's float32 error is that of the
    terms (XLA may fuse the multiply-adds), not of the element."""
    obs, jobs = obs.numpy(), np.asarray(jobs)
    assert obs.shape == jobs.shape
    spec = env.spec
    head = (C.EGO_FEAT_DIM + 3 * spec.reward_conditioned
            if spec.ego_state else 0) + (PARTNER_DIM if spec.partner_obs else 0)
    n = env.config.num_stack
    frames = obs.reshape(obs.shape[:-1] + (n, -1))
    jframes = jobs.reshape(jobs.shape[:-1] + (n, -1))
    if spec.partner_obs:
        np.testing.assert_array_equal(env.partner_mask.numpy(),
                                      np.asarray(jenv.partner_mask))
    else:
        assert env.partner_mask is None and jenv.partner_mask is None
    no_mask = np.zeros(obs.shape[:-1] + (C.MAX_AGENT_MAP_OBS,), bool)
    for i in range(n):
        got, want = frames[..., i, :], jframes[..., i, :]
        if tail:
            scale = max(1.0, float(np.abs(want[..., -tail:]).max()))
            np.testing.assert_allclose(got[..., -tail:], want[..., -tail:],
                                       rtol=0, atol=1e-5 * scale)
            got, want = got[..., :-tail], want[..., :-tail]
        np.testing.assert_allclose(got[..., :head], want[..., :head],
                                   rtol=1e-5, atol=1e-5)
        if not spec.road_map_obs:
            continue
        newest = i == n - 1
        got = _road_rows(got[..., head:], env.road_mask.numpy() if newest
                         else no_mask)
        want = _road_rows(want[..., head:], np.asarray(jenv.road_mask)
                          if newest else no_mask)
        if not ordered_roads:
            got = match_rows(got, want)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def assert_flat_obs_match(got, want):
    """Flat 3368-float rows [N, D] (a vec env's or a wrapper's): NaN rows
    in the same places, the ego and partner blocks within 1e-5 in order,
    the road rows within 1e-5 as sets."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    live = ~nan.any(axis=1)
    got, want = got[live], want[live]
    head = C.EGO_FEAT_DIM + PARTNER_DIM
    np.testing.assert_allclose(got[:, :head], want[:, :head], rtol=1e-5,
                               atol=1e-5)
    rows = (-1, C.MAX_AGENT_MAP_OBS, C.ROAD_GRAPH_FEAT_DIM)
    np.testing.assert_allclose(
        match_rows(got[:, head:].reshape(rows), want[:, head:].reshape(rows)),
        want[:, head:].reshape(rows), rtol=1e-5, atol=1e-5)


def no_matplotlib(monkeypatch):
    """Make ``import matplotlib`` fail for the rest of the test, as on a
    machine without it: the port's visualize modules are dropped from
    ``sys.modules`` so that their next import runs theirs."""
    import sys

    for name in list(sys.modules):
        if name.startswith("gpudrive_lab_torch.visualize"):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def record_states(monkeypatch, env) -> list:
    """The env's state after each ``step_dynamics`` (and after each
    ``reset``) while the test runs, in order."""
    states = []
    for name in ("reset", "step_dynamics"):
        real = getattr(env, name)

        def spy(*a, _real=real, **k):
            out = _real(*a, **k)
            states.append(env.state)
            return out
        monkeypatch.setattr(env, name, spy)
    return states


def jax_figures(scene, state, worlds, render_config=None, **kw):
    """The JAX visualizer's RGB arrays of ``worlds`` for the port's
    ``scene`` and ``state`` (both crossed through numpy)."""
    from gpudrive_lab_tpu.visualize.core import MatplotlibVisualizer

    vis = MatplotlibVisualizer(scene_to_jax(scene), render_config)
    return vis.plot_simulator_state(state_to_jax(state), list(worlds), **kw)
