"""The port's official VBD (``vbd/model_official.py``, ``vbd/model.py``'s
scheduler and roll-out, ``vbd/integration.py``) against the plain
reference, on the CPU: both copies of it, ``tests/vbd_official_reference.py``
and the benchmark's frozen ``benchmark/gdbench/reference/vbd_official.py``.

Full widths (256 wide, 8 heads, FFN 1024, 6 encoder layers, 11 history
steps, 30 points a polyline, 16 lights, 80 future steps in 16 blocks) at a
small size: 2 pool worlds, 8 agents, 16 polylines, 3 diffusion steps.  The
seeded weights are the port's, loaded into the reference by name with
``load_state_dict(strict=True)``.

Tolerances, each a gap over the largest magnitude of the reference's
output (``rel_gap``):
  * MODEL_TOL 1e-5 for the encoder, the denoiser, the sample and the
    roll-out: both compute in float32, but the port batches the agents and
    forms q.k + q.r where the reference forms q.(k + r), so sums run in
    other orders; the gaps read up to 4.5e-6 (the local-frame roll-out, a
    cumulative sum over 80 steps) and 7e-7 elsewhere.
  * EXACT_TOL 1e-6 for the scheduler step, the relations, the scatter, the
    VBD observation block and reward: elementwise formulas, the same in
    both up to the last bit of a coefficient (read: 1e-7 and below).
A reference computed in bfloat16 (8 bits of mantissa) reads 1e-2 and
fails every one of them: each comparison is also run so and must fail.
"""

import ast
import copy
import importlib.util
import os

import pytest
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv, shaped_rewards
from gpudrive_lab_torch.rollout import SLICE_CONFIG
from gpudrive_lab_torch.vbd import integration, model_official
from gpudrive_lab_torch.vbd.data_utils import (
    VBDSampleConfig,
    official_inputs,
    process_scenario_data,
)
from gpudrive_lab_torch.vbd.model import DDPMScheduler, roll_out
from torch_parity import POOL_SCENES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = {"tests": os.path.join(ROOT, "tests", "vbd_official_reference.py"),
          "benchmark": os.path.join(ROOT, "benchmark", "gdbench",
                                    "reference", "vbd_official.py")}
MODEL_TOL = 1e-5
EXACT_TOL = 1e-6
AGENTS, POLYLINES, STEPS = 8, 16, 3
DTYPES = [torch.float32, torch.bfloat16]  # the second must fail
FORBIDDEN = {"jax", "jaxlib", "flax", "gpudrive_lab_tpu",
             "gpudrive_lab_torch"}


def load_copy(name: str):
    spec = importlib.util.spec_from_file_location(
        f"vbd_reference_{name}", COPIES[name])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rel_gap(got, want) -> float:
    want = want.double()
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def holds(gap: float, tol: float, dtype) -> bool:
    """float32 within the tolerance; bfloat16 beyond it."""
    return gap <= tol if dtype == torch.float32 else gap > tol


def cast(x, dtype):
    if isinstance(x, dict):
        return {k: cast(v, dtype) for k, v in x.items()}
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


@pytest.fixture(scope="module")
def port():
    """The env on 2 pool worlds with the VBD block and reward, the port's
    seeded model at full width (8 agents, 3 diffusion steps), and its
    sample inputs at the env's reset state."""
    env = GPUDriveTorchEnv(EnvConfig(**dict(
        SLICE_CONFIG, agent_bucket="auto", use_vbd=True, vbd_in_obs=True,
        reward_type="distance_to_vdb_trajs")), POOL_SCENES[20:22],
        device="cpu")
    cfg = model_official.OfficialVBDConfig(agents_len=AGENTS,
                                           diffusion_steps=STEPS)
    model = model_official.OfficialVBD(
        cfg, device="cpu", generator=torch.Generator().manual_seed(7)).eval()
    batch = process_scenario_data(
        env.scene, env.state, 0,
        VBDSampleConfig(max_agents=AGENTS, max_polylines=POLYLINES))
    inputs = official_inputs(batch)
    with torch.no_grad():
        enc = model.encode(inputs)
    return env, model, batch, inputs, enc


@pytest.fixture(scope="module", params=sorted(COPIES))
def ref(request, port):
    """(the reference module, its model with the port's weights)."""
    R = load_copy(request.param)
    _, model, *_ = port
    net = R.VBD(R.Config(agents_len=AGENTS, diffusion_steps=STEPS))
    net.load_state_dict(model.state_dict(), strict=True)
    return R, net


def reference_model(ref, dtype):
    """The reference model in ``dtype`` (a copy: its weights stay
    float32)."""
    _, net = ref
    return net if dtype == torch.float32 else copy.deepcopy(net).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_outputs(port, ref, dtype):
    _, _, _, inputs, enc = port
    net = reference_model(ref, dtype)
    got = net.encode(cast(inputs, dtype))
    for key in ("encodings", "relation_encodings"):
        gap = rel_gap(got[key], enc[key])
        assert holds(gap, MODEL_TOL, dtype), (key, gap)
    for key in ("agents_mask", "maps_mask", "traffic_lights_mask"):
        assert torch.equal(got[key], enc[key]), key


def test_relations_from_the_batch(port, ref):
    _, _, _, inputs, _ = port
    R, _ = ref
    want = R.relations(inputs["agents_history"], inputs["polylines"],
                       inputs["traffic_light_points"])
    assert rel_gap(inputs["relations"], want) <= EXACT_TOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_each_denoise_step(port, ref, dtype):
    """At each diffusion step, from the same x_t: the denoiser's x0 on the
    reference's own encoding, then the scheduler's step from the port's x0
    with the same draw."""
    _, model, _, inputs, enc = port
    R, _ = ref
    net = reference_model(ref, dtype)
    gen = torch.Generator().manual_seed(11)
    sched, rsched = DDPMScheduler(STEPS), R.DDPMScheduler(STEPS)
    renc = net.encode(cast(inputs, dtype))
    for t in reversed(range(STEPS)):
        x_t = torch.randn((2, AGENTS, 16, 2), generator=gen)
        eps = torch.randn((2, AGENTS, 16, 2), generator=gen)
        steps = torch.full((2, AGENTS), t)
        with torch.no_grad():
            x0 = model.denoise(enc, x_t, steps)
        gap = rel_gap(net.denoise(renc, x_t.to(dtype), steps), x0)
        assert holds(gap, MODEL_TOL, dtype), (t, gap)
        want = rsched.step(x0.to(dtype), x_t.to(dtype), t, eps.to(dtype))
        gap = rel_gap(want, sched.step(x0, x_t, t, [eps.numpy()]))
        assert holds(gap, EXACT_TOL, dtype), (t, gap)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sample_official_with_given_draws(port, ref, dtype):
    _, model, _, inputs, _ = port
    R, _ = ref
    net = reference_model(ref, dtype)
    gen = torch.Generator().manual_seed(13)
    draws = [torch.randn((2, AGENTS, 16, 2), generator=gen)
             for _ in range(STEPS + 1)]
    out = model_official.sample_official(
        model, DDPMScheduler(STEPS), inputs, noise=[d.numpy() for d in draws])
    actions, trajs = R.sample(net, R.DDPMScheduler(STEPS),
                              cast(inputs, dtype),
                              [d.to(dtype) for d in draws])
    assert holds(rel_gap(actions, out["denoised_actions"]), MODEL_TOL, dtype)
    assert holds(rel_gap(trajs, out["denoised_trajs"]), MODEL_TOL, dtype)


@pytest.mark.parametrize("global_frame", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_roll_out(port, ref, dtype, global_frame):
    _, _, _, inputs, _ = port
    R, _ = ref
    current = inputs["agents_history"][:, :AGENTS, -1, :5]
    actions = torch.randn((2, AGENTS, 16, 2),
                          generator=torch.Generator().manual_seed(17))
    want = roll_out(current, actions, action_len=5,
                    global_frame=global_frame)
    got = R.roll_out(current.to(dtype), actions.to(dtype), 5,
                     global_frame=global_frame)
    assert holds(rel_gap(got, want), MODEL_TOL, dtype)


def test_scatter_to_the_agent_rows(port, ref):
    env, _, batch, _, _ = port
    R, _ = ref
    trajs = torch.randn((2, AGENTS, 80, 5),
                        generator=torch.Generator().manual_seed(19))
    want = integration.scatter_trajectories(trajs, batch["agents_id"],
                                            env.max_agent_count)
    got = R.scatter(trajs, batch["agents_id"], env.max_agent_count)
    assert rel_gap(got, want) <= EXACT_TOL
    assert int((got.abs().sum((-1, -2)) > 0).sum()) == int(
        (batch["agents_id"] >= 0).sum())


@pytest.mark.parametrize("dtype", DTYPES)
def test_vbd_obs_block_and_reward(port, ref, dtype):
    """The env's last 455 observation floats and its reward's VBD bonus,
    two steps after a sampled source's trajectories were installed."""
    env, model, *_ = port
    R, _ = ref
    env.reset()
    env.set_vbd_trajectories(integration.OfficialVBDSource(model, seed=3))
    for _ in range(2):
        env.step_dynamics(torch.randint(
            0, env.action_space_n, (env.num_worlds, env.max_agent_count),
            generator=torch.Generator().manual_seed(23)))
    obs, reward = env.get_obs(), env.get_rewards()
    s, traj = env.state, env.vbd_trajectories
    block = R.vbd_obs_block(s.pos.to(dtype), s.yaw.to(dtype), traj.to(dtype))
    assert holds(rel_gap(block, obs[..., -integration.VBD_OBS_DIM:]),
                 EXACT_TOL, dtype)
    base = shaped_rewards(env.scene, s, "weighted_combination",
                          env.reward_weights, env.world_time_steps)
    bonus = R.vbd_reward(s.pos.to(dtype), traj.to(dtype),
                         env.world_time_steps,
                         env.config.vbd_trajectory_weight)
    assert holds(rel_gap(bonus, reward - base), EXACT_TOL, dtype)
    assert obs.shape[-1] == env.observation_dim == (
        env.spec.obs_dim + 91 * 5)
    assert C.TRAJECTORY_LEN == R.TRAJECTORY_LEN


@pytest.mark.parametrize("name", sorted(COPIES))
def test_a_copy_imports_nothing_of_either_package(name):
    """Neither copy imports JAX or either package: it stands beside them
    as a plain reference (its top-level imports, read from the source)."""
    with open(COPIES[name]) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names and not names & FORBIDDEN, names
    assert names <= {"__future__", "math", "numpy", "torch"}, names
