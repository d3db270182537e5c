"""Linear probing and the closed-loop analyses: the port's
gpudrive_lab_torch/il/{linear_probing,analysis}.py against the JAX
package's on the same inputs, on the CPU.

  * the grid helpers, ``partner_slot_map``, ``position_grid_labels`` and
    ``expert_done_steps`` equal;
  * ``LinearProbe`` from the JAX probe's initial weights, in the same
    sample order (numpy's): parameters within 1e-4, loss within 1e-5 and
    accuracy equal;
  * on the expert data of two pool worlds with a narrow BC net
    (BCConfig(network_dim=32, num_head=2, num_stack=3)): the frozen
    contexts and tokens within 1e-5, ``probe_labels_from_positions`` equal,
    ``probe_action_and_position`` and ``train_position_probes`` from the
    JAX initial weights within 1e-4 (accuracies within one sample), and
    ``intervention_effect`` and ``predict_partner_cells`` equal;
  * ``closed_loop_rollout`` on the 2 worlds x 6 steps with importance,
    tokens and states: the episode flags and the rates equal, goal
    progress within 1e-5, the importance (ego->partner attention) within
    1e-5 and summing to 1 per head, tokens within 1e-4 and positions within
    the step's 1e-3 bar.  Goal time ratio equal.

The overlay plots of tests/test_il_analysis.py are held against the JAX
visualizer in tests/test_torch_visualize.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.il import analysis as jan
from gpudrive_lab_tpu.il import data_generation as jgen
from gpudrive_lab_tpu.il import linear_probing as jlp
from gpudrive_lab_tpu.il.dataset import ExpertDataset as JaxDataset
from gpudrive_lab_tpu.il.networks import BCConfig as JaxBCConfig
from gpudrive_lab_tpu.il.networks import EarlyFusionAttnBCNet as JaxNet
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.il import analysis as tan
from gpudrive_lab_torch.il import linear_probing as tlp
from gpudrive_lab_torch.il.dataset import ExpertDataset
from gpudrive_lab_torch.il.networks import BCConfig, EarlyFusionAttnBCNet
from gpudrive_lab_torch.networks.convert import bc_params_from_flax
from torch_parity import POOL_SCENES, python_scene_compiler, scene_to_jax
from test_torch_il import bc_variables

PATHS = POOL_SCENES[20:22]
# 128 agent rows: the JAX package's partner position labels have A - 1
# slots, which match the 127 partner tokens only there
ENV_KW = dict(dynamics_model="delta_local", collision_behavior="ignore")
NARROW = dict(network_dim=32, num_head=2, num_stack=3)


class JaxInitProbe(tlp.LinearProbe):
    """The port's probe started from the JAX probe's weights (its
    PRNGKey(0) normal draw) instead of the torch generator's."""

    def __init__(self, context_dim, num_classes, config, device=None,
                 generator=None):
        super().__init__(context_dim, num_classes, config, device)
        w = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (context_dim, num_classes)))
        with torch.no_grad():
            self.params["w"].copy_(torch.from_numpy(
                w / np.sqrt(context_dim)))


def test_grid_helpers_match_jax():
    np.testing.assert_array_equal(tan.cell_centers_ego_frame(),
                                  jan.cell_centers_ego_frame())
    assert tan.grid_cells() == jan.grid_cells() == 64
    rel = np.random.default_rng(0).uniform(-150, 150, (500, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tan.position_to_cell(torch.from_numpy(rel)).numpy(),
        jan.position_to_cell(rel))
    np.testing.assert_array_equal(tan.partner_slot_map(16),
                                  jan.partner_slot_map(16))
    small = rel / 20
    np.testing.assert_array_equal(
        tlp.position_grid_labels(torch.from_numpy(small)).numpy(),
        jlp.position_grid_labels(small))


def test_linear_probe_matches_jax():
    """Same initial weights and sample order: the Adam steps agree."""
    rng = np.random.default_rng(1)
    ctx = rng.normal(size=(300, 16)).astype(np.float32)
    labels = (ctx[:, 0] > 0).astype(np.int64) + 2 * (ctx[:, 1] > 0.5)
    cfg = jlp.ProbeConfig(epochs=3, batch_size=64, lr=1e-2)
    jp = jlp.LinearProbe(16, 4, cfg)
    jout = jp.fit(ctx, labels, np.random.default_rng(2))
    tp = JaxInitProbe(16, 4, tlp.ProbeConfig(epochs=3, batch_size=64,
                                             lr=1e-2))
    tout = tp.fit(torch.from_numpy(ctx), torch.from_numpy(labels),
                  np.random.default_rng(2))
    for k in ("w", "b"):
        np.testing.assert_allclose(tp.params[k].detach().numpy(),
                                   np.asarray(jp.params[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
    assert abs(tout["loss"] - jout["loss"]) <= 1e-5
    assert tout["accuracy"] == jout["accuracy"]
    # the port's own init: N(0, 1/dim) from a torch generator, seeded 0
    own = tlp.LinearProbe(16, 4, tlp.ProbeConfig())
    assert torch.equal(own.params["w"], tlp.LinearProbe(
        16, 4, tlp.ProbeConfig()).params["w"])
    assert float(own.params["w"].detach().std()) < 0.5


@pytest.fixture(scope="module")
def setup():
    """The expert data of two pool worlds (JAX-generated; the port's data
    generation is held to it in test_torch_il.py), both packages'
    datasets over it, a narrow BC net's weights, and the policy-controlled
    evaluation envs."""
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(num_worlds=2,
                                           max_controlled_agents=0,
                                           **ENV_KW), scene_paths=PATHS)
        data = jgen.generate_state_action_pairs(jenv)
        data["controlled_mask"] = data["valid_mask"]
        jeval = GPUDriveTPUEnv(JaxEnvConfig(num_worlds=2, **ENV_KW),
                               scene_paths=PATHS)
    jds = JaxDataset(data, rollout_len=3)
    tds = ExpertDataset(data, rollout_len=3, device="cpu")
    cfg = JaxBCConfig(**NARROW)
    ex = jds.batch(np.arange(2))
    variables = bc_variables(cfg, 3, (ex["obs"], ex["partner_mask"],
                                      ex["road_mask"]))
    net = EarlyFusionAttnBCNet(BCConfig(**NARROW), device="cpu")
    net.load_state_dict(bc_params_from_flax(variables))
    teval = GPUDriveTorchEnv(EnvConfig(**ENV_KW), PATHS, device="cpu")
    return dict(jds=jds, tds=tds, cfg=cfg, variables=variables, net=net,
                jeval=jeval, teval=teval)


def test_expert_done_steps_match_jax(setup):
    scene = setup["teval"].scene
    got = tan.expert_done_steps(scene)
    want = jan.expert_done_steps(scene_to_jax(scene))
    np.testing.assert_array_equal(got.numpy(), want)


def test_probes_and_intervention_match_jax(setup, monkeypatch):
    jds, tds, variables, net = (setup[k] for k in ("jds", "tds",
                                                   "variables", "net"))
    model = JaxNet(setup["cfg"])
    jctx = jlp.extract_contexts(model, variables, jds)
    tctx = tlp.extract_contexts(net, tds)
    np.testing.assert_allclose(tctx.numpy(), jctx, rtol=0, atol=1e-5)
    jtok = jan.extract_token_dataset(model, variables, jds)
    ttok = tan.extract_token_dataset(net, tds)
    for k in ("ego", "ro"):
        np.testing.assert_allclose(ttok[k].numpy(), jtok[k], rtol=0,
                                   atol=1e-5, err_msg=k)
    jlab = jan.probe_labels_from_positions(jds, future_step=5)
    tlab = tan.probe_labels_from_positions(tds, future_step=5)
    for k in ("ego", "partner"):
        np.testing.assert_array_equal(tlab[k].numpy(), jlab[k], err_msg=k)

    monkeypatch.setattr(tlp, "LinearProbe", JaxInitProbe)
    monkeypatch.setattr(tan, "LinearProbe", JaxInitProbe)
    pcfg = dict(epochs=1, batch_size=32)
    n = len(jds)
    jres = jlp.probe_action_and_position(model, variables, jds, None,
                                         jlp.ProbeConfig(**pcfg))
    tres = tlp.probe_action_and_position(net, tds, None,
                                         tlp.ProbeConfig(**pcfg))
    for name in jres:
        assert abs(tres[name]["loss"] - jres[name]["loss"]) <= 1e-4, name
        assert abs(tres[name]["accuracy"] - jres[name]["accuracy"]) \
            <= 1.0 / n, name

    t, w, a = jds.index.T
    valid = jds.data["partner_mask"][t, w, a] == 0
    jego, jother, jm = jan.train_position_probes(
        jtok, jlab, valid, jlp.ProbeConfig(**pcfg))
    tego, tother, tm = tan.train_position_probes(
        {k: torch.from_numpy(np.asarray(v)) for k, v in jtok.items()},
        tlab, torch.from_numpy(valid), tlp.ProbeConfig(**pcfg))
    for jp, tp in ((jego, tego), (jother, tother)):
        for k in ("w", "b"):
            np.testing.assert_allclose(tp.params[k].detach().numpy(),
                                       np.asarray(jp.params[k]), rtol=0,
                                       atol=1e-4, err_msg=k)
    for k in ("ego", "partner"):
        assert abs(tm[k]["loss"] - jm[k]["loss"]) <= 1e-4, k
    ego = jtok["ego"][:64]
    jiv = jan.intervention_effect(jego, jother, ego, intervention_label=10)
    tiv = tan.intervention_effect(tego, tother, torch.from_numpy(ego), 10)
    for k in jiv:
        np.testing.assert_array_equal(tiv[k].numpy(), jiv[k], err_msg=k)
    ro = jtok["ro"][:8]
    np.testing.assert_array_equal(
        tan.predict_partner_cells(tother, torch.from_numpy(ro)).numpy(),
        jan.predict_partner_cells(jother, ro))


def test_closed_loop_rollout_matches_jax(setup):
    cfg, variables, net = setup["cfg"], setup["variables"], setup["net"]
    kw = dict(max_steps=6, collect_importance=True, collect_tokens=True,
              collect_states=True)
    jres = jan.closed_loop_rollout(setup["jeval"], JaxNet(cfg), variables,
                                   cfg, **kw)
    tres = tan.closed_loop_rollout(setup["teval"], net, BCConfig(**NARROW),
                                   **kw)
    for k in ("goal_rate", "collision_rate", "off_road_rate",
              "goal_time_ratio"):
        assert tres.metrics[k] == pytest.approx(jres.metrics[k], abs=1e-7), k
    assert tres.metrics["goal_rate"] == jres.metrics["goal_rate"]
    assert abs(tres.metrics["goal_progress"]
               - jres.metrics["goal_progress"]) <= 1e-5
    for k in ("goal_achieved", "collided", "off_road"):
        np.testing.assert_array_equal(getattr(tres, k).numpy(),
                                      getattr(jres, k), err_msg=k)
    assert tres.importance.shape == jres.importance.shape == (
        6, 2, cfg.num_head, cfg.ro_max)
    np.testing.assert_allclose(tres.importance.numpy(), jres.importance,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tres.importance.sum(-1).numpy(), 1.0,
                               atol=1e-5)
    for k in ("ego_tokens", "ro_tokens"):
        np.testing.assert_allclose(getattr(tres, k).numpy(),
                                   getattr(jres, k), rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(tres.positions.numpy(), jres.positions,
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(tres.yaws.numpy(), jres.yaws, rtol=0,
                               atol=1e-3)
    # a draw from the mixture runs too
    res = tan.closed_loop_rollout(setup["teval"], net, BCConfig(**NARROW),
                                  max_steps=2, deterministic=False)
    assert 0.0 <= res.metrics["goal_progress"] <= 1.0


def test_partner_labels_on_a_bucketed_agent_axis():
    """On 16 agent rows the partner labels still have one entry per
    observation slot (127), the slots past the rows being padding."""
    from gpudrive_lab_torch.il.data_generation import (
        generate_state_action_pairs,
    )

    env = GPUDriveTorchEnv(EnvConfig(max_controlled_agents=0,
                                     agent_bucket="auto", **ENV_KW), PATHS,
                           device="cpu")
    data = generate_state_action_pairs(env)
    data["controlled_mask"] = data["valid_mask"]
    ds = ExpertDataset(data, rollout_len=3, device="cpu")
    lab = tan.probe_labels_from_positions(ds, future_step=5)
    assert env.max_agent_count == 16
    assert lab["partner"].shape == (len(ds), 127)
    t, w, a = ds.index_t.unbind(1)
    live = data["partner_mask"][t, w, a] == 0
    assert not bool(live[:, 15:].any())  # only padding past the rows
    full = tan.partner_slot_map(16)
    rows = torch.as_tensor(full)[a][:, :15]
    want = tan.position_to_cell(tan._rotate_into_ego(
        data["positions"][torch.clamp(t + 5, max=90)[:, None], w[:, None],
                          rows] - data["positions"][t, w, a][:, None],
        data["yaw"][t, w, a][:, None]))
    assert torch.equal(lab["partner"][:, :15], want)
