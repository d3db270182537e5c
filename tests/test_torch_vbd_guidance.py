"""Parity of the port's VBD guidance (gpudrive_lab_torch/vbd/{guidance_metrics,
ilq,guidance}.py) with the JAX package, on the CPU.

Bars ("of the largest magnitude": max |got - want| over max |want|):

  * every guidance metric's values and the gradient of their sum (autograd
    against jax.grad), obb corners, the signed distance, ``dynamics`` and
    ``linearize``'s A and B: 1e-5 of the largest magnitude;
  * the three guided samplers (2 diffusion steps, 2 guidance iterations,
    the JAX draws given): 1e-3 absolute on the actions and trajectories;
    their reward histories, sums of rewards over agent pairs and steps in
    the thousands (a float32 ulp there is ~2.4e-4), within 1e-3 of their
    largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.vbd import guidance as jguidance
from gpudrive_lab_tpu.vbd import guidance_metrics as jgm
from gpudrive_lab_tpu.vbd import ilq as jilq
from gpudrive_lab_tpu.vbd import model as jmodel
from gpudrive_lab_torch.vbd import guidance, guidance_metrics as gm, ilq, model
from gpudrive_lab_torch.vbd.convert import vbd_params_from_flax
from torch_parity import recorded_draws

B, A, T = 2, 4, 20


def rel_err(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _batch(seed=0):
    """Agents in a 20 m box, moving at ~2 m/s, 4.5 x 2 m boxes; polylines
    half road edges (etype 1), half lanes."""
    rng = np.random.default_rng(seed)
    hist = np.zeros((B, A, 11, 8), np.float32)
    hist[..., 0:2] = rng.uniform(-10, 10, (B, A, 1, 2))
    hist[..., 2] = rng.uniform(-np.pi, np.pi, (B, A, 1))
    hist[..., 3] = 2.0 + rng.normal(size=(B, A, 1)) * 0.3
    hist[..., 5] = 4.5
    hist[..., 6] = 2.0
    hist[..., 7] = 1.5
    interested = np.ones((B, A), np.int32)
    interested[1, -1] = 0
    poly = np.zeros((B, 8, 10, 5), np.float32)
    poly[..., 0:2] = rng.uniform(-25, 25, (B, 8, 10, 2))
    poly[..., 2] = rng.uniform(-np.pi, np.pi, (B, 8, 10))
    poly[..., 4] = np.where(np.arange(8) < 4, 1, 3)[None, :, None]
    return {"agents_history": hist, "agents_id": np.tile(np.arange(A), (B, 1)),
            "agents_interested": interested, "polylines": poly}


def _trajs(seed=1):
    rng = np.random.default_rng(seed)
    cs = _batch()["agents_history"][:, :, -1, :5]
    acts = (rng.normal(size=(B, A, 4, 2)) * [1.0, 0.15]).astype(np.float32)
    trajs = np.array(jmodel.roll_out(cs, acts, action_len=5))
    return trajs, acts


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


METRICS = {
    "overlap": lambda m: m.overlap_reward(),
    "overlap_aoi_offset": lambda m: m.overlap_reward(aoi=[2, 0, 1],
                                                     offset=0.5,
                                                     saturate=True),
    "overlap_close": lambda m: m.overlap_reward(clip=30.0, weight=2.0),
    "overlap_simple": lambda m: m.overlap_reward_simple(clip=30.0),
    "onroad": lambda m: m.onroad_reward(weight=0.5),
    "onroad_aoi": lambda m: m.onroad_reward(aoi=[1, 3]),
    "control": lambda m: m.control_reward(2.0, 0.5),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_values_and_gradients_match_jax(name):
    trajs, acts = _trajs()
    batch = _batch()
    jfn, tfn = METRICS[name](jgm), METRICS[name](gm)
    want = jfn(jnp.asarray(trajs), jnp.asarray(acts), _j(batch))
    jg_traj, jg_act = jax.grad(lambda tr, ac: jfn(tr, ac, _j(batch)).sum(),
                               argnums=(0, 1))(jnp.asarray(trajs),
                                               jnp.asarray(acts))
    tr = torch.from_numpy(trajs).requires_grad_(True)
    ac = torch.from_numpy(acts).requires_grad_(True)
    got = tfn(tr, ac, _t(batch))
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5
    g_traj, g_act = torch.autograd.grad(got.sum(), (tr, ac),
                                        allow_unused=True)
    for g, w in ((g_traj, jg_traj), (g_act, jg_act)):
        w = np.asarray(w)
        if not np.abs(w).any():
            assert g is None or not g.abs().any()
            continue
        assert rel_err(g, w) <= 1e-5


def test_tracking_goal_and_geometry_match_jax():
    trajs, acts = _trajs(2)
    rng = np.random.default_rng(3)
    ref = trajs[..., :3] + rng.normal(size=trajs[..., :3].shape).astype(
        np.float32)
    w = rng.uniform(0, 2, trajs.shape[:3]).astype(np.float32)
    goal = rng.normal(size=(B, A, 2)).astype(np.float32) * 20
    gmask = (rng.uniform(size=(B, A, 2)) > 0.3).astype(np.float32)
    batch = _batch()
    for jfn, tfn in (
            (jgm.tracking_reward(jnp.asarray(ref), jnp.asarray(w), 0.5),
             gm.tracking_reward(torch.from_numpy(ref), torch.from_numpy(w),
                                0.5)),
            (jgm.goal_reward(jnp.asarray(goal), jnp.asarray(gmask), 10),
             gm.goal_reward(torch.from_numpy(goal), torch.from_numpy(gmask),
                            10))):
        want = jfn(jnp.asarray(trajs), jnp.asarray(acts), _j(batch))
        jg = jax.grad(lambda tr: jfn(tr, jnp.asarray(acts), _j(batch)).sum())(
            jnp.asarray(trajs))
        tr = torch.from_numpy(trajs).requires_grad_(True)
        got = tfn(tr, torch.from_numpy(acts), _t(batch))
        assert rel_err(got, want) <= 1e-5
        (g,) = torch.autograd.grad(got.sum(), tr)
        assert rel_err(g, jg) <= 1e-5
    x = np.linspace(-3, 3, 61).astype(np.float32)
    assert rel_err(gm.smooth_l1(torch.from_numpy(x), 0.7),
                   jgm.smooth_l1(jnp.asarray(x), 0.7)) <= 1e-6
    boxes = np.concatenate([rng.normal(size=(50, 2)) * 3,
                            rng.uniform(1, 5, (50, 2)),
                            rng.uniform(-np.pi, np.pi, (50, 1))],
                           -1).astype(np.float32)
    assert rel_err(gm.obb_corners(torch.from_numpy(boxes)),
                   jgm.obb_corners(jnp.asarray(boxes))) <= 1e-5
    a, b = boxes[:25], boxes[25:]
    sd = gm.signed_distance_obb(torch.from_numpy(a), torch.from_numpy(b))
    assert (sd < 0).any() and (sd > 0).any()  # overlapping and apart pairs
    assert rel_err(sd, jgm.signed_distance_obb(jnp.asarray(a),
                                               jnp.asarray(b))) <= 1e-5


def test_dynamics_and_linearize_match_jax():
    rng = np.random.default_rng(4)
    s = rng.normal(size=(2, 3, 5)).astype(np.float32) * 2
    s[0, 0, 3:5] = 0.01  # below the 0.1 m/s yaw-rate cut
    u = rng.normal(size=(2, 3, 2)).astype(np.float32)
    assert rel_err(ilq.dynamics(torch.from_numpy(s), torch.from_numpy(u), 0.1,
                                3),
                   jilq.dynamics(jnp.asarray(s), jnp.asarray(u), 0.1, 3)
                   ) <= 1e-5
    ja, jb = jilq.linearize(jnp.asarray(s), jnp.asarray(u))
    ta, tb = ilq.linearize(torch.from_numpy(s), torch.from_numpy(u))
    assert ta.shape == (2, 3, 5, 5) and tb.shape == (2, 3, 5, 2)
    assert rel_err(ta, ja) <= 1e-5
    assert rel_err(tb, jb) <= 1e-5


# ---------------------------------------------------------------------------
# the guided samplers
# ---------------------------------------------------------------------------

CFG = dict(future_len=20, agents_len=A, action_len=5, diffusion_steps=2,
           encoder_layers=1, hidden_dim=32, num_heads=2)


@pytest.fixture(scope="module")
def pair():
    jcfg = jmodel.VBDConfig(**CFG)
    jm = jmodel.VBDModel(jcfg)
    batch = dict(_batch(), anchors=np.zeros((B, A, 2, 2), np.float32))
    variables = jm.init(jax.random.PRNGKey(0), _j(batch),
                        jnp.zeros((B, A, 4, 2)), jnp.zeros((B, A), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = model.VBDModel(model.VBDConfig(**CFG), device="cpu")
    tm.load_state_dict(vbd_params_from_flax(variables), strict=True)
    return jm, variables, tm


def _goals():
    return np.array([[[30.0, 5.0], [-20.0, 10.0], [5.0, -30.0],
                      [0.0, 0.0]]] * B, np.float32)


GUIDED = {
    "ctg": dict(
        jax=lambda: dict(guidance=[jguidance.goal_guidance(
            jnp.asarray(_goals()), 1.0), jguidance.collision_guidance(),
            jguidance.comfort_guidance()],
            rewards=[jgm.control_reward(0.1, 0.1)], guidance_scale=0.3),
        torch=lambda: dict(guidance=[guidance.goal_guidance(
            torch.from_numpy(_goals()), 1.0), guidance.collision_guidance(),
            guidance.comfort_guidance()],
            rewards=[gm.control_reward(0.1, 0.1)], guidance_scale=0.3)),
    "waymo": dict(
        jax=lambda: dict(rewards=[jgm.overlap_reward(clip=30.0),
                                  jgm.onroad_reward(),
                                  jgm.goal_reward(jnp.asarray(_goals()))],
                         gradient_scale=0.05),
        torch=lambda: dict(rewards=[gm.overlap_reward(clip=30.0),
                                    gm.onroad_reward(),
                                    gm.goal_reward(torch.from_numpy(_goals()))],
                           gradient_scale=0.05)),
    "ibr": dict(
        jax=lambda: dict(ego_idx=0, adv_idx=1, ego_iter=1, adv_iter=1,
                         t_react=2),
        torch=lambda: dict(ego_idx=0, adv_idx=1, ego_iter=1, adv_iter=1,
                           t_react=2)),
    "ibr_others_ctg": dict(
        jax=lambda: dict(ego_idx=0, adv_idx=2, other_idx=[1, 3], ego_iter=1,
                         adv_iter=2, adv_use_ctg=True, gradient_scale=0.5),
        torch=lambda: dict(ego_idx=0, adv_idx=2, other_idx=[1, 3],
                           ego_iter=1, adv_iter=2, adv_use_ctg=True,
                           gradient_scale=0.5)),
}


@pytest.mark.parametrize("name", sorted(GUIDED))
def test_guided_samplers_match_jax(pair, name):
    jm, variables, tm = pair
    mode = name.split("_")[0]
    batch = _batch(5)
    with recorded_draws() as draws:
        want = jguidance.GUIDANCE_MODES[mode](
            jm, variables, jmodel.DDPMScheduler(2), _j(batch),
            jax.random.PRNGKey(6), jmodel.VBDConfig(**CFG), guidance_iter=2,
            **GUIDED[name]["jax"]())
    assert len(draws) == 1 + 2
    got = guidance.GUIDANCE_MODES[mode](
        tm, model.DDPMScheduler(2), _t(batch), model.VBDConfig(**CFG),
        draws, guidance_iter=2, **GUIDED[name]["torch"]())
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        if k.endswith("history"):  # reward sums in the thousands
            assert rel_err(got[k], w) <= 1e-3, k
        else:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-3,
                                       err_msg=k)
    # the guidance moved the sample away from the unguided one
    plain = model.sample_denoiser(tm, model.DDPMScheduler(2), _t(batch),
                                  model.VBDConfig(**CFG), draws)
    assert not torch.allclose(plain["denoised_actions"],
                              got["denoised_actions"])
    assert all(not p.requires_grad or p.grad is None
               for p in tm.parameters())


def test_unguided_ctg_is_the_plain_sampler(pair):
    _, _, tm = pair
    batch = _t(_batch(7))
    cfg, sched = model.VBDConfig(**CFG), model.DDPMScheduler(2)
    a = guidance.sample_denoiser_guided(tm, sched, batch, cfg,
                                        torch.Generator().manual_seed(1))
    b = model.sample_denoiser(tm, sched, batch, cfg,
                              torch.Generator().manual_seed(1))
    torch.testing.assert_close(a["denoised_trajs"], b["denoised_trajs"],
                               rtol=0, atol=0)
