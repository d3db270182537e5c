"""Parity of the port's TPU-first VBD (gpudrive_lab_torch/vbd/model.py) and
its sample batch (vbd/data_utils.py) with the JAX package, on the CPU.

Inputs are numpy arrays from a seed; the JAX VBDModel's flax weights (its
initialisation, every leaf then moved by seeded noise so that zero biases
are tested too) cross over through ``vbd.convert.vbd_params_from_flax``.
The samplers and ``denoise_loss`` get the draws the JAX function took for
the same key.  Bars ("of the largest magnitude": max |got - want| over
max |want|):

  * roll_out, inverse_roll_out and the scheduler's terms: 1e-5 of the
    largest magnitude;
  * the model's outputs (hidden 64, 1 layer, 4 heads, 8 agents, 4
    diffusion steps): 1e-4 of the largest magnitude;
  * denoise_loss: 1e-4 of its magnitude; every gradient leaf within 1e-4
    of the whole gradient's largest magnitude;
  * sample_denoiser: actions 1e-4, trajectories 1e-3 absolute;
  * the sample batch on pool scenes: ids, types, masks exact; histories
    and polylines within 1e-6 absolute; the relations within 1e-6 of their
    largest magnitude (cos and sin differ by an ulp between numpy and
    torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.vbd import data_utils as jdata
from gpudrive_lab_tpu.vbd import model as jmodel
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import expert_actions
from gpudrive_lab_torch.scene.compiler import build_scene
from gpudrive_lab_torch.vbd import data_utils, model
from gpudrive_lab_torch.vbd.convert import (
    assert_state_dict_matches,
    vbd_params_from_flax,
)
from torch_parity import (
    POOL_SCENES,
    recorded_draws,
    scene_to_jax,
    state_to_jax,
)

CFG = dict(future_len=20, agents_len=8, action_len=5, diffusion_steps=4,
           encoder_layers=1, hidden_dim=64, num_heads=4)
B, A = 2, 8


def rel_err(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _batch(seed=0, anchors=True):
    rng = np.random.default_rng(seed)
    ids = np.where(np.arange(A)[None].repeat(B, 0) < 5,
                   np.arange(A)[None].repeat(B, 0), -1).astype(np.int32)
    poly = rng.normal(size=(B, 16, 10, 5)).astype(np.float32)
    poly[1, -3:] = 0.0  # padded polylines
    interested = np.ones((B, A), np.int32)
    interested[0, 3] = 0
    out = {
        "agents_history": rng.normal(size=(B, A, 11, 8)).astype(np.float32),
        "agents_id": ids,
        "agents_interested": interested,
        "polylines": poly,
    }
    if anchors:
        out["anchors"] = rng.normal(size=(B, A, 4, 2)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, flax variables, port model) on the same weights."""
    jcfg = jmodel.VBDConfig(**CFG)
    jm = jmodel.VBDModel(jcfg)
    x = jnp.zeros((B, A, jcfg.action_blocks, 2))
    t = jnp.zeros((B, A), jnp.int32)
    variables = jm.init(jax.random.PRNGKey(0), _jnp(_batch()), x, t)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(
            np.float32), variables)
    tm = model.VBDModel(model.VBDConfig(**CFG), device="cpu")
    sd = vbd_params_from_flax(variables)
    assert_state_dict_matches(sd, tm)
    tm.load_state_dict(sd, strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("global_frame", [True, False])
def test_roll_out_and_inverse_match_jax(global_frame):
    rng = np.random.default_rng(0)
    cs = rng.normal(size=(2, 4, 5)).astype(np.float32) * 3
    acts = (rng.normal(size=(2, 4, 4, 2)) * 0.5).astype(np.float32)
    want = jmodel.roll_out(cs, acts, action_len=5, global_frame=global_frame)
    got = model.roll_out(torch.from_numpy(cs), torch.from_numpy(acts),
                         action_len=5, global_frame=global_frame)
    assert got.shape == (2, 4, 20, 5)
    assert rel_err(got, want) <= 1e-5
    want = np.array(want)
    inv_want = jmodel.inverse_roll_out(want, cs, action_len=5)
    inv = model.inverse_roll_out(torch.from_numpy(want),
                                 torch.from_numpy(cs), action_len=5)
    assert rel_err(inv, inv_want) <= 1e-5


@pytest.mark.parametrize("steps", [4, 50])
def test_scheduler_terms_match_jax(steps):
    js, ts = jmodel.DDPMScheduler(steps), model.DDPMScheduler(steps)
    for name in ("betas", "alphas", "alpha_bars"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    rng = np.random.default_rng(steps)
    x0 = (rng.normal(size=(2, 3, 4, 2)) * 3).astype(np.float32)
    xt = rng.normal(size=(2, 3, 4, 2)).astype(np.float32)
    eps = rng.normal(size=(2, 3, 4, 2)).astype(np.float32)
    t = rng.integers(0, steps, (2, 3)).astype(np.int32)
    t[0, 0] = 0
    T = torch.from_numpy
    assert rel_err(ts.add_noise(T(x0), T(eps), T(t).long()),
                   js.add_noise(x0, eps, t)) <= 1e-5
    for tt in (t, steps - 1, 0):
        jt = jnp.asarray(tt, jnp.int32)
        tt_t = torch.as_tensor(tt).long()
        jm, jsd = js.posterior_mean_std(x0, xt, jt)
        tm, tsd = ts.posterior_mean_std(T(x0), T(xt), tt_t)
        assert rel_err(tm, jm) <= 1e-5
        assert rel_err(tsd, np.broadcast_to(jsd, tsd.shape)) <= 1e-5
        with recorded_draws() as draws:
            want = js.step(x0, xt, jt, jax.random.PRNGKey(3))
        assert rel_err(ts.step(T(x0), T(xt), tt_t, draws), want) <= 1e-5
    for step in range(steps):
        want = 0.0 if step == 0 else np.sqrt(
            js.betas[step] * (1 - js.alpha_bars[step - 1])
            / (1 - js.alpha_bars[step]))
        assert float(ts.std_at(step)) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("anchors", [True, False])
def test_vbd_model_forward_matches_jax(pair, anchors):
    jm, variables, tm = pair
    batch = _batch(2, anchors)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, A, 4, 2)).astype(np.float32)
    t = rng.integers(0, 4, (B, A)).astype(np.int32)
    want = jm.apply(variables, _jnp(batch), jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tm(_torch(batch), torch.from_numpy(x), torch.from_numpy(t))
    assert got[0].shape == (B, A, 4, 2)
    assert rel_err(got[0], want[0]) <= 1e-4
    if anchors:
        assert got[1].shape == (B, A, 4, 4, 2) and got[2].shape == (B, A, 4)
        assert rel_err(got[1], want[1]) <= 1e-4
        assert rel_err(got[2], want[2]) <= 1e-4
    else:
        assert got[1] is None and want[1] is None


def test_denoise_loss_and_gradient_match_jax(pair):
    jm, variables, tm = pair
    jcfg, tcfg = jmodel.VBDConfig(**CFG), model.VBDConfig(**CFG)
    batch = _batch(4)
    gt = np.random.default_rng(5).normal(size=(B, A, 4, 2)).astype(np.float32)
    sched = jmodel.DDPMScheduler(4)
    key = jax.random.PRNGKey(7)

    def loss_fn(v):
        return jmodel.denoise_loss(jm, v, sched, _jnp(batch), jnp.asarray(gt),
                                   key, jcfg)

    with recorded_draws() as draws:
        loss_fn(variables)
    assert [d.shape for d in draws] == [(B, A), (B, A, 4, 2)]
    want, jgrads = jax.value_and_grad(loss_fn)(variables)
    tm.zero_grad()
    got = model.denoise_loss(tm, model.DDPMScheduler(4), _torch(batch),
                             torch.from_numpy(gt), tcfg, draws)
    got.backward()
    assert rel_err(got, want) <= 1e-4
    want_g = vbd_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    # the goal predictor runs but the loss does not reach it: no gradient
    # in torch, zeros in JAX
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in tm.named_parameters()}
    H = CFG["hidden_dim"]
    # the bar is of the whole gradient's largest magnitude: a leaf whose
    # gradient is zero in exact arithmetic (the relative-pose bias's bias,
    # a constant over the keys of a softmax) holds float noise on both sides
    scale = max(float(np.abs(w.numpy()).max()) for w in want_g.values())
    for k, w in want_g.items():
        g = grads[k]
        if k.endswith("bias_hh_l0"):
            # flax's hidden r and z gates have no bias: torch's add to the
            # same pre-activation as the input biases, so their gradients
            # are the input biases'
            assert rel_err(g[:2 * H], grads[k.replace("hh", "ih")][
                :2 * H].numpy()) <= 1e-5
            g, w = g[2 * H:], w[2 * H:]
        assert float((g - w).abs().max()) <= 1e-4 * scale, k


def test_sample_denoiser_matches_jax(pair):
    jm, variables, tm = pair
    batch = _batch(6, anchors=False)
    jcfg, tcfg = jmodel.VBDConfig(**CFG), model.VBDConfig(**CFG)
    with recorded_draws() as draws:
        want = jmodel.sample_denoiser(jm, variables, jmodel.DDPMScheduler(4),
                                      _jnp(batch), jax.random.PRNGKey(8),
                                      jcfg)
    assert len(draws) == 1 + 4
    got = model.sample_denoiser(tm, model.DDPMScheduler(4), _torch(batch),
                                tcfg, draws)
    assert got["denoised_trajs"].shape == (B, A, 20, 5)
    assert rel_err(got["denoised_actions"], want["denoised_actions"]) <= 1e-4
    np.testing.assert_allclose(got["denoised_trajs"].numpy(),
                               np.asarray(want["denoised_trajs"]), rtol=0,
                               atol=1e-3)


def test_draws_from_a_generator_and_refusals():
    """Without given draws the sampler draws from a generator (seeded runs
    repeat); a given draw of another shape, and a dtype other than
    float32, are refused."""
    tm = model.VBDModel(model.VBDConfig(**CFG), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    batch = _torch(_batch(anchors=False))
    cfg, sched = model.VBDConfig(**CFG), model.DDPMScheduler(4)
    a = model.sample_denoiser(tm, sched, batch, cfg,
                              torch.Generator().manual_seed(1))
    b = model.sample_denoiser(tm, sched, batch, cfg,
                              torch.Generator().manual_seed(1))
    torch.testing.assert_close(a["denoised_trajs"], b["denoised_trajs"],
                               rtol=0, atol=0)
    assert torch.isfinite(a["denoised_trajs"]).all()
    # no noise given: a new generator on the batch's device, seeded 0
    c, d = (model.sample_denoiser(tm, sched, batch, cfg) for _ in range(2))
    torch.testing.assert_close(c["denoised_trajs"], d["denoised_trajs"],
                               rtol=0, atol=0)
    # roll_out's training jitter draws from its generator only
    cs, acts = batch["agents_history"][:, :, -1, :5], a["denoised_actions"]
    plain = model.roll_out(cs, acts)
    j1, j2 = (model.roll_out(cs, acts, generator=torch.Generator()
                             .manual_seed(2)) for _ in range(2))
    torch.testing.assert_close(j1, j2, rtol=0, atol=0)
    assert not torch.allclose(j1, plain)
    with pytest.raises(ValueError, match="shape"):
        model.sample_denoiser(tm, sched, batch, cfg, [np.zeros((1, 2))])
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        model.VBDModel(model.VBDConfig(dtype=torch.bfloat16), device="cpu")


# ---------------------------------------------------------------------------
# the sample batch on pool scenes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool_state():
    """Three pool scenes after 12 expert steps, in both packages' types."""
    params = EnvConfig(dynamics_model="classic").sim_params()
    scene = build_scene(POOL_SCENES[40:43], params, device="cpu")
    state = stepmod.reset(scene, None, params)
    acts = expert_actions(scene, "classic")
    for t in range(12):
        state = stepmod.step(scene, state, acts[:, :, t], params)
    return scene, state


@pytest.mark.parametrize("current_step,max_agents", [(0, 32), (12, 8)])
def test_sample_batch_matches_jax(pool_state, current_step, max_agents):
    scene, state = pool_state
    cfg = data_utils.VBDSampleConfig(max_agents=max_agents)
    jcfg = jdata.VBDSampleConfig(max_agents=max_agents)
    got = data_utils.process_scenario_data(scene, state, current_step, cfg)
    want = jdata.process_scenario_data(scene_to_jax(scene),
                                       state_to_jax(state), current_step,
                                       jcfg)
    assert set(got) == set(want)
    for k in ("agents_id", "agents_type", "agents_interested"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert got[k].dtype == torch.int32
    assert (got["agents_id"][:, 0] == 0).all()  # the SDC first
    for k in ("agents_history", "polylines"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    assert np.abs(want["polylines"]).sum() > 0

    jin = jdata.official_inputs(want)
    tin = data_utils.official_inputs(got)
    assert set(tin) == set(jin)
    for k in ("agents_type", "agents_interested", "polylines_valid"):
        np.testing.assert_array_equal(tin[k].numpy(), jin[k], err_msg=k)
    for k in ("traffic_light_points", "anchors"):
        np.testing.assert_array_equal(tin[k].numpy(), jin[k], err_msg=k)
    # numpy's float32 cos and sin and torch's differ by an ulp on about a
    # fifth of inputs; times distances of hundreds of metres that is ~1e-5
    # absolute, so the relations are held to 1e-6 of their largest magnitude
    assert tin["relations"].dtype == torch.float32
    assert rel_err(tin["relations"], jin["relations"]) <= 1e-6


def test_relations_keep_the_quirks():
    """Traffic-light headings count as 0, the diagonal is 0.01, and a pair
    touching a token with x == 0 is zeroed, as in the JAX relations."""
    rng = np.random.default_rng(9)
    hist = rng.normal(size=(2, 3, 11, 8)).astype(np.float32) * 10
    hist[0, 2] = 0.0  # a padded agent
    poly = rng.normal(size=(2, 4, 5, 5)).astype(np.float32) * 10
    tl = rng.normal(size=(2, 2, 3)).astype(np.float32) * 10
    want = jdata.batched_relations(hist, poly, tl)
    got = data_utils.batched_relations(*map(torch.from_numpy,
                                            (hist, poly, tl))).numpy()
    assert rel_err(got, want) <= 1e-6
    S = 3 + 4 + 2
    assert (got[:, np.arange(S), np.arange(S)][1] == 0.01).all()
    assert (got[0, 2] == 0).all() and (got[0, :, 2] == 0).all()
    assert (got[:, 7:, :7, 2] == 0).all() and (got[:, :7, 7:, 2] == 0).all()
