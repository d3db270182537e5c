"""The port's TPU-first VBD model (gpudrive_lab_torch/vbd/model.py) in the
compute dtypes bfloat16 and float16 against the JAX ``VBDModel(VBDConfig(
dtype=jnp.bfloat16 / jnp.float16))`` on the same flax variables, on the CPU.

Sizes and inputs are those of tests/test_torch_vbd_model.py (hidden 64, 1
encoder layer, 4 heads, 8 agents, 4 diffusion steps; seeded numpy).  Both
sides run flax's dtype flow op by op (networks/flax_dtype.py), and part in
two places only:

  * float32 sums in another order (a LayerNorm's statistics, the relation
    layer's float32 products): a value near a cd rounding boundary rounds
    to the other neighbour, one cd ulp;
  * inside nn.RNN's scan XLA fuses the GRU step and keeps two cd values in
    float32 where they meet the float32 carry (excess precision); op by op
    the port's GRU gives flax's bits (test_gru_is_flax_cell_op_by_op).

The cd unit roundoff u is 2^-8 in bf16 and 2^-11 in float16; the bars are
a few u of the outputs' largest magnitude (``BARS``, each beside its
readings; the tests print them, ``READ``, with -s).

Two guards catch a model that quietly computes in float32: every
intermediate's dtype equals flax's (module by module, on both sides), and
the port's cd outputs are more than u from its float32 outputs on the same
weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.vbd import guidance as jguidance
from gpudrive_lab_tpu.vbd import integration as jintegration
from gpudrive_lab_tpu.vbd import model as jmodel
from gpudrive_lab_torch.vbd import guidance, integration, model
from gpudrive_lab_torch.vbd.convert import vbd_params_from_flax
from test_torch_vbd_model import A, B, CFG, _batch, _jnp, _torch, rel_err
from torch_parity import recorded_draws

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


@pytest.fixture(scope="module")
def variables():
    """flax variables of the test size, every leaf moved by seeded noise
    (as tests/test_torch_vbd_model.py does)."""
    jm = jmodel.VBDModel(jmodel.VBDConfig(**CFG))
    v = jm.init(jax.random.PRNGKey(0), _jnp(_batch()),
                jnp.zeros((B, A, 4, 2)), jnp.zeros((B, A), jnp.int32))
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), v)


def _models(variables, name):
    """(JAX config, JAX model, port config, port model) in compute dtype
    ``name``."""
    jdt, tdt = DTYPES[name]
    jcfg = jmodel.VBDConfig(**CFG, dtype=jdt)
    tcfg = model.VBDConfig(**CFG, dtype=tdt)
    tm = model.VBDModel(tcfg, device="cpu")
    tm.load_state_dict(vbd_params_from_flax(variables), strict=True)
    return jcfg, jmodel.VBDModel(jcfg), tcfg, tm


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request, variables):
    return (request.param,) + _models(variables, request.param)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, A, 4, 2)).astype(np.float32)
    t = rng.integers(0, 4, (B, A)).astype(np.int32)
    return x, t


def _read(what, name, err, bar):
    print(f"READ {what} [{name}]: {err:.3g} = {err / U[name]:.2f} u "
          f"(bar {bar / U[name]:g} u)")
    assert err <= bar, (what, name, err)


# ---------------------------------------------------------------------------
# submodules
# ---------------------------------------------------------------------------


def _sub(variables, *path):
    p = variables["params"]
    for k in path:
        p = p[k]
    return {"params": p}


def test_agent_and_map_encoders_match_jax(pair, variables):
    name, jcfg, _, _, tm = pair
    cd = jcfg.dtype
    batch = _batch(2)
    want = jmodel.AgentEncoder(CFG["hidden_dim"], cd).apply(
        _sub(variables, "encoder", "AgentEncoder_0"), batch["agents_history"])
    with torch.no_grad():
        got = tm.encoder.agent(torch.from_numpy(batch["agents_history"]))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _read("AgentEncoder", name, rel_err(got, want), BARS[name]["gru"])
    want = jmodel.MapEncoder(CFG["hidden_dim"], cd).apply(
        _sub(variables, "encoder", "MapEncoder_0"), batch["polylines"])
    with torch.no_grad():
        got = tm.encoder.map(torch.from_numpy(batch["polylines"]))
    assert str(got.dtype)[6:] == str(want.dtype) == name
    _read("MapEncoder", name, rel_err(got.float(), np.asarray(
        want, np.float32)), BARS[name]["sub"])


def test_gru_is_flax_cell_op_by_op(pair, variables):
    """The port's cd GRU equals flax's GRUCell(dtype=cd) run step by step
    in eager JAX, bit for bit: each op is one XLA computation there, so
    every cd value is rounded where flax's code says.  (Inside nn.RNN's
    scan, XLA fuses the step and drops two of those roundings: see
    test_agent_and_map_encoders_match_jax.)"""
    from flax import linen as nn

    name, jcfg, _, _, tm = pair
    hist = _batch(2)["agents_history"][:, :5]
    x = hist.reshape(-1, hist.shape[2], hist.shape[3])
    cell = nn.GRUCell(CFG["hidden_dim"], dtype=jcfg.dtype)
    cv = _sub(variables, "encoder", "AgentEncoder_0", "GRUCell_0")
    h = jnp.zeros((x.shape[0], CFG["hidden_dim"]), jnp.float32)
    for t in range(x.shape[1]):
        h, _ = cell.apply(cv, h, jnp.asarray(x[:, t]))
    with torch.no_grad():
        got = tm.encoder.agent(torch.from_numpy(hist))
    assert h.dtype == jnp.float32
    np.testing.assert_array_equal(got.reshape(x.shape[0], -1).numpy(),
                                  np.asarray(h))


def test_relation_layer_matches_jax(pair, variables):
    name, jcfg, _, tcfg, tm = pair
    rng = np.random.default_rng(3)
    T, D, H = 12, CFG["hidden_dim"], CFG["num_heads"]
    tokens = rng.normal(size=(B, T, D)).astype(np.float32)
    rel = rng.normal(size=(B, T, T, H)).astype(np.float32)
    pad = rng.random((B, T)) < 0.3
    pad[:, 0] = False
    want = jmodel.RelationAttentionLayer(D, H, jcfg.dtype).apply(
        _sub(variables, "encoder", "RelationAttentionLayer_0"), tokens,
        jnp.asarray(rel, jcfg.dtype), pad)
    with torch.no_grad():
        got = tm.encoder.layers[0](torch.from_numpy(tokens), torch.from_numpy(
            rel).to(tcfg.dtype), torch.from_numpy(pad))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _read("RelationAttentionLayer", name, rel_err(got, want),
          BARS[name]["sub"])


def _scene(pair, variables, seed):
    """The JAX encoder's (tokens, valid) on a batch, as both packages'
    arrays: the denoiser and predictor tests start from the same tokens."""
    jm = pair[2]
    tokens, valid = jm.apply(variables, _jnp(_batch(seed)),
                             method=lambda m, b: m.encode(b))
    return (np.asarray(tokens), np.asarray(valid))


def test_denoiser_and_predictor_match_jax(pair, variables):
    name, jcfg, jm, _, tm = pair
    tokens, valid = _scene(pair, variables, 4)
    x, t = _inputs(5)
    want = jm.apply(variables, tokens, valid, x, t,
                    method=lambda m, *a: m.denoiser(*a))
    anchors = np.random.default_rng(6).normal(size=(B, A, 4, 2)).astype(
        np.float32)
    jact, jscore = jm.apply(variables, tokens, valid, anchors,
                            method=lambda m, *a: m.predictor(*a))
    T = torch.from_numpy
    with torch.no_grad():
        got = tm.denoiser(T(tokens), T(valid), T(x), T(t).long())
        act, score = tm.predictor(T(tokens), T(valid), T(anchors))
    for g in (got, act, score):
        assert g.dtype == torch.float32
    _read("Denoiser", name, rel_err(got, want), BARS[name]["sub"])
    _read("GoalPredictor actions", name, rel_err(act, jact),
          BARS[name]["sub"])
    _read("GoalPredictor scores", name, rel_err(score, jscore),
          BARS[name]["sub"])


# ---------------------------------------------------------------------------
# the dtype of every intermediate, and the distance from float32
# ---------------------------------------------------------------------------

F32, CD = "float32", "cd"
# port module -> (flax module path, dtype of its first output)
FLOW = {
    "encoder.agent": ("encoder/AgentEncoder_0", F32),
    "encoder.map": ("encoder/MapEncoder_0", CD),
    "encoder.relation": ("encoder/FourierEmbedding_0", CD),
    "encoder.layers.0": ("encoder/RelationAttentionLayer_0", F32),
    "encoder": ("encoder", F32),
    "denoiser.blocks.0.self_attn": ("denoiser/MultiHeadDotProductAttention_0",
                                    CD),
    "denoiser.blocks.0.cross_attn": (
        "denoiser/MultiHeadDotProductAttention_1", CD),
    "denoiser.blocks.1.cross_attn": (
        "denoiser/MultiHeadDotProductAttention_3", CD),
    "denoiser": ("denoiser", F32),
    "predictor.attn": ("predictor/MultiHeadDotProductAttention_0", CD),
    "predictor": ("predictor", F32),
}
# flax layers with no port module of their own (the port calls
# flax_dtype's functions): their outputs are cd
FLAX_CD = ("encoder/FourierEmbedding_0/Dense_0",
           "encoder/RelationAttentionLayer_0/LayerNorm_0",
           "encoder/RelationAttentionLayer_0/Dense_0",
           "encoder/RelationAttentionLayer_0/Dense_3",
           "encoder/MapEncoder_0/Dense_1", "encoder/MapEncoder_0/Embed_0",
           "denoiser/MultiHeadDotProductAttention_1/key",
           "denoiser/Dense_0", "denoiser/Dense_1", "denoiser/LayerNorm_0",
           "denoiser/Dense_5", "predictor/Dense_1", "predictor/Dense_3")


def _first(x):
    while isinstance(x, (tuple, list)):
        x = x[0]
    return x


def _flax_dtypes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            out[prefix.rstrip("/")] = str(_first(v).dtype)
        else:
            out.update(_flax_dtypes(v, f"{prefix}{k}/"))
    return out


def test_every_intermediate_has_flax_dtype(pair, variables):
    name, _, jm, _, tm = pair
    batch = _batch(2)
    x, t = _inputs(3)
    _, inter = jm.apply(variables, _jnp(batch), x, t,
                        capture_intermediates=True, mutable=["intermediates"])
    flax = _flax_dtypes(inter["intermediates"])
    seen = {}

    def hook(key):
        def record(module, args, out):
            seen.setdefault(key, str(_first(out).dtype)[6:])
        return record

    hooks = [tm.get_submodule(k).register_forward_hook(hook(k)) for k in FLOW]
    try:
        with torch.no_grad():
            tm(_torch(batch), torch.from_numpy(x), torch.from_numpy(t))
    finally:
        for h in hooks:
            h.remove()
    for k, (path, kind) in FLOW.items():
        want = name if kind == CD else "float32"
        assert flax[path] == want, (path, flax[path])
        assert seen[k] == want, (k, seen[k])
    for path in FLAX_CD:
        assert flax[path] == name, (path, flax[path])
    # the GRU's carry, (1 - z) n + z h, is float32
    assert flax["encoder/AgentEncoder_0/RNN_0"] == "float32"


def test_compute_dtype_is_not_float32(pair, variables):
    """The port's cd outputs are more than a cd unit roundoff (of their
    largest magnitude) from its float32 outputs on the same weights, where
    a model that computed in float32 would give 0 (readings bf16 / float16
    in u: 2.0-2.2 / 2.0-2.6)."""
    name, _, _, _, tm = pair
    f32 = model.VBDModel(model.VBDConfig(**CFG), device="cpu")
    f32.load_state_dict(tm.state_dict())
    batch = _torch(_batch(2))
    x, t = (torch.from_numpy(v) for v in _inputs(3))
    with torch.no_grad():
        got, ref = tm(batch, x, t), f32(batch, x, t)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        dist = rel_err(g, r.numpy())
        print(f"READ cd against float32 [{name}]: {dist:.3g}")
        assert dist > U[name], dist


# ---------------------------------------------------------------------------
# the model, the loss, the samplers and the env
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("anchors", [True, False])
def test_forward_matches_jax(pair, variables, anchors):
    name, _, jm, _, tm = pair
    batch = _batch(2, anchors)
    x, t = _inputs(3)
    want = jm.apply(variables, _jnp(batch), jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tm(_torch(batch), torch.from_numpy(x), torch.from_numpy(t))
    _read("forward denoised", name, rel_err(got[0], want[0]),
          BARS[name]["model"])
    if anchors:
        _read("forward goal actions", name, rel_err(got[1], want[1]),
              BARS[name]["model"])
        _read("forward goal scores", name, rel_err(got[2], want[2]),
              BARS[name]["model"])
    else:
        assert got[1] is None and want[1] is None


def test_denoise_loss_and_gradient_match_jax(pair, variables):
    name, jcfg, jm, tcfg, tm = pair
    batch = _batch(4)
    gt = np.random.default_rng(5).normal(size=(B, A, 4, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def loss_fn(v):
        return jmodel.denoise_loss(jm, v, jmodel.DDPMScheduler(4),
                                   _jnp(batch), jnp.asarray(gt), key, jcfg)

    with recorded_draws() as draws:
        loss_fn(variables)
    want, jgrads = jax.value_and_grad(loss_fn)(variables)
    tm.zero_grad()
    got = model.denoise_loss(tm, model.DDPMScheduler(4), _torch(batch),
                             torch.from_numpy(gt), tcfg, draws)
    got.backward()
    assert got.dtype == torch.float32
    _read("denoise_loss", name, rel_err(got, want), BARS[name]["loss"])
    want_g = vbd_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in tm.named_parameters()}
    for p in tm.parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or (p.grad.dtype == torch.float32
                                  and bool(torch.isfinite(p.grad).all()))
    H = CFG["hidden_dim"]
    # of the whole gradient's largest magnitude, as in test_torch_vbd_model
    scale = max(float(np.abs(w.numpy()).max()) for w in want_g.values())
    worst = 0.0
    for k, w in want_g.items():
        g = grads[k]
        if k.endswith("bias_hh_l0"):
            # flax's hidden r and z gates have no bias (test_torch_vbd_model):
            # their gradients are the input biases', summed over the steps
            # in another order
            ih = grads[k.replace("hh", "ih")][:2 * H]
            worst = max(worst, float((g[:2 * H] - ih).abs().max()) / scale)
            g, w = g[2 * H:], w[2 * H:]
        worst = max(worst, float((g - w).abs().max()) / scale)
    _read("gradient", name, worst, BARS[name]["grad"])


def test_sample_denoiser_matches_jax(pair, variables):
    name, jcfg, jm, tcfg, tm = pair
    batch = _batch(6, anchors=False)
    with recorded_draws() as draws:
        want = jmodel.sample_denoiser(jm, variables, jmodel.DDPMScheduler(4),
                                      _jnp(batch), jax.random.PRNGKey(8),
                                      jcfg)
    got = model.sample_denoiser(tm, model.DDPMScheduler(4), _torch(batch),
                                tcfg, draws)
    for k in ("denoised_actions", "denoised_trajs"):
        assert got[k].dtype == torch.float32
        _read(f"sample_denoiser {k}", name, rel_err(got[k], want[k]),
              BARS[name]["model"])


def test_ctg_sampler_matches_jax(pair, variables):
    name, jcfg, jm, tcfg, tm = pair
    batch = _batch(9, anchors=False)
    goals = np.random.default_rng(10).normal(size=(B, A, 2)).astype(
        np.float32) * 20
    with recorded_draws() as draws:
        want = jguidance.sample_denoiser_guided(
            jm, variables, jmodel.DDPMScheduler(4), _jnp(batch),
            jax.random.PRNGKey(11), jcfg,
            guidance=[jguidance.goal_guidance(jnp.asarray(goals)),
                      jguidance.collision_guidance()], guidance_iter=2)
    got = guidance.sample_denoiser_guided(
        tm, model.DDPMScheduler(4), _torch(batch), tcfg, draws,
        guidance=[guidance.goal_guidance(torch.from_numpy(goals)),
                  guidance.collision_guidance()], guidance_iter=2)
    plain = model.sample_denoiser(tm, model.DDPMScheduler(4), _torch(batch),
                                  tcfg, draws)
    assert not torch.allclose(plain["denoised_actions"],
                              got["denoised_actions"])
    for k in ("denoised_actions", "denoised_trajs"):
        _read(f"ctg {k}", name, rel_err(got[k], want[k]),
              BARS[name]["model"])


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_trajectory_source_through_the_env(variables, name):
    """A cd VBDTrajectorySource into set_vbd_trajectories on 3 pool
    scenes, against the JAX source on the same weights and draws; then
    both envs step on the port's trajectories (test_torch_vbd_env)."""
    from test_torch_vbd_env import VBD_CFG, _envs, _run

    jdt, tdt = DTYPES[name]
    jcfg = jmodel.VBDConfig(**VBD_CFG, dtype=jdt)
    tcfg = model.VBDConfig(**VBD_CFG, dtype=tdt)
    jm = jmodel.VBDModel(jcfg)
    tm = model.VBDModel(tcfg, device="cpu")
    # VBD_CFG differs from CFG in its horizon only: the denoiser's in and
    # out widths; the rest of the weights are the fixture's
    Ab = jcfg.action_blocks
    v = jm.init(jax.random.PRNGKey(0), _jnp(_batch()),
                jnp.zeros((B, A, Ab, 2)), jnp.zeros((B, A), jnp.int32))
    v = jax.tree_util.tree_map(np.asarray, v)
    tm.load_state_dict(vbd_params_from_flax(v), strict=True)
    env, jenv = _envs()
    with recorded_draws() as draws:
        jenv.set_vbd_trajectories(jintegration.VBDTrajectorySource(
            jm, v, jmodel.DDPMScheduler(3), jcfg, seed=3))
    src = integration.VBDTrajectorySource(tm, model.DDPMScheduler(3), tcfg)
    src.noise = draws
    env.set_vbd_trajectories(src)
    got = env.vbd_trajectories
    want = np.asarray(jenv.vbd_trajectories)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert float(got.abs().sum()) > 0
    _read("VBDTrajectorySource trajectories", name, rel_err(got, want),
          BARS[name]["model"])
    jenv.set_vbd_trajectories(got.numpy())
    _run(env, jenv, steps=4, seed=3)


# bars, of the largest magnitude, in units of the compute dtype's unit
# roundoff u (2^-8 bf16, 2^-11 float16); readings bf16 / float16 in u
U = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
BARS = {name: dict(
    # submodules on the same inputs: the map encoder and the predictor
    # read 0 / 0, the denoiser 0 / 1.52, the relation layer 0.45 / 1.01 (a
    # LayerNorm's float32 statistics summed in another order flip a rounding
    # to cd: 0.07% of the entries of the relation layer's second LayerNorm)
    sub=2 * U[name],
    # the GRU inside flax's nn.RNN (reads 3.0 / 2.4): XLA compiles the scan
    # body as one fusion and keeps (1 - z) n and z in float32 where flax's
    # code rounds them to cd before the float32 carry meets them (excess
    # precision; each op alone, as test_gru_is_flax_cell_op_by_op runs
    # it, gives the port's bits); the whole model carries that difference
    gru=4 * U[name],
    # the model's outputs, samples and trajectories (readings 0.85-2.60 /
    # 1.16-2.68)
    model=6 * U[name],
    # the loss, a mean over the agents' blocks (reads 0.04 / 0.03)
    loss=0.25 * U[name],
    # every gradient leaf within this of the whole gradient's largest
    # magnitude (reads 2.19 / 1.09)
    grad=6 * U[name],
    ) for name in DTYPES}
