"""Behavior-cloning parity: the port's BC net, expert data, dataset and
trainer (gpudrive_lab_torch/il/{networks,data_generation,dataset,train}.py)
against the JAX package's on the same inputs, on the CPU.

  * the BC net at narrow widths (BCConfig(network_dim=32, num_head=2,
    num_stack=2)), with and without the ToM head, on rows drawn with numpy
    that include rows with every partner masked: the context, GMM means
    and weights within 1e-5, the variances (exp(2 log_std), up to e^4)
    within 1e-5 relative, every attention's weights within 1e-6 (a fully
    masked row's are uniform on both sides), the recorded tokens and ToM
    logits within 1e-5;
  * ``bc_params_from_flax`` takes every flax leaf once;
  * ``gmm_log_prob`` within 1e-5, the deterministic ``gmm_sample`` and
    ``tom_aux_loss``;
  * one AdamW step of ``make_bc_train_step`` (gmm and l1 losses) from the
    same parameters and batch: loss within 1e-5, parameters within 1e-4,
    AdamW's moments beside them;
  * expert data generation on two pool worlds: the masks, actions and
    action indices equal, positions and yaw within the step's 1e-3 bar,
    observations within the env's observation bar (1e-5, road rows as
    sets), for the first 10 steps of the replay and for all 91 where the
    two simulations' states still agree to 1e-5;
  * ``ExpertDataset``: the index and the shuffled batches equal;
  * the CLI for one epoch, its ``bc_policy.pt``, and a JAX
    ``bc_policy.pkl`` loaded through the converter.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.il import data_generation as jgen
from gpudrive_lab_tpu.il import dataset as jds
from gpudrive_lab_tpu.il import networks as jnet
from gpudrive_lab_tpu.il import train as jtrain
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.il import data_generation as tgen
from gpudrive_lab_torch.il import networks as tnet
from gpudrive_lab_torch.il import train as ttrain
from gpudrive_lab_torch.il.dataset import ExpertDataset
from gpudrive_lab_torch.networks.convert import (
    adam_state_from_optax,
    bc_params_from_flax,
)
from torch_parity import (
    POOL_SCENES,
    PARTNER_DIM,
    match_rows,
    python_scene_compiler,
)

NARROW = dict(network_dim=32, num_head=2, num_stack=2)


def bc_variables(cfg, seed=0, batch=None):
    """The JAX BC net's parameter tree with every leaf drawn with numpy:
    kernels N(0, 1/fan_in), biases N(0, 0.1), LayerNorm scale 1 + N(0,
    0.1)."""
    model = jnet.EarlyFusionAttnBCNet(cfg)
    obs, pm, rm = batch or bc_inputs(cfg, 2, 0)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(obs), jnp.asarray(pm),
        jnp.asarray(rm)))
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


def bc_inputs(cfg, B, seed):
    """B rows of stacked obs with masks: rows 0 and 1 have every partner
    masked, the others about 70%; about half the road points masked."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, cfg.obs_dim)).astype(np.float32)
    pm = rng.random((B, cfg.ro_max)) < 0.7
    pm[:2] = True
    rm = rng.random((B, cfg.rg_max)) < 0.5
    return obs, pm, rm


def port_net(cfg, variables):
    net = tnet.EarlyFusionAttnBCNet(tnet.BCConfig(**{
        k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}),
        device="cpu")
    net.load_state_dict(bc_params_from_flax(variables))
    return net


def _jax_attn(inter):
    """{port module path: weights} from flax's sown intermediates."""
    out = {}
    for blk, key in (("SelfAttentionBlock_0", "ro_block"),
                     ("SelfAttentionBlock_1", "rg_block"),
                     ("SelfAttentionBlock_2", "fusion_block")):
        for name, v in inter[blk].items():
            layer = int(name.rsplit("_", 1)[1])
            out[f"{key}.layers.{layer}.attn"] = v["attn_weights"][0]
    for key in ("ego_ro_cross", "ego_rg_cross"):
        out[f"{key}.attn"] = inter[key]["MultiHeadAttention_0"][
            "attn_weights"][0]
    return out


@pytest.mark.parametrize("use_tom", [False, True])
def test_bc_net_matches_jax(use_tom):
    cfg = jnet.BCConfig(**NARROW, use_tom=use_tom)
    batch = bc_inputs(cfg, 6, 1)
    variables = bc_variables(cfg, 2, batch)
    (ctx, gmm), inter = jnet.EarlyFusionAttnBCNet(cfg).apply(
        variables, *map(jnp.asarray, batch), mutable=["intermediates"])
    inter = inter["intermediates"]
    net = port_net(cfg, variables)
    with torch.no_grad():
        tctx, tgmm, rec = net(*map(torch.from_numpy, batch), record=True)
        tctx2, tgmm2 = net(*map(torch.from_numpy, batch))
    assert torch.equal(tctx, tctx2)  # recording changes nothing
    np.testing.assert_allclose(tctx.numpy(), np.asarray(ctx), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tgmm[0].numpy(), np.asarray(gmm[0]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tgmm[1].numpy(), np.asarray(gmm[1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgmm[2].numpy(), np.asarray(gmm[2]), rtol=0,
                               atol=1e-5)
    want = _jax_attn(inter)
    assert set(rec["attn"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(rec["attn"][k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6, err_msg=k)
    # a row with every partner masked: uniform weights over the partners
    uniform = rec["attn"]["ego_ro_cross.attn"][:2].numpy()
    np.testing.assert_allclose(uniform, 1.0 / cfg.ro_max, rtol=1e-6)
    for k in ("ego_token", "ro_tokens") + (("tom_logits",) if use_tom
                                           else ()):
        np.testing.assert_allclose(rec[k].numpy(), np.asarray(inter[k][0]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_bc_converter_takes_every_leaf_once():
    cfg = jnet.BCConfig(**NARROW, use_tom=True)
    variables = bc_variables(cfg)
    sd = bc_params_from_flax(variables)
    assert set(sd) == set(port_net(cfg, variables).state_dict())
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    stray = jax.tree.map(lambda x: x, variables)
    stray["params"]["GMMHead_0"]["Dense_9"] = {
        "kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="Dense_9"):
        bc_params_from_flax(stray)


def test_gmm_functions_match_jax():
    rng = np.random.default_rng(3)
    B, K, D = 16, 6, 3
    means = rng.normal(size=(B, K, D)).astype(np.float32)
    var = rng.uniform(0.05, 3.0, (B, K, D)).astype(np.float32)
    w = rng.dirichlet(np.ones(K), B).astype(np.float32)
    a = rng.normal(size=(B, D)).astype(np.float32)
    got = tnet.gmm_log_prob(*map(torch.from_numpy, (a, means, var, w)))
    want = jnet.gmm_log_prob(*map(jnp.asarray, (a, means, var, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    got = tnet.gmm_sample(None, *map(torch.from_numpy, (means, var, w)),
                          deterministic=True)
    want = jnet.gmm_sample(None, *map(jnp.asarray, (means, var, w)), True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    draw = tnet.gmm_sample(torch.Generator().manual_seed(0),
                           *map(torch.from_numpy, (means, var, w)))
    assert draw.shape == (B, D) and bool(torch.isfinite(draw).all())
    logits = rng.normal(size=(B, 5, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (B, 5))
    mask = rng.random((B, 5)) < 0.4
    got = tnet.tom_aux_loss(torch.from_numpy(logits),
                            torch.from_numpy(labels), torch.from_numpy(mask))
    want = jnet.tom_aux_loss(jnp.asarray(logits), jnp.asarray(labels),
                             jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("loss", ["gmm", "l1"])
def test_adamw_step_matches_jax(loss):
    cfg = jnet.BCConfig(**NARROW)
    obs, pm, rm = bc_inputs(cfg, 24, 4)
    actions = np.random.default_rng(5).normal(
        scale=0.5, size=(24, 1, 3)).astype(np.float32)
    variables = bc_variables(cfg, 6, (obs, pm, rm))
    tcfg = jtrain.BCTrainConfig(loss=loss)
    tx, jstep = jtrain.make_bc_train_step(jnet.EarlyFusionAttnBCNet(cfg),
                                          tcfg)
    jvars = jax.tree.map(jnp.asarray, variables)
    batch = dict(obs=obs, partner_mask=pm, road_mask=rm, actions=actions)
    jvars2, jopt, jloss = jstep(jvars, tx.init(jvars),
                                {k: jnp.asarray(v) for k, v in
                                 batch.items()})
    net = port_net(cfg, variables)
    opt, step = ttrain.make_bc_train_step(
        net, ttrain.BCTrainConfig(loss=loss))
    tloss = step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    want = bc_params_from_flax(jax.tree.map(np.asarray, jvars2))
    moved = 0
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
        moved += int((v != torch.from_numpy(bc_params_from_flax(
            variables)[k].numpy())).sum())
    assert moved > 0
    adam = adam_state_from_optax(jax.tree.map(np.asarray, jopt), net)
    for i, p in enumerate(net.parameters()):
        st = opt.state[p]
        assert float(st["step"]) == float(adam[i]["step"]) == 1.0
        for m in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(st[m].numpy(), adam[i][m].numpy(),
                                       rtol=1e-3, atol=1e-6)


# ---- expert data and the dataset ---------------------------------------------


@pytest.fixture(scope="module")
def il_data():
    """Expert data of two pool worlds (agent axis bucketed to the batch)
    from both packages."""
    paths = POOL_SCENES[20:22]
    kw = dict(dynamics_model="delta_local", collision_behavior="ignore",
              max_controlled_agents=0, agent_bucket="auto")
    env = GPUDriveTorchEnv(EnvConfig(**kw), paths, device="cpu")
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(num_worlds=2, **kw),
                              scene_paths=paths)
    return tgen.generate_state_action_pairs(env), \
        jgen.generate_state_action_pairs(jenv)


def _assert_obs_frames(got, want, steps):
    """Per step: the ego and partner blocks within 1e-5, the road rows
    (with the road mask beside) as sets within 1e-5."""
    head = 6 + PARTNER_DIM
    for t in steps:
        g, w = got["obs"][t].numpy(), want["obs"][t]
        np.testing.assert_allclose(g[..., :head], w[..., :head], rtol=0,
                                   atol=1e-5, err_msg=f"t={t}")
        rg = np.concatenate([g[..., head:].reshape(g.shape[:-1] + (200, 13)),
                             got["road_mask"][t].numpy()[..., None]], -1)
        rw = np.concatenate([w[..., head:].reshape(w.shape[:-1] + (200, 13)),
                             want["road_mask"][t][..., None]], -1)
        np.testing.assert_allclose(match_rows(rg, rw), rw, rtol=0, atol=1e-5,
                                   err_msg=f"t={t}")


def test_data_generation_matches_jax(il_data):
    got, want = il_data
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    for k in ("dead_mask", "partner_mask", "controlled_mask", "valid_mask",
              "actions", "action_idx"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("positions", "yaw"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-3, err_msg=k)
    # the two simulations agree to float noise: every step where positions
    # are within 1e-5 is held at the obs bar, and at least the first 10
    near = np.abs(got["positions"].numpy() - want["positions"]).reshape(
        91, -1).max(1) <= 1e-5
    steps = [t for t in range(91) if near[t] or t < 10]
    assert len(steps) >= 10
    _assert_obs_frames(got, want, steps)


def test_map_to_closest_discrete_value_matches_jax():
    grid = EnvConfig().dx
    vals = np.random.default_rng(0).uniform(-7, 7, (50,)).astype(np.float32)
    vals[:3] = [grid[0], (grid[1] + grid[2]) / 2, 100.0]
    snapped, idx = tgen.map_to_closest_discrete_value(torch.from_numpy(vals),
                                                      grid)
    jsnapped, jidx = jgen.map_to_closest_discrete_value(vals, grid)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(snapped.numpy(), jsnapped)


def test_expert_dataset_matches_jax(il_data):
    """The same data in both datasets: index, a batch of given ids and the
    shuffled batches equal, with action indices and pred_len 2."""
    _, want = il_data
    data = dict(want, controlled_mask=want["valid_mask"])
    for rl, pl in ((5, 1), (3, 2)):
        jd = jds.ExpertDataset(data, rollout_len=rl, pred_len=pl,
                               use_action_indices=True)
        td = ExpertDataset(data, rollout_len=rl, pred_len=pl,
                           use_action_indices=True, device="cpu")
        np.testing.assert_array_equal(td.index, jd.index)
        assert len(td) == len(jd) > 0
        ids = np.arange(0, len(jd), 7)
        pairs = [(td.batch(ids), jd.batch(ids))] + list(zip(
            td.iter_batches(64, np.random.default_rng(1)),
            jd.iter_batches(64, np.random.default_rng(1))))
        assert len(pairs) == 1 + len(jd) // 64
        for got, exp in pairs:
            assert set(got) == set(exp)
            for k in exp:
                np.testing.assert_array_equal(got[k].numpy(), exp[k],
                                              err_msg=k)


def test_concat_data_batches_matches_jax(il_data):
    _, want = il_data
    parts = [want, want]
    jcat = jtrain._concat_data_batches(parts)
    tcat = ttrain._concat_data_batches(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in parts])
    for k in jcat:
        np.testing.assert_array_equal(tcat[k].numpy(), jcat[k], err_msg=k)


# ---- the CLI -------------------------------------------------------------------


def test_cli_one_epoch_and_checkpoints(tmp_path, capsys):
    """One epoch on one pool world at the default BCConfig widths: finite
    loss, the train split evaluated, the heldout split skipped (the
    one-scene loader is spent), bc_policy.pt reloads to the same outputs;
    a JAX bc_policy.pkl loads through the converter."""
    data = tmp_path / "scenes"
    data.mkdir()
    (data / "tfrecord-0.json").write_text(open(POOL_SCENES[20]).read())
    out = tmp_path / "bc_policy.pt"
    ttrain.main(["--device", "cpu", "--data-dir", str(data),
                 "--num-worlds", "1", "--epochs", "1", "--batch-size", "256",
                 "--agent-bucket", "16", "--eval-heldout", "--out",
                 str(out)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert np.isfinite(lines[0]["loss"])
    assert lines[1]["split"] == "train"
    assert all(0.0 <= lines[1][k] <= 1.0 for k in (
        "goal_rate", "collision_rate", "off_road_rate"))
    assert lines[2] == {"split": "heldout",
                        "skipped": "data loader exhausted"}
    model = ttrain.load_policy(out, device="cpu")
    assert model.config == tnet.BCConfig(num_stack=5)

    cfg = jnet.BCConfig(**NARROW)
    variables = bc_variables(cfg, 8)
    pkl = tmp_path / "bc_policy.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"variables": variables,
                     "config": dataclasses.asdict(cfg)}, f)
    model = ttrain.load_policy(pkl, device="cpu")
    want = bc_params_from_flax(variables)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_cli_refuses_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--num-worlds", "1", "--out",
                     str(tmp_path / "x.pt")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tnet.EarlyFusionAttnBCNet()
