"""The reference-checkpoint loader, the training utilities and the small
leftovers of the port, against the JAX package on the CPU.

  * ``networks/convert``: ``load_pretrained`` on a reference ``NeuralNet``
    state dict built here (``.pt``, ``.safetensors``, a hub-layout
    directory, a blob wrapping it under "state_dict"): logits and values
    within 1e-5 of the JAX ``load_pretrained`` policy's on the same
    observations; ``config_from_state_dict`` equal; a missing, an extra or
    a vbd_embed key refused;
  * ``utils/checkpoint``: a policy and Adam round trip bit for bit, in
    ``torch.save`` and safetensors files, and the sidecar equal to the JAX
    ``_jsonable`` output;
  * ``utils/config``, ``utils/generate_sweep`` and ``utils/dashboard``:
    the same results as the JAX modules on the same inputs;
  * ``scene/synthetic.synthetic_scene`` and ``core/types.zero_state``:
    equal to the JAX ones array by array, dtypes included;
  * ``networks/basic_ffn`` and ``networks/perm_eq_late_fusion``: logits and
    values within 1e-5 of the JAX networks' after conversion (float32 sums
    in another order over 3368 inputs).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core.types import zero_state as jax_zero_state
from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.networks import basic_ffn as jffn
from gpudrive_lab_tpu.networks import convert as jconvert
from gpudrive_lab_tpu.networks import perm_eq_late_fusion as jperm
from gpudrive_lab_tpu.scene.synthetic import synthetic_scene as jax_synthetic
from gpudrive_lab_tpu.utils import checkpoint as jckpt
from gpudrive_lab_tpu.utils import config as jcfg
from gpudrive_lab_tpu.utils import dashboard as jdash
from gpudrive_lab_tpu.utils import generate_sweep as jsweep
from gpudrive_lab_torch.core.types import zero_state
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.networks import basic_ffn, convert
from gpudrive_lab_torch.networks import perm_eq_late_fusion as perm
from gpudrive_lab_torch.rollout import slice_env
from gpudrive_lab_torch.scene.synthetic import synthetic_scene
from gpudrive_lab_torch.utils import checkpoint, config, dashboard
from gpudrive_lab_torch.utils import generate_sweep
from torch_parity import POOL_SCENES, scene_to_jax, state_to_jax

TOL = 1e-5


def reference_state_dict(seed=0, ego=6, width=64, hidden=128, actions=91):
    """A seeded state dict in the reference NeuralNet layout (the key set
    of examples/09_pretrained_policy.py::synth_checkpoint), made with
    torch."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(o, i, name):
        sd[f"{name}.weight"] = torch.randn((o, i), generator=g) / i ** 0.5
        sd[f"{name}.bias"] = 0.1 * torch.randn(o, generator=g)

    for name, ind in (("ego_embed", ego), ("partner_embed", 6),
                      ("road_map_embed", 13)):
        lin(width, ind, f"{name}.0")
        sd[f"{name}.1.weight"] = 1 + 0.1 * torch.randn(width, generator=g)
        sd[f"{name}.1.bias"] = 0.1 * torch.randn(width, generator=g)
        lin(width, width, f"{name}.4")
    lin(hidden, 3 * width, "shared_embed.0")
    lin(actions, hidden, "actor")
    lin(1, hidden, "critic")
    return sd


@pytest.fixture(scope="module")
def obs():
    env = slice_env(POOL_SCENES[20:22], device="cpu")
    return env.get_obs().reshape(-1, env.observation_dim)


def _write(sd, tmp_path, layout):
    from safetensors.torch import save_file

    if layout == ".pt":
        path = tmp_path / "policy.pt"
        torch.save(sd, path)
    elif layout == ".safetensors":
        path = tmp_path / "policy.safetensors"
        save_file(sd, str(path))
    elif layout == "directory":
        path = tmp_path
        save_file(sd, str(tmp_path / "model.safetensors"))
    else:  # a training blob holding it under "state_dict"
        path = tmp_path / "pytorch_model.bin"
        torch.save({"state_dict": sd, "epoch": 3}, path)
    return str(path)


@pytest.mark.parametrize("layout", [".pt", ".safetensors", "directory",
                                    "wrapped blob"])
def test_load_pretrained_matches_jax(layout, obs, tmp_path):
    path = _write(reference_state_dict(seed=1), tmp_path, layout)
    policy, cfg = convert.load_pretrained(path, device="cpu")
    jpolicy, jvars, jcfg_ = jconvert.load_pretrained(path)
    assert next(policy.parameters()).device.type == "cpu"
    for f in ("action_dim", "input_dim", "hidden_dim", "ego_feat_dim",
              "act_func", "fused_embed"):
        assert getattr(cfg, f) == getattr(jcfg_, f), f
    with torch.no_grad():
        logits, value = policy(obs)
    jlogits, jvalue = jpolicy.apply(jvars, jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=0,
                               atol=TOL)
    # the same policy on kernels K3/K4 (their plain versions on the CPU)
    fused = type(policy)(dataclasses.replace(cfg, fused_embed=True),
                         device="cpu")
    fused.load_state_dict(policy.state_dict())
    with torch.no_grad():
        flogits, _ = fused(obs)
    np.testing.assert_allclose(flogits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=TOL)


def test_config_from_state_dict_matches_jax():
    sd = reference_state_dict(ego=9, width=32, hidden=96, actions=21)
    got = convert.config_from_state_dict(sd)
    want = jconvert.config_from_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert (got.action_dim, got.input_dim, got.hidden_dim,
            got.ego_feat_dim) == (want.action_dim, want.input_dim,
                                  want.hidden_dim, want.ego_feat_dim) == (
        21, 32, 96, 9)


@pytest.mark.parametrize("fault", ["missing", "extra", "vbd_embed"])
def test_convert_state_dict_refuses(fault):
    sd = reference_state_dict()
    if fault == "missing":
        del sd["road_map_embed.4.bias"]
        err, match = ValueError, "missing"
    elif fault == "extra":
        sd["shared_embed.2.weight"] = torch.zeros(3)
        err, match = ValueError, "extra"
    else:
        sd["vbd_embed.0.weight"] = torch.zeros(3)
        err, match = NotImplementedError, "vbd"
    with pytest.raises(err, match=match):
        convert.convert_state_dict(sd)


def test_load_pretrained_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(reference_state_dict(), tmp_path, ".pt")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.load_pretrained(path)


METADATA = dict(step=np.int64(7), lr=np.float32(0.25), grid=np.arange(3),
                widths=(64, 128), nested={"a": [np.int32(1), 2.5]})


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_checkpoint_round_trip(suffix, tmp_path):
    """The policy (and, in a .pt file, Adam after one step) round-trip bit
    for bit; the sidecar is the JAX ``_jsonable`` output of the same
    metadata (with the JAX EnvConfig in place of the port's)."""
    policy, _ = convert.load_pretrained(
        _write(reference_state_dict(), tmp_path, ".pt"), device="cpu")
    opt = None
    if suffix == ".pt":
        opt = torch.optim.Adam(policy.parameters(), lr=1e-3)
        policy(torch.ones(2, 3368))[0].sum().backward()
        opt.step()
    path = tmp_path / ("ckpt" + suffix)
    meta = dict(METADATA, env=EnvConfig())
    assert checkpoint.save_checkpoint(path, policy, opt, meta) == str(path)
    got = checkpoint.load_checkpoint(path)
    for k, v in policy.state_dict().items():
        assert torch.equal(got["state"][k], v), k
    if opt is not None:
        want = opt.state_dict()
        assert got["opt_state"]["param_groups"] == want["param_groups"]
        for i, s in want["state"].items():
            for k, v in s.items():
                assert torch.equal(got["opt_state"]["state"][i][k], v)
    jmeta = json.loads(json.dumps(jckpt._jsonable(
        dict(METADATA, env=JaxEnvConfig()))))
    assert checkpoint.load_metadata(path) == jmeta
    assert not os.path.exists(str(path) + ".tmp")


def test_safetensors_checkpoint_refuses_optimizer_state(tmp_path):
    policy, _ = convert.load_pretrained(
        _write(reference_state_dict(), tmp_path, ".pt"), device="cpu")
    opt = torch.optim.Adam(policy.parameters())
    with pytest.raises(ValueError, match="optimizer"):
        checkpoint.save_checkpoint(tmp_path / "c.safetensors", policy, opt)


def test_yaml_config_matches_jax(tmp_path):
    path = tmp_path / "exp.yaml"
    path.write_text("train:\n  lr: 0.0003\n  epochs: 4\nenv:\n  name: pool\n"
                    "  worlds: [1, 2]\n")
    overrides = ["train.lr=0.001", "env.name=womd", "new.deep.key=[1, 2]",
                 "train.tag=plain text"]
    got = config.apply_overrides(config.load_config(path), overrides)
    want = jcfg.apply_overrides(jcfg.load_config(path), overrides)
    assert got == want
    assert got.train.lr == 0.001 and got.new["deep"]["key"] == [1, 2]
    got.train.lr = 0.5
    assert got["train"]["lr"] == 0.5
    with pytest.raises(AttributeError):
        got.missing
    assert config.load_config(tmp_path / "exp.yaml") != got


@pytest.mark.parametrize("backend", ["shell", "sbatch"])
def test_generate_sweep_matches_jax(backend, tmp_path, monkeypatch):
    grid = {"--rollout-len": [16, 32], "--lr": [0.001, 0.0003],
            "--tag": ["a b"]}
    assert generate_sweep.expand_grid(grid) == jsweep.expand_grid(grid)
    got = generate_sweep.generate_sweep("python -m x", grid, tmp_path / "t",
                                        backend, extra_sbatch="#SBATCH -n 1")
    want = jsweep.generate_sweep("python -m x", grid, tmp_path / "j",
                                 backend, extra_sbatch="#SBATCH -n 1")
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        assert a.read_text().replace(str(tmp_path / "t"), "DIR") == \
            b.read_text().replace(str(tmp_path / "j"), "DIR")
        assert os.stat(a).st_mode == os.stat(b).st_mode
    # main(): the port's CLI, its default command naming the port
    monkeypatch.setattr(sys, "argv", [
        "generate_sweep", "--grid", json.dumps(grid), "--out-dir",
        str(tmp_path / "m"), "--backend", backend])
    generate_sweep.main()
    text = (tmp_path / "m" / "sweep_000.sh").read_text()
    assert "python -m gpudrive_lab_torch.ppo.train --lr=0.001 " in text


def test_dashboard_matches_jax(monkeypatch):
    """The table rendered to text equals the JAX dashboard's; without a
    tty (or without rich) the dashboard switches itself off."""
    m = dict(controlled_agent_sps=12345.6, pg_loss=-0.01, v_loss=0.5,
             entropy=4.4, approx_kl=0.002, perc_goal_achieved=0.25,
             episodes=12.0, time_env_s=1.5, cpu_util=55.0)
    got = dashboard.Dashboard(2e6, env_name="run", force=True)
    want = jdash.Dashboard(2e6, env_name="run", force=True)
    assert got.render_text(80_000, m) == want.render_text(80_000, m)
    assert "12.35K" in got.render_text(80_000, m)
    off = dashboard.Dashboard(2e6)
    assert not off._enabled  # pytest's captured stdout is no tty
    with off:
        off.update(1, m)
    monkeypatch.setitem(sys.modules, "rich.console", None)
    monkeypatch.setattr(sys.stdout, "isatty", lambda: True, raising=False)
    assert not dashboard.Dashboard(2e6)._enabled


@pytest.mark.parametrize("kw", [dict(num_worlds=2),
                                dict(num_worlds=3, num_agents=9,
                                     num_roads=10, max_roads=32, seed=5)])
def test_synthetic_scene_matches_jax(kw):
    got = scene_to_jax(synthetic_scene(**kw, device="cpu"))
    want = jax_synthetic(**kw)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got)) == 26
    for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got)):
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and np.array_equal(g, w), \
            jax.tree_util.keystr(path)


def test_zero_state_matches_jax():
    got = state_to_jax(zero_state(3, 16, device="cpu"))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax_zero_state(3, 16))):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert not np.asarray(g).any()


def _net_pair(kind, act):
    if kind == "ffn":
        jnet = jffn.FFNPolicy(jffn.FFNConfig(act_func=act))
        net = basic_ffn.FFNPolicy(basic_ffn.FFNConfig(act_func=act),
                                  device="cpu")
    else:
        jnet = jperm.LateFusionPolicy(jperm.PermEqConfig(act_func=act))
        net = perm.LateFusionPolicy(perm.PermEqConfig(act_func=act),
                                    device="cpu")
    variables = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 3368)))
    return jnet, net, jax.tree.map(np.asarray, variables)


@pytest.mark.parametrize("act", ["tanh", "gelu"])
@pytest.mark.parametrize("kind", ["ffn", "perm_eq"])
def test_extra_networks_match_jax(kind, act, obs):
    jnet, net, variables = _net_pair(kind, act)
    net.load_state_dict(convert.params_fn_for(net)(variables))
    with torch.no_grad():
        logits, value = net(obs)
    jlogits, jvalue = jnet.apply(variables, jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("kind", ["ffn", "perm_eq"])
def test_extra_network_converters_refuse_leftovers(kind):
    _, net, variables = _net_pair(kind, "tanh")
    variables["params"]["Extra_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="Extra_0"):
        convert.params_fn_for(net)(variables)
    cfg = (basic_ffn.FFNConfig if kind == "ffn" else perm.PermEqConfig)(
        dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        type(net)(cfg, device="cpu")
