"""Parity of the port's OfficialVBD (gpudrive_lab_torch/vbd/model_official.py)
with the JAX package's, and the checkpoint paths (vbd/convert.py), on the CPU.

The port's seeded ``OfficialVBD.state_dict()`` goes, as numpy, through the
JAX package's own ``convert_state_dict``: the JAX OfficialVBD with those
variables must give the port's outputs.  That the JAX converter reads
every key of the port's state dict and nothing else shows that the port's
modules carry the released checkpoint's names (strict loading, no key
map).  Fixed widths (256 / 1024 / 8 heads); 2 encoder layers, 4 agents,
future 20, 8 polylines x 10 points, 2 traffic lights, 4 anchors, 4
diffusion steps.  Bar: 1e-4 of the largest magnitude (max |got - want|
over max |want|) for the encodings, the relation encodings, denoise,
denoise_raw, predict_goal and sample_official (given the JAX draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.vbd import convert as jconvert
from gpudrive_lab_tpu.vbd import model as jmodel
from gpudrive_lab_tpu.vbd import model_official as jofficial
from gpudrive_lab_torch.vbd import convert, integration, model_official
from gpudrive_lab_torch.vbd.model import DDPMScheduler, VBDConfig, VBDModel
from torch_parity import recorded_draws

KW = dict(future_len=20, agents_len=4, action_len=5, diffusion_steps=4,
          encoder_layers=2)
B, N, P, K, TL, Q = 2, 4, 8, 10, 2, 4


def rel_err(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _inputs(seed=0):
    """The JAX package's test inputs (tests/test_vbd_convert.py:51-81) at
    this size: a padded agent, a padded polyline, one live light."""
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(B, N, 11, 8)).astype(np.float32)
    hist[..., 2] *= 0.5
    hist[0, -1] = 0.0
    interested = np.ones((B, N), np.int32)
    interested[0, -1] = 0
    poly = rng.normal(size=(B, P, K, 5)).astype(np.float32)
    poly[..., 3] = np.clip(poly[..., 3] * 2, 0, 7).astype(np.int32)
    poly[..., 4] = np.clip(np.abs(poly[..., 4]) * 8, 0, 20).astype(np.int32)
    poly[1, -1] = 0.0
    poly_valid = np.ones((B, P), bool)
    poly_valid[1, -1] = False
    tl = np.zeros((B, TL, 3), np.float32)
    tl[:, 0, :2] = rng.normal(size=(B, 2))
    tl[:, 0, 2] = 3
    S = N + P + TL
    return {
        "agents_history": hist,
        "agents_type": np.array([[1, 1, 2, 3]] * B, np.int64),
        "agents_interested": interested,
        "polylines": poly,
        "polylines_valid": poly_valid,
        "traffic_light_points": tl,
        "relations": rng.normal(size=(B, S, S, 3)).astype(np.float32),
        "anchors": rng.normal(size=(B, N, Q, 2)).astype(np.float32),
    }


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


class _Reads(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


@pytest.fixture(scope="module")
def pair():
    """(port model, JAX model, JAX variables from the port's state dict)."""
    tm = model_official.OfficialVBD(
        model_official.OfficialVBDConfig(**KW), device="cpu",
        generator=torch.Generator().manual_seed(0)).eval()
    sd = _Reads({k: v.numpy() for k, v in tm.state_dict().items()})
    jcfg = jofficial.OfficialVBDConfig(**KW)
    variables = jconvert.convert_state_dict(sd, jcfg)
    assert sd.read == set(sd), sorted(set(sd) - sd.read)[:5]
    jm = jofficial.OfficialVBD(jcfg, with_predictor=True)
    return tm, jm, variables


def test_keys_are_the_checkpoints(pair):
    """The JAX converter read every key of the port's state dict (the
    fixture) and its tree has the JAX model's shapes."""
    tm, jm, variables = pair
    x = jnp.zeros((B, N, KW["future_len"] // 5, 2))
    t = jnp.zeros((B, N), jnp.int32)
    init = jm.init(jax.random.PRNGKey(0), _j(_inputs()), x, t)
    jconvert.assert_tree_matches(variables, init)
    assert "encoder.agent_encoder.motion.weight_ih_l0" in tm.state_dict()
    assert isinstance(tm.encoder.agent_encoder.motion, torch.nn.GRU)


def _encode(pair, seed=0):
    tm, jm, variables = pair
    inputs = _inputs(seed)
    want = jm.apply(variables, _j(inputs), method="encode")
    with torch.no_grad():
        got = tm.encode(_t(inputs))
    return got, want


def test_encoder_matches_jax(pair):
    got, want = _encode(pair)
    for k in ("encodings", "relation_encodings"):
        assert got[k].shape == want[k].shape
        assert rel_err(got[k], want[k]) <= 1e-4, k
    for k in ("agents_mask", "maps_mask", "traffic_lights_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_denoise_and_goal_match_jax(pair):
    tm, jm, variables = pair
    got_enc, want_enc = _encode(pair, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, N, 4, 2)).astype(np.float32)
    t = rng.integers(0, 4, (B, N)).astype(np.int32)
    with torch.no_grad():
        for method in ("denoise", "denoise_raw"):
            want = jm.apply(variables, want_enc, jnp.asarray(x),
                            jnp.asarray(t), method=method)
            got = getattr(tm, method)(got_enc, torch.from_numpy(x),
                                      torch.from_numpy(t))
            assert got.shape == (B, N, 4, 2)
            assert rel_err(got, want) <= 1e-4, method
        want = jm.apply(variables, want_enc, method="predict_goal")
        got = tm.predict_goal(got_enc)
    assert got[0].shape == (B, N, Q, 4, 2) and got[1].shape == (B, N, Q)
    assert rel_err(got[0], want[0]) <= 1e-4
    assert rel_err(got[1], want[1]) <= 1e-4


def test_sample_official_matches_jax(pair):
    tm, jm, variables = pair
    inputs = _inputs(3)
    with recorded_draws() as draws:
        want = jofficial.sample_official(jm, variables,
                                         jmodel.DDPMScheduler(4), _j(inputs),
                                         jax.random.PRNGKey(4))
    assert len(draws) == 1 + 4
    got = model_official.sample_official(tm, DDPMScheduler(4), _t(inputs),
                                         noise=draws)
    assert got["denoised_trajs"].shape == (B, N, 20, 5)
    for k in ("denoised_actions", "denoised_trajs"):
        assert rel_err(got[k], want[k]) <= 1e-4, k


def test_causal_mask_matches_jax_and_is_cached(pair):
    tm = pair[0]
    dec = tm.denoiser.decoder
    want = jofficial.TransformerDecoder(
        jofficial.OfficialVBDConfig(**KW)).causal_mask()
    got = dec.causal_mask("cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert dec.causal_mask(torch.device("cpu")) is got


def test_official_params_from_flax(pair):
    """JAX variables back to the port's keys: a model loaded from them
    strictly gives the first model's outputs (the GRU's r and z biases
    arrive merged into the input biases, which adds the same
    pre-activation)."""
    tm, _, variables = pair
    sd = convert.official_params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables))
    back = model_official.OfficialVBD(
        model_official.OfficialVBDConfig(**KW), device="cpu").eval()
    convert.assert_state_dict_matches(sd, back)
    back.load_state_dict(sd, strict=True)
    inputs = _t(_inputs(5))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(B, N, 4, 2)).astype(np.float32))
    t = torch.full((B, N), 2)
    with torch.no_grad():
        a = tm(inputs, x, t)
        b = back(inputs, x, t)
    for u, v in zip(a, b):
        assert rel_err(u, v.numpy()) <= 1e-5
    with pytest.raises(ValueError, match="not mapped"):
        extra = jax.tree_util.tree_map(np.asarray, variables)
        extra["params"]["stray"] = {"kernel": np.zeros((1, 1), np.float32)}
        convert.official_params_from_flax(extra)


@pytest.mark.parametrize("with_predictor", [True, False])
def test_lightning_checkpoint_loads_in_both_packages(pair, tmp_path,
                                                     with_predictor):
    """A Lightning-style blob (the state dict under ``model.``, the config
    under hyper_parameters.cfg) loads into both packages, strictly into
    the port's OfficialVBD, and both give the same denoiser output."""
    tm = pair[0]
    sd = {f"model.{k}": v for k, v in tm.state_dict().items()
          if with_predictor or not k.startswith("predictor.")}
    path = tmp_path / "vbd.ckpt"
    torch.save({"state_dict": sd,
                "hyper_parameters": {"cfg": dict(KW, action_std=[1.0, 0.15])}},
               path)
    got_model, got_cfg = convert.load_vbd_checkpoint(str(path), device="cpu")
    jm, jvars, jcfg = jconvert.load_vbd_checkpoint(str(path))
    assert got_cfg == model_official.OfficialVBDConfig(**KW)
    assert got_model.with_predictor == jm.with_predictor == with_predictor
    assert not got_model.training
    inputs = _inputs(7)
    x = np.random.default_rng(8).normal(size=(B, N, 4, 2)).astype(np.float32)
    t = np.full((B, N), 3, np.int32)
    want = jm.apply(jvars, _j(inputs), jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = got_model(_t(inputs), torch.from_numpy(x), torch.from_numpy(t))
    assert rel_err(got[0], want[0]) <= 1e-4
    assert (got[1] is None) == (not with_predictor)
    source = integration.OfficialVBDSource.from_checkpoint(str(path),
                                                           device="cpu")
    assert source.config == got_cfg and source.scheduler.steps == 4
    assert source.model.with_predictor == with_predictor


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a device the VBD models and the checkpoint loader ask for
    CUDA and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = model_official.OfficialVBDConfig(**KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_official.OfficialVBD(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        VBDModel(VBDConfig(hidden_dim=32, num_heads=2))
    path = tmp_path / "vbd.ckpt"
    torch.save({"state_dict": model_official.OfficialVBD(
        cfg, device="cpu").state_dict(), "hyper_parameters": {"cfg": KW}},
        path)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.load_vbd_checkpoint(str(path))
