"""VBD checkpoints and weight conversion (port of
``gpudrive_lab_tpu/vbd/convert.py``).

The released VBD checkpoint (a LightningModule's; reference:
gpudrive/integrations/vbd/sim_agent/sim_actor.py:12-60 loads it with
``VBDTest.load_from_checkpoint``) loads into ``OfficialVBD`` with strict
``load_state_dict`` and no key map: the port's modules carry the torch
checkpoint's names (``vbd/model_official.py``).

``vbd_params_from_flax`` and ``official_params_from_flax`` map the JAX
package's flax trees (``VBDModel``, ``OfficialVBD``) onto the port's
state dicts, so that tests run both packages on the same weights:

  * a flax Dense kernel [in, out] is a Linear weight [out, in];
  * LayerNorm scale / bias -> weight / bias; Embed embedding -> weight;
  * flax's GRUCell (ir, iz, in with biases; hr, hz without; hn with) ->
    ``nn.GRU``'s packed [r | z | n] rows with the hidden r and z biases 0
    (the JAX official converter merged them into ir and iz);
  * ``MultiHeadDotProductAttention`` query / key / value kernels
    [D, heads, head_dim] and out [heads, head_dim, D] -> Linears;
  * ``TorchMHA``'s q_proj / k_proj / v_proj -> ``in_proj_weight`` /
    ``in_proj_bias`` as [Q | K | V] blocks.

Every converter takes each leaf of the flax tree once and refuses a tree
with a leaf left over (``networks/convert._Leaves``).
"""

from __future__ import annotations

from typing import Dict

import torch

from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.networks.convert import _Leaves
from gpudrive_lab_torch.vbd.model_official import (
    OfficialVBD,
    OfficialVBDConfig,
)


def _read(path: str):
    """torch.load of a checkpoint file on the CPU.  A Lightning
    checkpoint pickles its hyperparameters, so the file is unpickled in
    full (weights_only=False, as the JAX package reads it): load only
    checkpoints from a source you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .ckpt / .pt file -> a flat state dict (CPU), the Lightning
    ``model.`` prefix removed."""
    blob = _read(path)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k.removeprefix("model."): v for k, v in sd.items()}


def config_from_checkpoint(path: str) -> OfficialVBDConfig:
    """The model hyperparameters of a Lightning checkpoint."""
    blob = _read(path)
    cfg = (blob.get("hyper_parameters") or {}).get("cfg", {})
    return OfficialVBDConfig(
        future_len=cfg.get("future_len", 80),
        agents_len=cfg.get("agents_len", 32),
        action_len=cfg.get("action_len", 5),
        diffusion_steps=cfg.get("diffusion_steps", 50),
        encoder_layers=cfg.get("encoder_layers", 6),
        action_mean=tuple(cfg.get("action_mean", (0.0, 0.0))),
        action_std=tuple(cfg.get("action_std", (1.0, 0.15))),
    )


def load_vbd_checkpoint(path: str, device=None):
    """One-call loader: (OfficialVBD in eval mode on ``device``, config).
    The goal predictor is built when the checkpoint holds it."""
    config = config_from_checkpoint(path)
    sd = load_state_dict(path)
    model = OfficialVBD(config, with_predictor=any(
        k.startswith("predictor.") for k in sd), device="cpu")
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device)).eval(), config


def assert_state_dict_matches(sd: Dict[str, torch.Tensor],
                              module: torch.nn.Module) -> None:
    """Key- and shape-check a converted state dict against ``module``'s
    own (the counterpart of the JAX ``assert_tree_matches``)."""
    own = module.state_dict()
    missing = set(own) - set(sd)
    extra = set(sd) - set(own)
    if missing or extra:
        raise ValueError(f"state dict mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: {tuple(v.shape)} != {tuple(own[k].shape)}")


def _gru(take, sd, key, layer, *path):
    """A flax GRUCell (torch's gate equations) -> nn.GRU layer ``layer``."""
    sd[f"{key}.weight_ih_l{layer}"] = torch.cat(
        [take(*path, f"i{g}", "kernel") for g in "rzn"], 1).T.contiguous()
    sd[f"{key}.weight_hh_l{layer}"] = torch.cat(
        [take(*path, f"h{g}", "kernel") for g in "rzn"], 1).T.contiguous()
    sd[f"{key}.bias_ih_l{layer}"] = torch.cat(
        [take(*path, f"i{g}", "bias") for g in "rzn"])
    hn = take(*path, "hn", "bias")
    sd[f"{key}.bias_hh_l{layer}"] = torch.cat([torch.zeros_like(hn),
                                               torch.zeros_like(hn), hn])


def _flax_mha(take, sd, key, *path):
    for name in ("query", "key", "value"):
        sd[f"{key}.{name}.weight"] = take(*path, name, "kernel").flatten(
            1).T.contiguous()
        sd[f"{key}.{name}.bias"] = take(*path, name, "bias").flatten()
    sd[f"{key}.out.weight"] = take(*path, "out", "kernel").flatten(
        0, 1).T.contiguous()
    sd[f"{key}.out.bias"] = take(*path, "out", "bias")


def vbd_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX ``VBDModel`` tree -> ``vbd.model.VBDModel`` state dict
    keys.  Flax numbers the compact modules in creation order: the
    denoiser's Dense_0 (actions) and Dense_1 (step embedding), then per
    block LayerNorm_{3b..3b+2}, MultiHeadDotProductAttention_{2b, 2b+1}
    (self, cross) and Dense_{2b+2, 2b+3}, then the last LayerNorm and
    Dense; the predictor's Dense_0..3 are the anchor MLP, the actions and
    the score."""
    take = _Leaves(variables)
    sd: Dict[str, torch.Tensor] = {}
    enc = ("encoder",)
    _gru(take, sd, "encoder.agent.gru", 0, *enc, "AgentEncoder_0",
         "GRUCell_0")
    take.dense(sd, "encoder.map.point0", *enc, "MapEncoder_0", "Dense_0")
    take.dense(sd, "encoder.map.point1", *enc, "MapEncoder_0", "Dense_1")
    sd["encoder.map.type_embed.weight"] = take(*enc, "MapEncoder_0",
                                               "Embed_0", "embedding")
    sd["encoder.relation.freqs"] = take(*enc, "FourierEmbedding_0", "freqs")
    take.dense(sd, "encoder.relation.dense", *enc, "FourierEmbedding_0",
               "Dense_0")
    layer = 0
    while take.has(*enc, f"RelationAttentionLayer_{layer}"):
        p = (*enc, f"RelationAttentionLayer_{layer}")
        k = f"encoder.layers.{layer}"
        take.layer_norm(sd, f"{k}.ln1", *p, "LayerNorm_0")
        for i, name in enumerate(("qkv", "out", "fc1", "fc2")):
            take.dense(sd, f"{k}.{name}", *p, f"Dense_{i}")
        take.layer_norm(sd, f"{k}.ln2", *p, "LayerNorm_1")
        layer += 1

    den = ("denoiser",)
    take.dense(sd, "denoiser.action_in", *den, "Dense_0")
    take.dense(sd, "denoiser.step_in", *den, "Dense_1")
    for b in range(2):
        k = f"denoiser.blocks.{b}"
        for i, name in enumerate(("ln_self", "ln_cross", "ln_ffn")):
            take.layer_norm(sd, f"{k}.{name}", *den, f"LayerNorm_{3 * b + i}")
        _flax_mha(take, sd, f"{k}.self_attn", *den,
                  f"MultiHeadDotProductAttention_{2 * b}")
        _flax_mha(take, sd, f"{k}.cross_attn", *den,
                  f"MultiHeadDotProductAttention_{2 * b + 1}")
        take.dense(sd, f"{k}.fc1", *den, f"Dense_{2 * b + 2}")
        take.dense(sd, f"{k}.fc2", *den, f"Dense_{2 * b + 3}")
    take.layer_norm(sd, "denoiser.out_ln", *den, "LayerNorm_6")
    take.dense(sd, "denoiser.out", *den, "Dense_6")

    pred = ("predictor",)
    for i, name in enumerate(("anchor0", "anchor1", "actions", "score")):
        take.dense(sd, f"predictor.{name}", *pred, f"Dense_{i}")
    take.layer_norm(sd, "predictor.ln", *pred, "LayerNorm_0")
    _flax_mha(take, sd, "predictor.attn", *pred,
              "MultiHeadDotProductAttention_0")
    return take.finish(sd)


def _torch_mha(take, sd, key, *path):
    """TorchMHA's q_proj, k_proj, v_proj -> in_proj as [Q | K | V]."""
    sd[f"{key}.in_proj_weight"] = torch.cat(
        [take(*path, n, "kernel") for n in ("q_proj", "k_proj", "v_proj")],
        1).T.contiguous()
    sd[f"{key}.in_proj_bias"] = torch.cat(
        [take(*path, n, "bias") for n in ("q_proj", "k_proj", "v_proj")])
    take.dense(sd, f"{key}.out_proj", *path, "out_proj")


def _transformer(take, sd, key, *path, attention):
    """A Self- or CrossTransformer: its attention, norms and FFN."""
    attention(take, sd, key, *path)
    take.layer_norm(sd, f"{key}.norm_1", *path, "norm_1")
    take.layer_norm(sd, f"{key}.norm_2", *path, "norm_2")
    take.dense(sd, f"{key}.ffn.0", *path, "ffn_0")
    take.dense(sd, f"{key}.ffn.3", *path, "ffn_3")


def _qc(take, sd, key, *path):
    for name in ("in_proj", "out_proj"):
        take.dense(sd, f"{key}.qc_attention.{name}", *path, "qc_attention",
                   name)


def _cross(take, sd, key, *path):
    _torch_mha(take, sd, f"{key}.cross_attention", *path, "cross_attention")


def official_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX ``OfficialVBD`` tree -> ``OfficialVBD`` state dict keys
    (the torch checkpoint's; the inverse of the JAX
    ``convert_state_dict``)."""
    take = _Leaves(variables)
    sd: Dict[str, torch.Tensor] = {}
    e = "encoder"
    for layer in range(2):
        _gru(take, sd, f"{e}.agent_encoder.motion", layer, e,
             "agent_encoder", "motion", f"l{layer}")
    for k, path in (("agent_encoder.type_embed", ("agent_encoder",
                                                  "type_embed")),
                    ("map_encoder.traffic_light_embed",
                     ("map_encoder", "traffic_light_embed")),
                    ("map_encoder.type_embed", ("map_encoder",
                                                "type_embed")),
                    ("traffic_light_encoder.type_embed",
                     ("traffic_light_encoder", "type_embed"))):
        sd[f"{e}.{k}.weight"] = take(e, *path, "embedding")
    take.dense(sd, f"{e}.map_encoder.point.0", e, "map_encoder", "point_0")
    take.dense(sd, f"{e}.map_encoder.point.2", e, "map_encoder", "point_2")
    rel = (e, "relation_encoder")
    sd[f"{e}.relation_encoder.freqs.weight"] = take(*rel, "freqs")
    for i in range(3):
        take.dense(sd, f"{e}.relation_encoder.mlps.{i}.0", *rel, f"mlp{i}_0")
        take.layer_norm(sd, f"{e}.relation_encoder.mlps.{i}.1", *rel,
                        f"mlp{i}_1")
        take.dense(sd, f"{e}.relation_encoder.mlps.{i}.3", *rel, f"mlp{i}_3")
    take.layer_norm(sd, f"{e}.relation_encoder.to_out.0", *rel, "to_out_0")
    take.dense(sd, f"{e}.relation_encoder.to_out.2", *rel, "to_out_2")
    layer = 0
    while take.has(e, f"layer{layer}"):
        _transformer(take, sd, f"{e}.transformer_encoder.layers.{layer}", e,
                     f"layer{layer}", attention=_qc)
        layer += 1

    d = ("denoiser", "decoder")
    sd["denoiser.noise_level_embedding.weight"] = take(
        "denoiser", "noise_level_embedding", "embedding")
    sd["denoiser.decoder.time_embedding.weight"] = take(
        *d, "time_embedding", "embedding")
    for k, name in (("encoder.0", "encoder_0"), ("encoder.2", "encoder_2"),
                    ("decoder.0", "decoder_0"), ("decoder.3", "decoder_3")):
        take.dense(sd, f"denoiser.decoder.{k}", *d, name)
    for i in range(4):
        _transformer(take, sd, f"denoiser.decoder.attention_layers.{i}", *d,
                     f"attn{i}", attention=_cross)

    if take.has("predictor"):
        for k, name in (("anchor_encoder.0", "anchor_0"),
                        ("anchor_encoder.2", "anchor_2"),
                        ("act_decoder.0", "act_0"), ("act_decoder.3", "act_3"),
                        ("score_decoder.0", "score_0"),
                        ("score_decoder.3", "score_3")):
            take.dense(sd, f"predictor.{k}", "predictor", name)
        for i in range(4):
            _transformer(take, sd, f"predictor.attention_layers.{i}",
                         "predictor", f"attn{i}", attention=_cross)
    return take.finish(sd)
