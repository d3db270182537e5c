"""Flax parameters and optax Adam state -> the port's ``state_dict`` and
``torch.optim.Adam`` (or ``AdamW``) state, for the late-fusion policy
(``params_from_flax``), its LSTM variant (``lstm_params_from_flax``) and the
attention BC net (``bc_params_from_flax``).

The inverse of ``gpudrive_lab_tpu/networks/convert.py``'s key mapping
(flax path -> reference ``NeuralNet`` module):

    _Embed_0/{Dense_0, LayerNorm_0, Dense_1} -> ego_embed.{0,1,4}
    _Embed_1/...                             -> partner_embed.{0,1,4}
    _Embed_2/...                             -> road_map_embed.{0,1,4}
    Dense_0                                  -> shared_embed.0
    Dense_1                                  -> actor
    Dense_2                                  -> critic

Flax ``Dense`` kernels are [in, out]; torch ``Linear.weight`` is [out, in],
so kernels are transposed.  LayerNorm scale/bias map to weight/bias.  Adam's
moments are trees of the parameters' shape and map the same way.  The LSTM
and BC converters take every leaf of the tree by its own name and refuse a
tree with a leaf left over.

``load_jax_checkpoint`` reads the JAX trainers' pickles (the PPO trainer's
and ``scripts/train_rnn.py``'s ``policy.pkl``, the BC trainer's
``bc_policy.pkl``) without importing optax or flax: their classes in the
pickle are read back as plain stand-ins, and a class from anywhere but
numpy is refused.

The reference direction: the reference releases its self-play policies as
torch ``NeuralNet`` checkpoints (reference: gpudrive/networks/late_fusion.py
:69-75, README.md:207-231).  Their keys are ``LateFusionPolicy``'s own, so
``convert_state_dict`` takes each tensor by name and refuses a missing or
extra key; ``load_pretrained`` reads a file, a directory or a hub repo id
and returns the policy on its device.  ``ffn_params_from_flax`` and
``perm_eq_params_from_flax`` convert the two extra networks
(``networks/basic_ffn.py``, ``networks/perm_eq_late_fusion.py``).
"""

from __future__ import annotations

import collections
import os
import pickle
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EMBEDS = {"_Embed_0": "ego_embed", "_Embed_1": "partner_embed",
           "_Embed_2": "road_map_embed"}
_HEADS = {"Dense_0": "shared_embed.0", "Dense_1": "actor",
          "Dense_2": "critic"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax variable tree (``{"params": ...}`` or the params dict
    itself, leaves as numpy arrays) onto LateFusionPolicy state_dict keys."""
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}

    def dense(tree, key):
        sd[f"{key}.weight"] = _t(tree["kernel"]).T.contiguous()
        sd[f"{key}.bias"] = _t(tree["bias"])

    for flax_name, key in _EMBEDS.items():
        blk = params[flax_name]
        dense(blk["Dense_0"], f"{key}.0")
        sd[f"{key}.1.weight"] = _t(blk["LayerNorm_0"]["scale"])
        sd[f"{key}.1.bias"] = _t(blk["LayerNorm_0"]["bias"])
        dense(blk["Dense_1"], f"{key}.4")
    for flax_name, key in _HEADS.items():
        dense(params[flax_name], key)
    return sd


class _Leaves:
    """A flax parameter tree whose leaves are taken by path, each once."""

    def __init__(self, variables):
        self.tree = variables.get("params", variables)
        self.taken = set()

    def __call__(self, *path) -> torch.Tensor:
        if path in self.taken:
            raise ValueError(f"leaf {'/'.join(path)} taken twice")
        node = self.tree
        for k in path:
            node = node[k]
        self.taken.add(path)
        return _t(node)

    def dense(self, sd, key, *path, bias=True):
        sd[f"{key}.weight"] = self(*path, "kernel").T.contiguous()
        if bias:
            sd[f"{key}.bias"] = self(*path, "bias")

    def layer_norm(self, sd, key, *path):
        sd[f"{key}.weight"] = self(*path, "scale")
        sd[f"{key}.bias"] = self(*path, "bias")

    def has(self, *path) -> bool:
        node = self.tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                return False
            node = node[k]
        return True

    def finish(self, sd):
        """``sd``, once every leaf of the tree was taken."""
        def leaves(node, path=()):
            if isinstance(node, dict):
                for k, v in node.items():
                    yield from leaves(v, path + (k,))
            else:
                yield path

        left = [p for p in leaves(self.tree) if p not in self.taken]
        if left:
            raise ValueError("flax leaves not mapped: "
                             + ", ".join("/".join(p) for p in left))
        return sd


def _embed_block(take, sd, key, *path, first=0, ln=0):
    """Dense_{first} -> LayerNorm_{ln} -> Dense_{first + 1} under ``path``
    -> ``key``.{0, 1, 4} (the port's embed Sequential)."""
    take.dense(sd, f"{key}.0", *path, f"Dense_{first}")
    take.layer_norm(sd, f"{key}.1", *path, f"LayerNorm_{ln}")
    take.dense(sd, f"{key}.4", *path, f"Dense_{first + 1}")


def lstm_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX ``LateFusionLSTMPolicy`` tree -> ``LateFusionLSTMPolicy``
    state_dict keys: _Embed_0..2 -> ego_embed, partner_embed,
    road_map_embed; OptimizedLSTMCell_0/{ii, if, ig, io} (no bias) ->
    lstm_i and {hi, hf, hg, ho} -> lstm_h, the four gates' kernels side by
    side in i, f, g, o order; Dense_0 -> actor and Dense_1 -> critic (in
    the feed-forward policy Dense_0 is shared_embed)."""
    take = _Leaves(variables)
    sd: Dict[str, torch.Tensor] = {}
    for flax_name, key in _EMBEDS.items():
        _embed_block(take, sd, key, flax_name)
    cell = "OptimizedLSTMCell_0"
    sd["lstm_i.weight"] = torch.cat(
        [take(cell, f"i{g}", "kernel") for g in "ifgo"], dim=1).T.contiguous()
    sd["lstm_h.weight"] = torch.cat(
        [take(cell, f"h{g}", "kernel") for g in "ifgo"], dim=1).T.contiguous()
    sd["lstm_h.bias"] = torch.cat([take(cell, f"h{g}", "bias")
                                   for g in "ifgo"])
    take.dense(sd, "actor", "Dense_0")
    take.dense(sd, "critic", "Dense_1")
    return take.finish(sd)


def _mha(take, sd, key, *path):
    """MultiHeadAttention: Dense_0..3 are q, k, v and the output."""
    for i, name in enumerate(("q", "k", "v", "out")):
        take.dense(sd, f"{key}.{name}", *path, f"Dense_{i}")


def _self_attention_block(take, sd, key, *path):
    """SelfAttentionBlock: layer l holds LayerNorm_{2l}, the attention
    MultiHeadAttention_l, LayerNorm_{2l+1}, Dense_{2l} and Dense_{2l+1}."""
    layer = 0
    while take.has(*path, f"MultiHeadAttention_{layer}"):
        k = f"{key}.layers.{layer}"
        take.layer_norm(sd, f"{k}.ln1", *path, f"LayerNorm_{2 * layer}")
        _mha(take, sd, f"{k}.attn", *path, f"MultiHeadAttention_{layer}")
        take.layer_norm(sd, f"{k}.ln2", *path, f"LayerNorm_{2 * layer + 1}")
        take.dense(sd, f"{k}.fc1", *path, f"Dense_{2 * layer}")
        take.dense(sd, f"{k}.fc2", *path, f"Dense_{2 * layer + 1}")
        layer += 1


def bc_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX ``EarlyFusionAttnBCNet`` tree -> ``il.networks
    .EarlyFusionAttnBCNet`` state_dict keys.  The embeds are made in one
    compact method, so they are numbered in creation order: Dense_0,
    LayerNorm_0, Dense_1 (ego), Dense_2, LayerNorm_1, Dense_3 (partners),
    Dense_4, LayerNorm_2, Dense_5 (roads), then Dense_6, Dense_7 of the
    ToM head when present; SelfAttentionBlock_0..2 are the partner, road
    and fusion blocks; ego_ro_cross and ego_rg_cross hold
    MultiHeadAttention_0 and LayerNorm_0..2 (query, key/value and the MLP's
    norm) and Dense_0..1; GMMHead_0 holds Dense_0..3 (hidden, means,
    log_std, mixture logits)."""
    take = _Leaves(variables)
    sd: Dict[str, torch.Tensor] = {}
    for i, key in enumerate(("ego_embed", "ro_embed", "rg_embed")):
        _embed_block(take, sd, key, first=2 * i, ln=i)
    for i, key in enumerate(("ro_block", "rg_block", "fusion_block")):
        _self_attention_block(take, sd, key, f"SelfAttentionBlock_{i}")
    for key in ("ego_ro_cross", "ego_rg_cross"):
        _mha(take, sd, f"{key}.attn", key, "MultiHeadAttention_0")
        for i, ln in enumerate(("ln_q", "ln_kv", "ln_mlp")):
            take.layer_norm(sd, f"{key}.{ln}", key, f"LayerNorm_{i}")
        take.dense(sd, f"{key}.fc1", key, "Dense_0")
        take.dense(sd, f"{key}.fc2", key, "Dense_1")
    for i, name in enumerate(("hidden", "means", "log_std", "logits")):
        take.dense(sd, f"gmm.{name}", "GMMHead_0", f"Dense_{i}")
    if take.has("Dense_6"):
        take.dense(sd, "tom_hidden", "Dense_6")
        take.dense(sd, "tom_out", "Dense_7")
    return take.finish(sd)


def ffn_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX ``basic_ffn.FFNPolicy`` tree -> ``FFNPolicy`` state_dict
    keys: Dense_0..Dense_{n-1} -> hidden.0..n-1, Dense_n -> actor and
    Dense_{n+1} -> critic, for n hidden layers."""
    take = _Leaves(variables)
    sd: Dict[str, torch.Tensor] = {}
    n = len([k for k in take.tree if k.startswith("Dense_")]) - 2
    for i in range(n):
        take.dense(sd, f"hidden.{i}", f"Dense_{i}")
    take.dense(sd, "actor", f"Dense_{n}")
    take.dense(sd, "critic", f"Dense_{n + 1}")
    return take.finish(sd)


def perm_eq_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX ``perm_eq_late_fusion.LateFusionPolicy`` tree -> the port's
    state_dict keys: LateFusionNet_0/Dense_{0,1,2} -> net.{ego, partner,
    road}; _Tower_0 and _Tower_1 (Dense_l, LayerNorm_l per layer) ->
    pi_tower and vf_tower .layers.{2l, 2l+1}; Dense_0 -> actor and Dense_1
    -> critic."""
    take = _Leaves(variables)
    sd: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(("ego", "partner", "road")):
        take.dense(sd, f"net.{name}", "LateFusionNet_0", f"Dense_{i}")
    for tower, key in (("_Tower_0", "pi_tower"), ("_Tower_1", "vf_tower")):
        layer = 0
        while take.has(tower, f"Dense_{layer}"):
            take.dense(sd, f"{key}.layers.{2 * layer}", tower,
                       f"Dense_{layer}")
            take.layer_norm(sd, f"{key}.layers.{2 * layer + 1}", tower,
                            f"LayerNorm_{layer}")
            layer += 1
    take.dense(sd, "actor", "Dense_0")
    take.dense(sd, "critic", "Dense_1")
    return take.finish(sd)


def params_fn_for(module: torch.nn.Module):
    """The converter of ``module``'s class (named by its module, since
    ``LateFusionPolicy`` names two networks)."""
    cls = type(module)
    return {
        "networks.late_fusion.LateFusionPolicy": params_from_flax,
        "networks.late_fusion.LateFusionLSTMPolicy": lstm_params_from_flax,
        "il.networks.EarlyFusionAttnBCNet": bc_params_from_flax,
        "networks.basic_ffn.FFNPolicy": ffn_params_from_flax,
        "networks.perm_eq_late_fusion.LateFusionPolicy":
            perm_eq_params_from_flax,
    }[f"{cls.__module__.removeprefix('gpudrive_lab_torch.')}.{cls.__name__}"]


# ---- the reference's torch checkpoints -----------------------------------


def reference_keys() -> list:
    """The state_dict keys of the reference ``NeuralNet`` (without the
    vbd_embed branch), which are ``LateFusionPolicy``'s: each embed's
    Linear(0), LayerNorm(1) and Linear(4) (its act(2) and Dropout(3) have
    no parameters), shared_embed.0, actor and critic."""
    mods = [f"{e}.{i}" for e in _EMBEDS.values() for i in (0, 1, 4)]
    mods += list(_HEADS.values())
    return [f"{m}.{p}" for m in mods for p in ("weight", "bias")]


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return _t(x)


def convert_state_dict(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference ``NeuralNet`` state_dict (tensors or numpy arrays) ->
    ``LateFusionPolicy``'s state_dict, float32 on the CPU, every tensor
    taken by its own name.  A missing or extra key raises; a checkpoint of
    the vbd_in_obs variant (its ``vbd_embed`` branch, reference:
    late_fusion.py:147-156) raises as the JAX converter does."""
    if any(k.startswith("vbd_embed.") for k in sd):
        raise NotImplementedError(
            "vbd_in_obs policies are not supported by LateFusionPolicy (the "
            "reference's vbd_embed branch, late_fusion.py:147-156)")
    want = reference_keys()
    missing = [k for k in want if k not in sd]
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"not a reference NeuralNet state_dict: missing "
                         f"{missing}, extra {extra}")
    return {k: _tensor(sd[k]) for k in want}


def config_from_state_dict(sd: Dict[str, Any]):
    """The ``PolicyConfig`` of a reference state_dict, read from its
    shapes: ``input_dim`` and ``ego_feat_dim`` from ego_embed.0,
    ``hidden_dim`` from shared_embed.0, ``action_dim`` from actor."""
    from gpudrive_lab_torch.networks.late_fusion import PolicyConfig

    ego = tuple(sd["ego_embed.0.weight"].shape)
    return PolicyConfig(
        action_dim=int(sd["actor.weight"].shape[0]),
        input_dim=int(ego[0]),
        hidden_dim=int(sd["shared_embed.0.weight"].shape[0]),
        ego_feat_dim=int(ego[1]),
    )


def load_policy_state_dict(path: str) -> Dict[str, Any]:
    """A local checkpoint file as a flat CPU state_dict: ``.safetensors``
    through ``safetensors.torch``, a ``.pt``/``.bin`` torch blob (a
    state_dict, a dict holding one under "state_dict", or a pickled
    module) through ``torch.load``.  The blob may pickle a module, so it is
    read with ``weights_only=False``: load only checkpoints you trust."""
    path = str(path)
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    if hasattr(blob, "state_dict"):
        blob = blob.state_dict()
    return dict(blob)


def load_pretrained(repo_or_path: str, revision: str | None = None,
                    device=None) -> Tuple[torch.nn.Module, Any]:
    """A released reference policy as a ``LateFusionPolicy`` on ``device``
    (CUDA unless another is named).

    ``repo_or_path`` is a local file, a local directory holding
    ``model.safetensors``, ``pytorch_model.bin`` or ``model.pt`` (looked
    for in that order; the PyTorchModelHubMixin layout), or a hub repo id
    such as ``daphne-cornelisse/policy_S10_000_02_27`` (reference:
    README.md:228; fetched with ``huggingface_hub.hf_hub_download``, which
    needs the network).  Returns (policy, policy_config); the config is
    read from the tensors' shapes, so ``dataclasses.replace(config,
    fused_embed=True)`` builds the same policy on kernels K3/K4."""
    from gpudrive_lab_torch.networks.late_fusion import LateFusionPolicy

    path = str(repo_or_path)
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin", "model.pt"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
    elif not os.path.exists(path):
        from huggingface_hub import hf_hub_download

        path = hf_hub_download(repo_id=repo_or_path,
                               filename="model.safetensors",
                               revision=revision)
    sd = load_policy_state_dict(path)
    config = config_from_state_dict(sd)
    policy = LateFusionPolicy(config, device=device)
    policy.load_state_dict(convert_state_dict(sd))
    return policy, config


def _adam_moments(opt_state):
    """The ScaleByAdamState (count, mu, nu) inside an optax state tree."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_moments(s)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, policy: torch.nn.Module) -> dict:
    """optax ``chain(clip_by_global_norm, adam)`` (or ``adamw``) state ->
    the ``state`` entry of ``torch.optim.Adam(policy.parameters())
    .state_dict()`` (AdamW's is the same): per parameter index, ``step``
    (optax ``count``), ``exp_avg`` (``mu``) and ``exp_avg_sq`` (``nu``),
    mapped by the converter of ``policy``'s class.  Load it with
    ``sd = opt.state_dict(); sd["state"] = ...; opt.load_state_dict(sd)``."""
    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    convert = params_fn_for(policy)
    mu = convert(adam.mu)
    nu = convert(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    return {
        i: {"step": step.clone(), "exp_avg": mu[name],
            "exp_avg_sq": nu[name]}
        for i, (name, _) in enumerate(policy.named_parameters())
    }


class _Opaque(tuple):
    """Stand-in for a class of optax or flax met in a pickle."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


_ScaleByAdamState = collections.namedtuple("ScaleByAdamState",
                                           "count mu nu")


class _CheckpointUnpickler(pickle.Unpickler):
    """Reads numpy arrays and plain containers; optax and flax classes
    become stand-ins, a jax.numpy dtype its name, and any other class is
    refused."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in ("optax", "flax"):
            return _ScaleByAdamState if name == "ScaleByAdamState" else _Opaque
        if module == "jax.numpy":  # a dtype in a config, e.g. jnp.float32
            return name
        if root == "numpy" or (module, name) == ("collections",
                                                 "OrderedDict"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a "
                                     "checkpoint")


def read_jax_pickle(path) -> dict:
    """A JAX trainer's pickle as plain containers and numpy arrays."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def load_jax_checkpoint(path, policy: torch.nn.Module,
                        optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load a JAX trainer's pickle (``variables`` and, from the PPO
    trainers, ``opt_state`` and ``global_step``; ``train_rnn.py`` adds
    ``arch``, the BC trainer ``config``) into ``policy`` through the
    converter of its class and, when given and the file holds Adam state,
    ``optimizer``.  Returns the global step (0 when the file has none)."""
    ckpt = read_jax_pickle(path)
    policy.load_state_dict(params_fn_for(policy)(ckpt["variables"]))
    if optimizer is not None and "opt_state" in ckpt:
        sd = optimizer.state_dict()
        sd["state"] = adam_state_from_optax(ckpt["opt_state"], policy)
        optimizer.load_state_dict(sd)
    return int(ckpt.get("global_step", 0))
