"""Flax ``LateFusionPolicy`` parameters and optax Adam state -> the port's
``state_dict`` and ``torch.optim.Adam`` state.

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
moments are trees of the parameters' shape and map the same way.

``load_jax_checkpoint`` reads the JAX trainer's ``policy.pkl``
(``gpudrive_lab_tpu/ppo/train.py::save_checkpoint``) without importing optax
or flax: their classes in the pickle are read back as plain stand-ins, and
a class from anywhere but numpy is refused.
"""

from __future__ import annotations

import collections
import pickle
from typing import Any, Dict

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
    """optax ``chain(clip_by_global_norm, adam)`` state -> the ``state``
    entry of ``torch.optim.Adam(policy.parameters()).state_dict()``:
    per parameter index, ``step`` (optax ``count``), ``exp_avg`` (``mu``)
    and ``exp_avg_sq`` (``nu``), Dense kernels transposed.  Load it with
    ``sd = opt.state_dict(); sd["state"] = ...; opt.load_state_dict(sd)``."""
    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    mu = params_from_flax(adam.mu)
    nu = params_from_flax(adam.nu)
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
    become stand-ins, and any other class is refused."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in ("optax", "flax"):
            return _ScaleByAdamState if name == "ScaleByAdamState" else _Opaque
        if root == "numpy" or (module, name) == ("collections",
                                                 "OrderedDict"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a "
                                     "checkpoint")


def load_jax_checkpoint(path, policy: torch.nn.Module,
                        optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load the JAX trainer's ``policy.pkl`` (``variables``, ``opt_state``,
    ``iteration``, ``global_step``) into ``policy`` and, when given and the
    file holds Adam state, ``optimizer``.  Returns the global step."""
    with open(path, "rb") as f:
        ckpt = _CheckpointUnpickler(f).load()
    policy.load_state_dict(params_from_flax(ckpt["variables"]))
    if optimizer is not None and "opt_state" in ckpt:
        sd = optimizer.state_dict()
        sd["state"] = adam_state_from_optax(ckpt["opt_state"], policy)
        optimizer.load_state_dict(sd)
    return int(ckpt.get("global_step", 0))
