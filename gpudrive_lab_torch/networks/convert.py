"""Flax ``LateFusionPolicy`` parameters -> the port's ``state_dict``.

The inverse of ``gpudrive_lab_tpu/networks/convert.py``'s key mapping
(flax path -> reference ``NeuralNet`` module):

    _Embed_0/{Dense_0, LayerNorm_0, Dense_1} -> ego_embed.{0,1,4}
    _Embed_1/...                             -> partner_embed.{0,1,4}
    _Embed_2/...                             -> road_map_embed.{0,1,4}
    Dense_0                                  -> shared_embed.0
    Dense_1                                  -> actor
    Dense_2                                  -> critic

Flax ``Dense`` kernels are [in, out]; torch ``Linear.weight`` is [out, in],
so kernels are transposed.  LayerNorm scale/bias map to weight/bias.
"""

from __future__ import annotations

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
