"""Flat feed-forward actor-critic baseline (port of
``gpudrive_lab_tpu/networks/basic_ffn.py``; reference:
gpudrive/networks/basic_ffn.py:10-112): an MLP over the full flattened
observation, no per-modality structure.

Flax infers a Dense layer's input width at init; torch needs it, so
``FFNConfig`` carries ``obs_dim`` (the flat observation's 3368 floats by
default).  Activations follow flax: gelu is the tanh approximation.
Float32 only (another ``dtype`` raises).  ``networks/convert
.ffn_params_from_flax`` carries the JAX policy's parameters over.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.networks.late_fusion import lecun_normal_

OBS_DIM = (C.EGO_FEAT_DIM + (C.MAX_AGENTS - 1) * C.PARTNER_FEAT_DIM
           + C.MAX_AGENT_MAP_OBS * C.ROAD_GRAPH_FEAT_DIM)


def activation(name: str) -> nn.Module:
    """flax's nn.tanh, or nn.gelu (the tanh approximation)."""
    return nn.Tanh() if name == "tanh" else nn.GELU(approximate="tanh")


def check_float32(dtype) -> None:
    if dtype != torch.float32:
        raise ValueError(f"this network computes in float32 only, got "
                         f"{dtype}")


def init_heads(actor: nn.Linear, critic: nn.Linear, generator) -> None:
    """flax's head inits: orthogonal with gain 0.01 (logits) and 1.0
    (value), zero biases."""
    for lin, gain in ((actor, 0.01), (critic, 1.0)):
        nn.init.orthogonal_(lin.weight, gain, generator=generator)
        nn.init.zeros_(lin.bias)


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    action_dim: int = 91
    hidden_layers: Sequence[int] = (256, 128)
    act_func: str = "tanh"
    dtype: torch.dtype = torch.float32
    obs_dim: int = OBS_DIM


class FFNPolicy(nn.Module):
    """obs [..., obs_dim] -> (logits [..., action_dim], value [...]).
    Weights from ``generator`` with flax's initializers (hidden kernels
    lecun normal, zero biases, the heads orthogonal); the module lives on
    ``device`` (CUDA unless another is named)."""

    def __init__(self, config: FFNConfig = FFNConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_float32(config.dtype)
        self.config = config
        widths = [config.obs_dim, *config.hidden_layers]
        self.hidden = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.act = activation(config.act_func)
        self.actor = nn.Linear(widths[-1], config.action_dim)
        self.critic = nn.Linear(widths[-1], 1)
        with torch.no_grad():
            for lin in self.hidden:
                lecun_normal_(lin.weight, generator)
                nn.init.zeros_(lin.bias)
            init_heads(self.actor, self.critic, generator)
        self.to(resolve_device(device))

    def forward(self, obs_flat: torch.Tensor):
        x = obs_flat
        for lin in self.hidden:
            x = self.act(lin(x))
        return self.actor(x), self.critic(x)[..., 0]
