"""Permutation-equivariant late-fusion actor-critic with separate towers
(port of ``gpudrive_lab_tpu/networks/perm_eq_late_fusion.py``; reference:
gpudrive/networks/perm_eq_late_fusion.py:19-259 LateFusionNet/
LateFusionPolicy).

Per-modality embeddings whose entity sets are processed
permutation-equivariantly (one Dense shared by the entities, then a max
over the set), with separate actor and value towers (unlike
networks/late_fusion.py's shared head).  Numerics follow flax: LayerNorm
eps 1e-6, gelu the tanh approximation.  Float32 only (another ``dtype``
raises).  ``networks/convert.perm_eq_params_from_flax`` carries the JAX
policy's parameters over.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.networks.basic_ffn import (
    activation,
    check_float32,
    init_heads,
)
from gpudrive_lab_torch.networks.fused_embed import LN_EPS
from gpudrive_lab_torch.networks.late_fusion import lecun_normal_


@dataclasses.dataclass(frozen=True)
class PermEqConfig:
    action_dim: int = 91
    ego_feat_dim: int = C.EGO_FEAT_DIM
    max_agents: int = C.MAX_AGENTS
    top_k_roads: int = C.MAX_AGENT_MAP_OBS
    embed_dim: int = 64
    tower_layers: Sequence[int] = (128, 64)
    act_func: str = "tanh"
    dtype: torch.dtype = torch.float32

    @property
    def obs_dim(self) -> int:
        return (
            self.ego_feat_dim
            + (self.max_agents - 1) * C.PARTNER_FEAT_DIM
            + self.top_k_roads * C.ROAD_GRAPH_FEAT_DIM
        )


class _Tower(nn.Module):
    """Dense -> LayerNorm -> act per width of ``layers`` (``self.layers``
    holds the Linear and LayerNorm of layer l at 2l and 2l + 1)."""

    def __init__(self, in_dim: int, layers: Sequence[int], act: str):
        super().__init__()
        mods = []
        for h in layers:
            mods += [nn.Linear(in_dim, h), nn.LayerNorm(h, eps=LN_EPS)]
            in_dim = h
        self.layers = nn.ModuleList(mods)
        self.act = activation(act)

    def forward(self, x):
        for i in range(0, len(self.layers), 2):
            x = self.act(self.layers[i + 1](self.layers[i](x)))
        return x


class LateFusionNet(nn.Module):
    """Feature extractor: the ego's tanh Dense and the partner and road
    sets' shared tanh Dense, max-pooled over each set."""

    def __init__(self, config: PermEqConfig = PermEqConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        self.ego = nn.Linear(cfg.ego_feat_dim, cfg.embed_dim)
        self.partner = nn.Linear(C.PARTNER_FEAT_DIM, cfg.embed_dim)
        self.road = nn.Linear(C.ROAD_GRAPH_FEAT_DIM, cfg.embed_dim)

    def forward(self, obs_flat):
        cfg = self.config
        e = cfg.ego_feat_dim
        p = (cfg.max_agents - 1) * C.PARTNER_FEAT_DIM
        ego = obs_flat[..., :e]
        partner = obs_flat[..., e:e + p].unflatten(
            -1, (cfg.max_agents - 1, C.PARTNER_FEAT_DIM))
        road = obs_flat[..., e + p:].unflatten(
            -1, (cfg.top_k_roads, C.ROAD_GRAPH_FEAT_DIM))
        return torch.cat([
            torch.tanh(self.ego(ego)),
            torch.tanh(self.partner(partner)).max(dim=-2).values,
            torch.tanh(self.road(road)).max(dim=-2).values,
        ], dim=-1)


class LateFusionPolicy(nn.Module):
    """obs [..., obs_dim] -> (logits [..., action_dim], value [...]):
    separate actor and value towers over the shared extractor (reference:
    perm_eq_late_fusion.py LateFusionPolicy).  Weights from ``generator``
    with flax's initializers (Dense kernels lecun normal, LayerNorm ones
    and zeros, zero biases, the heads orthogonal 0.01 and 1.0); the module
    lives on ``device`` (CUDA unless another is named)."""

    def __init__(self, config: PermEqConfig = PermEqConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_float32(config.dtype)
        cfg = config
        self.config = cfg
        self.net = LateFusionNet(cfg)
        feat = 3 * cfg.embed_dim
        self.pi_tower = _Tower(feat, cfg.tower_layers, cfg.act_func)
        self.vf_tower = _Tower(feat, cfg.tower_layers, cfg.act_func)
        last = cfg.tower_layers[-1] if cfg.tower_layers else feat
        self.actor = nn.Linear(last, cfg.action_dim)
        self.critic = nn.Linear(last, 1)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    nn.init.zeros_(m.bias)
            init_heads(self.actor, self.critic, generator)
        self.to(resolve_device(device))

    def forward(self, obs_flat: torch.Tensor):
        feats = self.net(obs_flat)
        logits = self.actor(self.pi_tower(feats))
        value = self.critic(self.vf_tower(feats))[..., 0]
        return logits, value
