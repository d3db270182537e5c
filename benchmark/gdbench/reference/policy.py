"""The late-fusion actor-critic of the plain reference (reference:
gpudrive/networks/late_fusion.py:69-248), in plain PyTorch and float32.

Per-modality MLP embeddings (ego 6->64, partner 6->64, road 13->64:
Linear, LayerNorm with eps 1e-6, tanh, Linear), a max over the entities, a
shared Linear 192->128, then the actor's logits and the critic's value.
Parameter names are the reference ``NeuralNet``'s state_dict keys, which
the port keeps too.

``tf32=True`` rounds both operands of every product to TF32 (10 bits of
mantissa, round to nearest) before a float32 product: the arithmetic of
TF32 tensor cores, on any device, for the control.
"""

from __future__ import annotations

import torch
from torch import nn

from . import constants as C

LN_EPS = 1e-6


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest, ties
    away from zero (the tensor cores' conversion)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    """x @ w.T + b with every product's operands rounded to TF32, in the
    forward pass and in both products of the backward pass."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.t() + b

    @staticmethod
    def backward(ctx, gy):
        xr, wr = ctx.saved_tensors
        g = round_tf32(gy)
        gw = g.reshape(-1, g.shape[-1]).t() @ xr.reshape(-1, xr.shape[-1])
        gb = gy.reshape(-1, gy.shape[-1]).sum(0)
        return g @ wr, gw, gb


class Linear(nn.Linear):
    """nn.Linear whose products can run on TF32-rounded operands."""

    tf32 = False

    def forward(self, x):
        if self.tf32:
            return _TF32Linear.apply(x, self.weight, self.bias)
        return super().forward(x)


def _embed(in_dim: int, dim: int) -> nn.Sequential:
    return nn.Sequential(Linear(in_dim, dim), nn.LayerNorm(dim, eps=LN_EPS),
                         nn.Tanh(), nn.Identity(), Linear(dim, dim))


class LateFusionNet(nn.Module):
    """obs [..., obs_dim] -> (logits [..., actions], value [...])."""

    def __init__(self, ego: int = C.EGO_FEAT_DIM, embed: int = 64,
                 hidden: int = 128, actions: int = 91,
                 partners: int = C.MAX_AGENTS - 1,
                 roads: int = C.MAX_AGENT_MAP_OBS):
        super().__init__()
        self.ego, self.partners, self.roads = ego, partners, roads
        self.ego_embed = _embed(ego, embed)
        self.partner_embed = _embed(C.PARTNER_FEAT_DIM, embed)
        self.road_map_embed = _embed(C.ROAD_GRAPH_FEAT_DIM, embed)
        self.shared_embed = nn.Sequential(Linear(3 * embed, hidden),
                                          nn.Identity())
        self.actor = Linear(hidden, actions)
        self.critic = Linear(hidden, 1)

    def set_tf32(self, on: bool) -> None:
        for m in self.modules():
            if isinstance(m, Linear):
                m.tf32 = on

    def forward(self, obs: torch.Tensor):
        e = self.ego
        p = self.partners * C.PARTNER_FEAT_DIM
        ego = obs[..., :e]
        partner = obs[..., e:e + p].unflatten(
            -1, (self.partners, C.PARTNER_FEAT_DIM))
        road = obs[..., e + p:].unflatten(
            -1, (self.roads, C.ROAD_GRAPH_FEAT_DIM))
        feats = torch.cat([self.ego_embed(ego),
                           self.partner_embed(partner).max(dim=-2).values,
                           self.road_map_embed(road).max(dim=-2).values], -1)
        hidden = self.shared_embed(feats)
        return self.actor(hidden), self.critic(hidden)[..., 0]


# gain of each layer's weights (the reference's orthogonal init gains)
GAINS = {"actor": 0.01, "critic": 1.0}


def make_weights(net: LateFusionNet, generator: torch.Generator,
                 device) -> dict:
    """Weights for ``net``'s state_dict keys, drawn on ``device`` from
    ``generator`` in one call: each Linear's weight normal with standard
    deviation gain / sqrt(fan_in) (gain sqrt 2 but the actor's 0.01 and the
    critic's 1), each bias normal with standard deviation 0.01, LayerNorms
    at scale 1 and shift 0."""
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    draw = [k for k in shapes if k.endswith(("weight", "bias"))
            and not _is_norm(net, k)]
    total = sum(int(torch.Size(shapes[k]).numel()) for k in draw)
    flat = torch.randn(total, generator=generator, device=device)
    out, o = {}, 0
    for k, shape in shapes.items():
        if k in draw:
            n = int(torch.Size(shape).numel())
            x = flat[o:o + n].reshape(shape)
            o += n
            if k.endswith("weight"):
                gain = GAINS.get(k.split(".")[0], 2 ** 0.5)
                x = x * (gain / shape[1] ** 0.5)
            else:
                x = x * 0.01
            out[k] = x.contiguous()
        elif k.endswith("weight"):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def _is_norm(net: nn.Module, key: str) -> bool:
    return isinstance(net.get_submodule(key.rsplit(".", 1)[0]), nn.LayerNorm)


def log_prob_entropy(logits: torch.Tensor, action: torch.Tensor):
    """Log-probability of ``action`` and the entropy of the categorical
    distribution of ``logits``."""
    log_probs = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(log_probs, -1, action[..., None].long())[..., 0]
    entropy = -(log_probs.exp() * log_probs).sum(-1)
    return logp, entropy
