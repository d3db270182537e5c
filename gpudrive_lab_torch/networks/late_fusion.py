"""Late-fusion actor-critic policy (port of
``gpudrive_lab_tpu/networks/late_fusion.py``; reference:
gpudrive/networks/late_fusion.py:69-248).

Per-modality MLP embeddings (ego 6->64, partner 6->64, road 13->64), a max
over entities, a shared Linear 192->128, then actor logits and a critic
value.  Module names are the reference ``NeuralNet``'s state_dict keys
(ego_embed.{0,1,4}, partner_embed, road_map_embed, shared_embed.0, actor,
critic), so ``networks/convert.params_from_flax`` carries flax weights over.

Numerics follow flax rather than torch's defaults: LayerNorm eps is 1e-6
and gelu is the tanh approximation.  With ``fused_embed`` the partner and
road blocks go through kernel K3 forward and kernel K4 backward
(networks/fused_embed.py); with ``embed_remat`` the unfused blocks are
recomputed in the backward pass (``torch.utils.checkpoint``) instead of
keeping their [B, E, 64] activations.  The forward also takes the
pre-split (ego, partner, road) tuple of ``flat_observation(split=True)``.
The LSTM variant is not ported (ROADMAP).

Compute dtype (``PolicyConfig.dtype``): torch.float32, or torch.bfloat16
with flax's semantics for ``dtype=jnp.bfloat16`` (flax 0.12.3), not
``torch.autocast``'s.  Parameters, their gradients and Adam's state stay
float32.  A Dense casts its input, kernel and bias to bf16, multiplies
(bf16 result) and then adds the bias in bf16; a LayerNorm takes float32
statistics (var = E[x^2] - E[x]^2), normalises, scales and shifts in
float32 and casts to bf16; the activation runs on bf16; the fused blocks
run K3 and K4 in their bf16 compute mode and cast the pooled float32 row
to bf16; logits and value are cast to float32 at the end.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.networks.fused_embed import LN_EPS, fused_embed_pool


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    action_dim: int = 91  # 7 accel x 13 steer (reference default)
    input_dim: int = 64
    hidden_dim: int = 128
    act_func: str = "tanh"
    ego_feat_dim: int = C.EGO_FEAT_DIM  # +3 when reward_conditioned
    max_agents: int = C.MAX_AGENTS
    top_k_roads: int = C.MAX_AGENT_MAP_OBS
    # Recompute the unfused partner/road embed+pool in the backward pass
    # instead of storing its [B, E, 64] activations; same gradients.
    embed_remat: bool = False
    # Route the partner/road embed+pool through kernels K3 (forward) and
    # K4 (backward); d/d(obs) is not computed, the obs being data.
    fused_embed: bool = False
    # Compute dtype: torch.float32 or torch.bfloat16 (module docstring).
    dtype: torch.dtype = torch.float32

    @property
    def obs_dim(self) -> int:
        return (
            self.ego_feat_dim
            + (self.max_agents - 1) * C.PARTNER_FEAT_DIM
            + self.top_k_roads * C.ROAD_GRAPH_FEAT_DIM
        )


def _embed(in_dim: int, dim: int, act: str) -> nn.Sequential:
    """Linear(0) -> LayerNorm(1) -> act(2) -> Dropout slot(3) -> Linear(4),
    the reference's Sequential (its dropout is off in evaluation and flax
    has none, so slot 3 is an identity)."""
    return nn.Sequential(
        nn.Linear(in_dim, dim),
        nn.LayerNorm(dim, eps=LN_EPS),
        nn.Tanh() if act == "tanh" else nn.GELU(approximate="tanh"),
        nn.Identity(),
        nn.Linear(dim, dim),
    )


def _dense_bf16(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax Dense(dtype=bfloat16): the bf16 product, then the bias added
    in bf16 (two roundings)."""
    bf = torch.bfloat16
    return torch.matmul(x.to(bf), lin.weight.t().to(bf)) + lin.bias.to(bf)


def _layer_norm_bf16(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm(dtype=bfloat16): float32 statistics with the fast
    variance, (x - mean) * (rsqrt(var + eps) * scale) + bias in float32,
    then cast to bf16."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight
    return ((xf - mu) * mul + ln.bias).to(torch.bfloat16)


def _bf16_value(v: float) -> float:
    return torch.tensor(v, dtype=torch.bfloat16).item()


# jax.nn.gelu's constants as its bf16 arithmetic takes them
_GELU_C = _bf16_value((2.0 / math.pi) ** 0.5)
_GELU_A = _bf16_value(0.044715)


def _act_bf16(act: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The activation on bf16, as flax runs it: tanh, or jax.nn.gelu's
    tanh form op by op in bf16 with its constants rounded to bf16 (not
    torch's gelu, which computes in float32 with the exact constants)."""
    if isinstance(act, nn.Tanh):
        return torch.tanh(x)
    u = _GELU_C * (x + _GELU_A * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(u)))


def _embed_bf16(embed: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    lin1, ln, act, _, lin2 = embed
    return _dense_bf16(
        lin2, _act_bf16(act, _layer_norm_bf16(ln, _dense_bf16(lin1, x))))


def _embed_max(embed: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    return embed(x).max(dim=-2).values


def _embed_max_bf16(embed: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    # amax splits the cotangent evenly among tied maxima, as jnp.max does;
    # ties are common among bf16 values
    return _embed_bf16(embed, x).amax(dim=-2)


class LateFusionPolicy(nn.Module):
    """obs [..., obs_dim] -> (logits [..., action_dim], value [...]).

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; the
    global RNG when None) with the reference's layer init: orthogonal,
    gain sqrt(2) for the embeds and the shared layer, 0.01 for the actor and
    1.0 for the critic, zero biases.  The module lives on ``device`` (CUDA
    unless the caller names another)."""

    def __init__(self, config: PolicyConfig = PolicyConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = config
        if cfg.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, "
                             f"got {cfg.dtype}")
        self.bf16 = cfg.dtype == torch.bfloat16
        self.config = cfg
        d = cfg.input_dim
        self.ego_embed = _embed(cfg.ego_feat_dim, d, cfg.act_func)
        self.partner_embed = _embed(C.PARTNER_FEAT_DIM, d, cfg.act_func)
        self.road_map_embed = _embed(C.ROAD_GRAPH_FEAT_DIM, d, cfg.act_func)
        self.shared_embed = nn.Sequential(nn.Linear(3 * d, cfg.hidden_dim),
                                          nn.Identity())
        self.actor = nn.Linear(cfg.hidden_dim, cfg.action_dim)
        self.critic = nn.Linear(cfg.hidden_dim, 1)
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, nn.Linear):
                    gain = {"actor": 0.01, "critic": 1.0}.get(name, 2 ** 0.5)
                    nn.init.orthogonal_(m.weight, gain, generator=generator)
                    nn.init.zeros_(m.bias)
        self.to(resolve_device(device))

    def _pool(self, embed: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """max over the entity axis of embed(x); x [..., E, F]."""
        if not self.config.fused_embed:
            fn = _embed_max_bf16 if self.bf16 else _embed_max
            if self.config.embed_remat and torch.is_grad_enabled():
                return checkpoint(fn, embed, x, use_reentrant=False)
            return fn(embed, x)
        lin1, ln, _, _, lin2 = embed
        lead = x.shape[:-2]
        pooled = fused_embed_pool(
            x.reshape((-1,) + x.shape[-2:]),
            lin1.weight.t().contiguous(), lin1.bias, ln.weight, ln.bias,
            lin2.weight.t().contiguous(), lin2.bias, self.config.act_func,
            self.config.dtype,
        ).reshape(lead + (lin2.out_features,))
        return pooled.to(torch.bfloat16) if self.bf16 else pooled

    def forward(self, obs):
        """obs [..., obs_dim], or the pre-split tuple (ego [..., E],
        partner [..., 127, 6], road [..., 200, 13]) -> (logits, value)."""
        cfg = self.config
        if isinstance(obs, tuple):
            ego, partner, road = obs
        else:
            e = cfg.ego_feat_dim
            p = (cfg.max_agents - 1) * C.PARTNER_FEAT_DIM
            ego = obs[..., :e]
            partner = obs[..., e:e + p].unflatten(
                -1, (cfg.max_agents - 1, C.PARTNER_FEAT_DIM)
            )
            road = obs[..., e + p:].unflatten(
                -1, (cfg.top_k_roads, C.ROAD_GRAPH_FEAT_DIM)
            )
        lead = ego.shape[:-1]
        feats = torch.cat(
            [
                _embed_bf16(self.ego_embed, ego) if self.bf16
                else self.ego_embed(ego),
                self._pool(self.partner_embed, partner),
                self._pool(self.road_map_embed, road),
            ],
            dim=-1,
        )
        if self.bf16:
            hidden = _dense_bf16(self.shared_embed[0], feats)
            logits = _dense_bf16(self.actor, hidden).float()
            value = _dense_bf16(self.critic, hidden).float()[..., 0]
        else:
            hidden = self.shared_embed(feats)
            logits = self.actor(hidden)
            value = self.critic(hidden)[..., 0]
        return logits.reshape(lead + (cfg.action_dim,)), value


def sample_logits(generator: torch.Generator | None, logits: torch.Tensor,
                  action=None, deterministic: bool = False):
    """Categorical sample, its log-probability and the entropy
    (reference: late_fusion.py sample_logits via pufferlib).  Actions are
    int32; ``generator`` lives on the logits' device."""
    log_probs = torch.log_softmax(logits, dim=-1)
    if action is None:
        if deterministic:
            action = torch.argmax(logits, dim=-1)
        else:
            flat = log_probs.exp().reshape(-1, logits.shape[-1])
            action = torch.multinomial(
                flat, 1, generator=generator
            ).reshape(logits.shape[:-1])
    action = action.to(torch.int32)
    logprob = torch.gather(log_probs, -1, action[..., None].long())[..., 0]
    probs = log_probs.exp()
    entropy = -(probs * log_probs).sum(-1)
    return action, logprob, entropy
