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
``LateFusionLSTMPolicy`` is the recurrent variant (the same three embeds,
unfused, then an LSTM cell and the actor and critic heads), the policy of
``ppo/ppo_rnn.py``.

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


def lecun_normal_(w: torch.Tensor, generator) -> None:
    """flax's default Dense kernel init: a normal of variance 1/fan_in
    truncated at two standard deviations (std corrected for the cut)."""
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class LateFusionLSTMPolicy(nn.Module):
    """Recurrent late-fusion actor-critic: the three embeds (ego, and the
    max over partners and over road points), an LSTM cell over their
    concatenation, then the actor logits and the critic value (port of the
    JAX ``LateFusionLSTMPolicy``; reference: the optional use_rnn path of
    the puffer policy, integrations/puffer/ppo.py:59-73,156-163).

    ``forward(obs, carry, done=None) -> (carry, logits, value)``.  The
    carry is ``(c, h)``, flax's order (torch's LSTMCell returns (h, c)),
    float32 [..., lstm_hidden] in both compute dtypes; ``done`` [...]
    multiplies it by ``1 - done`` before the cell.  The cell is flax's
    ``OptimizedLSTMCell``: gates i, f, g, o from ``lstm_i(x)`` (no bias)
    plus ``lstm_h(h)`` (with bias), ``c' = sigmoid(f) c + sigmoid(i)
    tanh(g)``, ``h' = sigmoid(o) tanh(c')``; ``lstm_i`` and ``lstm_h`` hold
    the four gates' kernels side by side in that order.  With the bf16
    dtype the two products and their sum are bf16 (flax's _concat_dense),
    the float32 carry meets the bf16 gates in ``f c`` and ``o tanh(c')``,
    so the new carry is float32.

    ``encode`` (the embeds) does not depend on the carry and ``step`` (the
    cell and the heads) is the rest, so that a replay can embed a whole
    sequence in one pass.  The partner and road blocks are unfused, as in
    the JAX policy: ``fused_embed`` and ``embed_remat`` are refused.
    Weights are drawn from ``generator`` with flax's initializers (Dense
    kernels lecun normal, the recurrent kernels orthogonal per gate, the
    actor orthogonal 0.01 and the critic 1.0, zero biases)."""

    def __init__(self, config: PolicyConfig = PolicyConfig(),
                 lstm_hidden: int = 128, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = config
        if cfg.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, "
                             f"got {cfg.dtype}")
        if cfg.fused_embed or cfg.embed_remat:
            raise ValueError("the LSTM policy embeds unfused, as the JAX "
                             "package's: fused_embed and embed_remat are off")
        self.bf16 = cfg.dtype == torch.bfloat16
        self.config = cfg
        self.lstm_hidden = H = lstm_hidden
        d = cfg.input_dim
        self.ego_embed = _embed(cfg.ego_feat_dim, d, cfg.act_func)
        self.partner_embed = _embed(C.PARTNER_FEAT_DIM, d, cfg.act_func)
        self.road_map_embed = _embed(C.ROAD_GRAPH_FEAT_DIM, d, cfg.act_func)
        self.lstm_i = nn.Linear(3 * d, 4 * H, bias=False)
        self.lstm_h = nn.Linear(H, 4 * H)
        self.actor = nn.Linear(H, cfg.action_dim)
        self.critic = nn.Linear(H, 1)
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, nn.Linear) and m.bias is not None:
                    nn.init.zeros_(m.bias)
                if name in ("actor", "critic"):
                    nn.init.orthogonal_(m.weight, 0.01 if name == "actor"
                                        else 1.0, generator=generator)
                elif name == "lstm_h":
                    for gate in m.weight.split(H):
                        nn.init.orthogonal_(gate, generator=generator)
                elif name == "lstm_i":
                    for gate in m.weight.split(H):
                        lecun_normal_(gate, generator)
                elif isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
        self.to(resolve_device(device))

    def initialize_carry(self, batch_shape) -> tuple:
        """Zero (c, h), float32 [*batch_shape, lstm_hidden]."""
        h = torch.zeros(tuple(batch_shape) + (self.lstm_hidden,),
                        device=self.actor.weight.device)
        return (h, h.clone())

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        """obs [..., obs_dim] -> the embeds side by side [..., 3 * input_dim]
        (bf16 with the bf16 dtype)."""
        cfg = self.config
        e = cfg.ego_feat_dim
        p = (cfg.max_agents - 1) * C.PARTNER_FEAT_DIM
        ego = obs[..., :e]
        partner = obs[..., e:e + p].unflatten(
            -1, (cfg.max_agents - 1, C.PARTNER_FEAT_DIM))
        road = obs[..., e + p:].unflatten(
            -1, (cfg.top_k_roads, C.ROAD_GRAPH_FEAT_DIM))
        if self.bf16:
            return torch.cat([_embed_bf16(self.ego_embed, ego),
                              _embed_max_bf16(self.partner_embed, partner),
                              _embed_max_bf16(self.road_map_embed, road)], -1)
        return torch.cat([self.ego_embed(ego),
                          _embed_max(self.partner_embed, partner),
                          _embed_max(self.road_map_embed, road)], -1)

    def step(self, feats: torch.Tensor, carry: tuple, done=None):
        """The cell and the heads on ``encode``'s output: (carry, logits
        [..., action_dim], value [...]), logits and value float32."""
        c, h = carry
        if done is not None:
            m = (1.0 - done)[..., None]
            c, h = c * m, h * m
        if self.bf16:
            bf = torch.bfloat16
            gates = (_dense_bf16(self.lstm_h, h)
                     + torch.matmul(feats.to(bf), self.lstm_i.weight.t().to(bf)))
        else:
            gates = self.lstm_h(h) + self.lstm_i(feats)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        if self.bf16:
            logits = _dense_bf16(self.actor, h).float()
            value = _dense_bf16(self.critic, h).float()[..., 0]
        else:
            logits = self.actor(h)
            value = self.critic(h)[..., 0]
        return (c, h), logits, value

    def forward(self, obs: torch.Tensor, carry: tuple, done=None):
        return self.step(self.encode(obs), carry, done)


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
