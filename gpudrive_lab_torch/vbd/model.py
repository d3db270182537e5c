"""Versatile Behavior Diffusion, the TPU-first design (port of
``gpudrive_lab_tpu/vbd/model.py``; reference:
gpudrive/integrations/vbd/model/VBD.py:16-694, modules.py:15-360, the
model_utils.py roll_out and the utils.py DDPM sampler).

  * ``Encoder``: a GRU over each agent's history and a PointNet-style
    polyline encoder, fused by self-attention with an additive bias from a
    Fourier embedding of the tokens' relative poses.
  * ``Denoiser``: agent queries over the noised normalised action blocks
    plus a sinusoidal diffusion-step embedding, attending to the agents and
    to the scene; it predicts the denoised actions (x0).
  * ``GoalPredictor``: per-anchor action proposals and scores.
  * ``DDPMScheduler``: the cosine schedule, ``add_noise``, the posterior
    q(x_{t-1} | x_t, x0) and one reverse ``step``.
  * ``roll_out``: accel / yaw-rate unicycle integration of the action
    blocks into (x, y, yaw, vx, vy) trajectories.

Numerics follow flax: LayerNorm eps 1e-6, gelu the tanh approximation,
flax's GRUCell (torch's ``nn.GRU`` with the hidden r and z biases at 0),
``MultiHeadDotProductAttention`` (the query scaled before the product,
masked keys at the compute dtype's minimum).  Module names are those
``vbd/convert.vbd_params_from_flax`` maps flax's tree onto.

Compute dtype (``VBDConfig.dtype``): torch.float32, torch.bfloat16 or
torch.float16, with flax 0.12.3's semantics for the JAX ``VBDConfig.dtype``
(``networks/flax_dtype.py``: Dense, LayerNorm, gelu and softmax in the
compute dtype cd), not ``torch.autocast``'s.  Parameters, their gradients
and the sampling arithmetic (the scheduler, ``x_t``, ``roll_out``) stay
float32.  The flow is flax's, so it is mixed: the GRU's carry is float32
(flax's ``initialize_carry``), its gates cd, its output float32; the map
tokens are cd and the encoder's residual stream float32 (agent tokens promote
the concatenation); the relation layer sums its logits and ``attn @ v``
in float32 over cd operands and adds cd sublayers to the float32 stream;
the denoiser's residual stream is cd, its attention (flax MHA) scales,
masks, normalises and mixes in cd, and only its output is cast to
float32; the goal predictor adds the cd anchor embedding to the float32
agent tokens and casts both heads to float32.  float32 runs the modules'
own float32 ops (``nn.GRU`` and all).  float64 is refused: JAX without
x64 would compute it in float32.

Randomness: every sampler, and ``denoise_loss``, takes its draws through
one argument, ``noise`` (see ``Draws``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.networks.flax_dtype import (
    COMPUTE_DTYPES,
    cd_value,
    dense,
    gelu,
    layer_norm,
    sigmoid,
    softmax,
)

LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


@dataclasses.dataclass(frozen=True)
class VBDConfig:
    future_len: int = 80
    agents_len: int = 32
    action_len: int = 5
    diffusion_steps: int = 10
    encoder_layers: int = 2
    hidden_dim: int = 256
    num_heads: int = 8
    action_mean: tuple = (0.0, 0.0)
    action_std: tuple = (1.0, 0.15)
    dtype: torch.dtype = torch.float32

    @property
    def action_blocks(self) -> int:
        return self.future_len // self.action_len


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------


class Draws:
    """The random draws of a sampler or of ``denoise_loss``, taken in order:
    Gaussian noise (``normal``) and diffusion steps (``randint``).

    ``source`` is a ``torch.Generator`` (draws on its device), a sequence of
    arrays handed out in the order they are asked for (the tests pass the
    arrays jax.random gives the JAX function for the same key), or None: a
    new generator on ``device`` seeded 0."""

    def __init__(self, source=None, device=None):
        self.device = torch.device(device or "cpu")
        self.gen = self.queue = None
        if source is None:
            self.gen = torch.Generator(self.device).manual_seed(0)
        elif isinstance(source, torch.Generator):
            self.gen = source
            self.device = source.device
        else:
            self.queue = iter(source)

    def _given(self, shape, dtype) -> torch.Tensor:
        x = torch.as_tensor(np.array(next(self.queue)), device=self.device)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"given draw of shape {tuple(x.shape)}, "
                             f"{tuple(shape)} asked for")
        return x.to(dtype)

    def normal(self, shape) -> torch.Tensor:
        if self.queue is not None:
            return self._given(shape, torch.float32)
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device)

    def randint(self, low: int, high: int, shape) -> torch.Tensor:
        if self.queue is not None:
            return self._given(shape, torch.long)
        return torch.randint(low, high, tuple(shape), generator=self.gen,
                             device=self.device)


NoiseSource = Union[None, torch.Generator, Sequence, Draws]


def as_draws(noise: NoiseSource, device) -> Draws:
    return noise if isinstance(noise, Draws) else Draws(noise, device)


# ---------------------------------------------------------------------------
# dynamics (reference: model_utils.py roll_out)
# ---------------------------------------------------------------------------


def roll_out(current_states, actions, dt=0.1, action_len=5,
             global_frame=True, generator: Optional[torch.Generator] = None):
    """current_states [..., 5] (x, y, theta, vx, vy); actions
    [..., T_blocks, 2] (accel, yaw_rate) -> trajs [..., T, 5].  With
    ``generator``, the training-time jitter N(0, 0.1) on the speed and
    N(0, 0.01) on the yaw rate (the reference's)."""
    x = current_states[..., 0]
    y = current_states[..., 1]
    theta = current_states[..., 2]
    v = torch.hypot(current_states[..., 3], current_states[..., 4])

    a = torch.repeat_interleave(actions[..., 0], action_len, dim=-1)
    yaw_rate = torch.repeat_interleave(actions[..., 1], action_len, dim=-1)
    if generator is not None:
        v_noise = torch.randn(a.shape, generator=generator,
                              device=a.device) * 0.1
        y_noise = torch.randn(a.shape, generator=generator,
                              device=a.device) * 0.01
    else:
        v_noise = 0.0
        y_noise = 0.0

    v_t = v[..., None] + torch.cumsum(a * dt, dim=-1) + v_noise
    v_t = torch.clamp(v_t, min=0.0)
    yaw_rate = yaw_rate + y_noise
    if global_frame:
        theta_t = theta[..., None] + torch.cumsum(yaw_rate * dt, dim=-1)
    else:
        theta_t = torch.cumsum(yaw_rate * dt, dim=-1)
    vx = v_t * torch.cos(theta_t)
    vy = v_t * torch.sin(theta_t)
    if global_frame:
        xs = x[..., None] + torch.cumsum(vx * dt, dim=-1)
        ys = y[..., None] + torch.cumsum(vy * dt, dim=-1)
    else:
        xs = torch.cumsum(vx * dt, dim=-1)
        ys = torch.cumsum(vy * dt, dim=-1)
    return torch.stack([xs, ys, theta_t, vx, vy], dim=-1)


def inverse_roll_out(trajs, current_states, dt=0.1, action_len=5):
    """Trajectories -> mean accel / yaw rate per action block (the inverse
    used to diffuse ground-truth futures)."""
    theta = torch.cat([current_states[..., 2:3], trajs[..., 2]], dim=-1)
    v = torch.cat(
        [torch.hypot(current_states[..., 3], current_states[..., 4])[..., None],
         torch.hypot(trajs[..., 3], trajs[..., 4])],
        dim=-1,
    )
    a = torch.diff(v, dim=-1) / dt
    yr = torch.diff(theta, dim=-1) / dt
    blocks = a.shape[-1] // action_len
    a = a.unflatten(-1, (blocks, action_len)).mean(-1)
    yr = yr.unflatten(-1, (blocks, action_len)).mean(-1)
    return torch.stack([a, yr], dim=-1)


# ---------------------------------------------------------------------------
# diffusion schedule (reference: utils.py DDPM_Sampler, cosine schedule)
# ---------------------------------------------------------------------------


def _expand_to(x: torch.Tensor, ndim: int) -> torch.Tensor:
    while x.dim() < ndim:
        x = x[..., None]
    return x


class DDPMScheduler:
    """The schedule is computed in float64 with numpy and kept in float32,
    as the JAX scheduler keeps it; its tensors are copied to each device
    once."""

    def __init__(self, steps: int = 10, clamp_val: float = 5.0):
        self.steps = steps
        s = 0.008
        t = np.linspace(0, steps, steps + 1) / steps
        alpha_bar = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
        betas = np.clip(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)
        self.betas = torch.tensor(betas, dtype=torch.float32)
        self.alphas = 1.0 - self.betas
        self.alpha_bars = torch.tensor(np.cumprod(1 - betas),
                                       dtype=torch.float32)
        self.clamp_val = clamp_val
        self._on = {}

    def _tables(self, device):
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = (self.betas.to(device),
                                self.alpha_bars.to(device))
        return self._on[device]

    def add_noise(self, x0, noise, t):
        """q(x_t | x_0); ``t`` an int tensor broadcastable from the left."""
        _, ab = self._tables(x0.device)
        ab = _expand_to(ab[torch.as_tensor(t, device=x0.device)], x0.dim())
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise

    def posterior_mean_std(self, x0_pred, x_t, t):
        """Mean and std of q(x_{t-1} | x_t, x0) (the reference scheduler's
        q_mean / q_variance, used by CTG guidance in sim_actor.py:125-140);
        ``t`` an int or an int tensor [B, A]."""
        betas, abars = self._tables(x_t.device)
        x0_pred = torch.clamp(x0_pred, -self.clamp_val, self.clamp_val)
        t = torch.as_tensor(t, device=x_t.device)
        ab_t = abars[t]
        ab_prev = torch.where(t > 0, abars[torch.clamp(t - 1, min=0)],
                              torch.ones_like(ab_t))
        beta_t = betas[t]
        ab_t, ab_prev, beta_t = (_expand_to(v, x_t.dim())
                                 for v in (ab_t, ab_prev, beta_t))
        coef_x0 = torch.sqrt(ab_prev) * beta_t / (1.0 - ab_t)
        coef_xt = torch.sqrt(1.0 - beta_t) * (1.0 - ab_prev) / (1.0 - ab_t)
        mean = coef_x0 * x0_pred + coef_xt * x_t
        var = beta_t * (1.0 - ab_prev) / (1.0 - ab_t)
        return mean, torch.sqrt(var)

    def step(self, x0_pred, x_t, t, noise: NoiseSource):
        """One reverse step from the predicted x0 (the posterior
        q(x_{t-1} | x_t, x0)).  It draws its noise from ``noise`` at every
        t, the last step (t = 0) too, as the JAX scheduler does."""
        mean, std = self.posterior_mean_std(x0_pred, x_t, t)
        eps = as_draws(noise, x_t.device).normal(x_t.shape)
        t_b = _expand_to(torch.as_tensor(t, device=x_t.device), x_t.dim())
        return torch.where(t_b > 0, mean + std * eps, mean)

    def std_at(self, step: int) -> torch.Tensor:
        """The posterior std of q(x_{t-1} | x_t, x0) at diffusion step
        ``step``, the same for every element (reference:
        noise_scheduler.q_variance); 0 at step 0."""
        if step <= 0:
            return torch.tensor(0.0)
        return torch.sqrt(self.betas[step] * (1.0 - self.alpha_bars[step - 1])
                          / (1.0 - self.alpha_bars[step]))


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------


def seeded_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` from ``generator`` (a CPU
    generator), with torch's default schemes: Linear weight and bias
    U(+-1/sqrt(fan_in)), GRU U(+-1/sqrt(hidden)), Embedding N(0, 1) with
    its padding row zero, LayerNorm ones and zeros; a module's own other
    parameters through its ``reset_parameters(generator)``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.GRU):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(generator=generator)
                if m.padding_idx is not None:
                    m.weight[m.padding_idx] = 0.0
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif hasattr(m, "reset_parameters") and any(
                    True for _ in m.parameters(recurse=False)):
                m.reset_parameters(generator)


def check_dtype(dtype) -> None:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"VBD computes in torch.float32, torch.bfloat16 or torch.float16;"
            f" got {dtype}")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class FourierEmbedding(nn.Module):
    """reference: modules.py:21 FourierEmbedding; features
    [sin(2 pi x f), cos(2 pi x f)] per input dimension, then x."""

    def __init__(self, in_dim: int, out_dim: int, num_bands: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cd = dtype
        self.freqs = nn.Parameter(torch.empty(in_dim, num_bands))
        self.dense = nn.Linear(in_dim * (2 * num_bands + 1), out_dim)

    def reset_parameters(self, generator):
        self.freqs.normal_(generator=generator)

    def forward(self, x):
        ang = 2 * math.pi * x[..., None] * self.freqs
        feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return dense(self.dense, torch.cat([feats.flatten(-2), x], dim=-1),
                     self.cd)


class AgentEncoder(nn.Module):
    """GRU over per-agent history (reference: modules.py:216-229); its
    output is float32 in every compute dtype."""

    def __init__(self, hidden: int, features: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.cd = dtype
        self.gru = nn.GRU(features, hidden, batch_first=True)

    def forward(self, history):  # [B, N, H, 8]
        B, N, H, Fd = history.shape
        x = history.reshape(B * N, H, Fd)
        if self.cd == torch.float32:
            out, _ = self.gru(x)
            return out[:, -1].reshape(B, N, self.hidden)
        return self._flax_cells(x).reshape(B, N, self.hidden)

    def _flax_cells(self, x):
        """flax's ``nn.RNN(GRUCell(dtype=cd))`` over the steps of x
        [M, H, F]: every gate Dense in cd (the input products of all steps
        at once), the carry float32 from zero, so ``(1 - z) n + z h``
        promotes to float32; the last carry [M, hidden]."""
        cd, g = self.cd, self.gru
        gi = (torch.matmul(x.to(cd), g.weight_ih_l0.t().to(cd))
              + g.bias_ih_l0.to(cd))
        w_hh, b_hh = g.weight_hh_l0.t().to(cd), g.bias_hh_l0.to(cd)
        h = x.new_zeros((x.shape[0], self.hidden))
        for t in range(x.shape[1]):
            i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
            # flax's hr and hz have no bias: torch's hidden r and z biases
            # (0 when converted from flax) add to the cd product exactly
            h_r, h_z, h_n = (torch.matmul(h.to(cd), w_hh) + b_hh).chunk(
                3, dim=-1)
            r = sigmoid(i_r + h_r, cd)
            z = sigmoid(i_z + h_z, cd)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
        return h


class MapEncoder(nn.Module):
    """Point MLP + max-pool per polyline + a lane-type embedding
    (reference: modules.py:231-252)."""

    def __init__(self, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cd = dtype
        self.point0 = nn.Linear(3, 128)
        self.point1 = nn.Linear(128, hidden)
        self.type_embed = nn.Embedding(32, hidden)

    def forward(self, polylines):  # [B, P, K, 5]
        cd = self.cd
        h = dense(self.point1, F.relu(dense(self.point0, polylines[..., :3],
                                            cd)), cd)
        pooled = h.amax(dim=-2)
        ptype = polylines[..., 0, 4].to(torch.int32).clamp(0, 31)
        # flax's Embed(dtype=cd) looks the row up in the table cast to cd
        return pooled + F.embedding(ptype.long(),
                                    self.type_embed.weight.to(cd))


def _heads(z: torch.Tensor, heads: int) -> torch.Tensor:
    return z.unflatten(-1, (heads, z.shape[-1] // heads))


class RelationAttentionLayer(nn.Module):
    """Pre-norm self-attention with an additive relative-pose bias, then a
    pre-norm 4x MLP; the stand-in for the reference's QCMHA
    (modules.py:268-360)."""

    def __init__(self, hidden: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.cd = dtype
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.out = nn.Linear(hidden, hidden)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.fc1 = nn.Linear(hidden, 4 * hidden)
        self.fc2 = nn.Linear(4 * hidden, hidden)

    def forward(self, tokens, rel_emb, pad_mask):
        """tokens [B, T, D]; rel_emb [B, T, T, heads]; pad_mask [B, T]
        (True = padding, masked out of the keys).  The logits and
        ``attn @ v`` are float32 over cd operands (flax's
        preferred_element_type), the softmax float32; the cd sublayers add
        to the float32 tokens."""
        cd = self.cd
        q, k, v = (_heads(z, self.heads) for z in dense(
            self.qkv, layer_norm(self.ln1, tokens, cd), cd).chunk(3, dim=-1))
        logits = (torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                  / math.sqrt(q.shape[-1]))
        logits = logits + rel_emb.permute(0, 3, 1, 2)
        logits = logits.masked_fill(pad_mask[:, None, None, :], -1e9)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v.float()).flatten(-2)
        tokens = tokens + dense(self.out, out, cd)
        h = gelu(dense(self.fc1, layer_norm(self.ln2, tokens, cd), cd), cd)
        return tokens + dense(self.fc2, h, cd)


class Encoder(nn.Module):
    """Scene encoder (reference: modules.py:15-78)."""

    def __init__(self, config: VBDConfig):
        super().__init__()
        D, cd = config.hidden_dim, config.dtype
        self.agent = AgentEncoder(D, dtype=cd)
        self.map = MapEncoder(D, dtype=cd)
        self.relation = FourierEmbedding(3, config.num_heads, dtype=cd)
        self.layers = nn.ModuleList(
            RelationAttentionLayer(D, config.num_heads, dtype=cd)
            for _ in range(config.encoder_layers))

    def forward(self, agents_history, polylines, agents_valid, maps_valid):
        """``agents_valid`` / ``maps_valid``: True = real token.  The pad
        mask (True = padding) drives the attention layers; the returned
        ``valid_mask`` keeps True = real for the consumers.  The tokens
        are float32: the float32 agent tokens promote the cd map tokens."""
        tokens = torch.cat([self.agent(agents_history),
                            self.map(polylines).float()], dim=1)
        valid_mask = torch.cat([agents_valid, maps_valid], dim=1)
        pad_mask = ~valid_mask
        # relative positions between the tokens' anchor points
        pos = torch.cat([agents_history[:, :, -1, 0:2],
                         polylines[:, :, 0, 0:2]], dim=1)
        yaw = torch.cat([agents_history[:, :, -1, 2:3],
                         polylines[:, :, 0, 2:3]], dim=1)
        rel = torch.cat([pos[:, None, :, :] - pos[:, :, None, :],
                         yaw[:, None, :, :] - yaw[:, :, None, :]], dim=-1)
        rel_emb = self.relation(rel / 100.0)
        for layer in self.layers:
            tokens = layer(tokens, rel_emb, pad_mask)
        return tokens, valid_mask


def diffusion_step_embedding(t, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class FlaxMHA(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(dtype=cd)`` (qkv and output
    width = the input width), all in cd: the query divided by sqrt(head_dim)
    (rounded to cd) before the product, keys where ``mask`` is False set to
    cd's minimum (a query with every key masked attends uniformly, as in
    flax), the softmax in cd (flax's force_fp32_for_softmax is off)."""

    def __init__(self, hidden: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.cd = dtype
        d = math.sqrt(hidden // heads)
        self.scale = d if dtype == torch.float32 else cd_value(d, dtype)
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x_q, x_kv, mask):
        """x_q [B, Q, D]; x_kv [B, K, D]; mask [B, K] bool, True = attend."""
        cd = self.cd
        q = _heads(dense(self.query, x_q, cd), self.heads)
        k = _heads(dense(self.key, x_kv, cd), self.heads)
        v = _heads(dense(self.value, x_kv, cd), self.heads)
        q = q / self.scale
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = logits.masked_fill(~mask[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
        attn = softmax(logits, cd)
        return dense(self.out, torch.einsum("bhqk,bkhd->bqhd", attn,
                                            v).flatten(-2), cd)


class DenoiserBlock(nn.Module):
    """Agent self-attention, cross-attention over the scene and a 4x MLP,
    each pre-norm with a residual."""

    def __init__(self, hidden: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cd = dtype
        self.ln_self = nn.LayerNorm(hidden, eps=LN_EPS)
        self.self_attn = FlaxMHA(hidden, heads, dtype)
        self.ln_cross = nn.LayerNorm(hidden, eps=LN_EPS)
        self.cross_attn = FlaxMHA(hidden, heads, dtype)
        self.ln_ffn = nn.LayerNorm(hidden, eps=LN_EPS)
        self.fc1 = nn.Linear(hidden, 4 * hidden)
        self.fc2 = nn.Linear(4 * hidden, hidden)

    def forward(self, h, scene_tokens, scene_valid, agent_valid):
        cd = self.cd
        x = layer_norm(self.ln_self, h, cd)
        h = h + self.self_attn(x, x, agent_valid)
        h = h + self.cross_attn(layer_norm(self.ln_cross, h, cd),
                                scene_tokens, scene_valid)
        x = dense(self.fc1, layer_norm(self.ln_ffn, h, cd), cd)
        return h + dense(self.fc2, gelu(x, cd), cd)


class Denoiser(nn.Module):
    """reference: modules.py:156-214."""

    def __init__(self, config: VBDConfig):
        super().__init__()
        D = config.hidden_dim
        self.config = config
        self.action_in = nn.Linear(config.action_blocks * 2, D)
        self.step_in = nn.Linear(D, D)
        self.blocks = nn.ModuleList(
            DenoiserBlock(D, config.num_heads, config.dtype)
            for _ in range(2))
        self.out_ln = nn.LayerNorm(D, eps=LN_EPS)
        self.out = nn.Linear(D, config.action_blocks * 2)

    def forward(self, scene_tokens, scene_valid, noisy_actions,
                diffusion_step):
        """``scene_valid``: True = real token.  The residual stream is
        cd; the output is float32."""
        cd = self.config.dtype
        B, A = noisy_actions.shape[:2]
        h = dense(self.action_in, noisy_actions.reshape(B, A, -1), cd)
        h = h + dense(self.step_in, diffusion_step_embedding(
            diffusion_step, self.config.hidden_dim), cd)
        agent_valid = scene_valid[:, :A]
        for block in self.blocks:
            h = block(h, scene_tokens, scene_valid, agent_valid)
        out = dense(self.out, layer_norm(self.out_ln, h, cd), cd)
        return out.reshape(B, A, self.config.action_blocks, 2).float()


class GoalPredictor(nn.Module):
    """reference: modules.py:80-154."""

    def __init__(self, config: VBDConfig):
        super().__init__()
        D = config.hidden_dim
        self.config = config
        self.anchor0 = nn.Linear(2, 128)
        self.anchor1 = nn.Linear(128, D)
        self.ln = nn.LayerNorm(D, eps=LN_EPS)
        self.attn = FlaxMHA(D, config.num_heads, config.dtype)
        self.actions = nn.Linear(D, config.action_blocks * 2)
        self.score = nn.Linear(D, 1)

    def forward(self, scene_tokens, scene_valid, anchors):
        """The cd anchor embedding plus the float32 agent tokens is
        float32; both heads are cast to float32."""
        B, A, Q, _ = anchors.shape
        D, cd = self.config.hidden_dim, self.config.dtype
        a_emb = dense(self.anchor1, F.relu(dense(self.anchor0, anchors, cd)),
                      cd)
        h = a_emb + scene_tokens[:, :A][:, :, None, :]
        attn = self.attn(layer_norm(self.ln, h.reshape(B, A * Q, D), cd),
                         scene_tokens, scene_valid)
        h = (h.reshape(B, A * Q, D) + attn).reshape(B, A, Q, D)
        actions = dense(self.actions, h, cd).reshape(
            B, A, Q, self.config.action_blocks, 2)
        return actions.float(), dense(self.score, F.elu(h), cd)[..., 0].float()


class VBDModel(nn.Module):
    """Encoder + denoiser + goal predictor (reference: VBD.py:16-130).
    Weights are drawn from ``generator`` (``seeded_init_``; torch's
    default initialisation from the global generator when None); the
    module lives on ``device`` (CUDA unless the caller names another)."""

    def __init__(self, config: VBDConfig = VBDConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_dtype(config.dtype)
        self.config = config
        self.encoder = Encoder(config)
        self.denoiser = Denoiser(config)
        self.predictor = GoalPredictor(config)
        if generator is not None:
            seeded_init_(self, generator)
        self.to(resolve_device(device))

    def encode(self, batch):
        agents_valid = batch["agents_id"] >= 0
        maps_valid = (batch["polylines"][..., 4] > 0).any(dim=-1)
        return self.encoder(batch["agents_history"], batch["polylines"],
                            agents_valid, maps_valid)

    def forward(self, batch, noised_actions_normalized, diffusion_step):
        tokens, mask = self.encode(batch)
        denoised = self.denoiser(tokens, mask, noised_actions_normalized,
                                 diffusion_step)
        anchors = batch.get("anchors")
        if anchors is None:
            return denoised, None, None
        goal_actions, goal_scores = self.predictor(tokens, mask, anchors)
        return denoised, goal_actions, goal_scores


# ---------------------------------------------------------------------------
# training and sampling
# ---------------------------------------------------------------------------


def normalize_actions(actions, config):
    mean = actions.new_tensor(config.action_mean)
    std = actions.new_tensor(config.action_std)
    return (actions - mean) / std


def unnormalize_actions(actions, config):
    mean = actions.new_tensor(config.action_mean)
    std = actions.new_tensor(config.action_std)
    return actions * std + mean


def current_states(batch: dict, agents_len: int) -> torch.Tensor:
    """(x, y, yaw, vx, vy) of the first ``agents_len`` agents at the last
    history frame."""
    return batch["agents_history"][:, :agents_len, -1, :5]


def denoise_loss(model: VBDModel, scheduler: DDPMScheduler, batch: dict,
                 gt_actions: torch.Tensor, config: VBDConfig,
                 noise: NoiseSource = None) -> torch.Tensor:
    """Draw a diffusion step per agent, noise the normalised ground-truth
    actions, predict x0, smooth-L1 on the actions over the interested
    agents (reference: VBD.py:434-482).  Draws, in order: the steps
    [B, A], then the noise."""
    draws = as_draws(noise, gt_actions.device)
    B, A = gt_actions.shape[:2]
    t = draws.randint(0, scheduler.steps, (B, A))
    x0 = normalize_actions(gt_actions, config)
    x_t = scheduler.add_noise(x0, draws.normal(x0.shape), t)
    denoised, _, _ = model(batch, x_t, t)
    diff = torch.abs(denoised - x0)
    loss = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    m = (batch["agents_interested"] > 0).to(torch.float32)[..., None, None]
    return (loss * m).sum() / torch.clamp(
        m.sum() * loss.shape[-1] * loss.shape[-2], min=1.0)


@torch.no_grad()
def sample_denoiser(model: VBDModel, scheduler: DDPMScheduler, batch: dict,
                    config: VBDConfig, noise: NoiseSource = None) -> dict:
    """Reverse diffusion from pure noise; returns denoised_actions
    [B, A, blocks, 2] and denoised_trajs [B, A, future_len, 5]
    (reference: sim_agent/sim_actor.py sample_denoiser).  Draws: x_T, then
    one noise per step."""
    hist = batch["agents_history"]
    draws = as_draws(noise, hist.device)
    B, A = hist.shape[0], config.agents_len
    x_t = draws.normal((B, A, config.action_blocks, 2))
    for step in reversed(range(scheduler.steps)):
        t = torch.full((B, A), step, dtype=torch.long, device=hist.device)
        denoised, _, _ = model(batch, x_t, t)
        x_t = scheduler.step(denoised, x_t, t, draws)
    actions = unnormalize_actions(x_t, config)
    trajs = roll_out(current_states(batch, A), actions,
                     action_len=config.action_len, global_frame=True)
    return {"denoised_actions": actions, "denoised_trajs": trajs}
