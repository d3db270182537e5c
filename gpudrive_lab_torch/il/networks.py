"""Attention primitives and the behavior-cloning network (port of
``gpudrive_lab_tpu/il/networks.py``; reference: gpudrive/integrations/il/
model/networks.py, rotary multi-head attention :132-289, self/cross
perceiver blocks :584-805, GMM head :807-871, and model.py:10-163
EarlyFusionAttnBCNet).

Per-modality MLP embeddings of frame-stacked features, masked
self-attention within the partner (road-object) and road-graph token sets,
a fusion block over [ego, partners, roads], ego-query cross attention over
each set, and a GMM head (``gmm_components`` diagonal Gaussians over the
action) on the concatenated context.

The attention is written out (product, scale, padded keys set to -1e9,
softmax, product) rather than ``F.scaled_dot_product_attention``: its
weights are recorded for the importance analysis, and a query whose keys
are all padded (an agent with no live partner) gets uniform weights, as in
the JAX package, where a boolean SDPA mask gives NaN.  ``forward(...,
record=True)`` also returns what the JAX model sows: every attention's
weights by module path, the fused ``ego_token`` and ``ro_tokens``, and
``tom_logits`` with ``use_tom``; without it nothing is kept.

Numerics follow flax: LayerNorm eps 1e-6, gelu the tanh approximation,
``log_std`` clipped to [-5, 2] before the variances exp(2 log_std).  Module
names are those ``networks/convert.bc_params_from_flax`` maps flax's tree
onto.  Float32 only: the JAX trainer never sets ``BCConfig.dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.networks.fused_embed import LN_EPS
from gpudrive_lab_torch.networks.late_fusion import lecun_normal_


@dataclasses.dataclass(frozen=True)
class BCConfig:
    """reference: baselines/il/config (network_dim etc.); field for field
    the JAX package's BCConfig."""

    network_dim: int = 128
    num_head: int = 4
    num_fusion_layers: int = 2
    num_modal_layers: int = 1
    gmm_components: int = 6
    action_dim: int = 3
    num_stack: int = 5
    # Theory-of-mind auxiliary head: partner action classes from their
    # fused tokens (reference: model.py:25-31, il.yaml:44-46)
    use_tom: bool = False
    tom_classes: int = 64
    ego_feat: int = C.EGO_FEAT_DIM
    ro_feat: int = C.PARTNER_FEAT_DIM
    rg_feat: int = C.ROAD_GRAPH_FEAT_DIM
    ro_max: int = C.MAX_AGENTS - 1
    rg_max: int = C.MAX_AGENT_MAP_OBS
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32

    @property
    def frame_dim(self) -> int:
        return (self.ego_feat + self.ro_max * self.ro_feat
                + self.rg_max * self.rg_feat)

    @property
    def obs_dim(self) -> int:
        return self.num_stack * self.frame_dim


def rotary_embedding(x: torch.Tensor) -> torch.Tensor:
    """Rotary position encoding over the token axis of x [B, N, D]
    (reference: networks.py:132-190 RotaryEmbedding)."""
    N, D = x.shape[-2:]
    half = D // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = torch.arange(N, dtype=torch.float32,
                          device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class MultiHeadAttention(nn.Module):
    """MHA with rotary embeddings and a key-padding mask (reference:
    networks.py:132-289).  ``path`` names the module in a recording."""

    def __init__(self, num_heads: int, q_dim: int, kv_dim: int,
                 qk_channels: int, v_channels: int, out_channels: int,
                 rotary: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qk_channels = qk_channels
        self.v_channels = v_channels
        self.rotary = rotary
        self.q = nn.Linear(q_dim, qk_channels)
        self.k = nn.Linear(kv_dim, qk_channels)
        self.v = nn.Linear(kv_dim, v_channels)
        self.out = nn.Linear(v_channels, out_channels)
        self.path = ""

    def forward(self, q_in, kv_in, mask: Optional[torch.Tensor] = None,
                rec: Optional[dict] = None):
        """q_in [B, Nq, Dq]; kv_in [B, Nk, Dk]; mask [B, Nk] bool, set for
        padded keys.  Records the weights [B, H, Nq, Nk] in ``rec``."""
        Hh = self.num_heads
        q, k, v = self.q(q_in), self.k(kv_in), self.v(kv_in)
        if self.rotary:
            q, k = rotary_embedding(q), rotary_embedding(k)
        q = q.unflatten(-1, (Hh, self.qk_channels // Hh)).transpose(1, 2)
        k = k.unflatten(-1, (Hh, self.qk_channels // Hh)).transpose(1, 2)
        v = v.unflatten(-1, (Hh, self.v_channels // Hh)).transpose(1, 2)
        scale = (self.qk_channels // Hh) ** -0.5
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale
        if mask is not None:
            logits = torch.where(mask[:, None, None, :],
                                 torch.tensor(-1e9, dtype=logits.dtype,
                                              device=logits.device), logits)
        attn = torch.softmax(logits, dim=-1)
        if rec is not None:
            rec[self.path] = attn
        out = torch.matmul(attn, v).transpose(1, 2).flatten(-2)
        return self.out(out)


class _MLPBlock(nn.Module):
    """Pre-norm attention then pre-norm MLP (4x), residual each."""

    def __init__(self, num_heads: int, dim: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(num_heads, dim, dim, dim, dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x, mask=None, rec=None):
        h = self.ln1(x)
        x = x + self.attn(h, h, mask, rec)
        return x + self.fc2(_gelu(self.fc1(self.ln2(x))))


class SelfAttentionBlock(nn.Module):
    """Pre-norm transformer self-attention stack (reference:
    networks.py:584-700 SelfAttentionBlock)."""

    def __init__(self, num_layers: int, num_heads: int, num_channels: int):
        super().__init__()
        self.layers = nn.ModuleList(
            _MLPBlock(num_heads, num_channels) for _ in range(num_layers))

    def forward(self, x, mask=None, rec=None):
        for layer in self.layers:
            x = layer(x, mask, rec)
        return x


class CrossAttentionLayer(nn.Module):
    """Perceiver-style query cross-attention (reference:
    networks.py:700-805 CrossAttentionLayer)."""

    def __init__(self, num_heads: int, num_channels: int):
        super().__init__()
        D = num_channels
        self.attn = MultiHeadAttention(num_heads, D, D, D, D, D)
        self.ln_q = nn.LayerNorm(D, eps=LN_EPS)
        self.ln_kv = nn.LayerNorm(D, eps=LN_EPS)
        self.ln_mlp = nn.LayerNorm(D, eps=LN_EPS)
        self.fc1 = nn.Linear(D, 4 * D)
        self.fc2 = nn.Linear(4 * D, D)

    def forward(self, q, kv, mask=None, rec=None):
        x = q + self.attn(self.ln_q(q), self.ln_kv(kv), mask, rec)
        return x + self.fc2(_gelu(self.fc1(self.ln_mlp(x))))


class GMMHead(nn.Module):
    """Diagonal-covariance Gaussian-mixture action head (reference:
    networks.py:807-871 GMM, n_components=6)."""

    def __init__(self, config: BCConfig):
        super().__init__()
        cfg = config
        K, A, D = cfg.gmm_components, cfg.action_dim, cfg.network_dim
        self.K, self.A = K, A
        self.hidden = nn.Linear(3 * D, D)
        self.means = nn.Linear(D, K * A)
        self.log_std = nn.Linear(D, K * A)
        self.logits = nn.Linear(D, K)

    def forward(self, context):
        """-> (means [.., K, A], variances [.., K, A], weights [.., K])."""
        h = torch.relu(self.hidden(context))
        means = self.means(h).unflatten(-1, (self.K, self.A))
        log_std = torch.clamp(self.log_std(h).unflatten(-1, (self.K, self.A)),
                              -5.0, 2.0)
        weights = torch.softmax(self.logits(h), dim=-1)
        return means, torch.exp(2.0 * log_std), weights


def _embed(in_dim: int, dim: int) -> nn.Sequential:
    """Linear(0) -> LayerNorm(1) -> gelu(2) -> Dropout slot(3) ->
    Linear(4), the late-fusion embed's layout."""
    return nn.Sequential(nn.Linear(in_dim, dim),
                         nn.LayerNorm(dim, eps=LN_EPS),
                         nn.GELU(approximate="tanh"), nn.Identity(),
                         nn.Linear(dim, dim))


class EarlyFusionAttnBCNet(nn.Module):
    """reference: integrations/il/model/model.py:10-163.  Weights are
    drawn from ``generator`` with flax's initializers (Dense kernels lecun
    normal, zero biases, LayerNorm ones and zeros); the module lives on
    ``device`` (CUDA unless the caller names another)."""

    def __init__(self, config: BCConfig = BCConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = config
        if cfg.dtype != torch.float32:
            raise ValueError("the BC net computes in float32 (the JAX "
                             "trainer never sets BCConfig.dtype)")
        self.config = cfg
        D, ns, Hh = cfg.network_dim, cfg.num_stack, cfg.num_head
        self.ego_embed = _embed(ns * cfg.ego_feat, D)
        self.ro_embed = _embed(ns * cfg.ro_feat, D)
        self.rg_embed = _embed(ns * cfg.rg_feat, D)
        self.ro_block = SelfAttentionBlock(cfg.num_modal_layers, Hh, D)
        self.rg_block = SelfAttentionBlock(cfg.num_modal_layers, Hh, D)
        self.fusion_block = SelfAttentionBlock(cfg.num_fusion_layers, Hh, D)
        self.ego_ro_cross = CrossAttentionLayer(Hh, D)
        self.ego_rg_cross = CrossAttentionLayer(Hh, D)
        self.gmm = GMMHead(cfg)
        if cfg.use_tom:
            self.tom_hidden = nn.Linear(D, D)
            self.tom_out = nn.Linear(D, cfg.tom_classes)
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, MultiHeadAttention):
                    m.path = name
        self.to(resolve_device(device))

    def unpack_obs(self, obs_flat: torch.Tensor):
        """Stacked flat obs [B, num_stack * frame_dim] -> per-modality
        tokens with the frames moved into the features (reference:
        model.py:80-110 _unpack_obs): ego [B, ns*E], ro [B, ro_max,
        ns*6], rg [B, rg_max, ns*13]."""
        cfg = self.config
        ns = cfg.num_stack
        e = cfg.ego_feat
        ro = cfg.ro_feat * cfg.ro_max
        B = obs_flat.shape[0]
        frames = obs_flat.reshape(B, ns, cfg.frame_dim)
        ego = frames[..., :e].reshape(B, ns * e)
        ro_t = (frames[..., e:e + ro].reshape(B, ns, cfg.ro_max, cfg.ro_feat)
                .transpose(1, 2).reshape(B, cfg.ro_max, ns * cfg.ro_feat))
        rg_t = (frames[..., e + ro:].reshape(B, ns, cfg.rg_max, cfg.rg_feat)
                .transpose(1, 2).reshape(B, cfg.rg_max, ns * cfg.rg_feat))
        return ego, ro_t, rg_t

    def forward(self, obs_flat, ro_mask=None, rg_mask=None,
                record: bool = False):
        """obs_flat [B, obs_dim]; ro_mask [B, ro_max] bool of masked-out
        partners; rg_mask [B, rg_max].  Returns (context [B, 3 D], (means,
        variances, weights)), and with ``record`` a third item: {"attn":
        {module path: weights}, "ego_token" [B, D], "ro_tokens" [B, ro_max,
        D], "tom_logits" [B, ro_max, classes] with use_tom}."""
        cfg = self.config
        rec = {} if record else None
        ego, ro, rg = self.unpack_obs(obs_flat)
        ego_e = self.ego_embed(ego)[:, None, :]
        ro_e = self.ro_block(self.ro_embed(ro), ro_mask, rec)
        rg_e = self.rg_block(self.rg_embed(rg), rg_mask, rec)
        fmask = None
        if ro_mask is not None:
            fmask = torch.cat([ro_mask.new_zeros((ro_mask.shape[0], 1)),
                               ro_mask, rg_mask], dim=1)
        fused = self.fusion_block(torch.cat([ego_e, ro_e, rg_e], dim=1),
                                  fmask, rec)
        ego_f = fused[:, :1]
        ro_f = fused[:, 1:1 + cfg.ro_max]
        rg_f = fused[:, 1 + cfg.ro_max:]
        ego_ro = self.ego_ro_cross(ego_f, ro_f, ro_mask, rec)[:, 0]
        ego_rg = self.ego_rg_cross(ego_f, rg_f, rg_mask, rec)[:, 0]
        context = torch.cat([ego_f[:, 0], ego_ro, ego_rg], dim=-1)
        gmm = self.gmm(context)
        if not record:
            return context, gmm
        out = {"attn": rec, "ego_token": ego_f[:, 0], "ro_tokens": ro_f}
        if cfg.use_tom:
            out["tom_logits"] = self.tom_out(torch.relu(
                self.tom_hidden(ro_f)))
        return context, gmm, out


def tom_aux_loss(tom_logits, partner_action_labels, partner_mask):
    """Cross-entropy over the partners not masked out (reference:
    loss.py:7-30 aux_loss, unweighted)."""
    per = F.cross_entropy(tom_logits.flatten(0, -2),
                          partner_action_labels.reshape(-1).long(),
                          reduction="none").reshape(partner_mask.shape)
    keep = (~partner_mask).to(per.dtype)
    return (per * keep).sum() / torch.clamp(keep.sum(), min=1.0)


def gmm_log_prob(actions, means, variances, weights):
    """Mixture log-likelihood with diagonal covariance (reference:
    loss.py:32-50 gmm_loss)."""
    diff = actions[..., None, :] - means
    log_det = torch.log(variances).sum(-1)
    d = means.shape[-1]
    log_probs = -0.5 * ((diff * diff / variances).sum(-1) + log_det
                        + d * math.log(2.0 * math.pi))
    return torch.logsumexp(log_probs + torch.log(weights + 1e-8), dim=-1)


def gmm_sample(generator: torch.Generator | None, means, variances, weights,
               deterministic: bool = False):
    """A draw from the mixture, or the mean of its heaviest component
    (reference: the GMM head's get_action).  The component comes from
    ``weights + 1e-8`` and the Gaussian noise from ``generator`` (on the
    tensors' device)."""
    if deterministic:
        k = torch.argmax(weights, dim=-1)
    else:
        p = (weights + 1e-8).reshape(-1, weights.shape[-1])
        k = torch.multinomial(p, 1, generator=generator).reshape(
            weights.shape[:-1])
    idx = k[..., None, None].expand(k.shape + (1, means.shape[-1]))
    mean = torch.gather(means, -2, idx)[..., 0, :]
    if deterministic:
        return mean
    var = torch.gather(variances, -2, idx)[..., 0, :]
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean + torch.sqrt(var) * noise
