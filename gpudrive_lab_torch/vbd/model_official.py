"""The released VBD checkpoint's architecture, layer for layer (port of
``gpudrive_lab_tpu/vbd/model_official.py``; reference:
gpudrive/integrations/vbd/model/modules.py, Encoder :15-78, GoalPredictor
:80-150, Denoiser :155-214, QCMHA :268-360, SelfTransformer :363-388,
FourierEmbedding :390-428, TransformerEncoder :430-466, CrossTransformer
:467-505, TransformerDecoder :506-614, and VBD.py:16-130).

The modules carry the official torch checkpoint's parameter names (the
keys ``gpudrive_lab_tpu/vbd/convert.py::convert_state_dict`` reads, such as
``encoder.agent_encoder.motion.weight_ih_l0``), so a released state dict
loads with ``load_state_dict(strict=True)`` and no key map; the GRU is
``nn.GRU``.

Quirks reproduced (the JAX module's docstring, :13-22):
  * the transformer encoder's mask subtracts 1e9 along the QUERY axis,
    which softmax ignores up to float32 rounding: the self-attention is in
    effect unmasked (JAX :250-256; modules.py:455-460);
  * QCMHA packs its in-projection per head as [q|k|v] triples of
    head_dim, not as [Q|K|V] blocks (JAX :236-238);
  * ``CrossTransformer.norm_1`` has no residual from the query (JAX :327);
  * the decoder's second agent layer takes its keys from the updated stack
    (JAX :451-452);
  * zero input entries stay exactly zero through the local-frame
    transforms (model_utils.py:44,76).

The attention is written out: softmax of q.k plus the relative terms, as
the JAX einsums compute it.  The decoder's per-agent loops of the
reference are batched over a [B, A] lead (the weights are shared across
agents), and the relation sums that the JAX module forms on broadcast
copies are formed by broadcasting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.utils.profiling import span
from gpudrive_lab_torch.vbd.model import (
    DDPMScheduler,
    NoiseSource,
    as_draws,
    roll_out,
    seeded_init_,
)

D_MODEL = 256  # the checkpoint's width, fixed in the reference modules
FFN = 1024


@dataclasses.dataclass(frozen=True)
class OfficialVBDConfig:
    """Mirror of the checkpoint cfg (VBD.py:34-46 and the released
    config)."""

    future_len: int = 80
    agents_len: int = 32
    action_len: int = 5
    diffusion_steps: int = 50
    encoder_layers: int = 6
    hidden_dim: int = 256
    num_heads: int = 8
    action_mean: tuple = (0.0, 0.0)
    action_std: tuple = (1.0, 0.15)

    @property
    def seq_len(self) -> int:
        return self.future_len // self.action_len


def wrap_angle(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


def trajs_to_local_frame(trajs, ref_idx=-1):
    """model_utils.py batch_transform_trajs_to_local_frame."""
    x, y, th = trajs[..., 0], trajs[..., 1], trajs[..., 2]
    vx, vy = trajs[..., 3], trajs[..., 4]
    c = torch.cos(th[:, :, ref_idx, None])
    s = torch.sin(th[:, :, ref_idx, None])
    dx = x - x[:, :, ref_idx, None]
    dy = y - y[:, :, ref_idx, None]
    local = torch.stack([
        dx * c + dy * s,
        -dx * s + dy * c,
        wrap_angle(th - th[:, :, ref_idx, None]),
        vx * c + vy * s,
        -vx * s + vy * c,
    ], dim=-1)
    local = torch.where(trajs[..., :5] == 0, 0.0, local)
    return torch.cat([local, trajs[..., 5:]], dim=-1)


def polylines_to_local_frame(polylines):
    """model_utils.py batch_transform_polylines_to_local_frame."""
    x, y, th = polylines[..., 0], polylines[..., 1], polylines[..., 2]
    c = torch.cos(th[:, :, 0, None])
    s = torch.sin(th[:, :, 0, None])
    dx = x - x[:, :, 0, None]
    dy = y - y[:, :, 0, None]
    local = torch.stack([dx * c + dy * s, -dx * s + dy * c,
                         wrap_angle(th - th[:, :, 0, None])], dim=-1)
    local = torch.where(polylines[..., :3] == 0, 0.0, local)
    return torch.cat([local, polylines[..., 3:]], dim=-1)


def _mlp(a, b, c):
    """Linear, ReLU, Linear: the reference's Sequential (keys .0, .2)."""
    return nn.Sequential(nn.Linear(a, b), nn.ReLU(), nn.Linear(b, c))


def _ffn(d_in, hidden, d_out, act):
    """Linear, act, Dropout, Linear (keys .0, .3); the dropout is the
    identity, as at inference and in the JAX module."""
    return nn.Sequential(nn.Linear(d_in, hidden), act(), nn.Identity(),
                         nn.Linear(hidden, d_out))


class AgentEncoder(nn.Module):
    """modules.py:216-229: GRU(8, 256, 2) + type embedding (padding_idx
    0)."""

    def __init__(self):
        super().__init__()
        self.motion = nn.GRU(8, D_MODEL, 2, batch_first=True)
        self.type_embed = nn.Embedding(4, D_MODEL, padding_idx=0)

    def forward(self, history, atype):  # [B, N, T, 8], [B, N] int
        B, N, T, Fd = history.shape
        out, _ = self.motion(history.reshape(B * N, T, Fd))
        out = out[:, -1].reshape(B, N, D_MODEL)
        return out + self.type_embed(atype.clamp(0, 3).long())


class MapEncoder(nn.Module):
    """modules.py:231-252."""

    def __init__(self):
        super().__init__()
        self.point = _mlp(3, 128, D_MODEL)
        self.traffic_light_embed = nn.Embedding(8, D_MODEL)
        self.type_embed = nn.Embedding(21, D_MODEL)

    def forward(self, polylines):
        pooled = self.point(polylines[..., :3]).amax(dim=-2)
        tl = polylines[:, :, 0, 3].to(torch.int32).clamp(0, 7).long()
        ty = polylines[:, :, 0, 4].to(torch.int32).clamp(0, 20).long()
        return pooled + self.traffic_light_embed(tl) + self.type_embed(ty)


class TrafficLightEncoder(nn.Module):
    """modules.py:254-266."""

    def __init__(self):
        super().__init__()
        self.type_embed = nn.Embedding(8, D_MODEL)

    def forward(self, tl_points):  # [B, TL, 3]
        return self.type_embed(
            tl_points[:, :, 2].to(torch.int32).clamp(0, 7).long())


class FourierEmbedding(nn.Module):
    """modules.py:390-428: per input dimension, [cos, sin, x] of 64 bands
    through its own MLP; the MLPs summed, then LayerNorm, ReLU, Linear.
    One dimension's features are formed at a time (the values of the JAX
    module's all-at-once features, a third of the memory)."""

    def __init__(self, input_dim: int = 3, hidden: int = D_MODEL,
                 bands: int = 64):
        super().__init__()
        self.freqs = nn.Embedding(input_dim, bands)
        self.mlps = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * bands + 1, hidden),
                          nn.LayerNorm(hidden, eps=1e-5), nn.ReLU(),
                          nn.Linear(hidden, hidden))
            for _ in range(input_dim))
        self.to_out = nn.Sequential(nn.LayerNorm(hidden, eps=1e-5),
                                    nn.ReLU(), nn.Linear(hidden, hidden))

    def forward(self, x):  # [..., input_dim]
        out = None
        for i, mlp in enumerate(self.mlps):
            xi = x[..., i, None]
            ang = xi * self.freqs.weight[i] * 2 * math.pi
            h = mlp(torch.cat([torch.cos(ang), torch.sin(ang), xi], dim=-1))
            out = h if out is None else out + h
        return self.to_out(out)


class QCMHA(nn.Module):
    """modules.py:268-360: per-head [q|k|v] packing plus the relative
    position terms in the logits and in the output."""

    def __init__(self, hidden: int = D_MODEL, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.in_proj = nn.Linear(hidden, 3 * hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, query, rel_pos, query_pad_mask=None):
        b, t, D = query.shape
        H = self.heads
        hd = D // H
        q, k, v = self.in_proj(query).reshape(b, t, H, 3 * hd).split(hd, -1)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if rel_pos is not None:
            rel = rel_pos.reshape(b, t, t, H, hd)
            logits = logits + torch.einsum("bqhd,bqkhd->bhqk", q, rel)
        logits = logits / math.sqrt(hd)
        if query_pad_mask is not None:
            # the reference subtracts 1e9 along the QUERY axis, a softmax
            # no-op up to float32 rounding, kept as it computes it
            # (JAX :250-256)
            logits = logits - query_pad_mask[:, None, :, None].to(
                torch.float32) * 1e9
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        if rel_pos is not None:
            out = out + torch.einsum("bhqk,bqkhd->bqhd", attn, rel)
        return self.out_proj(out.reshape(b, t, D))


class SelfTransformer(nn.Module):
    """modules.py:363-388 (post-norm)."""

    def __init__(self):
        super().__init__()
        self.qc_attention = QCMHA()
        self.norm_1 = nn.LayerNorm(D_MODEL, eps=1e-5)
        self.norm_2 = nn.LayerNorm(D_MODEL, eps=1e-5)
        self.ffn = _ffn(D_MODEL, FFN, D_MODEL, nn.GELU)

    def forward(self, x, relations, query_pad_mask=None):
        a = self.norm_1(self.qc_attention(x, relations, query_pad_mask) + x)
        return self.norm_2(self.ffn(a) + a)


class TorchMHA(nn.Module):
    """torch nn.MultiheadAttention's parameters (in_proj as [Q | K | V]
    blocks) in eval mode, over any lead of batch dimensions: q [..., Q, D],
    k and v [..., K, D]; masks True = disallowed, ``key_padding_mask``
    [..., K], ``attn_mask`` [..., Q, K] (both broadcast over the lead)."""

    def __init__(self, hidden: int = D_MODEL, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * hidden))
        self.out_proj = nn.Linear(hidden, hidden)

    def reset_parameters(self, generator):
        bound = 1.0 / math.sqrt(self.in_proj_weight.shape[1])
        self.in_proj_weight.uniform_(-bound, bound, generator=generator)
        self.in_proj_bias.zero_()

    def forward(self, q, k, v, key_padding_mask=None, attn_mask=None):
        w, b = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)
        H = self.heads
        qp = F.linear(q, w[0], b[0]).unflatten(-1, (H, -1))
        kp = F.linear(k, w[1], b[1]).unflatten(-1, (H, -1))
        vp = F.linear(v, w[2], b[2]).unflatten(-1, (H, -1))
        logits = torch.einsum("...qhd,...khd->...hqk", qp, kp) / math.sqrt(
            qp.shape[-1])
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[..., None, None, :],
                                        float("-inf"))
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask[..., None, :, :],
                                        float("-inf"))
        # a row with every key masked would be NaN, as in torch; the
        # reference's masks always leave a key
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("...hqk,...khd->...qhd", attn, vp)
        return self.out_proj(out.flatten(-2))


class CrossTransformer(nn.Module):
    """modules.py:467-505.  NOTE: norm_1 has no residual from the query
    (JAX :327).  The keys are ``key + relations`` (broadcast), or ``key``
    where the caller formed that sum."""

    def __init__(self):
        super().__init__()
        self.cross_attention = TorchMHA()
        self.norm_1 = nn.LayerNorm(D_MODEL, eps=1e-5)
        self.norm_2 = nn.LayerNorm(D_MODEL, eps=1e-5)
        self.ffn = _ffn(D_MODEL, FFN, D_MODEL, nn.GELU)

    def forward(self, query, key, relations=None, key_padding_mask=None,
                attn_mask=None):
        k = key if relations is None else key + relations
        a = self.norm_1(self.cross_attention(
            query, k, k, key_padding_mask=key_padding_mask,
            attn_mask=attn_mask))
        return self.norm_2(self.ffn(a) + a)


class TransformerEncoder(nn.Module):
    """modules.py:430-466: the stack of SelfTransformers."""

    def __init__(self, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(SelfTransformer() for _ in range(layers))

    def forward(self, tokens, relations, pad_mask):
        for layer in self.layers:
            tokens = layer(tokens, relations, pad_mask)
        return tokens


class Encoder(nn.Module):
    """modules.py:15-78."""

    def __init__(self, layers: int = 6):
        super().__init__()
        self.agent_encoder = AgentEncoder()
        self.map_encoder = MapEncoder()
        self.traffic_light_encoder = TrafficLightEncoder()
        self.relation_encoder = FourierEmbedding()
        self.transformer_encoder = TransformerEncoder(layers)

    def forward(self, inputs):
        agents = inputs["agents_history"]
        a_tok = self.agent_encoder(trajs_to_local_frame(agents),
                                   inputs["agents_type"])
        agents_mask = inputs["agents_interested"] == 0
        m_tok = self.map_encoder(polylines_to_local_frame(inputs["polylines"]))
        maps_mask = ~inputs["polylines_valid"]
        tl = inputs["traffic_light_points"]
        t_tok = self.traffic_light_encoder(tl)
        tl_mask = tl.sum(dim=-1) == 0
        relations = self.relation_encoder(inputs["relations"])
        tokens = torch.cat([a_tok, m_tok, t_tok], dim=1)
        pad_mask = torch.cat([agents_mask, maps_mask, tl_mask], dim=-1)
        return {
            "encodings": self.transformer_encoder(tokens, relations,
                                                  pad_mask),
            "relation_encodings": relations,
            "agents_mask": agents_mask,
            "maps_mask": maps_mask,
            "traffic_lights_mask": tl_mask,
            "agents": agents,
            "anchors": inputs.get("anchors"),
        }


def _pad_mask(encoder_outputs):
    return torch.cat([encoder_outputs["agents_mask"],
                      encoder_outputs["maps_mask"],
                      encoder_outputs["traffic_lights_mask"]], dim=-1)


class TransformerDecoder(nn.Module):
    """modules.py:506-614, batched over [B, A]."""

    def __init__(self, config: OfficialVBDConfig):
        super().__init__()
        self.config = config
        T = config.seq_len
        self.encoder = _mlp(5, 128, D_MODEL)
        self.time_embedding = nn.Embedding(T, D_MODEL)
        self.attention_layers = nn.ModuleList(CrossTransformer()
                                              for _ in range(4))
        self.decoder = _ffn(D_MODEL, 128, 2, nn.ELU)
        self._causal = {}

    def causal_mask(self, device) -> torch.Tensor:
        """[A, T, A * T] bool, True = disallowed: agent i's query at step t
        sees all of its own steps and the other agents' steps up to t
        (JAX :384-393); built once per device."""
        device = torch.device(device)
        if device not in self._causal:
            A, T = self.config.agents_len, self.config.seq_len
            i = torch.arange(A, device=device)[:, None, None, None]
            t = torch.arange(T, device=device)[None, :, None, None]
            j = torch.arange(A, device=device)[None, None, :, None]
            s = torch.arange(T, device=device)[None, None, None, :]
            allowed = (i == j) | (s <= t)
            self._causal[device] = ~allowed.reshape(A, T, A * T)
        return self._causal[device]

    def forward(self, noisy_trajs_local, noise_level, encodings, relations,
                pad_mask):
        cfg = self.config
        A, T = cfg.agents_len, cfg.seq_len
        B = noisy_trajs_local.shape[0]
        x = noisy_trajs_local.reshape(B, A, T, cfg.action_len, 5)
        future = self.encoder(x).amax(dim=3)  # [B, A, T, D]
        time_emb = self.time_embedding(
            torch.arange(T, device=x.device))
        query = future + time_emb[None, None] + noise_level[:, :, None, :]
        cmask = self.causal_mask(x.device)
        rel_agents = relations[:, :A, :A, None, :]  # [B, A, A, 1, D]

        def agent_layer(layer, q, q_all):
            # each agent's T queries over every agent's T queries of
            # q_all; key i, j*T + s = q_all[j, s] + relations[i, j]
            k = (q_all[:, None] + rel_agents).reshape(B, A, A * T, D_MODEL)
            return layer(q, k, attn_mask=cmask)

        def scene_layer(layer, q):
            return layer(q, encodings[:, None], relations[:, :A],
                         key_padding_mask=pad_mask[:, None, :])

        l0, l1, l2, l3 = self.attention_layers
        qc = agent_layer(l0, query, query)
        qc = scene_layer(l1, qc)
        qc = qc + query
        # the second agent layer takes its keys from the UPDATED stack
        # (JAX :451-452: the reference rebuilds query_content_stack)
        qc2 = agent_layer(l2, qc, qc)
        qc2 = scene_layer(l3, qc2)
        return self.decoder(qc2)


class Denoiser(nn.Module):
    """modules.py:155-214."""

    def __init__(self, config: OfficialVBDConfig):
        super().__init__()
        self.config = config
        self.noise_level_embedding = nn.Embedding(config.diffusion_steps,
                                                  D_MODEL)
        self.decoder = TransformerDecoder(config)

    def forward(self, encoder_outputs, noisy_actions, diffusion_step):
        cfg = self.config
        A = cfg.agents_len
        noisy_actions = noisy_actions[:, :A]
        current = encoder_outputs["agents"][:, :A, -1]
        noise_level = self.noise_level_embedding(diffusion_step[:, :A].long())
        noisy_states_local = roll_out(
            current[..., :5], noisy_actions, action_len=cfg.action_len,
            global_frame=False)
        return self.decoder(noisy_states_local, noise_level,
                            encoder_outputs["encodings"],
                            encoder_outputs["relation_encodings"],
                            _pad_mask(encoder_outputs))


class GoalPredictor(nn.Module):
    """modules.py:80-150."""

    def __init__(self, config: OfficialVBDConfig):
        super().__init__()
        self.config = config
        self.anchor_encoder = _mlp(2, 128, D_MODEL)
        self.attention_layers = nn.ModuleList(CrossTransformer()
                                              for _ in range(4))
        self.act_decoder = _ffn(D_MODEL, 256, config.seq_len * 2, nn.ELU)
        self.score_decoder = _ffn(D_MODEL, 128, 1, nn.ELU)

    def forward(self, encoder_outputs):
        cfg = self.config
        A = cfg.agents_len
        anchors = self.anchor_encoder(encoder_outputs["anchors"][:, :A])
        encodings = encoder_outputs["encodings"]
        query = encodings[:, :A, None] + anchors  # [B, A, Q, D]
        B, _, Q, _ = query.shape
        pad_mask = _pad_mask(encoder_outputs)[:, None, :]
        rel = encoder_outputs["relation_encodings"][:, :A]

        def scene_layer(layer, q):
            return layer(q, encodings[:, None], rel,
                         key_padding_mask=pad_mask)

        l0, l1, l2, l3 = self.attention_layers
        qc = scene_layer(l1, scene_layer(l0, query))
        qc = qc + query
        qc = scene_layer(l3, scene_layer(l2, qc))
        actions = self.act_decoder(qc).reshape(B, A, Q, cfg.seq_len, 2)
        return actions, self.score_decoder(qc)[..., 0]


class OfficialVBD(nn.Module):
    """Encoder + Denoiser (+ GoalPredictor): VBD.py:16-130.  Weights are
    drawn from ``generator`` (``vbd/model.seeded_init_``; torch's default
    initialisation when None); the module lives on ``device`` (CUDA unless
    the caller names another)."""

    def __init__(self, config: OfficialVBDConfig = OfficialVBDConfig(),
                 with_predictor: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.hidden_dim != D_MODEL:
            raise ValueError(f"the official modules are {D_MODEL} wide")
        self.config = config
        self.with_predictor = with_predictor
        self.encoder = Encoder(config.encoder_layers)
        self.denoiser = Denoiser(config)
        if with_predictor:
            self.predictor = GoalPredictor(config)
        if generator is not None:
            seeded_init_(self, generator)
        self.to(resolve_device(device))

    def encode(self, inputs):
        return self.encoder(inputs)

    def denoise(self, encoder_outputs, noised_actions_normalized,
                diffusion_step):
        """forward_denoiser (VBD.py:158-205): unnormalise -> denoiser ->
        the normalised prediction."""
        x = noised_actions_normalized
        mean = x.new_tensor(self.config.action_mean)
        std = x.new_tensor(self.config.action_std)
        return self.denoiser(encoder_outputs, x * std + mean, diffusion_step)

    def denoise_raw(self, encoder_outputs, noised_actions, diffusion_step):
        """The denoiser on unnormalised actions (the torch
        Denoiser.forward contract)."""
        return self.denoiser(encoder_outputs, noised_actions, diffusion_step)

    def predict_goal(self, encoder_outputs):
        return self.predictor(encoder_outputs)

    def forward(self, inputs, noised_actions_normalized, diffusion_step):
        enc = self.encode(inputs)
        denoised = self.denoise(enc, noised_actions_normalized,
                                diffusion_step)
        if not self.with_predictor:
            return denoised, None, None
        actions, scores = self.predict_goal(enc)
        return denoised, actions, scores


@torch.no_grad()
def sample_official(model: OfficialVBD, scheduler: DDPMScheduler,
                    inputs: dict, config: Optional[OfficialVBDConfig] = None,
                    noise: NoiseSource = None) -> dict:
    """Reverse diffusion with the official weights (reference:
    sim_agent/sim_actor.py:100-160: encode once, then denoiser ->
    scheduler.step over every diffusion step; the denoiser predicts x0 in
    normalised action space).  Draws: x_T, then one noise per step.

    Returns denoised_actions [B, A, T, 2] (unnormalised) and
    denoised_trajs [B, A, future_len, 5] (global frame).  Spans
    ``vbd.encode``, one ``vbd.denoise`` a diffusion step (the denoiser and
    the scheduler step) and ``vbd.rollout``; counts its calls in
    ``sample_official.samples`` and its diffusion steps in
    ``sample_official.denoise_steps``."""
    cfg = config or model.config
    hist = inputs["agents_history"]
    draws = as_draws(noise, hist.device)
    B, A, T = hist.shape[0], cfg.agents_len, cfg.seq_len
    sample_official.samples += 1
    with span("vbd.encode"):
        enc = model.encode(inputs)
    x_t = draws.normal((B, A, T, 2))
    for step in reversed(range(cfg.diffusion_steps)):
        sample_official.denoise_steps += 1
        with span("vbd.denoise"):
            t_arr = torch.full((B, A), step, dtype=torch.long,
                               device=hist.device)
            x0 = model.denoise(enc, x_t, t_arr)
            x_t = scheduler.step(x0, x_t, step, draws)
    with span("vbd.rollout"):
        actions = x_t * x_t.new_tensor(cfg.action_std) + x_t.new_tensor(
            cfg.action_mean)
        trajs = roll_out(enc["agents"][:, :A, -1, :5], actions,
                         action_len=cfg.action_len, global_frame=True)
    return {"denoised_actions": actions, "denoised_trajs": trajs}


sample_official.samples = 0
sample_official.denoise_steps = 0
