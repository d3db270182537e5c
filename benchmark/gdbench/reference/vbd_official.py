"""A plain reference of VBD's diffusion sim agents at the released
checkpoint's architecture: the model, its sampler and the env's use of the
sampled trajectories, in float32 PyTorch with no kernel, cache or batching
trick of the port.

Source: Huang et al., Versatile Behavior Diffusion for Generalized Traffic
Agent Simulation, arXiv:2404.02524, and its code (SafeRoboticsLab/VBD,
vbd/model/modules.py and VBD.py, as GPUDrive's integrations/vbd runs it):

  * the encoder: an agent GRU (8 -> 256, 2 layers) over 11 history steps,
    the map's point MLP max-pooled over each polyline's points, the
    traffic lights' type embedding, the Fourier relation embedding of every
    token pair (per input dimension [cos, sin, x] of 64 bands through its
    own MLP, the three summed), and 6 query-centric attention layers
    (QCMHA) with the relations in their logits and values;
  * the denoiser: the noisy actions rolled out in each agent's frame,
    embedded per action block of 5 steps, then per agent as the official
    code loops over them: causal attention over every agent's blocks,
    cross-attention into the scene encoding, twice, and a decoder head;
  * ``DDPMScheduler.step``, the posterior of a cosine schedule;
  * ``roll_out``, the unicycle integration of (acceleration, yaw rate);
  * the sample (encode once, then the denoiser and the scheduler step at
    each diffusion step; the goal predictor is not called), the scatter to
    the sim's agent rows, the egocentric 455-float VBD observation block
    and the ``distance_to_vdb_trajs`` reward bonus;
  * the pairwise token relations the encoder takes (data_utils.py
    calculate_relations), world by world.

It is written in the official code's unbatched form: the decoder's loop
over agents, the relation sums k + r and v + r formed as written, and each
attention written out as softmax(q (k + r)^T / sqrt(d)) (v + r).  The
module names are the checkpoint's parameter names, so the port's state
dict loads with ``load_state_dict(strict=True)``.

Departures from the paper that the released code makes, reproduced here:
  1. the encoder's padding mask subtracts 1e9 along the QUERY axis, which a
     softmax over the keys ignores up to rounding: the encoder's attention
     is in effect unmasked;
  2. QCMHA packs its in-projection per head as [q|k|v] triples of the head
     width, not as [Q|K|V] blocks;
  3. the cross-attention block's first LayerNorm has no residual from the
     query;
  4. the decoder's second agent-attention block takes its keys from the
     updated queries, not from the first block's input;
  5. entries that are exactly zero stay zero through the local-frame
     transforms (padding stays padding);
  6. the scheduler draws a noise at every step, the last one (t = 0)
     included, where the posterior is its mean alone.

Imports torch, numpy and the standard library only.  ``tf32 = True`` (on
the model, ``set_tf32``) rounds both operands of every product to TF32
(10 bits of mantissa, to nearest) before a float32 product: the arithmetic
of TF32 tensor cores, on any device, for a control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the reference's float32 products stay float32 on a CUDA card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

D = 256  # the checkpoint's width
HEADS = 8
FFN_WIDTH = 1024
TRAJECTORY_LEN = 91  # the sim's logged steps
FEATURES = 5  # x, y, yaw, vel_x, vel_y


class Config:
    """The released checkpoint's configuration (VBD.py:34-46)."""

    def __init__(self, future_len=80, agents_len=32, action_len=5,
                 diffusion_steps=50, encoder_layers=6,
                 action_mean=(0.0, 0.0), action_std=(1.0, 0.15)):
        self.future_len = future_len
        self.agents_len = agents_len
        self.action_len = action_len
        self.diffusion_steps = diffusion_steps
        self.encoder_layers = encoder_layers
        self.action_mean = tuple(action_mean)
        self.action_std = tuple(action_std)
        self.seq_len = future_len // action_len


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest, ties
    away from zero (the tensor cores' conversion)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Part(nn.Module):
    """A module of the reference: its products go through ``linear`` and
    ``product``, which round their operands to TF32 where ``tf32`` is
    set."""

    tf32 = False

    def _r(self, x):
        return round_tf32(x) if self.tf32 and x.dtype == torch.float32 else x

    def linear(self, layer: nn.Linear, x):
        return F.linear(self._r(x), self._r(layer.weight), layer.bias)

    def product(self, equation: str, a, b):
        return torch.einsum(equation, self._r(a), self._r(b))


def wrap_angle(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


def trajs_to_local_frame(trajs):
    """Each agent's history in the frame of its last step
    (model_utils.py batch_transform_trajs_to_local_frame)."""
    x, y, th = trajs[..., 0], trajs[..., 1], trajs[..., 2]
    vx, vy = trajs[..., 3], trajs[..., 4]
    x0, y0, th0 = x[..., -1:], y[..., -1:], th[..., -1:]
    c, s = torch.cos(th0), torch.sin(th0)
    local = torch.stack([(x - x0) * c + (y - y0) * s,
                         -(x - x0) * s + (y - y0) * c,
                         wrap_angle(th - th0),
                         vx * c + vy * s,
                         -vx * s + vy * c], dim=-1)
    local = torch.where(trajs[..., :5] == 0, torch.zeros_like(local), local)
    return torch.cat([local, trajs[..., 5:]], dim=-1)


def polylines_to_local_frame(polylines):
    """Each polyline in the frame of its first point
    (model_utils.py batch_transform_polylines_to_local_frame)."""
    x, y, th = polylines[..., 0], polylines[..., 1], polylines[..., 2]
    x0, y0, th0 = x[..., :1], y[..., :1], th[..., :1]
    c, s = torch.cos(th0), torch.sin(th0)
    local = torch.stack([(x - x0) * c + (y - y0) * s,
                         -(x - x0) * s + (y - y0) * c,
                         wrap_angle(th - th0)], dim=-1)
    local = torch.where(polylines[..., :3] == 0, torch.zeros_like(local),
                        local)
    return torch.cat([local, polylines[..., 3:]], dim=-1)


class GRU(Part):
    """torch's GRU (batch first, h0 = 0), its gate equations written out:
    r = s(W_ir x + b_ir + W_hr h + b_hr), z = s(W_iz x + b_iz + W_hz h +
    b_hz), n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h' = (1 - z) n +
    z h; the gates stacked [r | z | n] in each weight, as torch stores
    them."""

    def __init__(self, d_in: int, hidden: int, layers: int):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        for i in range(layers):
            width = d_in if i == 0 else hidden
            self.register_parameter(f"weight_ih_l{i}", nn.Parameter(
                torch.empty(3 * hidden, width)))
            self.register_parameter(f"weight_hh_l{i}", nn.Parameter(
                torch.empty(3 * hidden, hidden)))
            self.register_parameter(f"bias_ih_l{i}", nn.Parameter(
                torch.empty(3 * hidden)))
            self.register_parameter(f"bias_hh_l{i}", nn.Parameter(
                torch.empty(3 * hidden)))

    def _mm(self, x, w, b):
        return F.linear(self._r(x), self._r(w), b)

    def forward(self, x):  # [N, T, F] -> [N, T, hidden]
        for i in range(self.layers):
            w_ih, w_hh = (getattr(self, f"weight_ih_l{i}"),
                          getattr(self, f"weight_hh_l{i}"))
            b_ih, b_hh = (getattr(self, f"bias_ih_l{i}"),
                          getattr(self, f"bias_hh_l{i}"))
            h = x.new_zeros((x.shape[0], self.hidden))
            outs = []
            for t in range(x.shape[1]):
                gi = self._mm(x[:, t], w_ih, b_ih)
                gh = self._mm(h, w_hh, b_hh)
                i_r, i_z, i_n = gi.chunk(3, dim=-1)
                h_r, h_z, h_n = gh.chunk(3, dim=-1)
                r = torch.sigmoid(i_r + h_r)
                z = torch.sigmoid(i_z + h_z)
                n = torch.tanh(i_n + r * h_n)
                h = (1 - z) * n + z * h
                outs.append(h)
            x = torch.stack(outs, dim=1)
        return x


class AgentEncoder(Part):
    """modules.py AgentEncoder: the GRU's last output plus the agent type's
    embedding (row 0, padding, is zero in the checkpoint)."""

    def __init__(self):
        super().__init__()
        self.motion = GRU(8, D, 2)
        self.type_embed = nn.Embedding(4, D)

    def forward(self, history, atype):  # [B, N, T, 8], [B, N]
        B, N = history.shape[:2]
        out = self.motion(history.reshape((B * N,) + history.shape[2:]))
        return out[:, -1].reshape(B, N, D) + self.type_embed.weight[
            atype.long().clamp(0, 3)]


class MapEncoder(Part):
    """modules.py MapEncoder: a point MLP (3 -> 128 -> 256) max-pooled over
    each polyline's points, plus the embeddings of the first point's
    traffic-light state and lane type."""

    def __init__(self):
        super().__init__()
        self.point = nn.Sequential(nn.Linear(3, 128), nn.ReLU(),
                                   nn.Linear(128, D))
        self.traffic_light_embed = nn.Embedding(8, D)
        self.type_embed = nn.Embedding(21, D)

    def forward(self, polylines):
        h = torch.relu(self.linear(self.point[0], polylines[..., :3]))
        pooled = self.linear(self.point[2], h).max(dim=-2).values
        light = polylines[:, :, 0, 3].to(torch.int32).clamp(0, 7).long()
        kind = polylines[:, :, 0, 4].to(torch.int32).clamp(0, 20).long()
        return (pooled + self.traffic_light_embed.weight[light]
                + self.type_embed.weight[kind])


class TrafficLightEncoder(Part):
    """modules.py TrafficLightEncoder: the light state's embedding."""

    def __init__(self):
        super().__init__()
        self.type_embed = nn.Embedding(8, D)

    def forward(self, lights):  # [B, TL, 3]
        return self.type_embed.weight[
            lights[:, :, 2].to(torch.int32).clamp(0, 7).long()]


class FourierEmbedding(Part):
    """modules.py FourierEmbedding: for each of the 3 input dimensions the
    features [cos(2 pi f x), sin(2 pi f x), x] over 64 learned bands, each
    dimension through its own MLP (Linear, LayerNorm, ReLU, Linear); the
    three stacked and summed; then LayerNorm, ReLU, Linear."""

    def __init__(self, input_dim: int = 3, bands: int = 64):
        super().__init__()
        self.freqs = nn.Embedding(input_dim, bands)
        self.mlps = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * bands + 1, D), nn.LayerNorm(D),
                          nn.ReLU(), nn.Linear(D, D))
            for _ in range(input_dim))
        self.to_out = nn.Sequential(nn.LayerNorm(D), nn.ReLU(),
                                    nn.Linear(D, D))

    def forward(self, x):  # [..., input_dim] -> [..., D]
        ang = x[..., None] * self.freqs.weight * 2 * math.pi
        feats = torch.cat([torch.cos(ang), torch.sin(ang), x[..., None]],
                          dim=-1)  # [..., input_dim, 2 * bands + 1]
        embs = []
        for i, mlp in enumerate(self.mlps):
            h = self.linear(mlp[0], feats[..., i, :])
            h = torch.relu(F.layer_norm(h, (D,), mlp[1].weight, mlp[1].bias,
                                        1e-5))
            embs.append(self.linear(mlp[3], h))
        out = torch.stack(embs).sum(dim=0)
        out = torch.relu(F.layer_norm(out, (D,), self.to_out[0].weight,
                                      self.to_out[0].bias, 1e-5))
        return self.linear(self.to_out[2], out)


class QCMHA(Part):
    """modules.py QCMHA, query-centric attention: for query i and key j
    with relation r_ij, per head, logits q_i . (k_j + r_ij) / sqrt(d) and
    output sum_j a_ij (v_j + r_ij); the in-projection packed per head as
    [q|k|v] (departure 2); the padding mask subtracted along the query
    axis (departure 1)."""

    def __init__(self):
        super().__init__()
        self.in_proj = nn.Linear(D, 3 * D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x, relations, query_pad_mask):
        B, S, _ = x.shape
        hd = D // HEADS
        q, k, v = self.linear(self.in_proj, x).reshape(
            B, S, HEADS, 3 * hd).split(hd, dim=-1)  # [B, S, H, hd] each
        rel = relations.reshape(B, S, S, HEADS, hd)  # [B, i, j, H, hd]
        k_rel = k[:, None] + rel  # the relation sums, as written
        v_rel = v[:, None] + rel
        logits = self.product("bihd,bijhd->bhij", q, k_rel) / math.sqrt(hd)
        logits = logits - query_pad_mask[:, None, :, None].to(
            logits.dtype) * 1e9
        attn = torch.softmax(logits, dim=-1)
        out = self.product("bhij,bijhd->bihd", attn, v_rel)
        return self.linear(self.out_proj, out.reshape(B, S, D))


class FFN(Part):
    """Linear, activation, Dropout (the identity at inference), Linear:
    the checkpoint's keys .0 and .3."""

    def __init__(self, d_in, hidden, d_out, act):
        super().__init__()
        self.act = act
        self.add_module("0", nn.Linear(d_in, hidden))
        self.add_module("3", nn.Linear(hidden, d_out))

    def forward(self, x):
        first, last = self._modules["0"], self._modules["3"]
        return self.linear(last, self.act(self.linear(first, x)))


class SelfTransformer(Part):
    """modules.py SelfTransformer, post-norm: a = LN(QCMHA(x) + x),
    LN(FFN(a) + a) with an exact GELU."""

    def __init__(self):
        super().__init__()
        self.qc_attention = QCMHA()
        self.norm_1 = nn.LayerNorm(D)
        self.norm_2 = nn.LayerNorm(D)
        self.ffn = FFN(D, FFN_WIDTH, D, F.gelu)

    def forward(self, x, relations, pad_mask):
        a = self.norm_1(self.qc_attention(x, relations, pad_mask) + x)
        return self.norm_2(self.ffn(a) + a)


class MultiheadAttention(Part):
    """torch nn.MultiheadAttention (eval, batch first) written out: the
    in-projection as [Q|K|V] blocks, per head softmax(q k^T / sqrt(d))
    v, masked keys (True) at -inf, the heads joined by ``out_proj``."""

    def __init__(self):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * D, D))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * D))
        self.out_proj = nn.Linear(D, D)

    def forward(self, q, k, v, key_padding_mask=None, attn_mask=None):
        # q [B, Q, D], k and v [B, K, D]; key_padding_mask [B, K],
        # attn_mask [Q, K], True = not attended
        w, b = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)
        hd = D // HEADS

        def heads(x, i):
            y = F.linear(self._r(x), self._r(w[i]), b[i])
            return y.reshape(y.shape[0], y.shape[1], HEADS, hd)

        qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
        logits = self.product("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        float("-inf"))
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask[None, None], float("-inf"))
        attn = torch.softmax(logits, dim=-1)
        out = self.product("bhqk,bkhd->bqhd", attn, vh)
        return self.linear(self.out_proj, out.reshape(q.shape[0], -1, D))


class CrossTransformer(Part):
    """modules.py CrossTransformer: keys and values key + relations, then
    a = LN(MHA(query, k, k)) with no residual (departure 3), LN(FFN(a) +
    a) with an exact GELU."""

    def __init__(self):
        super().__init__()
        self.cross_attention = MultiheadAttention()
        self.norm_1 = nn.LayerNorm(D)
        self.norm_2 = nn.LayerNorm(D)
        self.ffn = FFN(D, FFN_WIDTH, D, F.gelu)

    def forward(self, query, key, relations, key_padding_mask=None,
                attn_mask=None):
        k = key + relations
        a = self.norm_1(self.cross_attention(
            query, k, k, key_padding_mask=key_padding_mask,
            attn_mask=attn_mask))
        return self.norm_2(self.ffn(a) + a)


class Encoder(Part):
    """modules.py Encoder: agent, map and light tokens, the relation
    embedding, and the QCMHA stack over the S = agents + polylines +
    lights tokens."""

    def __init__(self, layers: int):
        super().__init__()
        self.agent_encoder = AgentEncoder()
        self.map_encoder = MapEncoder()
        self.traffic_light_encoder = TrafficLightEncoder()
        self.relation_encoder = FourierEmbedding()
        self.transformer_encoder = nn.Module()
        self.transformer_encoder.layers = nn.ModuleList(
            SelfTransformer() for _ in range(layers))

    def forward(self, inputs: dict) -> dict:
        agents = inputs["agents_history"]
        a_tok = self.agent_encoder(trajs_to_local_frame(agents),
                                   inputs["agents_type"])
        agents_mask = inputs["agents_interested"] == 0
        m_tok = self.map_encoder(polylines_to_local_frame(
            inputs["polylines"]))
        maps_mask = ~inputs["polylines_valid"]
        lights = inputs["traffic_light_points"]
        t_tok = self.traffic_light_encoder(lights)
        lights_mask = lights.sum(dim=-1) == 0
        relations = self.relation_encoder(inputs["relations"])
        x = torch.cat([a_tok, m_tok, t_tok], dim=1)
        pad_mask = torch.cat([agents_mask, maps_mask, lights_mask], dim=-1)
        for layer in self.transformer_encoder.layers:
            x = layer(x, relations, pad_mask)
        return {"encodings": x, "relation_encodings": relations,
                "agents_mask": agents_mask, "maps_mask": maps_mask,
                "traffic_lights_mask": lights_mask, "agents": agents}


def causal_mask(agents: int, blocks: int, i: int) -> torch.Tensor:
    """Agent ``i``'s mask over the A * T agent-block keys [T, A * T], True
    = not attended: its own blocks all, another agent's blocks up to the
    query's (modules.py TransformerDecoder)."""
    allowed = np.zeros((blocks, agents * blocks), bool)
    for j in range(agents):
        for t in range(blocks):
            if j == i:
                allowed[t, j * blocks:(j + 1) * blocks] = True
            else:
                allowed[t, j * blocks:j * blocks + t + 1] = True
    return torch.from_numpy(~allowed)


class TransformerDecoder(Part):
    """modules.py TransformerDecoder: the noisy trajectory embedded per
    action block, plus the block's time and the step's noise-level
    embeddings; then for each agent, as the official code loops: causal
    attention over every agent's blocks (keys q_j + r_ij), cross-attention
    into the scene (keys e_s + r_is); the stack plus its input; again with
    the updated stack as keys (departure 4); the decoder head."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        self.encoder = nn.Sequential(nn.Linear(5, 128), nn.ReLU(),
                                     nn.Linear(128, D))
        self.time_embedding = nn.Embedding(config.seq_len, D)
        self.attention_layers = nn.ModuleList(CrossTransformer()
                                              for _ in range(4))
        self.decoder = FFN(D, 128, 2, F.elu)

    def forward(self, trajs_local, noise_level, encodings, relations,
                pad_mask):
        cfg = self.config
        A, T = cfg.agents_len, cfg.seq_len
        B = trajs_local.shape[0]
        x = trajs_local.reshape(B, A, T, cfg.action_len, 5)
        h = torch.relu(self.linear(self.encoder[0], x))
        future = self.linear(self.encoder[2], h).max(dim=3).values
        query = (future + self.time_embedding.weight[None, None]
                 + noise_level[:, :, None, :])  # [B, A, T, D]
        masks = [causal_mask(A, T, i).to(x.device) for i in range(A)]
        l0, l1, l2, l3 = self.attention_layers

        def agents_pass(first, second, q):
            keys = q.reshape(B, A * T, D)
            out = []
            for i in range(A):
                rel = relations[:, i, :A].repeat_interleave(T, dim=1)
                qi = first(q[:, i], keys, rel, attn_mask=masks[i])
                qi = second(qi, encodings, relations[:, i],
                            key_padding_mask=pad_mask)
                out.append(qi)
            return torch.stack(out, dim=1)

        stack = agents_pass(l0, l1, query) + query
        return self.decoder(agents_pass(l2, l3, stack))


def roll_out(current, actions, action_len: int, dt: float = 0.1,
             global_frame: bool = True):
    """current [..., 5] (x, y, yaw, vx, vy); actions [..., blocks, 2]
    (acceleration, yaw rate), each held for ``action_len`` steps -> the
    trajectory [..., blocks * action_len, 5], step by step
    (model_utils.py roll_out): the speed v0 + sum a dt clamped at 0, the
    heading yaw0 + sum w dt, the position x0 + sum v cos(yaw) dt, each sum
    running from the first step and the start added to it.  In the
    agent's own frame (``global_frame=False``) position and heading start
    at 0."""
    x0, y0, th0 = current[..., 0], current[..., 1], current[..., 2]
    v0 = torch.sqrt(current[..., 3] ** 2 + current[..., 4] ** 2)
    sv, sth, sx, sy = (torch.zeros_like(v0) for _ in range(4))
    out = []
    for k in range(actions.shape[-2] * action_len):
        a = actions[..., k // action_len, 0]
        w = actions[..., k // action_len, 1]
        sv = sv + a * dt
        sth = sth + w * dt
        v = torch.clamp(v0 + sv, min=0.0)
        th = th0 + sth if global_frame else sth
        vx, vy = v * torch.cos(th), v * torch.sin(th)
        sx = sx + vx * dt
        sy = sy + vy * dt
        xy = (x0 + sx, y0 + sy) if global_frame else (sx, sy)
        out.append(torch.stack([xy[0], xy[1], th, vx, vy], dim=-1))
    return torch.stack(out, dim=-2)


class Denoiser(Part):
    """modules.py Denoiser: the noisy (unnormalised) actions rolled out in
    each agent's frame from its current state, through the decoder."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        self.noise_level_embedding = nn.Embedding(config.diffusion_steps, D)
        self.decoder = TransformerDecoder(config)

    def forward(self, enc: dict, actions, steps):
        cfg = self.config
        A = cfg.agents_len
        current = enc["agents"][:, :A, -1, :5]
        local = roll_out(current, actions[:, :A], cfg.action_len,
                         global_frame=False)
        pad_mask = torch.cat([enc["agents_mask"], enc["maps_mask"],
                              enc["traffic_lights_mask"]], dim=-1)
        return self.decoder(local, self.noise_level_embedding.weight[
            steps[:, :A].long()], enc["encodings"], enc["relation_encodings"],
            pad_mask)


class GoalPredictor(Part):
    """modules.py GoalPredictor's parameters, under the checkpoint's
    names: the sampler never calls it (sim_agent/sim_actor.py), so it has
    no forward here."""

    def __init__(self, config: Config):
        super().__init__()
        self.anchor_encoder = nn.Sequential(nn.Linear(2, 128), nn.ReLU(),
                                   nn.Linear(128, D))
        self.attention_layers = nn.ModuleList(CrossTransformer()
                                              for _ in range(4))
        self.act_decoder = FFN(D, 256, config.seq_len * 2, F.elu)
        self.score_decoder = FFN(D, 128, 1, F.elu)


class VBD(Part):
    """VBD.py: the encoder, the denoiser and the goal predictor's
    parameters.  Load weights with ``load_state_dict(strict=True)``."""

    def __init__(self, config: Config = None, with_predictor: bool = True):
        super().__init__()
        self.config = config or Config()
        self.encoder = Encoder(self.config.encoder_layers)
        self.denoiser = Denoiser(self.config)
        if with_predictor:
            self.predictor = GoalPredictor(self.config)

    def set_tf32(self, on: bool) -> None:
        for m in self.modules():
            if isinstance(m, Part):
                m.tf32 = on

    @torch.no_grad()
    def encode(self, inputs: dict) -> dict:
        return self.encoder(inputs)

    @torch.no_grad()
    def denoise(self, enc: dict, x_t, steps):
        """The denoiser's x0 (normalised actions) from the normalised noisy
        actions ``x_t`` [B, A, T, 2] at diffusion steps ``steps`` [B, A]
        (VBD.py forward_denoiser)."""
        cfg = self.config
        mean = x_t.new_tensor(cfg.action_mean)
        std = x_t.new_tensor(cfg.action_std)
        return self.denoiser(enc, x_t * std + mean, steps)


class DDPMScheduler:
    """The cosine schedule (s = 0.008, betas clipped at 0.999), computed in
    float64 and kept in float32; ``step`` samples the posterior
    q(x_{t-1} | x_t, x0) with x0 clamped to +-``clamp``."""

    def __init__(self, steps: int, clamp: float = 5.0):
        t = np.linspace(0, steps, steps + 1) / steps
        alpha_bar = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = np.clip(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)
        self.betas = torch.tensor(betas, dtype=torch.float32)
        self.alpha_bars = torch.tensor(np.cumprod(1 - betas),
                                       dtype=torch.float32)
        self.clamp = clamp

    def step(self, x0, x_t, t: int, eps):
        """x_{t-1} from the predicted ``x0``, ``x_t`` and the standard
        normal draw ``eps`` (drawn at t = 0 too, departure 6)."""
        x0 = torch.clamp(x0, -self.clamp, self.clamp)
        ab_t = self.alpha_bars[t].item()
        ab_prev = self.alpha_bars[t - 1].item() if t > 0 else 1.0
        beta = self.betas[t].item()
        mean = (math.sqrt(ab_prev) * beta / (1 - ab_t) * x0
                + math.sqrt(1 - beta) * (1 - ab_prev) / (1 - ab_t) * x_t)
        if t == 0:
            return mean
        return mean + math.sqrt(beta * (1 - ab_prev) / (1 - ab_t)) * eps


@torch.no_grad()
def sample(model: VBD, scheduler: DDPMScheduler, inputs: dict, draws):
    """Reverse diffusion (sim_agent/sim_actor.py): encode once, then at
    each step t = T-1 .. 0 the denoiser's x0 and the scheduler's step;
    ``draws`` gives x_T [B, A, blocks, 2] first, then each step's noise.
    Returns the unnormalised actions and the global-frame trajectories
    [B, A, future_len, 5]."""
    cfg = model.config
    draws = iter(draws)
    enc = model.encode(inputs)
    x_t = next(draws)
    B, A = x_t.shape[:2]
    for t in reversed(range(cfg.diffusion_steps)):
        steps = torch.full((B, A), t, dtype=torch.long, device=x_t.device)
        x_t = scheduler.step(model.denoise(enc, x_t, steps), x_t, t,
                             next(draws))
    actions = x_t * x_t.new_tensor(cfg.action_std) + x_t.new_tensor(
        cfg.action_mean)
    trajs = roll_out(inputs["agents_history"][:, :A, -1, :5], actions,
                     cfg.action_len)
    return actions, trajs


def relations(agents_history, polylines, lights):
    """[B, S, S, 3] token relations (integrations/vbd/data_utils.py
    calculate_relations), world by world: tokens are the agents at their
    last step, the polylines' first points and the lights (heading 0); the
    relation of source i and target j is the position of i minus that of j
    in i's frame and the wrapped heading difference (0 where either is a
    light); the diagonal 0.01 in all three; a pair with a padded token
    (x == 0) zero."""
    out = []
    for w in range(agents_history.shape[0]):
        lt = lights[w]
        tok = torch.cat([agents_history[w, :, -1, :3], polylines[w, :, 0, :3],
                         torch.cat([lt[:, :2], torch.zeros_like(lt[:, :1])],
                                   dim=-1)], dim=0)  # [S, 3]
        S, first_light = tok.shape[0], tok.shape[0] - lt.shape[0]
        dx = tok[:, None, 0] - tok[None, :, 0]  # [source, target]
        dy = tok[:, None, 1] - tok[None, :, 1]
        c, s = torch.cos(tok[:, None, 2]), torch.sin(tok[:, None, 2])
        dth = wrap_angle(tok[:, None, 2] - tok[None, :, 2])
        dth[first_light:] = 0.0
        dth[:, first_light:] = 0.0
        rel = torch.stack([dx * c + dy * s, -dx * s + dy * c, dth], dim=-1)
        rel[torch.arange(S), torch.arange(S)] = 0.01
        pad = tok[:, 0] == 0
        rel[pad] = 0.0
        rel[:, pad] = 0.0
        out.append(rel)
    return torch.stack(out)


def scatter(trajs, agent_ids, num_agents: int):
    """The sampled trajectories [W, N, F, 5] on the sim's agent rows
    [W, num_agents, 91, 5], agent by agent (integration.py): the first F
    steps, then the last one held; rows no sample agent maps to stay
    zero."""
    W, N, F_len = trajs.shape[:3]
    F_len = min(F_len, TRAJECTORY_LEN)
    out = trajs.new_zeros((W, num_agents, TRAJECTORY_LEN, FEATURES))
    for w in range(W):
        for n in range(N):
            a = int(agent_ids[w, n])
            if a < 0:
                continue
            out[w, a, :F_len] = trajs[w, n, :F_len]
            out[w, a, F_len:] = trajs[w, n, F_len - 1]
    return out


def vbd_obs_block(pos, yaw, trajs):
    """The egocentric VBD observation block [W, A, 91 * 5]: each agent's
    predicted trajectory in its own frame, the heading difference
    wrapped (gpudrive env_torch.py _get_vbd_obs)."""
    c = torch.cos(yaw)[..., None]
    s = torch.sin(yaw)[..., None]
    dx = trajs[..., 0] - pos[..., 0, None]
    dy = trajs[..., 1] - pos[..., 1, None]
    dth = trajs[..., 2] - yaw[..., None]
    block = torch.stack([dx * c + dy * s, -dx * s + dy * c,
                         torch.atan2(torch.sin(dth), torch.cos(dth)),
                         trajs[..., 3] * c + trajs[..., 4] * s,
                         -trajs[..., 3] * s + trajs[..., 4] * c], dim=-1)
    return block.reshape(block.shape[0], block.shape[1], -1)


def vbd_reward(pos, trajs, world_time_steps, weight: float):
    """The ``distance_to_vdb_trajs`` bonus [W, A]: weight x exp(-distance
    to the predicted position at the world's step, clamped to the
    trajectory)."""
    t = torch.clamp(world_time_steps.long(), 0, trajs.shape[2] - 1)
    at = trajs[torch.arange(trajs.shape[0], device=trajs.device), :, t, :2]
    return weight * torch.exp(-torch.sqrt(((at - pos) ** 2).sum(-1)))
